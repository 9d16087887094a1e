"""Attention dispatch and ring attention (context parallelism)."""
