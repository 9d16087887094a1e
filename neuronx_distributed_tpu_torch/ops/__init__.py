"""Attention dispatch."""
