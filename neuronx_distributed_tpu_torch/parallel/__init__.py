"""Sharded compute layers (tensor parallel degree 1 in this slice)."""
