"""Optimizers: fp32-master AdamW and its single-pass kernel."""
