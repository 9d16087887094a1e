"""Checkpoint storage (the filesystem control plane); see ``storage``."""
