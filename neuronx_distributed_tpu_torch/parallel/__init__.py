"""Sharded compute layers, the TP regions and the parallel state over ``torch.distributed``."""
