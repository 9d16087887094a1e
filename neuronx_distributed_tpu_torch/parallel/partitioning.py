"""Partition specs of the weights, and a rank's slice of a global state dict.

Counterpart of ``neuronx_distributed_tpu/parallel/partitioning.py``. A spec
is a tuple with ``"tp"`` on the dim that shards over the tensor-parallel
ranks and, on an expert weight, ``"ep"`` on the dim that shards over the
expert-parallel ranks (``inference/partition.py``'s terms; ``()``
replicated), taken from the layers that hold the weights
(``param_partition_specs``).

JAX's ``constrain`` (``with_sharding_constraint``) has no torch analogue:
a GSPMD hint that lets XLA choose the collectives. Here every activation
layout change is an explicit region of ``parallel/mappings.py``: the
sequence-parallel regions of the TP layers (``parallel/layers.py``: the
column layers all-gather their input along the sequence, the row layers
and the embedding reduce-scatter their output) do the work the
``ACT_SP``/``ACT_FULL`` constraints do in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from neuronx_distributed_tpu_torch.inference.partition import (  # noqa: F401
    Spec,
    param_partition_specs,
    shard_slice,
)


def local_state_dict(state: Mapping[str, Any], specs: Mapping[str, Spec], rank: int, tp: int,
                     shapes: Mapping[str, torch.Size] = None, ep_rank: int = 0,
                     ep: int = 1) -> Dict[str, torch.Tensor]:
    """Tensor-parallel rank ``rank``'s slices of a global state dict
    (tensors or arrays) under ``specs`` (a name absent from ``specs`` is
    replicated), an expert leaf cut over ``ep`` at ``ep_rank`` too. With
    ``shapes`` (the rank's local shapes), a tensor already of its local
    shape is taken as it is."""
    out = {}
    for name, v in state.items():
        t = torch.as_tensor(v)
        spec = specs.get(name, ())
        if shapes is not None and name in shapes and tuple(t.shape) == tuple(shapes[name]):
            out[name] = t
            continue
        out[name] = shard_slice(t, spec, rank, tp, ep_rank, ep)
        if shapes is not None and name in shapes and tuple(out[name].shape) != tuple(shapes[name]):
            raise ValueError(f"{name}: {tuple(t.shape)} is neither rank {rank}'s shard "
                             f"{tuple(shapes[name])} nor its global tensor under {spec}")
    return out
