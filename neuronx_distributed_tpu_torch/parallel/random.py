"""Seeds over the parallel ranks.

Counterpart of ``neuronx_distributed_tpu/parallel/random.py`` (the
reference's ``model_parallel_xla_manual_seed``): tensor-parallel ranks draw
different noise (dropout on their own shards) by offsetting the seed with
``2718 + tp_rank``, and data-parallel replicas share the seed, so their
draws agree.
"""

from __future__ import annotations

from typing import Optional

import torch

from neuronx_distributed_tpu_torch.parallel import mesh

# the reference's fixed offset (random.py:107)
_TENSOR_PARALLEL_SEED_OFFSET = 2718


def fold_in_axis_rank(seed: int, rank: Optional[int] = None,
                      device=None) -> torch.Generator:
    """A generator seeded ``seed + 2718 + rank`` (``rank``: this thread's
    tensor-parallel rank by default), distinct along the TP ranks."""
    if rank is None:
        rank = mesh.tensor_model_parallel_rank() if mesh.model_parallel_is_initialized() else 0
    return torch.Generator(device=device or "cpu").manual_seed(
        int(seed) + _TENSOR_PARALLEL_SEED_OFFSET + int(rank))


def data_parallel_consistent_key(seed):
    """The identity: data-parallel replicas share the seed."""
    return seed
