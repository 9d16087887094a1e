"""Gradient norm, clipping and the data-parallel reduction over sharded grads.

Counterpart of ``neuronx_distributed_tpu/parallel/grads.py``
(``get_grad_norm``, ``clip_grads_with_norm``, ``clip_grad_norm``,
``psum_gradients_over_dp``). JAX's gradients are global arrays and its norm
is a plain sum; here each rank holds pieces, so :func:`get_grad_norm` takes
the layout: a leaf named in ``tp_sharded`` is a tensor-parallel shard (its
squares summed over TP), one named in ``dp_sharded`` a ZeRO-1 shard
reduce-scattered over DP (summed over DP); every other leaf is replicated
along that axis and counted once, on the axis's rank 0. An expert leaf
(``ep_sharded``) is a different slice on each expert-parallel rank, whose
squares the sum over the DP group (which spans ``ep``) adds up; it is
replicated over the expert-data-parallel ranks unless ZeRO-1 split it
there (``dp_sharded``), so it counts on ``edp_group``'s rank 0. Under pipeline
parallelism each leaf lives on one stage, so the sum also runs over the
``pp_group``. The inf norm takes a MAX over every group. Every result stays a device tensor: nothing is read back
to the host.
"""

from __future__ import annotations

from typing import Collection, Dict, Mapping, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.parallel import mesh as ps
from neuronx_distributed_tpu_torch.parallel.mappings import all_reduce_max_, all_reduce_sum_

Tree = Mapping[str, torch.Tensor]


def get_grad_norm(grads: Tree, norm_type: float = 2.0, *, tp_group=None, dp_group=None,
                  pp_group=None, tp_sharded: Collection[str] = (),
                  dp_sharded: Collection[str] = (), ep_sharded: Collection[str] = (),
                  edp_group=None) -> torch.Tensor:
    """Global gradient norm in fp32 (the p-norm over every element of the
    global gradients, or the largest magnitude for ``inf``), the same on
    every rank. Without groups: the single-device norm."""
    leaves = list(grads.items())
    groups = (tp_group, dp_group, pp_group)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == float("inf"):
        out = torch.stack([g.float().abs().amax() for _, g in leaves]).amax().reshape(1)
        for group in groups:
            all_reduce_max_(out, group)
        return out.reshape(())
    tp_rank, dp_rank = ps.group_rank(tp_group), ps.group_rank(dp_group)
    edp_rank = ps.group_rank(edp_group)
    # a replicated piece counts on its axis's rank 0 only
    parts = [(g.float().abs() ** norm_type).sum() for n, g in leaves
             if (n in tp_sharded or tp_rank == 0)
             and (n in dp_sharded or (edp_rank if n in ep_sharded else dp_rank) == 0)]
    total = (torch.stack(parts).sum() if parts
             else torch.zeros((), dtype=torch.float32, device=leaves[0][1].device))
    if any(g is not None for g in groups):
        total = total.reshape(1)
        for group in groups:
            all_reduce_sum_(total, group)
        total = total.reshape(())
    return total ** (1.0 / norm_type)


def clip_grads_with_norm(grads: Tree, total_norm: torch.Tensor,
                         max_norm: float) -> Dict[str, torch.Tensor]:
    """Scale every grad by ``min(1, max_norm / (total_norm + 1e-6))``, in fp32,
    back in the grad's dtype (a multiply, no data-dependent branch)."""
    coeff = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    return {n: (g.float() * coeff).to(g.dtype) for n, g in grads.items()}


def clip_grad_norm(grads: Tree, max_norm: float, norm_type: float = 2.0,
                   **layout) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Compute the norm (``layout``: :func:`get_grad_norm`'s keywords),
    then clip. Returns ``(clipped grads, norm before clipping)``."""
    total_norm = get_grad_norm(grads, norm_type, **layout)
    return clip_grads_with_norm(grads, total_norm, max_norm), total_norm


def psum_gradients_over_dp(grads: Tree, mean: bool = True,
                           group: Optional[object] = None) -> Dict[str, torch.Tensor]:
    """The gradients summed (``mean``: averaged) over the data-parallel
    group (default: the current mesh's), as new tensors."""
    if group is None:
        if not ps.model_parallel_is_initialized():
            return dict(grads)
        group = ps.get_data_parallel_group()
    scale = 1.0 / ps.group_size(group) if mean else 1.0
    out = {}
    for n, g in grads.items():
        t = g.contiguous().clone()
        all_reduce_sum_(t, group)
        out[n] = t.mul_(scale) if mean else t
    return out
