"""Gradient norm and clipping over a dict of gradients, on one device.

Counterpart of ``neuronx_distributed_tpu/parallel/grads.py``
(``get_grad_norm``, ``clip_grads_with_norm``, ``clip_grad_norm``). Every
result stays a device tensor: nothing is read back to the host. The
data-parallel reduction (``psum_gradients_over_dp``) comes with the slice
that ports data parallelism.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


def get_grad_norm(grads: Tree, norm_type: float = 2.0) -> torch.Tensor:
    """Global gradient norm in fp32 (the p-norm over every element of every
    leaf, or the largest magnitude for ``inf``)."""
    leaves = list(grads.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == float("inf"):
        return torch.stack([g.float().abs().amax() for g in leaves]).amax()
    norms = torch.stack([(g.float().abs() ** norm_type).sum() for g in leaves])
    return norms.sum() ** (1.0 / norm_type)


def clip_grads_with_norm(grads: Tree, total_norm: torch.Tensor,
                         max_norm: float) -> Dict[str, torch.Tensor]:
    """Scale every grad by ``min(1, max_norm / (total_norm + 1e-6))``, in fp32,
    back in the grad's dtype (a multiply, no data-dependent branch)."""
    coeff = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    return {n: (g.float() * coeff).to(g.dtype) for n, g in grads.items()}


def clip_grad_norm(grads: Tree, max_norm: float,
                   norm_type: float = 2.0) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Compute the norm, then clip. Returns ``(clipped grads, norm before
    clipping)``."""
    total_norm = get_grad_norm(grads, norm_type)
    return clip_grads_with_norm(grads, total_norm, max_norm), total_norm
