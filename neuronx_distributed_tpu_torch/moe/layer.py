"""The MoE block: route, then the experts, for serving and training.

Counterpart of ``neuronx_distributed_tpu/moe/layer.py`` (``MoE``, JAX
``:25-121``). The inference dispatch is JAX's (``layer.py:63-86``): a
decode step (``s == 1``) runs ``selective`` when ``T * top_k / E <
selective_loading_threshold``, else ``all_experts``; context encoding
never drops a token, so ``capacity_factor`` becomes ``all_experts`` there.
The choice reads static shapes only, so it is fixed for a captured
program, and routing stays on the device (no host read, no boolean
indexing). The router output ``combine`` reaches the experts in the
activations' dtype, as in the JAX block.

Parallel training (the groups come from the model: ``tp_group``,
``ep_group``, ``dp_group``). The router is replicated and routes in fp32,
so every tensor-parallel rank routes its tokens alike. Each TP rank's
experts produce a partial sum over their intermediate columns, reduced
once after the combine: an all-reduce, or under ``sequence_parallel`` a
reduce-scatter along the sequence (SP re-entry; the block's input, the
rank's sequence shard, is all-gathered first: SP exit). The expert path's
input and the combine weights enter through copy regions (identity
forward, all-reduce over TP backward), so their gradients sum the ranks'
partials, while the router's own path and the auxiliary loss, computed
alike on every TP rank, are counted once: the reference all-reduces its
``LinearRouter``'s weight gradient over TP for the same reason. Under SP
the gathered input's gradient is then whole on every rank, so the exit's
backward keeps the rank's slice.

Auxiliary losses (JAX's ``sow("losses", ...)``): outside decode mode each
forward computes ``aux_loss_coef * load_balancing_loss`` (plus
``z_loss_coef * router_z_loss``), the load balance over the global
dispatch counts (``moe/routing.py``); inside :func:`record_aux_losses`
each block keeps its value where :func:`collect_aux_losses` finds it. A
recompute under activation checkpointing computes it again (the recompute
must run the forward's operations) without keeping it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch import nn

from neuronx_distributed_tpu_torch.moe.expert_mlps import ExpertMLPs, dispatch_counts
from neuronx_distributed_tpu_torch.moe.routing import (
    RouterSinkhorn,
    RouterTopK,
    load_balancing_loss,
    router_z_loss,
)
from neuronx_distributed_tpu_torch.parallel.mappings import (
    copy_to_tensor_parallel_region,
    gather_from_tensor_parallel_region,
    reduce_from_tensor_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import group_size


class MoE(nn.Module):
    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 top_k: int = 2, router: str = "top_k", mode: str = "capacity_factor",
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 inference: bool = False, selective_loading_threshold: float = 0.5,
                 device=None, sequence_parallel: bool = False, aux_loss_coef: float = 0.01,
                 z_loss_coef: float = 0.0, tp_group=None, ep_group=None, dp_group=None):
        super().__init__()
        self.num_experts, self.hidden_size, self.top_k = num_experts, hidden_size, top_k
        self.mode, self.inference = mode, inference
        self.selective_loading_threshold = selective_loading_threshold
        self.aux_loss_coef, self.z_loss_coef = aux_loss_coef, z_loss_coef
        self.tp_group, self.dp_group = tp_group, dp_group
        self.sequence_parallel = bool(sequence_parallel) and tp_group is not None
        if router == "top_k":
            self.router = RouterTopK(hidden_size, num_experts, top_k=top_k, device=device)
        elif router == "sinkhorn":
            self.router = RouterSinkhorn(hidden_size, num_experts, device=device, group=dp_group)
        else:
            raise ValueError(f"unknown router {router!r}")
        self.experts = ExpertMLPs(num_experts, hidden_size, intermediate_size,
                                  capacity_factor=capacity_factor, mode=mode, dtype=dtype,
                                  param_dtype=param_dtype, device=device,
                                  tp=group_size(tp_group), ep_group=ep_group,
                                  dp_group=dp_group)
        # set by record_aux_losses: keep this forward's auxiliary loss
        self.record_aux = False
        self.aux_loss = None

    def mode_for(self, batch: int, seq: int) -> str:
        """The expert mode of a forward over ``(batch, seq)`` tokens."""
        if not self.inference:
            return self.mode
        if seq == 1:   # token generation
            selective = batch * self.top_k / self.num_experts < self.selective_loading_threshold
            return "selective" if selective else "all_experts"
        return "all_experts" if self.mode == "capacity_factor" else self.mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp_group
        if self.sequence_parallel:   # exit SP: routing needs the whole sequence
            x = gather_from_tensor_parallel_region(x, tp, 1)
        b, s, h = x.shape
        if h != self.hidden_size:
            raise ValueError(f"input hidden dim {h} != configured hidden_size {self.hidden_size}")
        flat = x.reshape(b * s, h)
        combine, logits = self.router(flat)
        mode = self.mode_for(b, s)
        counts = None if self.inference else dispatch_counts(combine, self.dp_group)
        out = self.experts(copy_to_tensor_parallel_region(flat, tp),
                           copy_to_tensor_parallel_region(combine.to(flat.dtype), tp),
                           top_k=self.top_k, mode=mode, counts=counts).reshape(b, s, h)
        if not self.inference:
            aux = self.aux_loss_coef * load_balancing_loss(
                logits, combine, self.num_experts, counts.sum(dim=0), b * s * counts.shape[0])
            if self.z_loss_coef:
                aux = aux + self.z_loss_coef * router_z_loss(logits)
            if self.record_aux:
                self.aux_loss = aux
        if self.sequence_parallel:   # re-enter SP: the partial sums reduce-scattered
            return reduce_scatter_to_sequence_parallel_region(out, tp, 1)
        return reduce_from_tensor_parallel_region(out, tp)


def _moe_blocks(module: nn.Module) -> Iterator[MoE]:
    return (m for m in module.modules() if isinstance(m, MoE))


@contextlib.contextmanager
def record_aux_losses(module: nn.Module):
    """Inside this context each MoE block of ``module`` keeps its forward's
    auxiliary loss (JAX ``apply(..., mutable=["losses"])``); on exit they
    are dropped."""
    blocks = list(_moe_blocks(module))
    for m in blocks:
        m.record_aux, m.aux_loss = True, None
    try:
        yield
    finally:
        for m in blocks:
            m.record_aux, m.aux_loss = False, None


def collect_aux_losses(module: nn.Module) -> torch.Tensor:
    """The sum of the auxiliary losses the MoE blocks of ``module`` kept
    (over layers), fp32; 0 if none (JAX ``collect_aux_losses``)."""
    kept = [m.aux_loss for m in _moe_blocks(module) if m.aux_loss is not None]
    if not kept:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([a.float() for a in kept]).sum()
