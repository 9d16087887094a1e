"""The MoE block for serving: route, then the experts.

Counterpart of ``neuronx_distributed_tpu/moe/layer.py`` (``MoE``) without
sequence parallelism, expert parallelism or the sown auxiliary losses
(training is not ported). The inference dispatch is JAX's
(``layer.py:63-86``): a decode step (``s == 1``) runs ``selective`` when
``T * top_k / E < selective_loading_threshold``, else ``all_experts``;
context encoding never drops a token, so ``capacity_factor`` becomes
``all_experts`` there. The choice reads static shapes only, so it is fixed
for a captured program, and routing stays on the device (no host read,
no boolean indexing). The router output ``combine`` reaches the experts in
the activations' dtype, as in the JAX block.
"""

from __future__ import annotations

import torch
from torch import nn

from neuronx_distributed_tpu_torch.moe.expert_mlps import ExpertMLPs
from neuronx_distributed_tpu_torch.moe.routing import RouterSinkhorn, RouterTopK


class MoE(nn.Module):
    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 top_k: int = 2, router: str = "top_k", mode: str = "capacity_factor",
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.bfloat16, param_dtype: torch.dtype = torch.float32,
                 inference: bool = False, selective_loading_threshold: float = 0.5,
                 device=None):
        super().__init__()
        self.num_experts, self.hidden_size, self.top_k = num_experts, hidden_size, top_k
        self.mode, self.inference = mode, inference
        self.selective_loading_threshold = selective_loading_threshold
        if router == "top_k":
            self.router = RouterTopK(hidden_size, num_experts, top_k=top_k, device=device)
        elif router == "sinkhorn":
            self.router = RouterSinkhorn(hidden_size, num_experts, device=device)
        else:
            raise ValueError(f"unknown router {router!r}")
        self.experts = ExpertMLPs(num_experts, hidden_size, intermediate_size,
                                  capacity_factor=capacity_factor, mode=mode, dtype=dtype,
                                  param_dtype=param_dtype, device=device)

    def mode_for(self, batch: int, seq: int) -> str:
        """The expert mode of a forward over ``(batch, seq)`` tokens."""
        if not self.inference:
            return self.mode
        if seq == 1:   # token generation
            selective = batch * self.top_k / self.num_experts < self.selective_loading_threshold
            return "selective" if selective else "all_experts"
        return "all_experts" if self.mode == "capacity_factor" else self.mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        if h != self.hidden_size:
            raise ValueError(f"input hidden dim {h} != configured hidden_size {self.hidden_size}")
        flat = x.reshape(b * s, h)
        combine, _ = self.router(flat)
        out = self.experts(flat, combine.to(flat.dtype), top_k=self.top_k,
                           mode=self.mode_for(b, s))
        return out.reshape(b, s, h)
