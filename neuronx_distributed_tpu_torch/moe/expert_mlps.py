"""Expert MLPs: E gated (SiLU) MLPs with fused 3-D weights, in three modes.

Counterpart of ``neuronx_distributed_tpu/moe/expert_mlps.py``. Weights
``gate``/``up`` ``(E, H, I)`` and ``down`` ``(E, I, H)`` (the JAX names and
shapes), float or :class:`~neuronx_distributed_tpu_torch.parallel.layers.
QuantizedKernel`. Each mode keeps the JAX package's summation order:

* ``all_experts``: every expert runs every token, the outputs summed over
  experts with the ``combine`` weights;
* ``selective`` (decode): each token's ``top_k`` experts only, summed over k
  with their router weights. With int8 weights B5 reads the chosen
  experts' weights in place through an index of (token, expert) pairs, so
  nothing gathers a copy; the JAX package gathers the int8 rows and then
  dequantizes the gathered slice, which gives the same numbers;
* ``capacity_factor``: the one-hot dispatch and combine of a fixed number
  of slots an expert, tokens past an expert's capacity dropped in token
  order (positions from an int32 cumsum).

Every expert product is one batched product: B5 (``kernels/w8a16.py``) for
int8 weights (the kernel on the card, its twin on the CPU), ``torch.matmul``
for float ones.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
from neuronx_distributed_tpu_torch.moe.routing import top_k as _top_k
from neuronx_distributed_tpu_torch.parallel.layers import QuantizedKernel, _param

MODES = ("capacity_factor", "all_experts", "selective")


class ExpertMLPs(nn.Module):
    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 capacity_factor: float = 1.25,
                 mode: str = "capacity_factor", dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown expert mode {mode!r}")
        E, H, I = num_experts, hidden_size, intermediate_size
        self.num_experts, self.capacity_factor = E, capacity_factor
        self.mode, self.dtype = mode, dtype
        self.gate = _param((E, H, I), param_dtype, device)
        self.up = _param((E, H, I), param_dtype, device)
        self.down = _param((E, I, H), param_dtype, device)

    def _bmm(self, x: torch.Tensor, w, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x (B, M, K)`` against experts ``w (E, K, N)``: entry b against
        expert ``idx[b]``, or expert b when ``idx`` is None."""
        if isinstance(w, QuantizedKernel):
            if x.stride(0) != 0:   # B5 takes rows contiguous; a shared x keeps stride 0
                x = x.contiguous()
            if idx is None:
                idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
            return w8a16_gemm(x, w.qweight, w.scale, idx.to(torch.int32))
        wf = w.to(self.dtype)
        if idx is not None:
            wf = wf.index_select(0, idx.long())
        return torch.matmul(x, wf)

    def _act(self, g: torch.Tensor, x: torch.Tensor, idx=None) -> torch.Tensor:
        return F.silu(g) * self._bmm(x, self.up, idx)

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        """``h (E, C, H)`` expert-major activations -> ``(E, C, H)``."""
        h = h.to(self.dtype)
        return self._bmm(self._act(self._bmm(h, self.gate), h), self.down)

    def capacity(self, num_tokens: int) -> int:
        c = int(self.capacity_factor * num_tokens / self.num_experts)
        return max(1, min(c, num_tokens))

    def forward_capacity_factor(self, x: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
        """``x (T, H)``, ``combine (T, E)`` -> ``(T, H)``; assignments past an
        expert's capacity are dropped in token order."""
        T = x.shape[0]
        C = self.capacity(T)
        mask = (combine > 0).to(torch.int32)
        pos = torch.cumsum(mask, dim=0, dtype=torch.int32) * mask - mask
        keep = (pos < C) & (mask > 0)
        # slot C is the drop slot: one class more, then cut (jax.nn.one_hot
        # of an index out of range is all zeros)
        pos_oh = F.one_hot(torch.where(keep, pos, C).long(), C + 1)[..., :C].to(x.dtype)
        dispatch = pos_oh * keep[..., None].to(x.dtype)
        combine_w = dispatch * combine[..., None].to(x.dtype)
        expert_in = torch.einsum("th,tec->ech", x, dispatch)
        out = torch.einsum("ech,tec->th", self._mlp(expert_in), combine_w)
        return out.to(x.dtype)

    def forward_all_experts(self, x: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
        """Every expert on every token: one product an expert weight, the
        tokens shared by the experts (a batch stride of 0)."""
        T, H = x.shape
        out = self._mlp(x[None].expand(self.num_experts, T, H))
        return torch.einsum("eth,te->th", out, combine.to(out.dtype)).to(x.dtype)

    def forward_selective(self, x: torch.Tensor, combine: torch.Tensor,
                          top_k: int) -> torch.Tensor:
        """Each token through its ``top_k`` experts only: ``T * top_k``
        (token, expert) pairs of one row each; ``combine`` must have exactly
        ``top_k`` nonzeros a row."""
        in_dtype = x.dtype
        aff, idx = _top_k(combine, top_k)                        # (T, k)
        T, H = x.shape
        h = x.to(self.dtype)[:, None, None, :].expand(T, top_k, 1, H).reshape(T * top_k, 1, H)
        flat = idx.reshape(-1)
        a = self._act(self._bmm(h, self.gate, flat), h, flat)
        out_k = self._bmm(a, self.down, flat).reshape(T, top_k, H)
        return torch.einsum("tkh,tk->th", out_k, aff.to(out_k.dtype)).to(in_dtype)

    def forward(self, x: torch.Tensor, combine: torch.Tensor, top_k: Optional[int] = None,
                mode: Optional[str] = None) -> torch.Tensor:
        mode = mode or self.mode
        if mode == "selective":
            if top_k is None:
                raise ValueError("selective mode needs the router's top_k")
            return self.forward_selective(x, combine, top_k)
        if mode == "capacity_factor":
            return self.forward_capacity_factor(x, combine)
        if mode == "all_experts":
            return self.forward_all_experts(x, combine)
        raise ValueError(f"unknown expert mode {mode!r}")
