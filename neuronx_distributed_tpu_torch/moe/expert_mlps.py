"""Expert MLPs: E gated (SiLU) MLPs with fused 3-D weights, in three modes.

Counterpart of ``neuronx_distributed_tpu/moe/expert_mlps.py``. Weights
``gate``/``up`` ``(E, H, I)`` and ``down`` ``(E, I, H)`` (the JAX names and
shapes), float or :class:`~neuronx_distributed_tpu_torch.parallel.layers.
QuantizedKernel`. Each mode keeps the JAX package's arithmetic:

* ``all_experts``: every expert runs every token, the outputs summed over
  experts with the ``combine`` weights;
* ``selective`` (decode): each token's ``top_k`` experts only, summed over k
  with their router weights. With int8 weights B5 reads the chosen
  experts' weights in place through an index of (token, expert) pairs, so
  nothing gathers a copy; the JAX package gathers the int8 rows and then
  dequantizes the gathered slice, which gives the same numbers;
* ``capacity_factor``: ``C = int(capacity_factor * T / E)`` slots an
  expert, assignments past an expert's capacity dropped in token order
  (positions from an int32 cumsum). Each token's kept assignments are
  copied into their slots and read back out of them by index (JAX's
  one-hot dispatch and combine einsums, without their ``T x E x C``
  products); every kept slot holds one token, so the copies are exact.

Every expert product is one batched product: B5 (``kernels/w8a16.py``) for
int8 weights (the kernel on the card, its twin on the CPU), ``torch.matmul``
for float ones, as JAX computes them outside any Pallas kernel.

Parallel layouts (JAX ``:55-67``: ``(ep, None, tp)`` and ``(ep, tp,
None)``, ``partition_specs``). Under an expert-parallel group of ``ep``
ranks a rank holds experts ``ep_rank * E/ep`` onwards, and under a
tensor-parallel degree ``tp`` their ``I/tp`` intermediate columns of its
TP rank; the output is then this rank's partial sum over those columns,
which the caller reduces over TP once (``moe/layer.py``). In
``capacity_factor`` mode a rank fills ``(E, Cl, H)`` slots, ``Cl = min(C,
T_local)`` (a rank cannot keep more of an expert's assignments than it has
tokens), the expert all-to-all (``parallel/mappings.py``) brings each
owner its experts' slots from every rank of its ep group, ``(E/ep, ep *
Cl, H)``, and the reverse all-to-all takes the outputs home. In
``all_experts`` mode the ep group's tokens are all-gathered, a rank runs
its experts on all of them, and the partial sums are reduce-scattered
back. ``selective`` runs on one rank only.

Global capacity (JAX computes over the global batch under GSPMD): with a
data-parallel ``dp_group`` (dp ranks, each holding its rows of the global
batch in rank order) ``C`` comes from the global token count, and a
token's position in an expert is its local position plus that expert's
assignments on the lower dp ranks: the ranks all-gather their ``E``
dispatch counts once a forward (:func:`dispatch_counts`), so every rank
drops exactly the assignments the one-device run drops. ``last_dropped``
holds the global dropped assignments an expert of the last
``capacity_factor`` forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
from neuronx_distributed_tpu_torch.moe.routing import top_k as _top_k
from neuronx_distributed_tpu_torch.parallel import mappings
from neuronx_distributed_tpu_torch.parallel.layers import QuantizedKernel, _param, divide
from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size

MODES = ("capacity_factor", "all_experts", "selective")


def dispatch_counts(combine: torch.Tensor, dp_group=None) -> torch.Tensor:
    """``(dp, E)`` int32: each data-parallel rank's count of assignments
    (``combine > 0``) an expert, in dp rank order (``(1, E)`` without a
    group). No gradient."""
    counts = (combine > 0).sum(dim=0, dtype=torch.int32)[None]
    if dp_group is None:
        return counts
    return mappings._all_gather(counts, 0, dp_group)


class ExpertMLPs(nn.Module):
    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 capacity_factor: float = 1.25,
                 mode: str = "capacity_factor", dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None, tp: int = 1,
                 ep_group=None, dp_group=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown expert mode {mode!r}")
        E, H, I = num_experts, hidden_size, intermediate_size
        self.num_experts, self.capacity_factor = E, capacity_factor
        self.mode, self.dtype = mode, dtype
        self.tp, self.ep_group, self.dp_group = tp, ep_group, dp_group
        self.ep, self.ep_rank = group_size(ep_group), group_rank(ep_group)
        el, il = divide(E, self.ep), divide(I, tp)
        self.gate = _param((el, H, il), param_dtype, device)
        self.up = _param((el, H, il), param_dtype, device)
        self.down = _param((el, il, H), param_dtype, device)
        self.partition_specs = {"gate": ("ep", None, "tp"), "up": ("ep", None, "tp"),
                                "down": ("ep", "tp", None)}
        self.last_dropped: Optional[torch.Tensor] = None

    @property
    def local_experts(self) -> int:
        return self.num_experts // self.ep

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
        """``h (E_local, C, H)`` expert-major activations -> ``(E_local, C,
        H)`` (a partial sum under TP)."""
        h = h.to(self.dtype)
        return self._bmm(self._act(self._bmm(h, self.gate), h), self.down)

    def capacity(self, num_tokens: int) -> int:
        c = int(self.capacity_factor * num_tokens / self.num_experts)
        return max(1, min(c, num_tokens))

    def forward_capacity_factor(self, x: torch.Tensor, combine: torch.Tensor,
                                top_k: Optional[int] = None,
                                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x (T, H)`` (the rank's tokens), ``combine (T, E)`` -> ``(T, H)``;
        assignments past an expert's global capacity are dropped in global
        token order. ``top_k``: the most nonzeros a row of ``combine`` has
        (default E); ``counts``: :func:`dispatch_counts` of ``combine``
        over the dp group, when the caller has them."""
        T, H = x.shape
        E = self.num_experts
        k = min(top_k or E, E)
        if counts is None:
            counts = dispatch_counts(combine, self.dp_group)
        dp = counts.shape[0]
        C = self.capacity(T * dp)
        cl = min(C, T)
        offset = counts[:group_rank(self.dp_group)].sum(dim=0)             # (E,)
        self.last_dropped = (counts.sum(dim=0) - C).clamp_min(0)
        mask = (combine > 0).to(torch.int32)
        pos = torch.cumsum(mask, dim=0, dtype=torch.int32) * mask - mask   # 0-based, local
        keep = (pos + offset < C) & (mask > 0)
        w, e_idx = _top_k(combine, k)                                      # (T, k)
        kept = keep.gather(1, e_idx)
        # slot e * cl + position; the dropped go to one spare row past the end
        slot = torch.where(kept, e_idx * cl + pos.gather(1, e_idx), E * cl).reshape(-1)
        rows = x[:, None, :].expand(T, k, H).reshape(T * k, H)
        expert_in = x.new_zeros((E * cl + 1, H)).index_add(0, slot, rows)[:-1]
        expert_in = expert_in.view(E, cl, H)
        if self.ep > 1:   # each owner takes its experts' slots from every ep rank
            expert_in = mappings.all_to_all_in_expert_parallel_region(expert_in, 0, 1,
                                                                      self.ep_group)
        expert_out = self._mlp(expert_in)
        if self.ep > 1:
            expert_out = mappings.all_to_all_in_expert_parallel_region(expert_out, 1, 0,
                                                                       self.ep_group)
        dt = torch.promote_types(expert_out.dtype, x.dtype)
        flat = torch.cat([expert_out.reshape(E * cl, H).to(dt), expert_out.new_zeros((1, H),
                                                                                    dtype=dt)])
        picked = flat.index_select(0, slot).view(T, k, H)
        wk = torch.where(kept, w, torch.zeros_like(w)).to(dt)
        return torch.einsum("tkh,tk->th", picked, wk).to(x.dtype)

    def forward_all_experts(self, x: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
        """Every expert on every token: one product an expert weight, the
        tokens shared by the experts (a batch stride of 0). Under EP the ep
        group's tokens are all-gathered and the rank's experts' partial
        sums reduce-scattered back."""
        if self.ep > 1:
            x = mappings.all_gather(x, 0, self.ep_group)
            combine = mappings.all_gather(combine, 0, self.ep_group)
        e0 = self.ep_rank * self.local_experts
        combine = combine[:, e0:e0 + self.local_experts]
        T, H = x.shape
        out = self._mlp(x[None].expand(self.local_experts, T, H))
        out = torch.einsum("eth,te->th", out, combine.to(out.dtype)).to(x.dtype)
        if self.ep > 1:
            out = mappings.reduce_scatter(out, 0, self.ep_group)
        return out

    def forward_selective(self, x: torch.Tensor, combine: torch.Tensor,
                          top_k: int) -> torch.Tensor:
        """Each token through its ``top_k`` experts only: ``T * top_k``
        (token, expert) pairs of one row each; ``combine`` must have exactly
        ``top_k`` nonzeros a row."""
        if self.ep > 1 or self.tp > 1:
            raise NotImplementedError("selective expert loading runs on one rank (JAX excludes "
                                      "EP from token generation; Mixtral serving under TP/EP "
                                      "is ROADMAP queue A)")
        in_dtype = x.dtype
        aff, idx = _top_k(combine, top_k)                        # (T, k)
        T, H = x.shape
        h = x.to(self.dtype)[:, None, None, :].expand(T, top_k, 1, H).reshape(T * top_k, 1, H)
        flat = idx.reshape(-1)
        a = self._act(self._bmm(h, self.gate, flat), h, flat)
        out_k = self._bmm(a, self.down, flat).reshape(T, top_k, H)
        return torch.einsum("tkh,tk->th", out_k, aff.to(out_k.dtype)).to(in_dtype)

    def forward(self, x: torch.Tensor, combine: torch.Tensor, top_k: Optional[int] = None,
                mode: Optional[str] = None, counts: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        mode = mode or self.mode
        if mode == "selective":
            if top_k is None:
                raise ValueError("selective mode needs the router's top_k")
            return self.forward_selective(x, combine, top_k)
        if mode == "capacity_factor":
            return self.forward_capacity_factor(x, combine, top_k, counts)
        if mode == "all_experts":
            return self.forward_all_experts(x, combine)
        raise ValueError(f"unknown expert mode {mode!r}")
