"""Megatron-style compute layers at tensor-parallel degree 1.

Counterparts of ``neuronx_distributed_tpu/parallel/layers.py``:
``ColumnParallelLinear``, ``RowParallelLinear``, ``ParallelEmbedding``,
``GQAQKVColumnParallelLinear`` and ``RMSNorm``. Weights keep the JAX
package's layouts (``kernel`` is ``(in, out)``, the fused QKV kernels are
``(hidden, heads, head_dim)``) so a converted flax tree loads by renaming
alone. Each layer stores its weights in ``param_dtype`` and computes in
``dtype``, as flax's ``promote_dtype`` does. Meshes, sequence parallelism,
LoRA, int8 weights and KV-head replication (``kv_size_multiplier > 1``)
come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def _param(shape, param_dtype, device) -> nn.Parameter:
    # weights arrive through load_state_dict (a converted tree or a seeded
    # init): allocation only, no initializer runs here
    return nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device),
                        requires_grad=False)


def _compute_dtype(x: torch.Tensor, w: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class ColumnParallelLinear(nn.Module):
    """``y = x @ kernel (+ bias)``, kernel ``(in, out)``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((in_features, features), param_dtype, device)
        self.bias = _param((features,), param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.kernel, self.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class RowParallelLinear(ColumnParallelLinear):
    """Same math as :class:`ColumnParallelLinear` at TP=1 (the reduction
    over the sharded input dim is a no-op on one device)."""


class ParallelEmbedding(nn.Module):
    """Embedding table ``(num_embeddings, features)``; ``attend`` gives the
    tied-embedding logits ``x @ E.T``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((num_embeddings, features), param_dtype, device)

    def _table(self) -> torch.Tensor:
        return self.embedding if self.dtype is None else self.embedding.to(self.dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._table()[ids]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        e = self._table()
        return x.to(e.dtype) @ e.T


class GQAQKVColumnParallelLinear(nn.Module):
    """Fused Q, K, V projections with grouped-query attention. K/V kernels
    stay compact at ``num_kv_heads``; returns ``(b, s, heads, head_dim)``
    tensors."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, use_bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_heads, self.num_kv_heads, self.head_dim = num_heads, num_kv_heads, head_dim
        self.q_kernel = _param((hidden, num_heads, head_dim), param_dtype, device)
        self.k_kernel = _param((hidden, num_kv_heads, head_dim), param_dtype, device)
        self.v_kernel = _param((hidden, num_kv_heads, head_dim), param_dtype, device)
        self.use_bias = use_bias
        if use_bias:
            self.q_bias = _param((num_heads, head_dim), param_dtype, device)
            self.k_bias = _param((num_kv_heads, head_dim), param_dtype, device)
            self.v_bias = _param((num_kv_heads, head_dim), param_dtype, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dt = _compute_dtype(x, self.q_kernel, self.dtype)
        x = x.to(dt)
        hidden = x.shape[-1]
        out = []
        for name, heads in (("q", self.num_heads), ("k", self.num_kv_heads),
                            ("v", self.num_kv_heads)):
            w = getattr(self, f"{name}_kernel").to(dt).reshape(hidden, heads * self.head_dim)
            y = (x @ w).reshape(*x.shape[:-1], heads, self.head_dim)
            if self.use_bias:
                y = y + getattr(self, f"{name}_bias").to(y.dtype)
            out.append(y)
        return out[0], out[1], out[2]


class RMSNorm(nn.Module):
    """RMSNorm with the JAX casts: normalise in fp32, cast to ``dtype`` (or
    the input's dtype), then scale."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = _param((features,), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = (xf * torch.rsqrt(var + self.epsilon)).to(self.dtype or x.dtype)
        return y * self.scale.to(y.dtype)
