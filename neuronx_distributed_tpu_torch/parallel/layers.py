"""Megatron-style compute layers over a tensor-parallel group.

Counterparts of ``neuronx_distributed_tpu/parallel/layers.py``:
``ColumnParallelLinear``, ``RowParallelLinear``, ``ParallelEmbedding``,
``GQAQKVColumnParallelLinear``, ``SPLayerNorm`` and ``RMSNorm``. Weights
keep the JAX package's layouts (``kernel`` is ``(in, out)``, the fused QKV
kernels are ``(hidden, heads, head_dim)``) so a converted flax tree loads
by renaming alone. Each layer stores its weights in ``param_dtype`` and computes in
``dtype``, as flax's ``promote_dtype`` does.

Tensor parallelism: a layer built with a ``group`` (a
``torch.distributed`` group, ``parallel/mesh.py``) holds the rank's shard
of its weights — the slice of the global weight along the dim the JAX
package's ``nn.with_partitioning`` names (``tp_shard_dims``; a seeded init
or a converted tree is cut with ``inference/partition.py``'s
``shard_slice``) — and issues the collectives GSPMD would insert
(``parallel/mappings.py``): a column layer's output stays sharded unless
``gather_output``, a row layer all-reduces its partial sums once, the
vocab-parallel embedding all-reduces a masked lookup. Without a group
the layers are the single-device math, with no collective.

Sequence parallelism (JAX ``layers.py:83-250``, reference
``mappings.py:237-309``): with ``sequence_parallel=True`` under a group,
the activations between the TP layers are cut along the sequence (dim 1)
instead of replicated: a column layer (and the fused QKV) all-gathers its
input along the sequence (its backward reduce-scatters), a row layer
reduce-scatters its partial sums along the sequence instead of
all-reducing them, and the embedding reduce-scatters its masked lookup.
:class:`RMSNorm` then normalises the rank's positions only, so its weight
gradient is a partial sum: ``sequence_parallel=True`` routes the weight
through a copy region whose backward all-reduces it over the group (the
reference all-reduces the grads it tags ``sequence_parallel_enabled``,
grads.py:313-329; JAX's GSPMD sums the replicated weight's cotangents),
and the replicated weights stay bit-identical across the ranks.

int8 weights (JAX ``layers.py:116-120, 163, 322``): a weight may be a
:class:`QuantizedKernel` (int8 ``qweight`` in the float weight's layout and
its fp32 ``scale``, put in place by :func:`adopt_quantized`), and the
layer's product then runs through B5, the W8A16 GEMM (``kernels/w8a16.py``):
the kernel on the card, JAX's ``dequantize_leaf`` then the matmul on the
CPU. A GQA kernel ``(H, N, D)`` runs as ``(H, N*D)``. Not under a group
of more than one rank.

LoRA training (JAX ``layers.py:56-80``): ``adapters`` maps a weight's
attribute name to the callable ``lora.core.attach_adapters`` installs. A
linear layer adds its output ``(dropout(x) @ A) @ (s * B)`` to ``x @ W``
before the bias (a row layer before its reduction, a GQA kernel's per head
group); the embedding adds ``s * A @ B`` to its table. Empty: the layer is
unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.kernels.w8a16 import int8_linear
from neuronx_distributed_tpu_torch.parallel.mappings import (
    copy_to_tensor_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_parallel_region,
    reduce_from_tensor_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size


class QuantizedKernel(nn.Module):
    """An int8 weight: ``qweight`` int8 in the float weight's layout,
    ``scale`` fp32 (per output channel with the fan-in axis kept as 1, or
    0-d per tensor). ``dtype`` is the float weight's storage dtype, which
    the layer's compute dtype promotes with as before."""

    def __init__(self, qweight_shape, scale_shape, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("qweight", torch.empty(qweight_shape, dtype=torch.int8,
                                                    device=device))
        self.register_buffer("scale", torch.empty(scale_shape, dtype=torch.float32,
                                                  device=device))


def adopt_quantized(model: nn.Module, state) -> None:
    """Swap each float weight ``X`` of ``model`` that ``state`` holds as an
    ``X.qweight``/``X.scale`` pair for a :class:`QuantizedKernel` of those
    shapes (on ``model``'s device, meta included), so ``state`` loads
    strictly."""
    for key in state:
        if not key.endswith(".qweight"):
            continue
        base = key[: -len(".qweight")]
        if base + ".scale" not in state:
            raise KeyError(f"{key} has no {base}.scale")
        mod_name, _, attr = base.rpartition(".")
        mod = model.get_submodule(mod_name)
        if getattr(mod, "tp", 1) > 1 or getattr(mod, "ep", 1) > 1:
            raise NotImplementedError(f"{key}: int8 weights under tensor or expert "
                                      f"parallelism are not ported (ROADMAP queue A)")
        old = mod._parameters.get(attr)
        if old is None:
            raise KeyError(f"{base} is no float weight of the model")
        q, sc = state[key], state[base + ".scale"]
        if tuple(q.shape) != tuple(old.shape):
            raise ValueError(f"{key} is {tuple(q.shape)}, the weight {tuple(old.shape)}")
        del mod._parameters[attr]
        mod.add_module(attr, QuantizedKernel(q.shape, sc.shape, old.dtype, device=old.device))


def _param(shape, param_dtype, device) -> nn.Parameter:
    # weights arrive through load_state_dict (a converted tree or a seeded
    # init): allocation only, no initializer runs here
    return nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device),
                        requires_grad=False)


def _compute_dtype(x: torch.Tensor, w: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


def divide(numerator: int, denominator: int) -> int:
    """JAX ``divide``: the quotient, or the divisibility error."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")
    return numerator // denominator


def _product(x: torch.Tensor, k, dt: torch.dtype) -> torch.Tensor:
    if isinstance(k, QuantizedKernel):
        return int8_linear(x.to(dt), k.qweight, k.scale)
    return x.to(dt) @ k.to(dt)


class _Sharded(nn.Module):
    """A layer over an optional TP group: ``tp``/``tp_rank`` its degree and
    rank (1/0 without a group). ``tp_shard_dims``: each weight's sharded
    dim in the global layout (None: replicated)."""

    tp_shard_dims: Dict[str, Optional[int]] = {}

    def _bind(self, group, sequence_parallel: bool = False) -> None:
        self.group = group
        self.tp, self.tp_rank = group_size(group), group_rank(group)
        # without a group there is no sequence to cut: the flag is a no-op
        self.sequence_parallel = bool(sequence_parallel) and group is not None
        self.adapters: Dict[str, Callable] = {}   # LoRA training, by weight attribute

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        """A column layer's input region: all-gather the sequence shards
        under sequence parallelism, else the replicated copy."""
        if self.sequence_parallel:
            return gather_from_sequence_parallel_region(x, self.group, 1)
        return copy_to_tensor_parallel_region(x, self.group)

    def _leave(self, y: torch.Tensor) -> torch.Tensor:
        """A row layer's (or the embedding's) reduction of partial sums:
        reduce-scattered along the sequence under sequence parallelism,
        else all-reduced."""
        if self.sequence_parallel:
            return reduce_scatter_to_sequence_parallel_region(y, self.group, 1)
        return reduce_from_tensor_parallel_region(y, self.group)


class ColumnParallelLinear(_Sharded):
    """``y = x @ kernel (+ bias)``, kernel ``(in, out)`` sharded over the
    output features; ``gather_output`` all-gathers the sharded output;
    ``sequence_parallel`` takes a sequence-sharded input."""

    tp_shard_dims = {"kernel": 1, "bias": 0}

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None, group=None,
                 gather_output: bool = False, sequence_parallel: bool = False):
        super().__init__()
        self._bind(group, sequence_parallel)
        self.dtype = dtype
        self.gather_output = gather_output
        local = divide(features, self.tp)
        self.kernel = _param((in_features, local), param_dtype, device)
        self.bias = _param((local,), param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.kernel, self.dtype)
        x = self._enter(x)
        y = _product(x, self.kernel, dt)
        ad = self.adapters.get("kernel")
        if ad is not None:
            y = y + ad(x.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.gather_output:
            y = gather_from_tensor_parallel_region(y, self.group, -1)
        return y


class RowParallelLinear(_Sharded):
    """``y = x @ kernel (+ bias)``, kernel ``(in, out)`` sharded over the
    input features: each rank's partial sum is all-reduced once, after
    ``partial`` (a rank-local addend, the LoRA delta, JAX ``:166-169``) is
    added to it; the bias is replicated and added after the reduction.
    ``input_is_parallel=False`` takes a replicated input and keeps the
    rank's slice; ``sequence_parallel`` reduce-scatters the partial sums
    along the sequence instead."""

    tp_shard_dims = {"kernel": 0, "bias": None}

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None, group=None,
                 input_is_parallel: bool = True, sequence_parallel: bool = False):
        super().__init__()
        self._bind(group, sequence_parallel)
        self.dtype = dtype
        self.input_is_parallel = input_is_parallel
        self.kernel = _param((divide(in_features, self.tp), features), param_dtype, device)
        self.bias = _param((features,), param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor, partial: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = _compute_dtype(x, self.kernel, self.dtype)
        if not self.input_is_parallel:
            x = scatter_to_tensor_parallel_region(x, self.group, -1)
        y = _product(x, self.kernel, dt)
        ad = self.adapters.get("kernel")
        if ad is not None:
            y = y + ad(x.to(dt))
        if partial is not None:
            y = y + partial.to(y.dtype)
        y = self._leave(y)
        if self.bias is not None:
            # under SP the rank adds the replicated bias to its positions
            # only: its gradient is all-reduced, as the norms' are
            bias = (copy_to_tensor_parallel_region(self.bias, self.group)
                    if self.sequence_parallel else self.bias)
            y = y + bias.to(y.dtype)
        return y


class ParallelEmbedding(_Sharded):
    """Embedding table ``(num_embeddings, features)`` sharded over the
    vocabulary (JAX ``shard_over="vocab"``): a masked lookup of the rank's
    rows, then an all-reduce (a reduce-scatter along the sequence under
    ``sequence_parallel``). ``attend`` gives the tied-embedding logits
    ``x @ E.T``, vocab-sharded like a ``gather_output=False`` head."""

    tp_shard_dims = {"embedding": 0}

    def __init__(self, num_embeddings: int, features: int,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None, group=None,
                 sequence_parallel: bool = False):
        super().__init__()
        self._bind(group, sequence_parallel)
        self.dtype = dtype
        self.embedding = _param((divide(num_embeddings, self.tp), features), param_dtype,
                                device)

    def _table(self) -> torch.Tensor:
        e = self.embedding
        ad = self.adapters.get("embedding")
        if ad is not None:
            e = ad.merged(e)
        return e if self.dtype is None else e.to(self.dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        e = self._table()
        if self.group is None:
            return e[ids]
        rows = e.shape[0]
        local = ids - self.tp_rank * rows
        mine = (local >= 0) & (local < rows)
        y = torch.where(mine[..., None], e[local.clamp(0, rows - 1)], 0)
        return self._leave(y)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        e = self._table()
        return copy_to_tensor_parallel_region(x.to(e.dtype), self.group) @ e.T


class GQAQKVColumnParallelLinear(_Sharded):
    """Fused Q, K, V projections with grouped-query attention; returns the
    rank's heads as ``(b, s, heads, head_dim)`` tensors. The K/V kernels
    are stored compact at ``num_kv_heads``; with ``kv_size_multiplier > 1``
    they stay replicated and the forward repeats each head that many times
    (JAX ``:280-373``) before taking the rank's slice, so every rank holds
    whole KV heads. Raises JAX's divisibility errors."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, use_bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None, group=None,
                 kv_size_multiplier: int = 1, sequence_parallel: bool = False):
        super().__init__()
        self._bind(group, sequence_parallel)
        tp = self.tp
        if num_heads % tp != 0:
            raise ValueError(f"num_heads {num_heads} not divisible by tp {tp}")
        if (num_kv_heads * kv_size_multiplier) % tp != 0:
            raise ValueError(
                f"num_kv_heads*kv_size_multiplier ({num_kv_heads}*{kv_size_multiplier}) must "
                f"be divisible by tp {tp}; raise kv_size_multiplier")
        self.dtype = dtype
        self.head_dim, self.kv_size_multiplier = head_dim, kv_size_multiplier
        # the rank's heads
        self.num_heads = num_heads // tp
        self.num_kv_heads = num_kv_heads * kv_size_multiplier // tp
        compact = kv_size_multiplier > 1
        stored_kv = num_kv_heads if compact else self.num_kv_heads
        kv_dim = None if compact else 1
        self.tp_shard_dims = {"q_kernel": 1, "k_kernel": kv_dim, "v_kernel": kv_dim,
                              "q_bias": 0, "k_bias": kv_dim and 0, "v_bias": kv_dim and 0}
        self.q_kernel = _param((hidden, self.num_heads, head_dim), param_dtype, device)
        self.k_kernel = _param((hidden, stored_kv, head_dim), param_dtype, device)
        self.v_kernel = _param((hidden, stored_kv, head_dim), param_dtype, device)
        self.use_bias = use_bias
        if use_bias:
            self.q_bias = _param((self.num_heads, head_dim), param_dtype, device)
            self.k_bias = _param((stored_kv, head_dim), param_dtype, device)
            self.v_bias = _param((stored_kv, head_dim), param_dtype, device)

    def _kv_heads(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """The rank's KV heads of a compact (replicated) tensor. A rank uses
        only its heads of it, so its gradient is a partial sum: it enters
        through the copy region, whose backward all-reduces it."""
        if self.kv_size_multiplier == 1:
            return t
        t = copy_to_tensor_parallel_region(t, self.group)
        t = t.repeat_interleave(self.kv_size_multiplier, dim=axis)
        n = self.num_kv_heads
        return t.narrow(axis, self.tp_rank * n, n)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dt = _compute_dtype(x, self.q_kernel, self.dtype)
        x = self._enter(x.to(dt))
        hidden = x.shape[-1]
        out = []
        for name, heads in (("q", self.num_heads), ("k", self.num_kv_heads),
                            ("v", self.num_kv_heads)):
            k = getattr(self, f"{name}_kernel")
            if isinstance(k, QuantizedKernel):
                width = k.qweight.shape[1] * self.head_dim
                sc = k.scale.reshape(1, width) if k.scale.dim() else k.scale
                y = int8_linear(x, k.qweight.reshape(hidden, width), sc)
                y = y.reshape(*x.shape[:-1], -1, self.head_dim)
            else:
                kk = k.to(dt)
                if name != "q":
                    kk = self._kv_heads(kk, 1)
                y = (x @ kk.reshape(hidden, heads * self.head_dim)).reshape(
                    *x.shape[:-1], heads, self.head_dim)
            if name != "q" and isinstance(k, QuantizedKernel):
                y = self._kv_heads(y, -2)
            ad = self.adapters.get(f"{name}_kernel")
            if ad is not None:   # per stored head, then the rank's KV heads
                d = ad(x).reshape(*x.shape[:-1], -1, self.head_dim)
                y = y + (d if name == "q" else self._kv_heads(d, -2))
            if self.use_bias:
                bias = getattr(self, f"{name}_bias").to(y.dtype)
                y = y + (bias if name == "q" else self._kv_heads(bias, 0))
            out.append(y)
        return out[0], out[1], out[2]


def tp_shard_dims(model: nn.Module) -> Dict[str, Optional[int]]:
    """Each weight of ``model`` (state-dict name) that a TP layer shards:
    its dim in the global layout (None: replicated). Weights outside the
    TP layers (norms, routers) are absent: replicated."""
    out: Dict[str, Optional[int]] = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, _Sharded):
            for attr, dim in mod.tp_shard_dims.items():
                out[f"{prefix}.{attr}" if prefix else attr] = dim
    return out


class _LayerNormParams(nn.Module):
    # flax's ``nn.LayerNorm`` submodule ``ln``: its weights' names
    def __init__(self, features: int, use_bias: bool, param_dtype: torch.dtype, device):
        super().__init__()
        self.scale = _param((features,), param_dtype, device)
        self.bias = _param((features,), param_dtype, device) if use_bias else None


class SPLayerNorm(nn.Module):
    """LayerNorm inside sequence-parallel regions (JAX ``SPLayerNorm``, the
    reference's ``parallel_layers/layer_norm.py``): flax's ``LayerNorm``
    arithmetic (statistics in fp32, ``var = E[x^2] - E[x]^2``, scale then
    bias, the result in ``dtype``) on weights ``ln.scale``/``ln.bias``.
    ``sequence_parallel`` under a ``group``: the input is the rank's
    sequence shard and both weights' gradients are all-reduced over the
    group, as the reference all-reduces the grads it tags
    ``sequence_parallel_enabled``."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 sequence_parallel: bool = False, group=None, use_bias: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.group = group
        self.sequence_parallel = bool(sequence_parallel) and group is not None
        self.ln = _LayerNormParams(features, use_bias, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = [self.ln.scale] + ([self.ln.bias] if self.ln.bias is not None else [])
        if self.sequence_parallel:
            weights = [copy_to_tensor_parallel_region(w, self.group) for w in weights]
        out_dtype = self.dtype or torch.promote_types(x.dtype, self.ln.scale.dtype)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * weights[0].float())
        if len(weights) > 1:
            y = y + weights[1].float()
        return y.to(out_dtype)


class RMSNorm(nn.Module):
    """RMSNorm with the JAX casts: normalise in fp32, cast to ``dtype`` (or
    the input's dtype), then scale. ``sequence_parallel`` under a
    ``group``: the input is the rank's sequence shard and the weight's
    gradient is all-reduced over the group."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 sequence_parallel: bool = False, group=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.group = group
        self.sequence_parallel = bool(sequence_parallel) and group is not None
        self.scale = _param((features,), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = (xf * torch.rsqrt(var + self.epsilon)).to(self.dtype or x.dtype)
        scale = self.scale
        if self.sequence_parallel:
            scale = copy_to_tensor_parallel_region(scale, self.group)
        return y * scale.to(y.dtype)
