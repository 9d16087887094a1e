"""Llama-2/3 model family for serving and training, on PyTorch.

Counterpart of ``neuronx_distributed_tpu/models/llama.py``: ``LlamaConfig``
and its presets, rotary tables, ``cached_attention``, and the decoder stack
(``nn.scan`` over layers becomes an ``nn.ModuleList``). Module and weight
names mirror the flax tree (``model.layers.{i}.attention.qkv.q_kernel``,
...), so ``converters/jax_params.py`` maps a flax tree by renaming.

Decode mode (``config.decode``) keeps its KV state in a :class:`KVCache`
that the forward updates in place: a contiguous ``(b, max_seq_len, n_kv,
hd)`` slab per layer, or a page pool ``(pages + 1, page_size, n_kv, hd)``
per layer resolved through per-slot block tables (fp pages, or int8 pages
with per-(page, kv head) fp32 scales when ``page_dtype="int8"``). The
decode step reads no device value on the host and rebinds no tensor, so a
run of steps can be captured in a CUDA graph. Prefill widths of 128 and up
take the flash kernel under the same gate as the JAX package; single-token
paged steps take the paged decode kernel when ``paged_attn_kernel`` is set.

Training: :meth:`LlamaForCausalLM.loss` (whole-sequence or chunked head and
cross-entropy), activation checkpointing around each decoder layer (only
while autograd records, never in decode mode) under ``remat_policy="full"``
(JAX ``nothing_saveable``: the layer is recomputed in the backward) or
``"attention"`` (JAX ``dots_with_no_batch_dims_saveable``: the outputs of
the projection GEMMs are saved, everything else, the flash kernel
included, recomputed), ``qkv_clip``, and LoRA training through the layers'
``adapters`` (``lora/core.py``).

Context parallelism (JAX ``llama.py:75-86, 386-395, 808-829, 888-891``):
with ``context_parallel`` and a ``cp_group``, each rank's forward takes
its block of the sequence (``parallel/mesh.py::context_seq_slice`` of the
ids, permuted first under ``cp_layout="zigzag"``: JAX's caller applies
``zigzag_indices`` too); RoPE runs at the block's true positions and
attention is ``ops/ring_attention.py::ring_attention`` over the group.
:meth:`LlamaForCausalLM.loss` is the mean over the global sequence: the
rank's sum and count are summed over the group (the sum through an
all-reduce region whose backward is the identity), so each rank's
gradients are its share and the train step sums them over ``cp``.
Sequence parallelism with CP raises, as in JAX.

Sequence parallelism (JAX ``llama.py:822-829, 873-877``): with
``sequence_parallel`` under a group, the residual stream is cut along the
sequence from the embedding (which reduce-scatters) through every norm,
residual add and row-layer output to the final norm; the column layers
gather the whole sequence for the attention and the MLP, and the final
hidden state is all-gathered before the head. Every rank issues the same
collectives in the same order, the activation-checkpoint recompute
included.

Tree chunks (``chunk_ctx``, JAX ``llama.py:341``, ``:490-497``,
``:643-656``): a decode-mode forward may carry ``(chunk_mask (s, s) bool,
chunk_positions (s,))``. The chunk is written at slots ``idx .. idx + s``
as any chunk is, RoPE runs at ``idx + chunk_positions``, and query i sees
the prefix slots ``< idx`` and the chunk slots j with ``chunk_mask[i, j]``
(Medusa's tree verify: a node sees its ancestors). The attention is the
dense :func:`cached_attention` under that mask, in slab and paged modes;
the paged kernel and the flash kernel are not taken.

Multi-LoRA serving (``lora_rank``, JAX ``llama.py:315-333``): the model
holds one fp32 pool ``(lora_slots, num_layers, per_layer)`` of adapter
slots (:class:`LoraLayout` says where each matrix sits in a layer's chunk)
and reads an ``adapter_idx (b,)`` the caller sets; each targeted
projection adds the row's own ``s * (x @ A) @ B``, gathered from the pool
per row (S-LoRA's batched adapter matmul). Slot 0 is all zeros, so its
rows' outputs are bit for bit those of a model built without LoRA. A
Mixtral config's pool holds the attention targets only (its MoE block has
no dense MLP projections).

Tensor parallelism (JAX ``llama.py:863-871``): built with a ``group``, the
embedding, the QKV projection, ``o_proj``, the MLP and ``lm_head`` are the
TP layers of ``parallel/layers.py`` over it (RoPE and the norms stay
replicated): each rank holds its shard of the weights, attends over its
own heads and keeps its own heads' KV cache, and the logits come out
vocab-sharded (``lm_head`` is ``gather_output=False``); :meth:`loss`
reduces the cross entropy over the whole vocabulary through the group
(``parallel/loss.py``). The adapter pool
holds the rank's slices (:func:`lora_layout`). :func:`init_params` gives
each rank its slice of the same global values, so every degree runs the
same model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from neuronx_distributed_tpu_torch.inference.paged_kernel import (
    dequantize_kv_pages,
    paged_decode_attention,
    paged_kernel_supported,
    quantize_kv_pages,
)
from neuronx_distributed_tpu_torch.inference.partition import (
    ROW_PARALLEL_TARGETS,
    leaf_partition_spec,
    local_shape,
    param_partition_specs,
    shard_slice,
)
from neuronx_distributed_tpu_torch.kernels.flash_attn import (
    default_attention_blocks,
    default_prefill_blocks,
    flash_supported,
)
from neuronx_distributed_tpu_torch.ops.attention import attention
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    GQAQKVColumnParallelLinear,
    ParallelEmbedding,
    RMSNorm,
    RowParallelLinear,
    SPLayerNorm,
)
from neuronx_distributed_tpu_torch.parallel.loss import (
    parallel_cross_entropy,
    parallel_cross_entropy_mean,
)
from neuronx_distributed_tpu_torch.ops.ring_attention import _rank_positions, ring_attention
from neuronx_distributed_tpu_torch.parallel.mappings import (
    all_reduce_sum_,
    gather_from_tensor_parallel_region,
    reduce_from_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1 piecewise rope scaling (HF ``rope_type: "llama3"``)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    # repeat each KV head this many times so the tensor-parallel degree
    # divides num_kv_heads * kv_size_multiplier (the K/V kernels stay compact)
    kv_size_multiplier: int = 1
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16          # compute dtype
    param_dtype: torch.dtype = torch.float32     # storage dtype
    use_flash_attention: bool = True
    attention_block_q: Optional[int] = None
    attention_block_k: Optional[int] = None
    remat_policy: Optional[str] = "full"  # None | "full" | "attention"
    tie_word_embeddings: bool = False
    # clamp q/k/v projections to [-qkv_clip, qkv_clip] (DBRX's clip_qkv)
    qkv_clip: Optional[float] = None
    decode: bool = False
    # CE loss sequence chunking: the head matmul and CE run per chunk of
    # this many tokens when the sequence exceeds it (None = 4096)
    loss_chunk_size: Optional[int] = None
    # paged KV (decode only): page pool of page_pool_pages x page_size
    # tokens per layer; page_size must divide max_seq_len
    page_size: Optional[int] = None
    page_pool_pages: Optional[int] = None
    # page storage: None (the compute dtype) or "int8" (absmax per page and
    # kv head, requantized over the pages a write touches)
    page_dtype: Optional[str] = None
    paged_attn_kernel: bool = False
    # multi-LoRA serving pool: per-slot rank-lora_rank adapters on the
    # targeted projections (None: no pool, the forward is unchanged)
    lora_rank: Optional[int] = None
    lora_slots: int = 0
    lora_targets: Tuple[str, ...] = ("qkv", "o_proj", "gate_proj", "up_proj", "down_proj")
    # training layouts under a tensor-parallel group: the residual stream
    # cut along the sequence (Megatron SP); ring-attention context
    # parallelism over a cp group, the sequence cut contiguously or zigzag
    # ("zigzag": the caller permutes ids/labels by
    # ops.ring_attention.zigzag_indices(seq, cp); every rank then does the
    # same causal work)
    sequence_parallel: bool = False
    context_parallel: bool = False
    cp_layout: str = "contiguous"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope_dims(self) -> int:
        """The head dims the rotary tables cover (the whole head; GPT-NeoX
        rotates a part of it)."""
        return self.head_dim_

    def kv_heads(self, tp: int = 1) -> int:
        """KV heads one rank holds at degree ``tp``."""
        return self.num_kv_heads * self.kv_size_multiplier // tp

    def make_norm(self, device=None, group=None) -> nn.Module:
        """The norm of every decoder layer and of the stack's end (JAX
        ``make_norm``): RMSNorm, or under ``norm_type="layernorm"`` (DBRX,
        a Mixtral config field) a ``SPLayerNorm`` with a bias unless
        ``norm_bias`` is off; sequence-parallel under ``group`` when the
        config says so."""
        kw = dict(dtype=self.dtype, param_dtype=self.param_dtype, device=device,
                  sequence_parallel=self.sequence_parallel, group=group)
        norm_type = getattr(self, "norm_type", "rmsnorm")
        if norm_type == "layernorm":
            return SPLayerNorm(self.hidden_size, epsilon=getattr(self, "layer_norm_eps", 1e-5),
                               use_bias=getattr(self, "norm_bias", True), **kw)
        if norm_type != "rmsnorm":
            raise ValueError(f"unknown norm_type {norm_type!r}")
        return RMSNorm(self.hidden_size, epsilon=self.rms_norm_eps, **kw)

    def blocks_for(self, sq: int, sk: Optional[int] = None) -> Tuple[int, int]:
        """Flash block sizes: explicit config values, else adaptive (block_q
        keyed on the query length, block_k on the key sweep length), each
        shrunk to a divisor of its sequence — the JAX package's rule."""
        pick = default_prefill_blocks if self.decode else default_attention_blocks
        sk = sk or sq
        dq = self.attention_block_q or pick(sq)[0]
        dk = self.attention_block_k or pick(sk)[1]

        def shrink(b: int, s: int) -> int:
            b = min(b, s)
            while b > 128 and s % b:
                b //= 2
            return b

        return shrink(dq, sq), shrink(dk, sk)


def _preset(base, over):
    return LlamaConfig(**{**base, **over})


def llama2_7b(**over) -> LlamaConfig:
    return _preset(dict(hidden_size=4096, intermediate_size=11008, num_layers=32,
                        num_heads=32, num_kv_heads=32), over)


def llama2_13b(**over) -> LlamaConfig:
    return _preset(dict(hidden_size=5120, intermediate_size=13824, num_layers=40,
                        num_heads=40, num_kv_heads=40), over)


def llama2_70b(**over) -> LlamaConfig:
    return _preset(dict(hidden_size=8192, intermediate_size=28672, num_layers=80,
                        num_heads=64, num_kv_heads=8), over)


def llama3_8b(**over) -> LlamaConfig:
    return _preset(dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                        num_layers=32, num_heads=32, num_kv_heads=8,
                        rope_theta=500000.0, max_seq_len=8192), over)


def llama31_8b(**over) -> LlamaConfig:
    """Llama-3.1-8B: 3.0 dims + the long-context rope scaling."""
    return llama3_8b(max_seq_len=over.pop("max_seq_len", 131072),
                     rope_scaling=over.pop("rope_scaling", RopeScaling()), **over)


def llama3_70b(**over) -> LlamaConfig:
    return _preset(dict(vocab_size=128256, hidden_size=8192,
                        intermediate_size=28672, num_layers=80,
                        num_heads=64, num_kv_heads=8,
                        rope_theta=500000.0, max_seq_len=8192), over)


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float,
                     dtype=torch.float32, scaling: Optional[RopeScaling] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``(..., seq, head_dim/2)`` for the given positions."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=dev) / head_dim))
    if scaling is not None:
        s = scaling
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = s.original_max_position_embeddings / s.low_freq_factor
        high_wl = s.original_max_position_embeddings / s.high_freq_factor
        smooth = (s.original_max_position_embeddings / wavelen - s.low_freq_factor) / (
            s.high_freq_factor - s.low_freq_factor)
        interp = (1.0 - smooth) * inv_freq / s.factor + smooth * inv_freq
        inv_freq = torch.where(wavelen > low_wl, inv_freq / s.factor,
                               torch.where(wavelen < high_wl, inv_freq, interp))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate halves (x1, x2) of ``x`` (b, s, n, d); cos/sin (s, d/2) or (b, s, d/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LoraGroup(NamedTuple):
    """Projections that read one input: their ``A`` matrices side by side
    in one ``(fan_in, len(leaves) * rank)`` block at ``a_offset`` (one
    matmul for the group), each leaf's ``B (rank, fan_out)`` at its own
    offset, and its scale at ``scale_offset + scale`` of the layer chunk."""

    fan_in: int
    a_offset: int
    leaves: Tuple[Tuple[str, int, int, int], ...]   # (leaf, fan_out, b_offset, scale)


@dataclasses.dataclass(frozen=True)
class LoraLayout:
    """One adapter slot's bytes for one layer: ``per_layer`` fp32 words
    holding the groups' ``A`` and ``B`` blocks (row-major), then one scale
    per leaf. Groups by input: ``qkv`` (q, k, v), ``o_proj``, ``mlp_in``
    (gate_proj, up_proj) and ``down_proj``. At TP degree ``tp`` the fan-ins
    and fan-outs are rank ``tp_rank``'s (``inference/partition.py``: the
    row-parallel targets' ``A`` over fan-in, the others' ``B`` over
    fan-out), except the K/V ``B`` under ``kv_size_multiplier > 1``
    (``kv_compact``): whole and compact at ``num_kv_heads``, as the K/V
    kernels are, since their deltas are computed compact, repeated and
    then cut to the rank's heads (JAX ``llama.py:366-372``)."""

    rank: int
    groups: Dict[str, LoraGroup]
    scale_offset: int
    per_layer: int
    tp: int = 1
    tp_rank: int = 0
    kv_compact: bool = False

    def shard(self, leaf: str, a, b):
        """The rank's slices of one leaf's ``A (fan_in, r)`` and ``B (r,
        fan_out)`` (numpy or torch) when they are at full width; a rank's
        slices already pass as they are."""
        if self.tp == 1:
            return a, b
        _g, _c, fan_in, fan_out, _b, _s = self.leaves()[leaf]
        r0 = self.tp_rank
        if leaf in ROW_PARALLEL_TARGETS and a.shape[0] == fan_in * self.tp:
            a = a[r0 * fan_in:(r0 + 1) * fan_in]
        elif leaf not in ROW_PARALLEL_TARGETS and b.shape[1] == fan_out * self.tp:
            b = b[:, r0 * fan_out:(r0 + 1) * fan_out]
        return a, b

    def leaves(self) -> Dict[str, Tuple[str, int, int, int, int, int]]:
        """Leaf -> (group, column of its A block, fan_in, fan_out, B offset,
        scale index)."""
        out = {}
        for gname, g in self.groups.items():
            for j, (leaf, fan_out, b_off, scale) in enumerate(g.leaves):
                out[leaf] = (gname, j * self.rank, g.fan_in, fan_out, b_off, scale)
        return out


def pool_targets(cfg: LlamaConfig) -> set:
    """The ``lora_targets`` the pool holds stacks for: those the forward
    reads. An MoE block has no dense MLP projections, so a Mixtral config's
    pool holds the attention's only, as the JAX pool makes stacks only
    where its forward reads them."""
    t = set(cfg.lora_targets)
    return t & {"qkv", "o_proj"} if hasattr(cfg, "num_experts") else t


def lora_layout(cfg: LlamaConfig, tp: int = 1, tp_rank: int = 0) -> LoraLayout:
    """The pool layout of ``cfg``'s ``lora_rank`` over ``lora_targets``, at
    rank ``tp_rank`` of degree ``tp``."""
    r, hd = cfg.lora_rank, cfg.head_dim_
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
    # compact K/V deltas (repeated in the forward) keep their B whole
    kv_compact = cfg.kv_size_multiplier > 1
    unknown = set(cfg.lora_targets) - {"qkv", "o_proj", "gate_proj", "up_proj", "down_proj"}
    if unknown:
        raise ValueError(f"lora_targets {sorted(unknown)} are not serving projections")
    t = pool_targets(cfg)
    plan = []
    if "qkv" in t:
        plan.append(("qkv", cfg.hidden_size, (("q", q_out), ("k", kv_out), ("v", kv_out))))
    if "o_proj" in t:
        plan.append(("o_proj", q_out, (("o_proj", cfg.hidden_size),)))
    mlp_in = tuple((n, cfg.intermediate_size) for n in ("gate_proj", "up_proj") if n in t)
    if mlp_in:
        plan.append(("mlp_in", cfg.hidden_size, mlp_in))
    if "down_proj" in t:
        plan.append(("down_proj", cfg.intermediate_size, (("down_proj", cfg.hidden_size),)))
    def local(leaf: str, kind: str, shape) -> Tuple[int, ...]:
        if kv_compact and leaf in ("k", "v"):
            return tuple(shape)
        # the serving spec of the stacked leaf (L, slots, ...) decides
        full = (cfg.num_layers, 2, *shape)
        spec = leaf_partition_spec(f"lora_{leaf}_{kind}", full, tp)
        sharded = leaf in ROW_PARALLEL_TARGETS if kind == "a" else leaf not in ROW_PARALLEL_TARGETS
        if tp > 1 and sharded and not spec:
            raise ValueError(f"lora {leaf} {kind} {shape} does not split over {tp} ranks")
        return local_shape(full, spec, tp)[2:]

    groups, off, n_scales = {}, 0, 0
    for gname, fan_in, leaves in plan:
        fan_in = local(leaves[0][0], "a", (fan_in, r))[0]
        a_off = off
        off += fan_in * len(leaves) * r
        placed = []
        for leaf, fan_out in leaves:
            fan_out = local(leaf, "b", (r, fan_out))[1]
            placed.append((leaf, fan_out, off, n_scales))
            off += r * fan_out
            n_scales += 1
        groups[gname] = LoraGroup(fan_in, a_off, tuple(placed))
    return LoraLayout(rank=r, groups=groups, scale_offset=off, per_layer=off + n_scales,
                      tp=tp, tp_rank=tp_rank, kv_compact=kv_compact)


def lora_deltas(rows: torch.Tensor, layout: LoraLayout, group: str,
                x: torch.Tensor) -> List[torch.Tensor]:
    """Each leaf of ``group``: the rows' corrections ``s * (x @ A) @ B``
    (b, s, fan_out) in fp32, ``rows`` (b, per_layer) the rows' gathered
    layer chunks. The group's ``A`` blocks go through one matmul."""
    g = layout.groups[group]
    b, r = x.shape[0], layout.rank
    width = len(g.leaves) * r
    a = rows[:, g.a_offset: g.a_offset + g.fan_in * width].view(b, g.fan_in, width)
    d = torch.bmm(x.float().reshape(b, -1, g.fan_in), a)
    out = []
    for j, (_leaf, fan_out, b_off, scale) in enumerate(g.leaves):
        bm = rows[:, b_off: b_off + r * fan_out].view(b, r, fan_out)
        y = torch.bmm(d[..., j * r:(j + 1) * r], bm)
        out.append(y * rows[:, layout.scale_offset + scale][:, None, None])
    return out


def cached_attention(q, k_cache, v_cache, cache_len, sm_scale=None, mask=None):
    """Dense attention against a fixed-size cache: ``q`` (b, s_new, n, d) at
    positions ``cache_len .. cache_len + s_new``; ``k_cache``/``v_cache``
    (b, S, n_kv, d); key j visible to query i iff ``j <= cache_len + i``."""
    b, s_new, n, d = q.shape
    n_kv = k_cache.shape[2]
    if n != n_kv:   # kv head j serves query heads j*g .. j*g+g-1 (repeat_interleave)
        k_cache, v_cache = (t.unsqueeze(3).expand(*t.shape[:3], n // n_kv, d).reshape(
            *t.shape[:2], n, d) for t in (k_cache, v_cache))
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    s_max = k_cache.shape[1]
    cache_len = torch.as_tensor(cache_len, device=q.device)
    if cache_len.dim() == 0:
        cache_len = cache_len.expand(b)
    scores = torch.einsum("bind,bjnd->bnij", q.float(), k_cache.float()) * sm_scale
    if mask is None:
        qpos = cache_len[:, None] + torch.arange(s_new, device=q.device)[None, :]
        kpos = torch.arange(s_max, device=q.device)
        mask = kpos[None, None, :] <= qpos[..., None]
    scores = torch.where(mask[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnij,bjnd->bind", probs, v_cache.float())
    return out.to(q.dtype)


@dataclasses.dataclass
class KVCache:
    """Decode-mode KV state, updated in place by the forward.

    ``keys``/``values``: one tensor per layer — the slab ``(b, max_seq_len,
    n_kv, hd)`` or the page pool ``(pages + 1, page_size, n_kv, hd)``, whose
    last page is the sink of dropped writes (no block table names it).
    ``cache_index``: (b,) int32 tokens written per row (the write position
    of the next token), advanced in place. ``block_table``: (b, max_seq_len
    / page_size) int32 logical -> physical pages (paged mode only).
    ``k_scales``/``v_scales``: per layer ``(pages + 1, 1, n_kv, 1)`` fp32
    page scales of int8 pools (None otherwise)."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    cache_index: torch.Tensor
    block_table: Optional[torch.Tensor] = None
    k_scales: Optional[List[torch.Tensor]] = None
    v_scales: Optional[List[torch.Tensor]] = None

    def rows(self, cache_index: torch.Tensor,
             block_table: Optional[torch.Tensor] = None) -> "KVCache":
        """A row view sharing this cache's pools (paged inserts write the
        pools in place through their own block tables)."""
        return KVCache(self.keys, self.values, cache_index, block_table, self.k_scales,
                       self.v_scales)


def _write_pages(pool: torch.Tensor, new: torch.Tensor, phys: torch.Tensor,
                 slots: torch.Tensor, keep: torch.Tensor) -> None:
    """fp pages: scatter ``new`` (b, s_new, n_kv, hd) at logical ``slots``
    through physical pages ``phys`` (b, s_new); dropped writes (``keep``
    False) land in the sink page."""
    npages, ps = pool.shape[:2]
    sink = (npages - 1) * ps + slots % ps
    flat = torch.where(keep, phys * ps + slots % ps, sink)
    pool.view(npages * ps, *pool.shape[2:])[flat] = new.to(pool.dtype)


def _write_int8_window(pool: torch.Tensor, scale: torch.Tensor, new: torch.Tensor,
                       table: torch.Tensor, idx: torch.Tensor, slots: torch.Tensor,
                       keep: torch.Tensor, max_seq_len: int) -> None:
    """int8 pages: dequantize the W pages a step of ``s_new`` tokens can
    touch (the narrowest logical span covering ``idx .. idx + s_new - 1`` at
    any alignment), write ``new``, zero the positions at or above the row's
    new length (stale bytes would inflate the absmax), requantize per (page,
    kv head), and write back only the pages the step touched. An untouched
    window entry may name another row's live page (a clamped or unowned
    table entry): its write goes to the sink page instead."""
    b, s_new, n_kv, hd = new.shape
    npages, ps = pool.shape[:2]
    ppseq = table.shape[1]
    sink = npages - 1
    W = (s_new + ps - 1) // ps + 1
    first = torch.div(idx, ps, rounding_mode="floor").long()                 # (b,)
    lpage = first[:, None] + torch.arange(W, device=idx.device)[None, :]     # (b, W)
    phys_w = torch.gather(table, 1, lpage.clamp(0, ppseq - 1)).long()        # (b, W)
    win = dequantize_kv_pages(pool[phys_w], scale[phys_w]).reshape(b, W * ps, n_kv, hd)
    # window-relative slots; dropped writes go to one spare column
    rel = torch.where(keep, slots - first[:, None] * ps, W * ps).long()
    win = torch.cat([win, win.new_zeros((b, 1, n_kv, hd))], dim=1)
    rows = torch.arange(b, device=idx.device)[:, None].expand(b, s_new)
    win[rows, rel] = new.float()
    wpos = first[:, None] * ps + torch.arange(W * ps, device=idx.device)[None, :]
    live = (wpos < (idx.long() + s_new)[:, None])[..., None, None]
    win = torch.where(live, win[:, : W * ps], 0.0).reshape(b, W, ps, n_kv, hd)
    q, sc = quantize_kv_pages(win)                   # (b, W, ps, n_kv, hd), (b, W, 1, n_kv, 1)
    last = torch.div(torch.clamp_max(idx.long() + s_new - 1, max_seq_len - 1), ps,
                     rounding_mode="floor")
    touched = (lpage <= last[:, None]) & (lpage < ppseq)
    dest = torch.where(touched, phys_w, sink)
    pool[dest] = q
    scale[dest] = sc


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, group=None):
        super().__init__()
        cfg = self.config = config
        hd = cfg.head_dim_
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, hd, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device, group=group,
            kv_size_multiplier=cfg.kv_size_multiplier, sequence_parallel=cfg.sequence_parallel)
        self.o_proj = RowParallelLinear(cfg.num_heads * hd, cfg.hidden_size, use_bias=False,
                                        dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                                        device=device, group=group,
                                        sequence_parallel=cfg.sequence_parallel)
        # the context-parallel group (set by LlamaModel under context_parallel)
        self.cp_group = None

    def forward(self, x, rope, cache: Optional[KVCache] = None, layer: int = 0, lora=None,
                chunk_ctx=None):
        cfg = self.config
        q, k, v = self.qkv(x)
        if lora is not None and "qkv" in lora[1].groups:
            # the rows' corrections on the fused projections, before clip
            # and RoPE (JAX llama.py:357-369)
            dq, dk, dv = lora_deltas(*lora, "qkv", x)
            q = q + dq.reshape(q.shape).to(q.dtype)
            if lora[1].kv_compact:   # compact, repeated, then the rank's heads
                dk, dv = (self.qkv._kv_heads(d.reshape(*x.shape[:2], -1, cfg.head_dim_), -2)
                          for d in (dk, dv))
            k = k + dk.reshape(k.shape).to(k.dtype)
            v = v + dv.reshape(v.shape).to(v.dtype)
        if cfg.qkv_clip is not None:  # DBRX clip_qkv, before RoPE
            q, k, v = (t.clamp(-cfg.qkv_clip, cfg.qkv_clip) for t in (q, k, v))
        if cfg.decode:
            return self._decode_attention(x, q, k, v, cache, layer, lora, chunk_ctx)
        if chunk_ctx is not None:
            raise ValueError("chunk_ctx needs decode mode (a KV cache to attend over)")
        cos, sin = rope
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        s = q.shape[1]   # the whole sequence (x is the rank's shard under SP)
        if cfg.context_parallel:   # s is the rank's block of the sequence
            o = ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True, group=self.cp_group, layout=cfg.cp_layout,
                               block_q=cfg.attention_block_q, block_k=cfg.attention_block_k)
            return self._o_proj(o.transpose(1, 2).reshape(x.shape[0], s, -1), lora)
        blk_q, blk_k = cfg.blocks_for(s)
        o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                      use_flash=cfg.use_flash_attention and flash_supported(s, s, blk_q, blk_k),
                      block_q=blk_q, block_k=blk_k)
        return self._o_proj(o.transpose(1, 2).reshape(x.shape[0], s, -1), lora)

    def _o_proj(self, o, lora=None):
        # the rows' correction joins the rank's partial sum before the reduction
        delta = None
        if lora is not None and "o_proj" in lora[1].groups:
            delta = lora_deltas(*lora, "o_proj", o)[0]
        return self.o_proj(o, delta)

    def _decode_attention(self, x, q, k, v, cache: KVCache, layer: int, lora=None,
                          chunk_ctx=None):
        cfg = self.config
        b, s_new = x.shape[0], x.shape[1]
        n_kv, hd, ps = k.shape[2], cfg.head_dim_, cfg.page_size
        idx = cache.cache_index                                     # (b,) int32
        ck, cv = cache.keys[layer], cache.values[layer]
        slots = idx[:, None] + torch.arange(s_new, dtype=torch.int32, device=x.device)[None, :]
        chunk_mask = None
        if chunk_ctx is None:
            positions = slots
        else:   # tree chunk: RoPE at each node's depth past the prefix
            chunk_mask, chunk_positions = chunk_ctx
            positions = idx[:, None] + chunk_positions.to(torch.int32)[None, :]
        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta, dtype=q.dtype,
                                    scaling=cfg.rope_scaling)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        # writes at slots >= max_seq_len are dropped (JAX's mode="drop": the
        # overflow latch freezes a row instead of letting its writes wrap),
        # by redirection rather than boolean indexing, so no step waits for
        # the device
        keep = slots < cfg.max_seq_len
        if ps:
            table = cache.block_table
            ppseq = cfg.max_seq_len // ps
            ks = vs = None
            if cache.k_scales is not None:
                ks, vs = cache.k_scales[layer], cache.v_scales[layer]
                for pool, scale, new in ((ck, ks, k), (cv, vs, v)):
                    _write_int8_window(pool, scale, new, table, idx, slots, keep,
                                       cfg.max_seq_len)
            else:
                page_of = torch.clamp(slots // ps, 0, ppseq - 1).long()
                phys = torch.gather(table, 1, page_of).long()      # (b, s_new)
                _write_pages(ck, k, phys, slots, keep)
                _write_pages(cv, v, phys, slots, keep)
            if (cfg.paged_attn_kernel and chunk_mask is None
                    and paged_kernel_supported(s_new, ps, q.shape[2], n_kv)):
                # attend straight off the post-write pool: no logical slab
                o = paged_decode_attention(q.contiguous(), ck, cv, table, idx, k_scale=ks,
                                           v_scale=vs)
                return self._o_proj(o.reshape(b, s_new, -1), lora)
            # gather the (b, max_seq_len) logical view; stale bytes in reused
            # pages sit behind the position mask like the slab's zeros
            npages = ck.shape[0]
            lpos = torch.arange(cfg.max_seq_len, device=x.device)
            pg = table[:, lpos // ps].long()
            all_flat = pg * ps + (lpos % ps)[None, :]
            k_all = ck.view(npages * ps, n_kv, hd)[all_flat]
            v_all = cv.view(npages * ps, n_kv, hd)[all_flat]
            if ks is not None:   # each slot dequantized with its page's scale
                k_all = dequantize_kv_pages(k_all, ks.view(npages, n_kv)[pg][..., None], q.dtype)
                v_all = dequantize_kv_pages(v_all, vs.view(npages, n_kv)[pg][..., None], q.dtype)
        else:
            rows = torch.arange(b, device=x.device)[:, None].expand(b, s_new)
            # a dropped write rewrites column idx - 1 with its own value: no
            # kept write of this step lands there
            cols = torch.where(keep, slots, torch.clamp(idx - 1, 0, cfg.max_seq_len - 1)[:, None])
            cols = cols.long()
            for pool, new in ((ck, k), (cv, v)):
                pool[rows, cols] = torch.where(keep[..., None, None], new.to(pool.dtype),
                                               pool[rows, cols])
            k_all, v_all = ck, cv
        if chunk_mask is not None:
            # prefix slots (< idx) all visible; chunk slots by the tree mask
            kslot = torch.arange(cfg.max_seq_len, device=x.device)[None, None, :]   # (1,1,S)
            rel = kslot - idx.long()[:, None, None]                                # (b,1,S)
            in_chunk = (rel >= 0) & (rel < s_new)
            rel_c = rel.clamp(0, s_new - 1).expand(b, s_new, cfg.max_seq_len)
            cm = chunk_mask.to(torch.bool)[None].expand(b, s_new, s_new)
            mask = (rel < 0) | (in_chunk & torch.gather(cm, 2, rel_c))
            o = cached_attention(q, k_all, v_all, idx, mask=mask)
            return self._o_proj(o.reshape(b, s_new, -1), lora)
        # block_k tiles the cache sweep (max_seq_len), not the query chunk
        cfg_blk_q, cfg_blk_k = cfg.blocks_for(s_new, cfg.max_seq_len)
        blk_q = min(cfg_blk_q, s_new)
        use_flash = (cfg.use_flash_attention and s_new >= 128
                     and flash_supported(s_new, cfg.max_seq_len, blk_q, cfg_blk_k))
        if use_flash:
            o = attention(q.transpose(1, 2), k_all.transpose(1, 2), v_all.transpose(1, 2),
                          causal=False, use_flash=True, block_q=blk_q, block_k=cfg_blk_k,
                          q_positions=positions, kv_positions=None).transpose(1, 2)
        else:
            o = cached_attention(q, k_all, v_all, idx)
        return self._o_proj(o.reshape(b, s_new, -1), lora)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, group=None):
        super().__init__()
        cfg = config
        kw = dict(use_bias=False, dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                  group=group, sequence_parallel=cfg.sequence_parallel)
        self.gate_proj = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x, lora=None):
        gate, up = self.gate_proj(x), self.up_proj(x)
        if lora is not None and "mlp_in" in lora[1].groups:
            for leaf, d in zip(lora[1].groups["mlp_in"].leaves, lora_deltas(*lora, "mlp_in", x)):
                if leaf[0] == "gate_proj":
                    gate = gate + d.to(gate.dtype)
                else:
                    up = up + d.to(up.dtype)
        h = nn.functional.silu(gate) * up
        delta = None
        if lora is not None and "down_proj" in lora[1].groups:
            delta = lora_deltas(*lora, "down_proj", h)[0]
        return self.down_proj(h, delta)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, group=None):
        super().__init__()
        cfg = config
        self.input_norm = cfg.make_norm(device, group)
        self.attention = LlamaAttention(cfg, device, group)
        self.post_attn_norm = cfg.make_norm(device, group)
        self.mlp = LlamaMLP(cfg, device, group)

    def forward(self, x, rope, cache=None, layer=0, lora=None, chunk_ctx=None):
        x = x + self.attention(self.input_norm(x), rope, cache, layer, lora, chunk_ctx)
        return x + self.mlp(self.post_attn_norm(x), lora)


# the dots with no batch dims: every projection GEMM (a 3-D input times a
# 2-D kernel reaches the dispatcher as one of these)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if func in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: LlamaConfig) -> Optional[dict]:
    """The ``torch.utils.checkpoint`` arguments of each decoder layer, or
    None for no checkpointing: only while autograd records and outside
    decode mode, so serving never pays for it. ``"full"`` saves nothing
    inside a layer and recomputes it in the backward; ``"attention"`` saves
    the outputs of the dots with no batch dims and recomputes the rest."""
    if getattr(cfg, "decode", False) or not torch.is_grad_enabled() or cfg.remat_policy is None:
        return None
    if cfg.remat_policy == "full":
        return {"use_reentrant": False}
    if cfg.remat_policy == "attention":
        return {"use_reentrant": False,
                "context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)}
    raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")


class LlamaModel(nn.Module):
    """Embedding + decoder stack + final norm over ``(batch, seq, hidden)``.
    ``layer_cls`` is the decoder block (JAX ``llama.py:759-798``: the Mixtral
    family swaps in its MoE block), a class attribute a subclass sets or an
    argument. ``group``: the tensor-parallel group (None: one device);
    ``cp_group``: the context-parallel group under ``context_parallel``
    (None: one rank holds the whole sequence)."""

    layer_cls = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig, device=None, layer_cls=None, group=None,
                 cp_group=None, layer_kwargs: Optional[dict] = None):
        super().__init__()
        cfg = self.config = config
        layer_cls = layer_cls or self.layer_cls
        if cfg.context_parallel:
            if cfg.sequence_parallel:
                raise ValueError("sequence_parallel and context_parallel are exclusive")
            if cfg.decode:
                raise ValueError("context_parallel is a training layout; decode mode does not "
                                 "take it")
        self.cp_group = cp_group if cfg.context_parallel else None
        if cfg.sequence_parallel and cfg.decode:
            raise ValueError("sequence_parallel is a training layout; decode mode does not "
                             "take it")
        self.group = group
        self.tp, self.tp_rank = group_size(group), group_rank(group)
        sp = cfg.sequence_parallel
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                                       param_dtype=cfg.param_dtype, device=device, group=group,
                                       sequence_parallel=sp)
        self.layers = nn.ModuleList(layer_cls(cfg, device, group=group, **(layer_kwargs or {}))
                                    for _ in range(cfg.num_layers))
        for layer in self.layers:
            layer.attention.cp_group = self.cp_group
        self.final_norm = cfg.make_norm(device, group)
        # the adapter pool (read-only here; the serving pool writes its
        # slots in place) and the rows' slots, set by the caller
        self.lora_layout: Optional[LoraLayout] = None
        self.adapter_idx: Optional[torch.Tensor] = None
        if cfg.lora_rank:
            if cfg.lora_slots < 2:
                raise ValueError(f"lora_slots must be >= 2 (slot 0 is the identity adapter), "
                                 f"got {cfg.lora_slots}")
            self.lora_layout = lora_layout(cfg, self.tp, self.tp_rank)
            self.register_buffer("lora_pool", torch.zeros(
                (cfg.lora_slots, cfg.num_layers, self.lora_layout.per_layer),
                dtype=torch.float32, device=device), persistent=False)

    def forward(self, input_ids: torch.Tensor, cache: Optional[KVCache] = None,
                chunk_ctx=None):
        """``chunk_ctx``: the tree chunk's ``(chunk_mask, chunk_positions)``
        (decode mode; see the module docstring)."""
        cfg = self.config
        if input_ids.shape[1] > cfg.max_seq_len:
            raise ValueError(f"sequence length {input_ids.shape[1]} exceeds max_seq_len "
                             f"{cfg.max_seq_len}")
        if cfg.decode and cache is None:
            raise ValueError("decode mode needs a KVCache")
        x = self.embed(input_ids)
        rope = None
        if not cfg.decode:
            positions = self.positions(input_ids.shape[1], input_ids.device)
            rope = rotary_embedding(positions, cfg.rope_dims, cfg.rope_theta, dtype=x.dtype,
                                    scaling=cfg.rope_scaling)
        remat = _remat(cfg)
        idx = None
        if self.lora_layout is not None:
            idx = self.adapter_idx
            if idx is None:
                idx = torch.zeros((input_ids.shape[0],), dtype=torch.long, device=x.device)
            if idx.shape != (input_ids.shape[0],):
                raise ValueError(f"adapter_idx {tuple(idx.shape)} for {input_ids.shape[0]} rows")
            idx = idx.long()
        for i, layer in enumerate(self.layers):
            # the rows' chunks of this layer: one gather for every target
            lora = (None if idx is None
                    else (self.lora_pool[:, i].index_select(0, idx), self.lora_layout))
            if remat is not None:
                x = checkpoint(layer, x, rope, cache, i, lora, chunk_ctx, **remat)
            else:
                x = layer(x, rope, cache, i, lora, chunk_ctx)
        if cfg.decode:   # in place: a captured step keeps reading this buffer
            cache.cache_index.add_(input_ids.shape[1])
        return self.final_norm(x)

    def positions(self, s: int, device=None) -> torch.Tensor:
        """The true positions of a forward's ``s`` tokens: ``0 .. s-1``, or
        under context parallelism the rank's block of the global sequence
        (zigzag: its two chunks)."""
        if not self.config.context_parallel:
            return torch.arange(s, dtype=torch.int32, device=device)
        cp = group_size(self.cp_group)
        return _rank_positions(group_rank(self.cp_group), cp, s, self.config.cp_layout, device)


class LlamaForCausalLM(nn.Module):
    """Model + LM head (tied to the embedding when ``tie_word_embeddings``).
    ``forward`` returns logits ``(b, s, vocab)`` in the compute dtype, the
    rank's vocabulary shard under a ``group``. ``layer_cls`` is the decoder
    block of its :class:`LlamaModel` (JAX ``llama.py:853-857``)."""

    layer_cls = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig, device=None, group=None, cp_group=None,
                 layer_kwargs: Optional[dict] = None):
        super().__init__()
        cfg = self.config = config
        self.model = LlamaModel(cfg, device, layer_cls=self.layer_cls, group=group,
                                cp_group=cp_group, layer_kwargs=layer_kwargs)
        self.tp = self.model.tp
        if not cfg.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(cfg.hidden_size, cfg.vocab_size,
                                                use_bias=False, dtype=cfg.dtype,
                                                param_dtype=cfg.param_dtype, device=device,
                                                group=group, gather_output=False)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.tie_word_embeddings:
            return self.model.embed.attend(x)
        return self.lm_head(x)

    def _hidden(self, input_ids: torch.Tensor, cache: Optional[KVCache] = None,
                chunk_ctx=None) -> torch.Tensor:
        """The final norm's output over the whole sequence: under sequence
        parallelism the ranks' shards are all-gathered (the head's input
        region all-reduces the gradient, so the gather's backward keeps
        the rank's slice)."""
        x = self.model(input_ids, cache, chunk_ctx)
        if self.model.embed.sequence_parallel:
            x = gather_from_tensor_parallel_region(x, self.model.group, 1)
        return x

    def forward(self, input_ids: torch.Tensor, cache: Optional[KVCache] = None,
                chunk_ctx=None):
        return self._head(self._hidden(input_ids, cache, chunk_ctx))

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = -100) -> torch.Tensor:
        """Mean next-token cross entropy over the tokens whose label is not
        ``ignore_index``. Past ``loss_chunk_size`` tokens (default 4096) the
        head and the cross entropy run per chunk under activation
        checkpointing, so only one chunk's logits are alive at a time; a
        sequence that the chunk does not divide ends with a short chunk.
        Under a tensor-parallel group the logits stay vocab-sharded and the
        cross entropy reduces over the whole vocabulary through the group.
        Under context parallelism ``input_ids``/``labels`` are the rank's
        block and the mean is over the global sequence."""
        x = self._hidden(input_ids)
        group, cp_group = self.model.group, self.model.cp_group
        s = labels.shape[1]
        chunk = self.config.loss_chunk_size or 4096
        if s <= chunk and cp_group is None:
            return parallel_cross_entropy_mean(self._head(x), labels, ignore_index=ignore_index,
                                               group=group)

        def chunk_loss(xc, lc):
            per_tok = parallel_cross_entropy(self._head(xc), lc, ignore_index=ignore_index,
                                             group=group)
            return per_tok.sum(), (lc != ignore_index).float().sum()

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.float32, device=x.device)
        if s <= chunk:
            total, count = chunk_loss(x, labels)
        else:
            for i in range(0, s, chunk):
                sl, cn = checkpoint(chunk_loss, x[:, i:i + chunk], labels[:, i:i + chunk],
                                    use_reentrant=False)
                total, count = total + sl, count + cn
        if cp_group is not None:
            # the global sum and count; the sum's backward is the identity,
            # so each rank's gradients are its tokens' share
            total = reduce_from_tensor_parallel_region(total.reshape(1), cp_group).reshape(())
            count = all_reduce_sum_(count.detach().reshape(1).clone(), cp_group).reshape(())
        return total / torch.clamp(count, min=1.0)

    def new_cache(self, batch: int, device=None, cache_index: Optional[torch.Tensor] = None,
                  block_table: Optional[torch.Tensor] = None) -> KVCache:
        """Zeroed decode cache at ``batch`` rows (block tables all 0). Paged
        pools hold ``page_pool_pages`` pages plus the sink page; int8 pools
        carry zero scales (unwritten pages dequantize to zeros).
        ``cache_index`` and ``block_table``, when given, are the (zeroed)
        buffers to use for those fields."""
        cfg = self.config
        hd, n_kv = cfg.head_dim_, cfg.kv_heads(self.model.tp)
        if cache_index is None:
            cache_index = torch.zeros((batch,), dtype=torch.int32, device=device)
        scales = None
        if cfg.page_size:
            pages = cfg.page_pool_pages + 1
            shape = (pages, cfg.page_size, n_kv, hd)
            if block_table is None:
                block_table = torch.zeros((batch, cfg.max_seq_len // cfg.page_size),
                                          dtype=torch.int32, device=device)
            dtype = page_storage_dtype(cfg)
            if dtype == torch.int8:
                scales = [[torch.zeros((pages, 1, n_kv, 1), dtype=torch.float32, device=device)
                           for _ in range(cfg.num_layers)] for _ in range(2)]
        else:
            shape, block_table, dtype = (batch, cfg.max_seq_len, n_kv, hd), None, cfg.dtype
        z = lambda: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        return KVCache(keys=[z() for _ in range(cfg.num_layers)],
                       values=[z() for _ in range(cfg.num_layers)],
                       cache_index=cache_index, block_table=block_table,
                       k_scales=scales and scales[0], v_scales=scales and scales[1])


def page_storage_dtype(config: LlamaConfig) -> torch.dtype:
    """The dtype of the paged KV pools: ``page_dtype`` or the compute dtype."""
    named = {None: config.dtype, "int8": torch.int8}
    if config.page_dtype not in named:
        raise ValueError(f"page_dtype must be None or 'int8', got {config.page_dtype!r}")
    return named[config.page_dtype]


def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None, model_cls=None, quantize=None, tp_rank: int = 0,
                tp_size: int = 1, keep: Optional[Callable[[str], bool]] = None,
                ep_rank: int = 0, ep_size: int = 1) -> dict:
    """Random weights from a seeded generator, in each weight's storage dtype
    (``param_dtype``; a router's is fp32), as a state dict for ``model_cls``
    (default :class:`LlamaForCausalLM`): kernels normal with std
    1/sqrt(fan_in) (the JAX package's lecun-normal scale; an expert weight
    ``(E, in, out)`` has fan-in ``in``), embeddings normal(0, 1), norm
    scales 1 and every bias 0 (the LayerNorms' and the linear layers').
    ``model_cls`` may be any family whose config this module's conventions
    cover (Llama, Mixtral, GPT-NeoX, BERT). ``quantize`` (a ``QuantizationConfig``)
    quantizes each weight it targets as soon as it is drawn, so only one
    float weight exists at a time. ``tp_rank``/``tp_size`` (and, for a
    Mixtral model's expert weights, ``ep_rank``/``ep_size``): that rank's
    shard of the same global weights (each drawn whole, then cut, one at a
    time: JAX initialises the global array and shards it), the state dict
    of that rank's model; a quantized weight is quantized whole and its
    int8 pair cut (``quantization.core.quantize_shard``), so its scales are
    the global weight's. ``keep``: only the leaves whose name it accepts
    are returned; the others are still drawn, one at a time, and dropped,
    so a pipeline stage gets the same values as the whole model."""
    from neuronx_distributed_tpu_torch.quantization.core import quantize_shard

    model_cls = model_cls or LlamaForCausalLM
    with torch.device("meta"):
        model = model_cls(dataclasses.replace(config, lora_rank=None)
                          if hasattr(config, "lora_rank") else config)
    meta = model.state_dict()
    sharded = tp_size > 1 or ep_size > 1
    specs = param_partition_specs(model) if sharded else {}
    out = {}
    for name, p in meta.items():
        shape = tuple(p.shape)
        if name.endswith(".scale") or name.endswith("bias"):
            if keep is not None and not keep(name):
                continue
            fill = torch.ones if name.endswith(".scale") else torch.zeros
            out[name] = fill(local_shape(shape, specs.get(name, ()), tp_size, ep_size),
                             dtype=p.dtype, device=device)
            continue
        t = torch.randn(shape, generator=generator, dtype=p.dtype, device=device)
        if keep is not None and not keep(name):
            del t
            continue
        if not name.endswith("embedding"):
            t.mul_(1.0 / math.sqrt(shape[-2] if ".experts." in name else shape[0]))
        if quantize is not None:   # quantized whole, then cut (the global scales)
            out.update(quantize_shard(name, t, specs.get(name, ()), tp_rank, tp_size, quantize,
                                      ep_rank, ep_size))
            del t
            continue
        if specs.get(name):
            t = shard_slice(t, specs[name], tp_rank, tp_size, ep_rank, ep_size).clone()
        out[name] = t
    return out
