"""Ring attention: context-parallel attention over the ``cp`` group.

Counterpart of ``neuronx_distributed_tpu/ops/ring_attention.py``. The
sequence stays cut over the context-parallel ranks through attention
itself: each rank holds its block of queries, keys and values, the K/V
blocks travel round the ring (``parallel/mappings.py``'s permutes over the
group), and each rank folds one block a step into a streaming softmax.
Every tensor here is the rank's own: q ``(b, h, s_loc, d)``, compact GQA
k/v ``(b, hk, s_loc, d)``.

Two implementations behind :func:`ring_attention`:

* ``impl="flash"`` (the default on causal paths): each ring step runs B1
  (``kernels/flash_attn.py::flash_block_forward``) on the local queries
  against the block it holds, and :func:`merge_block` folds the block's
  normalized output and LSE into the state. The backward
  (:class:`_RingFlash`) runs B3a/B3b (``flash_block_grads``) per block
  under the GLOBAL LSE and ``delta = sum(do * out)``, so each call gives
  exactly its block's share of the gradients; the dK/dV accumulators
  (fp32) ride the ring with their block and reach home after ``cp``
  rotations. The rank's own (diagonal) block is folded first, so every
  row's running max is finite before a fully-future block (LSE
  ``NEG_INF``, weight ``exp(lse - m) = 0``) arrives.
* ``impl="xla"`` (JAX's name for it): plain fp32 block math, differentiable
  by autograd through the permutes; it takes non-causal attention and any
  shape.

Layouts: ``"contiguous"`` (rank ``r`` holds positions ``[r*s_loc,
(r+1)*s_loc)``) or ``"zigzag"`` (chunks ``r`` and ``2cp-1-r`` of ``2cp``:
every rank does the same causal work). Masking is by position, so zigzag
passes the rank's true positions (:func:`_rank_positions`); the caller
permutes the sequence (:func:`zigzag_indices`) and RoPE takes the permuted
positions.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.kernels.flash_attn import (
    NEG_INF,
    default_attention_blocks,
    flash_block_forward,
    flash_block_grads,
    flash_supported,
)
from neuronx_distributed_tpu_torch.parallel import mappings
from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size

_NEG = -1e30


def zigzag_indices(seq_len: int, cp: int) -> torch.Tensor:
    """Gather indices of the zigzag layout: position ``j`` of the permuted
    sequence holds token ``zigzag_indices[j]`` of the original, and rank
    ``r``'s contiguous block of it is original chunks ``r`` and
    ``2cp-1-r``. Apply as ``x[:, zigzag_indices(s, cp)]`` to ids, labels
    and positions."""
    if seq_len % (2 * cp):
        raise ValueError(f"seq_len {seq_len} not divisible by 2*cp={2 * cp}")
    c = seq_len // (2 * cp)
    idx = []
    for r in range(cp):
        idx.append(torch.arange(r * c, (r + 1) * c))
        idx.append(torch.arange((2 * cp - 1 - r) * c, (2 * cp - r) * c))
    return torch.cat(idx)


def _rank_positions(rank: int, cp: int, s_loc: int, layout: str, device=None) -> torch.Tensor:
    """Global token positions held by ``rank``, int32 ``(s_loc,)``."""
    if layout == "contiguous":
        return rank * s_loc + torch.arange(s_loc, dtype=torch.int32, device=device)
    if layout == "zigzag":
        c = s_loc // 2
        lo = rank * c + torch.arange(c, dtype=torch.int32, device=device)
        hi = (2 * cp - 1 - rank) * c + torch.arange(c, dtype=torch.int32, device=device)
        return torch.cat([lo, hi])
    raise ValueError(f"unknown cp layout {layout!r}")


def merge_block(m: torch.Tensor, se: torch.Tensor, acc: torch.Tensor, o_i: torch.Tensor,
                lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one normalized block result into the streaming-softmax state:
    ``o_i`` ``(bh, s, d)`` and ``lse_i`` ``(bh, s)`` from B1; state ``m``,
    ``se`` ``(bh, s)`` and ``acc`` ``(bh, s, d)`` fp32. A fully-future
    block carries ``lse == NEG_INF`` and weighs exactly 0."""
    m_new = torch.maximum(m, lse_i)
    c_old = torch.exp(m - m_new)
    c_i = torch.exp(lse_i - m_new)
    se = se * c_old + c_i
    acc = acc * c_old[..., None] + o_i.float() * c_i[..., None]
    return m_new, se, acc


def _rotate(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` one rank on round the ring (outside autograd)."""
    return mappings._permute(t.contiguous(), group, 1, True)


def ring_forward_steps(qf, kb, vb, q_pos, block_pos: Callable, rotate: Callable, cp: int,
                       sm_scale: float, block_q: int, block_k: int, rep: int, h: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's forward round the ring: ``cp`` B1 calls of the local
    queries ``qf`` ``(b*h, s, d)`` against the K/V block held at step ``i``
    (compact ``(b*h/rep, s, d)``, positions ``block_pos(i)``), each folded
    by :func:`merge_block`; ``rotate`` passes a block on between steps (the
    ring's permute; on one card, the CP microbench's identity). Returns
    the output in fp32 and the global LSE."""
    m = torch.full(qf.shape[:2], NEG_INF, dtype=torch.float32, device=qf.device)
    se = torch.zeros(qf.shape[:2], dtype=torch.float32, device=qf.device)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    for i in range(cp):
        o_i, lse_i = flash_block_forward(qf, kb, vb, q_pos, block_pos(i), sm_scale, block_q,
                                         block_k, rep, h)
        m, se, acc = merge_block(m, se, acc, o_i, lse_i)
        if i < cp - 1:   # the last block is folded in place, never sent on
            kb, vb = rotate(kb), rotate(vb)
    # causal self-attention: the diagonal is always visible, se > 0
    se = torch.clamp(se, min=1e-20)
    return acc / se[..., None], m + torch.log(se)


def ring_backward_steps(qf, kb, vb, dof, out, lse, q_pos, block_pos: Callable,
                        rotate: Callable, cp: int, sm_scale: float, block_q: int, block_k: int,
                        rep: int, h: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's backward round the ring (operands as in
    :func:`ring_forward_steps`; ``out`` the rounded output, ``lse`` the
    global one): B3a/B3b per block under the global LSE and ``delta =
    sum(do * out)``. The dK/dV accumulators (fp32) ride the ring with their
    block and reach home after ``cp`` hops. Returns ``(dq, dk, dv)`` fp32."""
    delta = (dof.float() * out.float()).sum(-1)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    dkb = torch.zeros(kb.shape, dtype=torch.float32, device=qf.device)
    dvb = torch.zeros_like(dkb)
    for i in range(cp):
        dq_i, dk_i, dv_i = flash_block_grads(qf, kb, vb, dof, lse, delta, q_pos, block_pos(i),
                                             sm_scale, block_q, block_k, rep, h)
        dq += dq_i.float()
        dkb += dk_i.float()
        dvb += dv_i.float()
        if i < cp - 1:
            kb, vb = rotate(kb), rotate(vb)
            dkb, dvb = rotate(dkb), rotate(dvb)
    if cp > 1:   # the last hop home; the K/V rotation would be thrown away
        dkb, dvb = rotate(dkb), rotate(dvb)
    return dq, dkb, dvb


class _RingFlash(torch.autograd.Function):
    """The fused ring over B1 calls, with its backward over B3a/B3b calls
    under the global statistics (JAX ``_ring_flash_fwd``/``_bwd``)."""

    @staticmethod
    def _operands(q, k, v, group, layout):
        b, h, s, d = q.shape
        cp, rank = group_size(group), group_rank(group)

        def pos(r):
            return _rank_positions(r, cp, s, layout, q.device).expand(b, s).reshape(
                b, 1, s).contiguous()

        return (q.contiguous().reshape(b * h, s, d),
                k.contiguous().reshape(b * k.shape[1], s, d),
                v.contiguous().reshape(b * k.shape[1], s, d), pos(rank),
                lambda i: pos((rank - i) % cp), lambda t: _rotate(t, group), cp)

    @staticmethod
    def forward(ctx, q, k, v, group, sm_scale, block_q, block_k, layout):
        h = q.shape[1]
        out, lse = ring_forward_steps(*_RingFlash._operands(q, k, v, group, layout), sm_scale,
                                      block_q, block_k, h // k.shape[1], h)
        out = out.to(q.dtype).reshape(q.shape)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (group, sm_scale, block_q, block_k, layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, sm_scale, block_q, block_k, layout = ctx.static
        b, h, s, d = q.shape
        qf, kb, vb, q_pos, block_pos, rotate, cp = _RingFlash._operands(q, k, v, group, layout)
        dq, dkb, dvb = ring_backward_steps(
            qf, kb, vb, do.to(q.dtype).contiguous().reshape(b * h, s, d),
            out.reshape(b * h, s, d), lse, q_pos, block_pos, rotate, cp, sm_scale, block_q,
            block_k, h // k.shape[1], h)
        return (dq.to(q.dtype).reshape(q.shape), dkb.to(k.dtype).reshape(k.shape),
                dvb.to(v.dtype).reshape(v.shape), None, None, None, None, None)


def _check_layout(s_loc: int, layout: str) -> None:
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown cp layout {layout!r}")
    if layout == "zigzag" and s_loc % 2:
        raise ValueError(f"zigzag needs even per-rank seq, got {s_loc}")


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                         sm_scale: Optional[float] = None, block_q: Optional[int] = None,
                         block_k: Optional[int] = None,
                         layout: str = "contiguous") -> torch.Tensor:
    """Causal ring attention over B1 (forward) and B3a/B3b (backward) calls;
    ``group`` is the context-parallel group (None: one rank, the plain
    flash call). ``layout`` states how the caller laid the sequence out."""
    b, h, s_loc, d = q.shape
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[1]}")
    _check_layout(s_loc, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dbq, dbk = default_attention_blocks(s_loc)
    block_q, block_k = block_q or dbq, block_k or dbk
    if not flash_supported(s_loc, s_loc, block_q, block_k):
        raise ValueError(
            f"per-rank seq {s_loc} not a multiple of blocks ({block_q}, {block_k})")
    return _RingFlash.apply(q, k, v, group, float(sm_scale), block_q, block_k, layout)


def _block_update(q, kb, vb, q_pos, k_pos, num, den, mx, sm_scale: float, causal: bool):
    """Fold one K/V block into the streaming state (fp32): q ``(b,h,s,d)``,
    kb/vb ``(b,h,sk,d)``, num ``(b,h,s,d)``, den/mx ``(b,h,s)``."""
    scores = torch.einsum("bhsd,bhkd->bhsk", q.float(), kb.float()) * sm_scale
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask[None, None], scores, _NEG)
        maskf = mask[None, None].float()
    else:
        maskf = torch.ones((), dtype=torch.float32, device=q.device)
    new_mx = torch.maximum(mx, scores.amax(-1))
    # exp(scores - new_mx) <= 1; masked entries are zeroed by the multiply
    p = torch.exp(scores - new_mx[..., None]) * maskf
    corr = torch.exp(mx - new_mx)
    num = num * corr[..., None] + torch.einsum("bhsk,bhkd->bhsd", p, vb.float())
    den = den * corr + p.sum(-1)
    return num, den, new_mx


def _ring_attention_plain(q, k, v, group=None, causal: bool = True,
                          sm_scale: Optional[float] = None, q_chunk: int = 512,
                          layout: str = "contiguous") -> torch.Tensor:
    """Plain fp32 ring attention (JAX ``impl="xla"``): query chunks of
    ``q_chunk`` rows when they divide the rank's sequence; autograd
    differentiates it, the permutes included."""
    b, h, s, d = q.shape
    _check_layout(s, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    rep = h // k.shape[1]
    cp, rank = group_size(group), group_rank(group)
    q_pos = _rank_positions(rank, cp, s, layout, q.device)
    chunks = [(j, j + q_chunk) for j in range(0, s, q_chunk)] if (
        s > q_chunk and s % q_chunk == 0) else [(0, s)]
    num = [torch.zeros((b, h, j1 - j0, d), dtype=torch.float32, device=q.device)
           for j0, j1 in chunks]
    den = [torch.zeros((b, h, j1 - j0), dtype=torch.float32, device=q.device)
           for j0, j1 in chunks]
    mx = [torch.full((b, h, j1 - j0), _NEG, dtype=torch.float32, device=q.device)
          for j0, j1 in chunks]
    kb, vb = k, v
    for i in range(cp):
        k_pos = _rank_positions((rank - i) % cp, cp, s, layout, q.device)
        kbf = kb.repeat_interleave(rep, dim=1) if rep > 1 else kb
        vbf = vb.repeat_interleave(rep, dim=1) if rep > 1 else vb
        for c, (j0, j1) in enumerate(chunks):
            num[c], den[c], mx[c] = _block_update(q[:, :, j0:j1], kbf, vbf, q_pos[j0:j1], k_pos,
                                                  num[c], den[c], mx[c], sm_scale, causal)
        if i < cp - 1:
            kb, vb = mappings.ppermute_next(kb, group), mappings.ppermute_next(vb, group)
    num, den = torch.cat(num, dim=2), torch.cat(den, dim=2)
    return (num / torch.clamp(den, min=1e-20)[..., None]).to(q.dtype)


def choose_impl(causal: bool, s_loc: int, layout: str, on_card: bool,
                block_q: Optional[int] = None, block_k: Optional[int] = None
                ) -> Tuple[str, Optional[int], Optional[int]]:
    """``(impl, block_q, block_k)`` of ``impl=None``. JAX's choice: flash
    where the path takes the shapes (causal, block-aligned, an even
    per-rank sequence under zigzag), else the plain blocks. On the card
    causal attention always runs the kernels, which tile at 64 whatever the
    blocks: where no block divides the rank's sequence, the block is the
    whole of it."""
    dbq, dbk = default_attention_blocks(s_loc)
    aligned = flash_supported(s_loc, s_loc, block_q or dbq, block_k or dbk)
    if not (causal and (layout != "zigzag" or s_loc % 2 == 0) and (aligned or on_card)):
        return "xla", block_q, block_k
    return ("flash", block_q, block_k) if aligned else ("flash", s_loc, s_loc)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                   sm_scale: Optional[float] = None, q_chunk: int = 512, group=None,
                   impl: Optional[str] = None, layout: str = "contiguous",
                   block_q: Optional[int] = None, block_k: Optional[int] = None
                   ) -> torch.Tensor:
    """Context-parallel multi-head attention over this rank's BHSD blocks;
    K/V may carry fewer (GQA) heads. ``group``: the context-parallel group
    (None: one rank). ``impl``: ``"flash"`` (B1/B3 per block), ``"xla"``
    (plain fp32 blocks) or None (:func:`choose_impl`)."""
    if impl is None:
        impl, block_q, block_k = choose_impl(causal, q.shape[2], layout, q.is_cuda, block_q,
                                             block_k)
    if impl == "flash":
        if not causal:
            raise ValueError("impl='flash' ring attention is causal-only")
        return ring_flash_attention(q, k, v, group, sm_scale=sm_scale, block_q=block_q,
                                    block_k=block_k, layout=layout)
    if impl != "xla":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    return _ring_attention_plain(q, k, v, group, causal=causal, sm_scale=sm_scale,
                                 q_chunk=q_chunk, layout=layout)
