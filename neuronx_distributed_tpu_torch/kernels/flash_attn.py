"""Flash attention forward and backward: CUDA kernels, plain PyTorch twins,
mask helpers.

Counterpart of ``neuronx_distributed_tpu/kernels/flash_attn.py``. Masking
is position based as there: key ``j`` is visible to query ``i`` iff
``kv_pos[j] <= q_pos[i]``; pad keys carry ``INVALID_POS``, pad query rows
``-1``, and a fully masked row gives output 0 and LSE ``NEG_INF``. K/V stay
compact under GQA (kv row = q row // group).

Kernel wrappers (a CUDA tensor launches the kernel and adds one to the
wrapper's ``launches``; a CPU tensor runs the plain twin, which keeps the
TPU kernel's tiling and roundings):

- :func:`flash_block_forward` -> ``csrc/flash_fwd.cu`` (out and LSE);
- :func:`flash_bwd_dkdv` and :func:`flash_bwd_dq` -> ``csrc/flash_bwd.cu``
  (recompute backward under a caller-supplied LSE and ``delta``), both
  behind :func:`flash_block_grads`.

The kernels are built for head_dim 64, 128 and 256; any other head_dim up
to 256 runs them zero-padded to the next of those widths
(:func:`at_kernel_width`): zero columns change no q·kᵀ, no LSE, no delta
and none of the first d columns of an output, and the softmax scale stays
the caller's (by default 1/√d of the unpadded d). A head_dim above 256 (no
public decoder config has one) raises.

:func:`flash_attention` is differentiable through ``_FlashAttention`` on
every device, the counterpart of JAX's custom VJP. LSE and ``delta`` are
``(b*h, sq)`` fp32; the TPU's 128-lane padding is not carried over.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from neuronx_distributed_tpu_torch._device import on_cuda

NEG_INF = -1e30
INVALID_POS = 2**30  # kv sentinel: never <= any real query position

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128, 256)


def default_attention_blocks(sq: int) -> tuple:
    """(block_q, block_k) defaults of the JAX package (measured there on a
    TPU; kept so the same shapes take the same path)."""
    for b in (1024, 512, 256, 128):
        if flash_supported(sq, sq, b, b):
            return min(b, sq), min(b, sq)
    return min(128, sq), min(128, sq)


def default_prefill_blocks(sq: int) -> tuple:
    """(block_q, block_k) for forward-only (prefill) use."""
    return default_attention_blocks(sq)


def flash_supported(sq: int, sk: int, block_q: int, block_k: int) -> bool:
    """True iff both sequence lengths are multiples of their clamped block
    sizes — the one shape contract of the kernel path."""
    return sq % min(block_q, sq) == 0 and sk % min(block_k, sk) == 0


def default_positions(b: int, sq: int, sk: int, causal: bool,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys at ``iota(sk)``; causal queries bottom-aligned at
    ``iota(sq) + (sk - sq)``, non-causal queries all at ``sk - 1``."""
    kpos = torch.arange(sk, dtype=torch.int32, device=device).expand(b, sk)
    if causal:
        qpos = torch.arange(sq, dtype=torch.int32, device=device) + (sk - sq)
    else:
        qpos = torch.full((sq,), sk - 1, dtype=torch.int32, device=device)
    return qpos.expand(b, sq), kpos


def resolve_positions(b, sq, sk, causal, q_positions, kv_positions, device=None):
    """Fill missing position arrays with :func:`default_positions`."""
    if q_positions is None or kv_positions is None:
        dq_pos, dk_pos = default_positions(b, sq, sk, causal, device)
        q_positions = dq_pos if q_positions is None else q_positions
        kv_positions = dk_pos if kv_positions is None else kv_positions
    return q_positions, kv_positions


def _check(q, k, v, qpos, kpos, group, num_q_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (rows, seq, head_dim)")
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if bh % num_q_heads or num_q_heads % group or k.shape[0] * group != bh:
        raise ValueError(f"rows {bh}, kv rows {k.shape[0]}, heads {num_q_heads}, "
                         f"group {group} are inconsistent")
    b = bh // num_q_heads
    sk = k.shape[1]
    if qpos.shape not in ((b, 1, sq), (b, sq)) or kpos.shape not in ((b, 1, sk), (b, sk)):
        raise ValueError(f"positions {tuple(qpos.shape)}/{tuple(kpos.shape)} do not match "
                         f"batch {b}, sq {sq}, sk {sk}")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_block_forward_plain(q, k, v, qpos, kpos, sm_scale, block_q, block_k,
                              group, num_q_heads):
    """Plain PyTorch twin of the kernel: the TPU kernel's blocked online
    softmax, vectorised over rows and query blocks, looping over key blocks.
    Returns ``(out (bh, sq, d) in q's dtype, lse (bh, sq) fp32)``."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    h = num_q_heads
    b = bh // h
    dev = q.device
    kvrow = torch.arange(bh, device=dev) // group
    qp = qpos.reshape(b, sq).repeat_interleave(h, dim=0)          # (bh, sq)
    kp = kpos.reshape(b, sk).repeat_interleave(h, dim=0)          # (bh, sk)
    nqb = math.ceil(sq / block_q)
    qmax = torch.nn.functional.pad(qp, (0, nqb * block_q - sq), value=-(2**31)) \
        .reshape(bh, nqb, block_q).amax(-1)                        # (bh, nqb)
    qf = q.float()
    m = torch.full((bh, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    for k0 in range(0, sk, block_k):
        kpj = kp[:, k0:k0 + block_k]
        run = (kpj.amin(-1, keepdim=True) <= qmax).repeat_interleave(block_q, dim=1)[:, :sq]
        if not bool(run.any()):
            continue
        kj = k[kvrow, k0:k0 + block_k].float()
        vj = v[kvrow, k0:k0 + block_k]
        s = torch.einsum("bqd,bkd->bqk", qf, kj) * sm_scale
        valid = kpj[:, None, :] <= qp[:, :, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bqk,bkd->bqd", p.to(v.dtype).float(), vj.float())
        m = torch.where(run, m_new, m)
        l = torch.where(run, l_new, l)
        acc = torch.where(run[..., None], acc_new, acc)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def kernel_head_dim(d: int) -> int:
    """The kernel width a head_dim runs at: the least built width >= d."""
    for w in _KERNEL_HEAD_DIMS:
        if d <= w:
            return w
    raise ValueError(f"flash kernels take head_dim up to {_KERNEL_HEAD_DIMS[-1]} (the widest "
                     f"built width), got {d}")


def at_kernel_width(fn, d: int, padded, *rest, keep=()):
    """``fn(*padded', *rest)`` with each tensor of ``padded`` zero-padded on
    its last axis from ``d`` to :func:`kernel_head_dim` ``(d)``, and each
    output (one, or a tuple whose indices in ``keep`` are left as they are)
    cut back to ``d`` columns. The caller passes ``sm_scale`` in ``rest``,
    taken from the unpadded d."""
    w = kernel_head_dim(d)
    if w == d:
        return fn(*padded, *rest)
    out = fn(*(torch.nn.functional.pad(t, (0, w - d)) for t in padded), *rest)
    if not isinstance(out, tuple):
        return out[..., :d].contiguous()
    return tuple(t if i in keep else t[..., :d].contiguous() for i, t in enumerate(out))


def _kernel_check(q, **operands):
    """What the CUDA kernels take: fp32 or bf16, head_dim at a built width
    (64, 128 or 256), every operand contiguous."""
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes fp32 or bf16, got {q.dtype}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    for name, t in (("q", q), *operands.items()):
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs a contiguous {name}")


def _flash_fwd_kernel(q, k, v, qpos, kpos, sm_scale, group, num_q_heads):
    return at_kernel_width(_flash_fwd_launch, q.shape[-1], (q, k, v), qpos, kpos, sm_scale,
                           group, num_q_heads, keep=(1,))   # the LSE has no head_dim


def _flash_fwd_launch(q, k, v, qpos, kpos, sm_scale, group, num_q_heads):
    from neuronx_distributed_tpu_torch.kernels import _build

    _kernel_check(q, k=k, v=v, qpos=qpos, kpos=kpos)
    if q.dtype == torch.bfloat16:   # the tensor-core route stages 16 bytes at a time
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash kernel needs {name} to start 16-byte aligned")
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _build.call("flash_fwd", _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(qpos),
                _build.ptr(kpos), _build.ptr(out), _build.ptr(lse), bh, sq, k.shape[1], d,
                group, num_q_heads, float(sm_scale), _KERNEL_DTYPES[q.dtype],
                _build.stream_of(q.device))
    return out, lse


def flash_block_forward(q, k, v, qpos, kpos, sm_scale, block_q, block_k,
                        group, num_q_heads):
    """Forward kernel with its softmax statistics over flattened operands:
    q ``(b*h, sq, d)``, compact k/v ``(b*h/group, sk, d)``, int32 positions
    ``(b, 1, s)`` or ``(b, s)``. Returns ``(out, lse (b*h, sq) fp32)``.
    CUDA tensors launch the kernel, CPU tensors run the twin. The block
    sizes set the shape contract and the twin's tiling; the kernel tiles
    64 x 64 whatever they are."""
    _check(q, k, v, qpos, kpos, group, num_q_heads)
    sq, sk = q.shape[1], k.shape[1]
    if not flash_supported(sq, sk, block_q, block_k):
        raise ValueError(f"seq lengths (q={sq}, kv={sk}) must be multiples of the block "
                         f"sizes (block_q={block_q}, block_k={block_k})")
    if not on_cuda(q, k, v, qpos, kpos):
        return flash_block_forward_plain(q, k, v, qpos, kpos, sm_scale, block_q, block_k,
                                         group, num_q_heads)
    out = _flash_fwd_kernel(q, k, v, qpos, kpos, sm_scale, group, num_q_heads)
    flash_block_forward.launches += 1
    return out


flash_block_forward.launches = 0


# --- backward ----------------------------------------------------------------------


def _bwd_check(q, k, v, do, lse, delta, qpos, kpos, block_q, block_k, group, num_q_heads):
    _check(q, k, v, qpos, kpos, group, num_q_heads)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {tuple(q.shape[:2])}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    sq, sk = q.shape[1], k.shape[1]
    if not flash_supported(sq, sk, block_q, block_k):
        raise ValueError(f"seq lengths (q={sq}, kv={sk}) must be multiples of the block "
                         f"sizes (block_q={block_q}, block_k={block_k})")


def _bwd_tiles(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k, group,
               num_q_heads):
    """The recompute both backward twins share, one ``block_k`` key block at
    a time over all rows: yields ``(k0, kj, p, ds)`` with ``kj`` the block's
    keys per q row (fp32), ``p = where(valid, exp(s - lse), 0)`` and
    ``ds = p * (dp - delta) * scale`` (fp32, before any rounding). A key
    block that no query block of any row can see is skipped (the TPU
    kernels' block skip; its ``p`` would be all zero)."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    h = num_q_heads
    b = bh // h
    dev = q.device
    kvrow = torch.arange(bh, device=dev) // group
    qp = qpos.reshape(b, sq).repeat_interleave(h, dim=0)          # (bh, sq)
    kp = kpos.reshape(b, sk).repeat_interleave(h, dim=0)          # (bh, sk)
    nqb = math.ceil(sq / block_q)
    qmax = torch.nn.functional.pad(qp, (0, nqb * block_q - sq), value=-(2**31)) \
        .reshape(bh, nqb, block_q).amax(-1)                        # (bh, nqb)
    qf, dof = q.float(), do.float()
    lse_, delta_ = lse[..., None], delta[..., None]
    for k0 in range(0, sk, block_k):
        kpj = kp[:, k0:k0 + block_k]
        if not bool((kpj.amin(-1, keepdim=True) <= qmax).any()):
            continue
        kj = k[kvrow, k0:k0 + block_k].float()
        vj = v[kvrow, k0:k0 + block_k].float()
        s = torch.einsum("bqd,bkd->bqk", qf, kj) * sm_scale
        valid = kpj[:, None, :] <= qp[:, :, None]
        # masked pairs are selected away before any use: a fully masked row
        # carries lse = NEG_INF, where exp(s - lse) overflows
        p = torch.where(valid, torch.exp(s - lse_), 0.0)
        dp = torch.einsum("bqd,bkd->bqk", dof, vj)
        yield k0, kj, p, p * (dp - delta_) * sm_scale


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k,
                         group, num_q_heads):
    """Plain twin of the dK/dV kernel: ``dV = P^T dO`` with ``p`` rounded to
    dO's dtype, ``dK = dS^T Q`` with ``ds`` rounded to q's dtype, fp32 sums
    over the GQA group and every query. Returns ``(dk, dv)`` in k's dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dk = torch.zeros((bh, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    qf, dof = q.float(), do.float()
    for k0, _, p, ds in _bwd_tiles(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q,
                                   block_k, group, num_q_heads):
        k1 = k0 + p.shape[-1]
        dv[:, k0:k1] = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), dof)
        dk[:, k0:k1] = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), qf)
    fold = lambda t: t.reshape(-1, group, sk, d).sum(1).to(k.dtype)  # noqa: E731
    return fold(dk), fold(dv)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k,
                       group, num_q_heads):
    """Plain twin of the dQ kernel: ``dQ = dS K`` with ``ds`` rounded to k's
    dtype, fp32 sums over the key blocks. Returns dq in q's dtype."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for _, kj, _, ds in _bwd_tiles(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q,
                                   block_k, group, num_q_heads):
        dq += torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), kj)
    return dq.to(q.dtype)


def flash_bwd_dkdv(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k, group,
                   num_q_heads):
    """dK and dV of one (query block, key block) pairing under the given
    softmax statistics (B3a). Operands as in :func:`flash_block_grads`. CUDA
    tensors launch ``csrc/flash_bwd.cu::flash_bwd_dkdv``, CPU tensors run
    :func:`flash_bwd_dkdv_plain`."""
    _bwd_check(q, k, v, do, lse, delta, qpos, kpos, block_q, block_k, group, num_q_heads)
    if not on_cuda(q, k, v, do, lse, delta, qpos, kpos):
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q,
                                    block_k, group, num_q_heads)
    out = at_kernel_width(_flash_bwd_dkdv_launch, q.shape[-1], (q, k, v, do), lse, delta,
                          qpos, kpos, sm_scale, group, num_q_heads)
    flash_bwd_dkdv.launches += 1
    return out


def _flash_bwd_dkdv_launch(q, k, v, do, lse, delta, qpos, kpos, sm_scale, group, num_q_heads):
    from neuronx_distributed_tpu_torch.kernels import _build

    _kernel_check(q, k=k, v=v, do=do, lse=lse, delta=delta, qpos=qpos, kpos=kpos)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.call("flash_bwd_dkdv", *map(_build.ptr, (q, k, v, do, lse, delta, qpos, kpos, dk, dv)),
                k.shape[0], q.shape[1], k.shape[1], q.shape[2], group, num_q_heads,
                float(sm_scale), _KERNEL_DTYPES[q.dtype], _build.stream_of(q.device))
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k, group,
                 num_q_heads):
    """dQ of one pairing under the given softmax statistics (B3b). CUDA
    tensors launch ``csrc/flash_bwd.cu::flash_bwd_dq``, CPU tensors run
    :func:`flash_bwd_dq_plain`."""
    _bwd_check(q, k, v, do, lse, delta, qpos, kpos, block_q, block_k, group, num_q_heads)
    if not on_cuda(q, k, v, do, lse, delta, qpos, kpos):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q,
                                  block_k, group, num_q_heads)
    dq = at_kernel_width(_flash_bwd_dq_launch, q.shape[-1], (q, k, v, do), lse, delta, qpos,
                         kpos, sm_scale, group, num_q_heads)
    flash_bwd_dq.launches += 1
    return dq


def _flash_bwd_dq_launch(q, k, v, do, lse, delta, qpos, kpos, sm_scale, group, num_q_heads):
    from neuronx_distributed_tpu_torch.kernels import _build

    _kernel_check(q, k=k, v=v, do=do, lse=lse, delta=delta, qpos=qpos, kpos=kpos)
    dq = torch.empty_like(q)
    _build.call("flash_bwd_dq", *map(_build.ptr, (q, k, v, do, lse, delta, qpos, kpos, dq)),
                q.shape[0], q.shape[1], k.shape[1], q.shape[2], group, num_q_heads,
                float(sm_scale), _KERNEL_DTYPES[q.dtype], _build.stream_of(q.device))
    return dq


flash_bwd_dq.launches = 0


def flash_block_grads(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k,
                      group, num_q_heads):
    """Backward of one (query block, key block) pairing under externally
    supplied softmax statistics: ``lse`` and ``delta`` are ``(b*h, sq)``
    fp32. With this call's own statistics it is plain flash backward; with
    global ones over a larger key set (ring attention) the result is this
    block's share of the global gradients. Shapes as in
    :func:`flash_block_forward`; ``do`` like q. Returns ``(dq, dk, dv)``."""
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k,
                            group, num_q_heads)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k, group,
                      num_q_heads)
    return dq, dk, dv


def flash_block_grads_plain(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k,
                            group, num_q_heads):
    """Both backward twins: ``(dq, dk, dv)`` as :func:`flash_block_grads`
    computes them for CPU tensors."""
    args = (q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k, group, num_q_heads)
    return (flash_bwd_dq_plain(*args), *flash_bwd_dkdv_plain(*args))


class _FlashAttention(torch.autograd.Function):
    """Flash attention over flattened operands with its recompute backward,
    the counterpart of JAX's ``_flash_attention_bh`` custom VJP. Gradients
    flow to q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, sm_scale, block_q, block_k, group, num_q_heads):
        out, lse = flash_block_forward(q, k, v, qpos, kpos, sm_scale, block_q, block_k, group,
                                       num_q_heads)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.static = (sm_scale, block_q, block_k, group, num_q_heads)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        # delta pre-pass rowsum(dO * O) in fp32: elementwise, a torch op, as
        # the JAX package leaves it to XLA outside the Pallas calls
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = flash_block_grads(q, k, v, do.contiguous(), lse, delta, qpos, kpos,
                                       *ctx.static)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention over ``(batch, heads, seq, head_dim)`` tensors; K/V
    may carry fewer (GQA) heads. Positions as in the module docstring.
    Differentiable in q, k and v: the backward runs the recompute kernels
    (their twins for CPU tensors)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if h % hk != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hk}")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    q_positions, kv_positions = resolve_positions(
        b, sq, sk, causal, q_positions, kv_positions, q.device)
    qp = q_positions.to(torch.int32).reshape(b, 1, sq).contiguous()
    kp = kv_positions.to(torch.int32).reshape(b, 1, sk).contiguous()
    out = _FlashAttention.apply(
        q.contiguous().reshape(b * h, sq, d), k.contiguous().reshape(b * hk, sk, d),
        v.contiguous().reshape(b * hk, sk, d), qp, kp, float(sm_scale), block_q, block_k,
        h // hk, h)
    return out.reshape(b, h, sq, d)


def reference_attention(q, k, v, causal=True, sm_scale=None,
                        q_positions=None, kv_positions=None):
    """Dense attention with the same position masks (the numerical golden)."""
    b, h, sq, d = q.shape
    hk = k.shape[1]
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    sk = k.shape[2]
    q_positions, kv_positions = resolve_positions(
        b, sq, sk, causal, q_positions, kv_positions, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = kv_positions[:, None, None, :] <= q_positions[:, None, :, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
