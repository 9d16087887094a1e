"""Paged decode attention: CUDA kernel, plain PyTorch twin, int8 pages.

Counterpart of ``neuronx_distributed_tpu/inference/paged_kernel.py``. The
single-token decode step attends straight off the KV page pool through the
per-slot block tables: pages past a row's ``cache_len`` are skipped, and
inside a page key position ``j*page_size + r`` is visible iff
``<= cache_len[b]``, so stale bytes in reused pages never contribute.
int8 pools carry one fp32 scale per (page, kv head), applied inside the
tile.

:func:`paged_decode_attention` is the kernel wrapper: a CUDA tensor
launches ``csrc/paged_decode.cu`` (pages split across CTAs, partials
merged by a second kernel; counted once a call in
``paged_decode_attention.launches``), a CPU tensor runs
:func:`paged_decode_attention_plain`, the twin with the TPU kernel's page
loop and online softmax in fp32. :func:`reference_paged_attention` is the
gather oracle (logical view, then dense cached attention).
"""

from __future__ import annotations

from typing import Optional

import torch

from neuronx_distributed_tpu_torch._device import on_cuda

NEG_INF = -1e30

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the widest head_dim the kernel reads (csrc/paged_decode.cu HD_MAX)
_MAX_HEAD_DIM = 256


def paged_kernel_supported(s_new: int, page_size: int, n_heads: int,
                           n_kv_heads: int) -> bool:
    """Static gate for the kernel branch: single-token decode steps with an
    integral GQA group."""
    return (s_new == 1 and page_size >= 1 and n_kv_heads >= 1
            and n_heads % n_kv_heads == 0)


def quantize_kv_pages(w: torch.Tensor):
    """absmax int8 quantization per (page, kv head) of ``(..., page_size,
    n_kv, head_dim)`` values. Returns ``(q int8, scale fp32 (..., 1, n_kv,
    1))``; the 1e-12 floor keeps all-zero pages exact."""
    wf = w.float()
    amax = wf.abs().amax(dim=(-3, -1), keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv_pages(q: torch.Tensor, scale: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_pages` (broadcast multiply)."""
    return (q.float() * scale).to(dtype)


def _check(q, k_pages, v_pages, block_table, cache_len, k_scale, v_scale):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention is the single-token decode kernel: "
                         f"q must be (b, 1, n_heads, hd), got {tuple(q.shape)}")
    b, _, n_q, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} must be "
                         f"(num_pages, page_size, n_kv, {hd})")
    num_pages, _, n_kv, _ = k_pages.shape
    if n_q % n_kv:
        raise ValueError(f"n_heads {n_q} must be a multiple of n_kv_heads {n_kv}")
    if block_table.dim() != 2 or block_table.shape[0] != b or block_table.dtype != torch.int32:
        raise ValueError(f"block_table must be ({b}, pages_per_seq) int32")
    if cache_len.shape != (b,) or cache_len.dtype != torch.int32:
        raise ValueError(f"cache_len must be ({b},) int32")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools carry BOTH k_scale and v_scale")
    if k_scale is not None:
        if k_pages.dtype != torch.int8:
            raise ValueError("k_scale/v_scale come with int8 pools only")
        for s in (k_scale, v_scale):
            if s.shape != (num_pages, 1, n_kv, 1) or s.dtype != torch.float32:
                raise ValueError(f"scales must be ({num_pages}, 1, {n_kv}, 1) fp32")
    elif k_pages.dtype == torch.int8:
        raise ValueError("int8 pools need k_scale and v_scale")


def paged_decode_attention_plain(q, k_pages, v_pages, block_table, cache_len, *,
                                 k_scale=None, v_scale=None, sm_scale=None):
    """Plain PyTorch twin: walk the block table one page at a time with an
    online softmax in fp32, vectorised over rows, kv heads and the GQA
    group; rows whose next page starts past ``cache_len`` pass through."""
    b, _, n_q, hd = q.shape
    _, ps, n_kv, _ = k_pages.shape
    group = n_q // n_kv
    if sm_scale is None:
        sm_scale = 1.0 / (hd ** 0.5)
    dev = q.device
    q3 = q[:, 0].reshape(b, n_kv, group, hd).float()
    qpos = cache_len.long()
    m = torch.full((b, n_kv, group), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, group), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, group, hd), dtype=torch.float32, device=dev)
    rpos = torch.arange(ps, device=dev)
    for j in range(block_table.shape[1]):
        run = j * ps <= qpos                                    # (b,)
        if not bool(run.any()):
            break
        page = block_table[:, j].long()
        kt = k_pages[page].float()                              # (b, ps, n_kv, hd)
        vt = v_pages[page].float()
        if k_scale is not None:
            kt = kt * k_scale[page]
            vt = vt * v_scale[page]
        s = torch.einsum("bngd,brnd->bngr", q3, kt) * sm_scale
        valid = (j * ps + rpos[None, :] <= qpos[:, None])[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(-1)
        acc_new = acc * alpha[..., None] + torch.einsum("bngr,brnd->bngd", p, vt)
        r = run[:, None, None]
        m, l = torch.where(r, m_new, m), torch.where(r, l_new, l)
        acc = torch.where(r[..., None], acc_new, acc)
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).reshape(b, 1, n_q, hd).to(q.dtype)


# keys of one split of the kernel's page loop, in whole pages (the
# KEYS_PER_SPLIT rule of csrc/paged_decode.cu; the workspace is sized by it)
_KEYS_PER_SPLIT = 128


def _n_split(page_size: int, pages_per_seq: int) -> int:
    pps = max(1, _KEYS_PER_SPLIT // page_size)
    return -(-pages_per_seq // pps)


def _paged_decode_kernel(q, k_pages, v_pages, block_table, cache_len, k_scale,
                         v_scale, sm_scale):
    from neuronx_distributed_tpu_torch.kernels import _build

    if q.dtype not in _Q_DTYPES or k_pages.dtype not in _POOL_DTYPES:
        raise ValueError(f"paged kernel takes fp32/bf16 queries and fp32/bf16/int8 pools, "
                         f"got {q.dtype} and {k_pages.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("cache_len", cache_len),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"paged kernel needs a contiguous {name}")
    b, _, n_q, hd = q.shape
    _, ps, n_kv, _ = k_pages.shape
    # a pool row is read in chunks of 16 bytes (4 where its byte length is
    # no multiple of 16) spread over the lanes of a warp
    if hd > _MAX_HEAD_DIM:
        raise ValueError(f"paged kernel takes head_dim up to {_MAX_HEAD_DIM}, got {hd}")
    if hd * k_pages.element_size() % 4:
        raise ValueError(f"paged kernel reads pool rows 4 bytes at a time at least: head_dim "
                         f"{hd} of {k_pages.dtype} spans {hd * k_pages.element_size()} bytes")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged kernel needs {name} to start 16-byte aligned")
    n_split = _n_split(ps, block_table.shape[1])
    out = torch.empty_like(q)
    # per query row and split: (m, l) and the partial sums, from shapes alone
    # (the step reads no device value on the host)
    work = torch.empty(b * n_q * n_split * (hd + 2), dtype=torch.float32, device=q.device)
    _build.call("paged_decode", _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
                _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(block_table),
                _build.ptr(cache_len), _build.ptr(out), _build.ptr(work), b, n_kv,
                n_q // n_kv, hd, ps, block_table.shape[1], float(sm_scale),
                _Q_DTYPES[q.dtype], _POOL_DTYPES[k_pages.dtype], _build.stream_of(q.device))
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, cache_len: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused decode attention straight off the page pool.

    ``q``: (b, 1, n_heads, hd) at positions ``cache_len``; ``k_pages``/
    ``v_pages``: (num_pages, page_size, n_kv, hd) post-write pools (fp32,
    bf16 or int8); ``block_table``: (b, pages_per_seq) int32;
    ``cache_len``: (b,) int32; ``k_scale``/``v_scale``: (num_pages, 1, n_kv,
    1) fp32, present iff the pools are int8. Returns (b, 1, n_heads, hd)
    in q's dtype. CUDA tensors launch the kernel, CPU tensors run the twin;
    under ``torch.export`` the call is the ``nxdt_torch::paged_decode``
    operator."""
    _check(q, k_pages, v_pages, block_table, cache_len, k_scale, v_scale)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    args = (q, k_pages, v_pages, block_table, cache_len, k_scale, v_scale, float(sm_scale))
    if torch.compiler.is_exporting():
        return torch.ops.nxdt_torch.paged_decode(*args)
    return _paged_decode_route(*args)   # eager calls skip the operator dispatch


def _paged_decode_route(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                        block_table: torch.Tensor, cache_len: torch.Tensor,
                        k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                        sm_scale: float) -> torch.Tensor:
    """B2's route: CUDA tensors launch the kernel and count the launch, CPU
    tensors run the twin."""
    if not on_cuda(q, k_pages, v_pages, block_table, cache_len, k_scale, v_scale):
        return paged_decode_attention_plain(q, k_pages, v_pages, block_table, cache_len,
                                            k_scale=k_scale, v_scale=v_scale,
                                            sm_scale=sm_scale)
    out = _paged_decode_kernel(q, k_pages, v_pages, block_table, cache_len, k_scale,
                               v_scale, sm_scale)
    paged_decode_attention.launches += 1
    return out


# B2 as an operator PyTorch can trace (``torch.export`` records the call)
_paged_decode_op = torch.library.custom_op("nxdt_torch::paged_decode", mutates_args=())(
    _paged_decode_route)


@_paged_decode_op.register_fake
def _(q, k_pages, v_pages, block_table, cache_len, k_scale, v_scale, sm_scale):
    return torch.empty_like(q)


paged_decode_attention.launches = 0


def reference_paged_attention(q, k_pages, v_pages, block_table, cache_len, *,
                              k_scale=None, v_scale=None, sm_scale=None):
    """Gather oracle: materialise each row's logical view of the pool, then
    the dense ``cached_attention`` math (int8 pages dequantized to q's dtype)."""
    from neuronx_distributed_tpu_torch.models.llama import cached_attention

    num_pages, ps, n_kv, hd = k_pages.shape
    s_max = block_table.shape[1] * ps
    lpos = torch.arange(s_max, device=q.device)
    page_idx = block_table[:, lpos // ps].long()                 # (b, S)
    flat = page_idx * ps + (lpos % ps)[None, :]
    k_all = k_pages.reshape(num_pages * ps, n_kv, hd)[flat]
    v_all = v_pages.reshape(num_pages * ps, n_kv, hd)[flat]
    if k_scale is not None:
        ks = k_scale.reshape(num_pages, n_kv)[page_idx]          # (b, S, n_kv)
        vs = v_scale.reshape(num_pages, n_kv)[page_idx]
        k_all = (k_all.float() * ks[..., None]).to(q.dtype)
        v_all = (v_all.float() * vs[..., None]).to(q.dtype)
    return cached_attention(q, k_all, v_all, cache_len, sm_scale=sm_scale)
