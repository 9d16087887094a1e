"""B5, the W8A16 GEMM: activations against int8 weights with fp32 scales.

The JAX package has no Pallas kernel here: it serves a quantized tree by
dequantizing each leaf inside the layer (``quantization/core.py``
``dequantize_leaf``: ``(q * scale)`` cast to the compute dtype) and leaves
XLA to fuse the convert into the consuming einsum. The port's counterpart
of that fusion is ``csrc/w8a16_gemm.cu``, which dequantizes each weight tile
on its way to the tensor cores, so the int8 weights are all a step reads.

:func:`w8a16_gemm` is the kernel wrapper: ``out[b] = x[b] @ W[idx[b]]`` with
``W = (qweight.float() * scale).to(x.dtype)``. A CUDA tensor launches the
kernel of the route :func:`_route` picks from the shapes (counted once a
call in ``w8a16_gemm.launches`` and in ``w8a16_gemm.launches_by_route``:
``wgmma`` for bf16 prefill, ``decode`` for bf16 at most 16 rows, ``f32``),
or raises; a CPU tensor runs
:func:`w8a16_gemm_plain`, the twin with JAX's math (the dequantized weights,
then ``torch.matmul`` in the compute dtype). :func:`int8_linear` is the
dense layers' product ``x @ dequant(qweight, scale)`` through the same
wrapper.
"""

from __future__ import annotations

import math

import torch

from neuronx_distributed_tpu_torch._device import on_cuda

_DTYPES = (torch.float32, torch.bfloat16)
# B5's routes (csrc/w8a16_gemm.cu): bf16 prefill on wgmma, bf16 decode (at
# most _DECODE_ROWS rows; a cp.async ring over several batch entries, PR
# 13's kernel over one), fp32 SIMT
ROUTES = ("wgmma", "decode", "f32")
_DECODE_ROWS = 16
# the wgmma route's tiles are 128 rows up to this many rows, else 256
_WGMMA_SHORT_ROWS = 128
_SMS = 132
# CTAs of one wave: the wgmma route's persistent grid (one a SM), the
# batched decode kernel four a SM (its 45 KB ring, csrc/w8a16_gemm.cu
# DECODE_SMEM). A route whose output tiles fill a wave takes one split;
# below that K is split into as many parts as still fit one wave, each at
# least _MIN_SPLIT_KTILES k tiles deep so the rings fill. The fp32 route
# and the one-entry decode kernel split as both first did: until about
# _SPLIT_TARGET CTAs, at most _MAX_SPLITS ways.
_WAVE = {"wgmma": _SMS, "decode": 4 * _SMS}
_MIN_SPLIT_KTILES = 8
_SPLIT_TARGET = 4 * _SMS
_MAX_SPLITS = 16


def _tile(route: str, M: int):
    """(k-tile depth, rows, columns) of ``route``'s output tile at M rows
    (``csrc/w8a16_gemm.cu``: tc::BK, Wg<MW>::BM or D_BM, BN; F_BK, F_BM,
    F_BN)."""
    if route == "wgmma":
        return 64, (128 if M <= _WGMMA_SHORT_ROWS else 256), 128
    return {"decode": (64, 16, 128), "f32": (16, 64, 64)}[route]


def _code(route: str, B: int, M: int) -> int:
    """The C entry's kernel: 0 f32, 1 decode over several batch entries (the
    cp.async ring), 4 decode over one (the register-staged kernel, which
    the ring did not beat there), 2 / 3 wgmma with 128- / 256-row tiles."""
    if route == "wgmma":
        return 2 if _tile(route, M)[1] == 128 else 3
    if route == "decode":
        return 1 if B > 1 else 4
    return 0


def _route(B: int, M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The kernel route for these shapes: shapes alone decide, so a rerun
    and a captured program take the same route."""
    if dtype == torch.float32:
        return "f32"
    return "decode" if M <= _DECODE_ROWS else "wgmma"


def _splits(route: str, B: int, M: int, K: int, N: int):
    """(splits, k tiles a split) of ``route`` at these shapes: shapes alone
    decide, so a rerun reduces in the same order."""
    bk, bm, bn = _tile(route, M)
    tiles = max(1, B * math.ceil(M / bm) * math.ceil(N / bn))
    ktiles = math.ceil(K / bk)
    if route == "f32" or _code(route, B, M) == 4:
        want = 1 if tiles >= _SPLIT_TARGET // 2 else min(_MAX_SPLITS, -(-_SPLIT_TARGET // tiles))
    else:
        want = max(1, min(_WAVE[route] // tiles, ktiles // _MIN_SPLIT_KTILES, _MAX_SPLITS))
    per = -(-ktiles // max(1, min(want, ktiles)))
    return -(-ktiles // per), per


def dequantize(qweight: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(q * scale)`` in fp32, cast to ``dtype`` (JAX ``dequantize_leaf``)."""
    return (qweight.float() * scale).to(dtype)


def _check(x, qweight, scale, idx):
    if x.dim() != 3 or qweight.dim() != 3 or qweight.dtype != torch.int8:
        raise ValueError(f"w8a16_gemm takes x (B, M, K) and int8 qweight (E, K, N), got "
                         f"{tuple(x.shape)} and {tuple(qweight.shape)} {qweight.dtype}")
    B, _, K = x.shape
    E, K2, N = qweight.shape
    if K2 != K:
        raise ValueError(f"x has {K} input features, qweight {K2}")
    if scale.dtype != torch.float32 or scale.shape not in ((), (E, 1, N)):
        raise ValueError(f"scale must be fp32 () or ({E}, 1, {N}), got {tuple(scale.shape)} "
                         f"{scale.dtype}")
    if idx.shape != (B,) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be ({B},) int32, got {tuple(idx.shape)} {idx.dtype}")


def _w8a16_kernel(x, qweight, scale, idx):
    from neuronx_distributed_tpu_torch.kernels import _build

    if x.dtype not in _DTYPES:
        raise ValueError(f"w8a16 kernel takes fp32 or bf16 activations, got {x.dtype}")
    B, M, K = x.shape
    E, _, N = qweight.shape
    if x.stride(2) != 1 or x.stride(1) != K or x.stride(0) not in (0, M * K):
        raise ValueError(f"w8a16 kernel needs x rows contiguous with batch stride 0 or M*K, "
                         f"got strides {x.stride()}")
    for name, t in (("qweight", qweight), ("scale", scale), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"w8a16 kernel needs a contiguous {name}")
    if x.dtype == torch.bfloat16:
        # 16-byte loads and TMA rows: 8 activations and 16 weights at a time
        if K % 8 or N % 16 or x.data_ptr() % 16 or qweight.data_ptr() % 16:
            raise ValueError(f"bf16 w8a16 kernel needs K % 8 == 0, N % 16 == 0 and 16-byte "
                             f"aligned x and qweight, got K={K}, N={N}")
    route = _route(B, M, K, N, x.dtype)
    splits, per = _splits(route, B, M, K, N)
    out = torch.empty((B, M, N), dtype=x.dtype, device=x.device)
    work = (torch.empty((splits * B * M * N,), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    per_channel = scale.dim() == 3
    _build.call("w8a16_gemm", _build.ptr(x), _build.ptr(qweight), _build.ptr(scale),
                _build.ptr(idx), _build.ptr(out), _build.ptr(work), B, M, K, N, E,
                x.stride(0), N if per_channel else 0, 1 if per_channel else 0, splits, per,
                _code(route, B, M), _build.stream_of(x.device))
    return out, route


def w8a16_gemm_plain(x: torch.Tensor, qweight: torch.Tensor, scale: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: the chosen experts' int8 weights gathered and
    dequantized to ``x.dtype``, then ``torch.matmul``. One batch entry is a
    2-D product (the dense layers' ``x @ W``, JAX's fold of the leading
    dims), more are a batched one (the expert einsums)."""
    i = idx.long()
    w = dequantize(qweight.index_select(0, i),
                   scale.index_select(0, i) if scale.dim() else scale, x.dtype)
    if x.shape[0] == 1:
        return (x[0] @ w[0])[None]
    return torch.matmul(x, w)


def w8a16_gemm(x: torch.Tensor, qweight: torch.Tensor, scale: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """``out[b] = x[b] @ dequant(qweight[idx[b]], scale[idx[b]])``.

    ``x``: (B, M, K) fp32 or bf16 (a batch stride of 0 broadcasts one x
    over the batch); ``qweight``: (E, K, N) int8; ``scale``: (E, 1, N) fp32
    per output channel or a 0-d fp32 per tensor; ``idx``: (B,) int32.
    Returns (B, M, N) in x's dtype. CUDA tensors launch the kernel, CPU
    tensors run the twin; under ``torch.export`` the call is the
    ``nxdt_torch::w8a16_gemm`` operator."""
    _check(x, qweight, scale, idx)
    if torch.compiler.is_exporting():
        return torch.ops.nxdt_torch.w8a16_gemm(x, qweight, scale, idx)
    return _w8a16_route(x, qweight, scale, idx)   # eager calls skip the operator dispatch


def _w8a16_route(x: torch.Tensor, qweight: torch.Tensor, scale: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """B5's route: CUDA tensors launch the kernel and count the launch, CPU
    tensors run the twin."""
    if not on_cuda(x, qweight, scale, idx):
        return w8a16_gemm_plain(x, qweight, scale, idx)
    out, route = _w8a16_kernel(x, qweight, scale, idx)
    w8a16_gemm.launches += 1
    w8a16_gemm.launches_by_route[route] += 1
    return out


_w8a16_op = torch.library.custom_op("nxdt_torch::w8a16_gemm", mutates_args=())(_w8a16_route)


@_w8a16_op.register_fake
def _(x, qweight, scale, idx):
    return x.new_empty((x.shape[0], x.shape[1], qweight.shape[2]))


w8a16_gemm.launches = 0
w8a16_gemm.launches_by_route = dict.fromkeys(ROUTES, 0)


def int8_linear(x: torch.Tensor, qweight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (K, N), scale)`` through B5: ``scale``
    is (1, N) per output channel or 0-d per tensor. Returns (..., N) in
    x's dtype."""
    K, N = qweight.shape
    lead = x.shape[:-1]
    sc = scale.reshape(1, 1, N) if scale.dim() else scale
    idx = torch.zeros((1,), dtype=torch.int32, device=x.device)
    out = w8a16_gemm(x.reshape(1, -1, K).contiguous(), qweight[None], sc, idx)
    return out.reshape(*lead, N)
