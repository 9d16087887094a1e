"""Single-pass AdamW update per leaf: CUDA kernel and plain PyTorch twin.

Counterpart of ``neuronx_distributed_tpu/optimizer/fused_kernel.py``. One
pass reads the grad (in the param dtype), mu, nu and the fp32 master, and
writes mu, nu and the master in place and the new param in its dtype; the
clip scale and the step's lr and bias corrections ride in as a ``(1, 4)``
fp32 tensor on the device, so the step needs no host sync.

:func:`fused_adamw_leaf` is the kernel wrapper: a CUDA tensor launches
``csrc/adamw.cu`` (counted in ``fused_adamw_leaf.launches``), a CPU tensor
runs :func:`fused_adamw_leaf_plain`. Only leaves that
:func:`leaf_supported` accepts take this route, the same rule as the JAX
package, so the same leaves take the kernel.
"""

from __future__ import annotations

import torch

from neuronx_distributed_tpu_torch._device import on_cuda

_W = 1024          # lane width of the JAX kernel's (rows, 1024) view
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def leaf_supported(n: int) -> bool:
    """Tileable in the JAX kernel's terms: flattens to (rows, 1024) with rows
    divisible by 8."""
    return n >= 8 * _W and n % (8 * _W) == 0


def _check(g, mu, nu, ms, scalars):
    n = g.numel()
    if not leaf_supported(n):
        raise ValueError(f"leaf of {n} elements is not a multiple of {8 * _W}: it takes the "
                         "plain update")
    for name, t in (("mu", mu), ("nu", nu), ("master", ms)):
        if t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"{name} must be fp32 with {n} elements, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if scalars.shape != (1, 4) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars must be fp32 (1, 4), got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")


def _check_out(g, out, p_dtype):
    if out is not None and (out.dtype != p_dtype or out.shape != g.shape):
        raise ValueError(f"out must be {p_dtype} {tuple(g.shape)}, got {out.dtype} "
                         f"{tuple(out.shape)}")


def fused_adamw_leaf_plain(g, mu, nu, ms, scalars, *, b1, b2, eps, wd, p_dtype, out=None):
    """The kernel's arithmetic one PyTorch operation at a time, in the JAX
    kernel's order; updates mu, nu and ms in place and returns
    ``(mu, nu, ms, p)`` (``p`` is ``out`` when one is given)."""
    _check_out(g, out, p_dtype)
    scale, lr, bc1, bc2 = scalars[0, 0], scalars[0, 1], scalars[0, 2], scalars[0, 3]
    g32 = g.reshape(ms.shape).float() * scale
    mu2 = b1 * mu + (1 - b1) * g32
    nu2 = b2 * nu + (1 - b2) * g32 * g32
    ms2 = ms - lr * ((mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps) + wd * ms)
    mu.copy_(mu2)
    nu.copy_(nu2)
    ms.copy_(ms2)
    if out is not None:
        return mu, nu, ms, out.copy_(ms2.reshape(g.shape))
    return mu, nu, ms, ms2.to(p_dtype).reshape(g.shape)


def fused_adamw_leaf(g, mu, nu, ms, scalars, *, b1, b2, eps, wd, p_dtype, out=None):
    """One leaf's update: mu, nu and the master ``ms`` change in place (the
    JAX kernel's aliases); returns ``(mu, nu, ms, p)`` with ``p`` the new
    param in ``p_dtype``, shaped like ``g``: written into ``out`` when one is
    given (a donated param), else into a new tensor. ``scalars`` is a
    ``(1, 4)`` fp32 tensor ``[clip_scale, lr, bias_corr1, bias_corr2]``."""
    _check(g, mu, nu, ms, scalars)
    _check_out(g, out, p_dtype)
    if not on_cuda(g, mu, nu, ms, scalars):
        return fused_adamw_leaf_plain(g, mu, nu, ms, scalars, b1=b1, b2=b2, eps=eps, wd=wd,
                                      p_dtype=p_dtype, out=out)
    from neuronx_distributed_tpu_torch.kernels import _build

    if g.dtype not in _DTYPES or p_dtype not in _DTYPES:
        raise ValueError(f"the AdamW kernel takes fp32 or bf16 grads and params, got "
                         f"{g.dtype} and {p_dtype}")
    p = torch.empty(g.shape, dtype=p_dtype, device=g.device) if out is None else out
    for name, t in (("g", g), ("mu", mu), ("nu", nu), ("master", ms), ("p", p),
                    ("scalars", scalars)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the AdamW kernel needs a contiguous, 16-byte aligned {name}")
    _build.call("fused_adamw", *map(_build.ptr, (g, mu, nu, ms, p, scalars)), g.numel(),
                float(b1), float(1.0 - b1), float(b2), float(1.0 - b2), float(eps), float(wd),
                _DTYPES[g.dtype], _DTYPES[p_dtype], _build.stream_of(g.device))
    fused_adamw_leaf.launches += 1
    return mu, nu, ms, p


fused_adamw_leaf.launches = 0
