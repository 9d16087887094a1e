"""Token samplers: greedy, temperature, top-k and top-p.

Counterpart of ``neuronx_distributed_tpu/inference/sampling.py``. The JAX
package draws a categorical as ``argmax(logits + gumbel(key))``; here the
pure function underneath is :func:`categorical_from_gumbel`, with the
Gumbel noise passed in. The noise comes from an explicit
``torch.Generator`` (:func:`gumbel_noise`) or, for the serving engine and
``generate``, from :func:`counter_gumbel`: a pure function of a per-row
key and a token counter, in integer tensor ops that give the same bits on
the CPU and the GPU and run inside a captured CUDA graph (the counterpart
of JAX's ``fold_in(fold_in(base, r), t)``). The two frameworks' generators
give different bits for the same seed, so parity tests feed both the same
noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


def apply_top_k_top_p(logits: torch.Tensor, top_k: Optional[int],
                      top_p: Optional[float]) -> torch.Tensor:
    """Mask ``logits`` (..., vocab) to the top-k / nucleus-p support (−1e30
    outside). Exactly k survive top-k: ties at the k-th value go to the
    lower index, as ``lax.top_k`` orders them (a stable descending sort)."""
    if top_k is not None:
        vocab = logits.shape[-1]
        if top_k > vocab:
            raise ValueError(f"top_k {top_k} exceeds vocab size {vocab}")
        idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :top_k]
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, idx, True)
        logits = torch.where(keep, logits, NEG_INF)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` from an explicit generator."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


_M32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def request_seed(seed: int, request_id: int) -> int:
    """Key of request ``request_id``'s noise under an engine ``seed`` (a
    splitmix64-style mix, below 2**63): the host gives it to the row at
    admission and the device adds the token counter (:func:`counter_gumbel`),
    so a request's stream does not depend on the schedule."""
    h = 0x9E3779B97F4A7C15
    for v in (seed, request_id):
        h = ((h ^ (int(v) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


def split_key(key: int):
    """A key's low and high 32 bits as int32 values (two's complement), the
    form the per-slot state carries."""
    lo, hi = key & _M32, (key >> 32) & _M32
    return tuple(int(v - (1 << 32)) if v >= 1 << 31 else int(v) for v in (lo, hi))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the product is
    taken in 16-bit halves, so no intermediate passes 2**49 and the bits are
    the same on every device."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche finalizer (xor-shift-multiply, lowbias32's
    constants) over int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_gumbel(key_lo: torch.Tensor, key_hi: torch.Tensor, counts: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """Counter-based standard Gumbel noise ``(b, vocab)`` fp32 for rows with
    keys ``(key_hi << 32) | key_lo`` (int32 or int64 tensors holding the
    32-bit halves) at token counters ``counts`` (b,): a pure function of
    (key, count, column), so fused, stepwise and differently scheduled runs
    draw the same noise for a request's t-th token. Integer mixing in int64
    ops (the same bits on CPU and GPU, no host read), then
    :func:`gumbel_from_bits`."""
    m = lambda t: t.long() & _M32  # noqa: E731
    row = _mix32(m(key_hi) ^ _mix32(m(key_lo) ^ _mix32((m(counts) + 0x9E3779B9) & _M32)))
    column = _mix32(torch.arange(vocab, dtype=torch.int64, device=counts.device) + 0x85EBCA6B)
    return gumbel_from_bits(_mix32(column[None, :] ^ row[:, None]))


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from 32-bit hash values (int64 in [0, 2**32)):
    a uniform from the top 23 bits, ``u = (v + 1/2) / 2**23`` in
    [2**-24, 1 - 2**-24] (exact in fp32, so never 0 or 1), then
    ``-log(-log(u))``, finite for every input."""
    u = ((bits >> 9).float() + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def draw_rows(logits: torch.Tensor, key_lo: torch.Tensor, key_hi: torch.Tensor,
              counts: torch.Tensor, temperature: torch.Tensor, greedy: torch.Tensor,
              slot_sampler: "SlotSampler", allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each row's token (b,) int32: the :class:`SlotSampler` draw under the
    row's :func:`counter_gumbel` noise at its token counter. The one draw
    of the fused decode block, the engine's stepwise route and
    ``generate``. ``allowed`` (b, vocab) bool is a grammar's support
    (``grammar.py``): the other logits are floored to −1e30 before the
    noise and the greedy argmax (JAX ``sampling.py:98``), so both branches
    draw inside it; an all-True row leaves its logits untouched."""
    logits = logits.float()
    if allowed is not None:
        logits = torch.where(allowed, logits, NEG_INF)
    noise = counter_gumbel(key_lo, key_hi, counts, logits.shape[-1])
    return slot_sampler(logits, temperature, greedy, noise)


def categorical_from_gumbel(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """The categorical draw given its noise: ``argmax(logits + gumbel)``."""
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Sampler:
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False

    def __call__(self, logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """logits (..., vocab) -> token ids (...). A sampled draw needs the
        noise or a generator to make it."""
        logits = logits.float()
        if self.greedy or self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        masked = apply_top_k_top_p(logits / self.temperature, self.top_k, self.top_p)
        if gumbel is None:
            if generator is None:
                raise ValueError("a sampled draw needs a torch.Generator or its gumbel noise")
            gumbel = gumbel_noise(masked.shape, generator, masked.device)
        return categorical_from_gumbel(masked, gumbel)


@dataclasses.dataclass(frozen=True)
class SlotSampler:
    """Per-slot sampler for the continuous-batching engine: each row
    carries its own greedy flag and temperature as tensors; ``top_k``/
    ``top_p`` are engine-wide. Row math is identical to :class:`Sampler` at
    the same settings. ``gumbel`` (b, vocab) is each row's own noise (the
    engine derives it per request and token), needed only when some row
    samples."""

    top_k: Optional[int] = None
    top_p: Optional[float] = None

    def __call__(self, logits: torch.Tensor, temperature: torch.Tensor,
                 greedy: torch.Tensor, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = logits.float()
        arg = torch.argmax(logits, dim=-1).to(torch.int32)
        if gumbel is None:
            return arg
        safe_t = torch.clamp_min(temperature, 1e-6)[:, None]
        masked = apply_top_k_top_p(logits / safe_t, self.top_k, self.top_p)
        sampled = categorical_from_gumbel(masked, gumbel)
        return torch.where(greedy | (temperature <= 0.0), arg, sampled)
