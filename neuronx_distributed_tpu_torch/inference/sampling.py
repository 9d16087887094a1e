"""Token samplers: greedy, temperature, top-k and top-p.

Counterpart of ``neuronx_distributed_tpu/inference/sampling.py``. The JAX
package draws a categorical as ``argmax(logits + gumbel(key))``; here the
pure function underneath is :func:`categorical_from_gumbel`, with the
Gumbel noise passed in, and the draw takes an explicit
``torch.Generator``. The two frameworks' generators give different bits for
the same seed, so parity tests feed both the same noise.
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
