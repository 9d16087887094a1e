"""Synthetic arrival traces for the serving engine, numpy only.

The port's own copy of ``synthetic_trace_stream`` and ``synthetic_trace``
(``neuronx_distributed_tpu/inference/engine.py:4212-4386``): for the same
knobs and seed it draws the same prompts, arrival blocks and tenant labels.
Virtual time is in decode blocks: a request with ``arrival_block`` t is
admitted no earlier than the engine's block t (``ServeEngine.submit``).

The deadline knobs (``ttft_deadline_ms``, ``deadline_ms``) are copied onto
every request, not drawn. Adapter labels (``adapters``, ``adapter_skew``)
and grammar labels (``grammar_frac``, ``grammars``) come from random
streams of their own (seeds ``seed + 0x5A`` and ``seed + 0x67``), so
adding them shifts no other draw.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np

def synthetic_trace_stream(num_requests: int, vocab_size: int, *,
                           prompt_lens: Sequence[int] = (8, 16), max_new_tokens: int = 16,
                           mean_interarrival_blocks: float = 0.5,
                           eos_token_id: Optional[int] = None,
                           shared_prefix_len: int = 0,
                           prefix_families: int = 1,
                           long_prompt_frac: float = 0.0,
                           long_prompt_len: int = 0,
                           ttft_deadline_ms: Optional[float] = None,
                           deadline_ms: Optional[float] = None,
                           tenants: int = 0,
                           tenant_skew: float = 1.0,
                           diurnal: float = 0.0,
                           diurnal_period_blocks: int = 64,
                           burst_every: int = 0,
                           burst_mult: float = 4.0,
                           adapters: int = 0,
                           adapter_skew: float = 1.0,
                           grammar_frac: float = 0.0,
                           grammars: Sequence[str] = (),
                           seed: int = 0) -> Iterator[dict]:
    """One request dict at a time (``prompt``, ``max_new_tokens``,
    ``eos_token_id``, ``arrival_block``, ``ttft_deadline_ms``,
    ``deadline_ms``, and ``tenant`` when ``tenants``):
    exponential inter-arrivals of mean ``mean_interarrival_blocks``, scaled
    by ``1 + diurnal * sin(2 pi t / diurnal_period_blocks)`` and by
    ``burst_mult`` in the first quarter of every ``burst_every`` blocks;
    prompt lengths cycled through ``prompt_lens``, every
    ``round(1 / long_prompt_frac)``-th request (never the first) carrying
    ``long_prompt_len`` tokens instead; ``shared_prefix_len`` tokens of one
    of ``prefix_families`` prefixes (runs of four requests) before each
    prompt; tenants ``t0..`` drawn with P(rank k) proportional to
    1 / (k + 1) ** ``tenant_skew`` (a label only); ``adapter`` ``a0..``
    drawn the same way with ``adapter_skew`` over ``adapters`` names (the
    caller registers every one); ``grammar``, on a ``grammar_frac`` share
    of requests, cycling through ``grammars`` over the constrained ones (JAX
    ``engine.py:4294-4343``)."""
    if not 0.0 <= diurnal < 1.0:
        raise ValueError(f"diurnal must be in [0, 1), got {diurnal}")
    if diurnal_period_blocks < 1:
        raise ValueError(f"diurnal_period_blocks must be >= 1, got {diurnal_period_blocks}")
    if burst_every < 0:
        raise ValueError(f"burst_every must be >= 0, got {burst_every}")
    if burst_mult <= 0:
        raise ValueError(f"burst_mult must be > 0, got {burst_mult}")
    if long_prompt_frac < 0 or long_prompt_frac > 1:
        raise ValueError(f"long_prompt_frac must be in [0, 1], got {long_prompt_frac}")
    if long_prompt_frac > 0 and long_prompt_len < 1:
        raise ValueError("long_prompt_frac > 0 needs long_prompt_len >= 1")
    if tenants < 0:
        raise ValueError(f"tenants must be >= 0, got {tenants}")
    if tenant_skew < 0:
        raise ValueError(f"tenant_skew must be >= 0, got {tenant_skew}")
    if prefix_families < 1:
        raise ValueError(f"prefix_families must be >= 1, got {prefix_families}")
    if adapters < 0:
        raise ValueError(f"adapters must be >= 0, got {adapters}")
    if adapter_skew < 0:
        raise ValueError(f"adapter_skew must be >= 0, got {adapter_skew}")
    if not 0.0 <= grammar_frac <= 1.0:
        raise ValueError(f"grammar_frac must be in [0, 1], got {grammar_frac}")
    if grammar_frac > 0 and not grammars:
        raise ValueError("grammar_frac > 0 needs grammars=(names...)")
    long_every = round(1 / long_prompt_frac) if long_prompt_frac > 0 else 0
    rs = np.random.RandomState(seed)
    prefixes = [rs.randint(1, vocab_size, (shared_prefix_len,)).astype(np.int32)
                for _ in range(prefix_families)]
    tenant_p = None
    if tenants:
        w = 1.0 / np.arange(1, tenants + 1, dtype=np.float64) ** tenant_skew
        tenant_p = w / w.sum()
    grammar_rs = np.random.RandomState(seed + 0x67)
    grammar_count = 0
    adapter_p = None
    adapter_rs = np.random.RandomState(seed + 0x5A)
    if adapters:
        wa = 1.0 / np.arange(1, adapters + 1, dtype=np.float64) ** adapter_skew
        adapter_p = wa / wa.sum()
    t = 0.0
    for i in range(num_requests):
        rate = 1.0
        if diurnal > 0:
            rate *= max(1.0 + diurnal * math.sin(2.0 * math.pi * t / diurnal_period_blocks),
                        0.05)
        if burst_every and int(t) % burst_every < max(1, burst_every // 4):
            rate *= burst_mult
        t += rs.exponential(mean_interarrival_blocks / rate)
        s = int(prompt_lens[i % len(prompt_lens)])
        if long_every and i % long_every == long_every - 1:
            s = int(long_prompt_len)
        tail = rs.randint(1, vocab_size, (s,)).astype(np.int32)
        item = {
            "prompt": (np.concatenate([prefixes[(i // 4) % prefix_families], tail])
                       if shared_prefix_len else tail),
            "max_new_tokens": max_new_tokens,
            "eos_token_id": eos_token_id,
            "arrival_block": int(t),
            # per-request budgets from arrival, the same on every item
            "ttft_deadline_ms": ttft_deadline_ms,
            "deadline_ms": deadline_ms,
        }
        if tenant_p is not None:
            item["tenant"] = f"t{int(rs.choice(tenants, p=tenant_p))}"
        if adapter_p is not None:
            item["adapter"] = f"a{int(adapter_rs.choice(adapters, p=adapter_p))}"
        if grammar_frac > 0 and grammar_rs.random_sample() < grammar_frac:
            # names cycle over the constrained requests, so every grammar
            # sees traffic at any share
            item["grammar"] = grammars[grammar_count % len(grammars)]
            grammar_count += 1
        yield item


def synthetic_trace(num_requests: int, vocab_size: int, **kw) -> List[dict]:
    """:func:`synthetic_trace_stream` as a list (the same knobs and draws)."""
    return list(synthetic_trace_stream(num_requests, vocab_size, **kw))
