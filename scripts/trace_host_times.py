#!/usr/bin/env python3
"""Where the host's time goes in the smoke trace's three passes.

    python3 scripts/trace_host_times.py

Builds the kernels, loads Llama-3-8B full width (random bf16 weights, as
``chip_smoke.py``), wraps the serving engine's and ``CausalLM``'s
host-side methods with wall-clock timers (no device synchronisation is
added), serves ``chip_smoke``'s synthetic trace once per pass (one-shot,
chunks of 512, chunks of 512 in the pipelined loop) and prints, per pass,
its wall seconds and tokens/s and each method's total host milliseconds and
call count. A method's host time includes any wait for the device inside
it, so a forward whose launches queue behind a running decode block reads
longer than one launched onto an idle card. Needs one NVIDIA GPU.
"""

import collections
import functools
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import torch

    import chip_smoke as cs
    from neuronx_distributed_tpu_torch.inference import engine as E
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    clock = time.perf_counter
    total, calls = collections.defaultdict(float), collections.Counter()

    def timed(cls, name):
        fn = getattr(cls, name)

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t0 = clock()
            out = fn(*a, **kw)
            total[f"{cls.__name__}.{name}"] += clock() - t0
            calls[f"{cls.__name__}.{name}"] += 1
            return out

        setattr(cls, name, wrapper)

    for name in ("_admit", "_advance_prefill", "_advance_block", "_retire_finished",
                 "_dispatch_block_async", "_harvest_inflight", "_insert_group",
                 "_finish_prefill", "_stage", "_first_tokens", "_draw", "_record"):
        timed(E.ServeEngine, name)
    for name in ("extend", "insert", "retire", "_forward"):
        timed(CausalLM, name)

    _build.build()
    cfg = cs.serve_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    lm = CausalLM(cfg, params, LlamaForCausalLM, buckets=cs.TRACE_BUCKETS, max_batch=8,
                  page_size=16, paged_attn_kernel=True, device="cuda")
    trace = synthetic_trace(cs.TRACE_REQUESTS, cfg.vocab_size, **cs.TRACE_KNOBS)
    warm = E.ServeEngine(lm, block_steps=8, prefill_chunk_tokens=cs.TRACE_CHUNK)
    warm.submit(trace[3]["prompt"][:1100], 2)
    warm.run()
    warm = E.ServeEngine(lm, block_steps=8)
    warm.submit(trace[0]["prompt"], 2)
    warm.submit(trace[3]["prompt"], 2)
    warm.run()
    del warm
    card = cs.card_line()
    for label, chunk, async_loop in cs.TRACE_PASSES:
        total.clear()
        calls.clear()
        t0 = clock()
        st = cs.trace_pass(lm, "cuda", trace, chunk, async_loop,
                           (flash_block_forward, paged_decode_attention))
        print(f"pass ({label}): wall {clock() - t0:.3f} s, {st['tokens_per_s']:.1f} tok/s, "
              f"{st['decode_blocks']} decode blocks [{card}]", flush=True)
        for name, s in sorted(total.items(), key=lambda kv: -kv[1]):
            print(f"   {name:40s} {s * 1e3:9.1f} ms  x{calls[name]}", flush=True)


if __name__ == "__main__":
    main()
