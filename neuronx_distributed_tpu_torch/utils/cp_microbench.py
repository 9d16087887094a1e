"""CP-vs-SP attention microbench on one card.

Counterpart of ``neuronx_distributed_tpu/utils/cp_microbench.py``
(``measure_cp_ratio``). Equal global tokens, real kernels: the SP side runs
B1 and B3a/B3b causally over the whole ``seq`` with ``heads/tp`` heads
(one tensor-parallel rank's share); the CP side runs ``cp`` ring steps of
B1 over ``seq/cp`` local tokens with all ``heads`` heads under the zigzag
schedule and ``cp`` block-gradient calls under the global LSE and delta,
through the ring op's own per-rank loop
(:func:`ops.ring_attention.ring_forward_steps`, ``ring_backward_steps``;
merges, fp32 dK/dV accumulators and all). Every rank's work is the same under zigzag, so rank 0 stands
in for all. The two sides' trials alternate (sp, cp, sp, cp, ...) so
drift hits both alike; each side's time is the least over its trials.

On one card there is no ring transfer: ``cp_vs_sp_throughput`` excludes
it (the full-overlap bound); ``ring_bytes_per_step`` is what one rank
would send a step (its K and V block).
"""

from __future__ import annotations

import math
import time

import torch

from neuronx_distributed_tpu_torch.kernels.flash_attn import (
    default_attention_blocks,
    flash_block_forward,
    flash_block_grads,
    flash_supported,
)
from neuronx_distributed_tpu_torch.ops.ring_attention import (
    _rank_positions,
    ring_backward_steps,
    ring_forward_steps,
)


def measure_cp_ratio(seq: int, cp: int = 2, heads: int = 32, head_dim: int = 128, tp: int = 2,
                     trials: int = 5, device="cuda", dtype=torch.bfloat16, seed: int = 0
                     ) -> dict:
    """Time one SP rank's and one CP rank's attention forward and backward
    at ``seq`` global tokens (CUDA events on a card; the host clock, named
    so, on the CPU). Raises JAX's errors for shapes the ring refuses."""
    if seq % (2 * cp):
        raise ValueError(f"--cp bench needs seq divisible by 2*cp={2 * cp}, got {seq}")
    s_loc = seq // cp
    bq, bk = default_attention_blocks(s_loc)
    sbq, sbk = default_attention_blocks(seq)
    if not (flash_supported(s_loc, s_loc, bq, bk) and flash_supported(seq, seq, sbq, sbk)):
        raise ValueError(f"seq {seq}: block alignment unsupported "
                         f"(s_loc={s_loc} vs {(bq, bk)}, seq vs {(sbq, sbk)})")
    dev = torch.device(device)
    sm = 1.0 / math.sqrt(head_dim)
    h_sp = heads // tp
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    sp_ops = [rand(h_sp, seq, head_dim) for _ in range(4)]
    cp_ops = [rand(heads, s_loc, head_dim) for _ in range(4)]
    iota = torch.arange(seq, dtype=torch.int32, device=dev).reshape(1, 1, seq)
    pos = [_rank_positions(r, cp, s_loc, "zigzag", dev).reshape(1, 1, s_loc) for r in range(cp)]

    def sp_step(q, k, v, do):
        o, lse = flash_block_forward(q, k, v, iota, iota, sm, sbq, sbk, 1, h_sp)
        delta = (do.float() * o.float()).sum(-1)
        return flash_block_grads(q, k, v, do, lse, delta, iota, iota, sm, sbq, sbk, 1, h_sp)

    def cp_step(q, k, v, do):   # rank 0 holds the block of rank -i mod cp at step i
        args = (pos[0], lambda i: pos[-i % cp], lambda t: t, cp, sm, bq, bk, 1, heads)
        o, lse = ring_forward_steps(q, k, v, *args)
        return ring_backward_steps(q, k, v, do, o.to(q.dtype), lse, *args)

    def timed(fn, ops) -> float:
        if dev.type != "cuda":
            t0 = time.perf_counter()
            fn(*ops)
            return (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*ops)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    timed(sp_step, sp_ops)   # warm: builds and first launches
    timed(cp_step, cp_ops)
    ts_sp, ts_cp = [], []
    for _ in range(trials):
        ts_sp.append(timed(sp_step, sp_ops))
        ts_cp.append(timed(cp_step, cp_ops))
    t_sp, t_cp = min(ts_sp), min(ts_cp)
    return {"seq": seq, "cp": cp, "tp": tp, "heads": heads, "head_dim": head_dim,
            "layout": "zigzag", "device": (torch.cuda.get_device_name(dev)
                                           if dev.type == "cuda" else "cpu (host clock)"),
            "sp_rank_ms": t_sp, "cp_rank_ms": t_cp, "cp_vs_sp_throughput": t_sp / t_cp,
            "sp_trials_ms": ts_sp, "cp_trials_ms": ts_cp,
            "ring_bytes_per_step": 2 * heads * s_loc * head_dim * cp_ops[0].element_size(),
            "note": "one card: the ring transfer is excluded (the full-overlap bound)"}
