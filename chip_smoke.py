#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neuronx_distributed_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build   every CUDA kernel of the serving path from ``csrc/`` (one
           ``nvcc`` per source, all started together);
2. kernels each kernel at the serving shapes, in bf16, against its plain
           PyTorch twin on the same inputs (max abs error beside the stated
           tolerance), timed beside the twin, one PyTorch library call
           (timed only, never used by the port) and the card's bound;
3. check   a small fp32 model served through ``CausalLM`` on the GPU
           (kernels) and on the CPU (twins): logits must agree;
4. serve   Llama-3-8B at full width (random bf16 weights from a seeded
           generator) behind ``ServeEngine``: the launch counters are set to
           0 just before and read just after, and every kernel must have run;
           every logit must be finite and every request complete.

``--profile PATH`` serves the workload a second time under
``torch.profiler`` (device activity only), prints the device's busy share
of that run's wall time and writes its kernel table to PATH.

Before its last line it prints one JSON object with every kernel's numbers
and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): the bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel vs twin at the seeded serving shapes, bf16 operands with fp32
# accumulation on both sides, outputs rounded to bf16. Each limit is set
# from the readings on an H100: B1's outputs differ by at most 0.00195, one
# bf16 last place at |x| in [0.25, 0.5) (the averages over 100-500 keys are
# mostly below 0.5), so 4e-3 admits one last place below |x| = 1 and no
# more; B2 matches its twin bit for bit (0.0) on bf16 and int8 pools; the
# LSE reads 9.5e-7.
TOL_FLASH_BF16 = 4e-3
TOL_PAGED_BF16 = 1e-3
TOL_LSE = 1e-3
# the small fp32 model: kernels vs twins on the CPU, summation order only
TOL_LOGITS_FP32 = 2e-3

SERVE_PROMPT_LENS = (100, 180, 316, 376, 300, 420, 500, 150)
SHARED_PREFIX = 256       # requests 2 and 3 share their first 256 tokens
MAX_NEW_TOKENS = 32


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, flush) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, each after the 50 MB
    L2 is flushed, each timed by its own pair of CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# --- phase 2: kernels vs twins -------------------------------------------------


def flash_case(dev, b=6, h=32, hk=8, sq=512, sk=4096, d=128, pad_rows=12, pad_keys=5):
    """B1 at the largest prefill of the serve phase: 6 rows of the 512-token
    bucket attending over the 4096-token logical view; pad query rows (-1)
    and INVALID_POS keys added."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import INVALID_POS

    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    q = torch.randn((b * h, sq, d), generator=g, device=dev).to(bf)
    k = torch.randn((b * hk, sk, d), generator=g, device=dev).to(bf)
    v = torch.randn((b * hk, sk, d), generator=g, device=dev).to(bf)
    qpos = torch.arange(sq, dtype=torch.int32, device=dev).repeat(b, 1)
    qpos[:, sq - pad_rows:] = -1
    kpos = torch.arange(sk, dtype=torch.int32, device=dev).repeat(b, 1)
    kpos[:, 200:200 + pad_keys] = INVALID_POS
    return q, k, v, qpos.reshape(b, 1, sq), kpos.reshape(b, 1, sk), h, hk


def run_flash(dev, flush, reps=10):
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
    )

    q, k, v, qp, kp, h, hk = flash_case(dev)
    bh, sq, d = q.shape
    b, sk = bh // h, k.shape[1]
    args = (q, k, v, qp, kp, d ** -0.5, 64, 64, h // hk, h)
    out, lse = flash_block_forward(*args)
    torch.cuda.synchronize()
    ref, ref_lse = flash_block_forward_plain(*args)
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())   # pad rows: -1e30 on both sides
    check(err <= TOL_FLASH_BF16, f"flash_fwd out differs from its twin by {err}")
    check(lse_err <= TOL_LSE, f"flash_fwd lse differs from its twin by {lse_err}")
    check(bool(torch.isfinite(out).all()), "flash_fwd produced non-finite values")

    mask = kp.reshape(b, 1, 1, sk) <= qp.reshape(b, 1, sq, 1)    # (b, 1, sq, sk)
    q4, k4, v4 = q.reshape(b, h, sq, d), k.reshape(b, hk, sk, d), v.reshape(b, hk, sk, d)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    pairs = int(mask.sum()) * h                         # visible (query, key) pairs
    flops = 4 * pairs * d
    # the bytes the function needs: q, positions, out and LSE once each, and
    # only the K/V rows that some query of their batch row can see (the
    # block skip reads no other tile)
    seen_keys = int(mask.any(dim=2).sum())              # over (b, key)
    moved = nbytes(q, qp, kp, out, lse) + 2 * hk * seen_keys * d * k.element_size()
    return dict(
        name="flash_fwd", route="cuda",
        source="neuronx_distributed_tpu_torch/csrc/flash_fwd.cu",
        replaces="neuronx_distributed_tpu/kernels/flash_attn.py:67",
        shape=f"q ({bh}, {sq}, {d}) bf16, k/v ({k.shape[0]}, {sk}, {d}), group {h // hk}",
        max_abs_err=err, lse_max_abs_err=lse_err, tolerance=TOL_FLASH_BF16,
        lse_tolerance=TOL_LSE, ref_max_abs=float(ref.float().abs().max()),
        visible_keys=seen_keys,
        ms=time_ms(lambda: flash_block_forward(*args), reps, flush),
        plain_ms=time_ms(lambda: flash_block_forward_plain(*args), max(2, reps // 5), flush),
        library_ms=time_ms(library, reps, flush),
        **bound(flops, moved))


def paged_case(dev, pool, b=8, n_q=32, n_kv=8, hd=128, ps=16, max_seq_len=4096):
    """B2 at the serving decode shape: 8 rows, ragged cache lengths over a
    4096-token table, stale bytes in every page."""
    import torch

    from neuronx_distributed_tpu_torch.inference.paged_kernel import quantize_kv_pages

    g = torch.Generator(device=dev).manual_seed(12)
    ppseq = max_seq_len // ps
    pages = b * ppseq + b
    q = torch.randn((b, 1, n_q, hd), generator=g, device=dev).to(torch.bfloat16)
    kf = torch.randn((pages, ps, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    vf = torch.randn((pages, ps, n_kv, hd), generator=g, device=dev).to(torch.bfloat16)
    table = torch.randperm(pages, generator=g, device=dev)[: b * ppseq].reshape(b, ppseq)
    cache_len = torch.tensor([0, 100, 131, 255, 256, 357, 420, 531][:b],
                             dtype=torch.int32, device=dev)
    kw = {}
    if pool == "int8":
        kf, ks = quantize_kv_pages(kf)
        vf, vs = quantize_kv_pages(vf)
        kw = dict(k_scale=ks, v_scale=vs)
    return (q, kf, vf, table.int().contiguous(), cache_len), kw


def run_paged(dev, flush, reps=20):
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.inference.paged_kernel import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    errs = {}
    for pool in ("int8", "bf16"):   # bf16 last: its inputs are the ones timed
        args, kw = paged_case(dev, pool)
        out = paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_decode_attention_plain(*args, **kw)
        errs[pool] = float((out.float() - ref.float()).abs().max())
        check(errs[pool] <= TOL_PAGED_BF16,
              f"paged_decode ({pool} pool) differs from its twin by {errs[pool]}")
        check(bool(torch.isfinite(out).all()), "paged_decode produced non-finite values")
    q, kp, vp, table, cache_len = args
    b, _, n_q, hd = q.shape
    _, ps, n_kv, _ = kp.shape
    s_max = table.shape[1] * ps

    def library():
        k_all = kp[table.long()].reshape(b, s_max, n_kv, hd).transpose(1, 2)
        v_all = vp[table.long()].reshape(b, s_max, n_kv, hd).transpose(1, 2)
        mask = (torch.arange(s_max, device=dev)[None, :] <= cache_len[:, None].long())
        return F.scaled_dot_product_attention(q.transpose(1, 2), k_all, v_all,
                                              attn_mask=mask[:, None, None, :],
                                              enable_gqa=True)

    # the work this run's data needs: the pages up to each row's cache_len
    lens = cache_len.long().cpu()
    pages_read = int(((lens // ps) + 1).sum())
    page_bytes = ps * n_kv * hd * kp.element_size()
    # K and V pages and their block-table entries read, q read, out written
    moved = 2 * pages_read * page_bytes + pages_read * 4 + 2 * nbytes(q) + nbytes(cache_len)
    flops = 4 * n_q * hd * int((lens + 1).sum())
    return dict(
        name="paged_decode", route="cuda",
        source="neuronx_distributed_tpu_torch/csrc/paged_decode.cu",
        replaces="neuronx_distributed_tpu/inference/paged_kernel.py:102",
        shape=f"q ({b}, 1, {n_q}, {hd}) bf16, bf16 pools ({kp.shape[0]}, {ps}, {n_kv}, {hd}), "
              f"cache_len {lens.tolist()}",
        max_abs_err=errs["bf16"], int8_pool_max_abs_err=errs["int8"],
        tolerance=TOL_PAGED_BF16,
        ms=time_ms(lambda: paged_decode_attention(*args), reps, flush),
        plain_ms=time_ms(lambda: paged_decode_attention_plain(*args), max(2, reps // 5), flush),
        library_ms=time_ms(library, reps, flush),
        **bound(flops, moved))


def bound(flops: float, moved: float) -> dict:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=moved)


# --- phase 3: small model, GPU kernels vs CPU twins ---------------------------------


def small_config():
    import torch

    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig

    # head_dim 128 (a kernel width), GQA group 2, fp32 end to end
    return LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                       num_heads=4, num_kv_heads=2, max_seq_len=256, rope_theta=500000.0,
                       dtype=torch.float32, param_dtype=torch.float32)


def reference_check(dev) -> float:
    """Insert logits (bucket 128: the flash gate) and four paged decode
    steps of one fp32 model, on ``dev`` and on the CPU. Returns the max abs
    logit difference."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    cfg = small_config()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    kw = dict(buckets=(128,), max_batch=3, page_size=16, paged_attn_kernel=True)
    lms = [CausalLM(cfg, params, LlamaForCausalLM, device=d, **kw) for d in (dev, "cpu")]
    sessions = [lm.start_session() for lm in lms]
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, cfg.vocab_size, (2, 120)).astype(np.int32)
    lengths = np.array([120, 101], np.int32)
    slots = np.array([0, 2])
    outs = [lm.insert(s, slots, prompts, lengths=lengths).float().cpu()
            for lm, s in zip(lms, sessions)]
    worst = float((outs[0] - outs[1]).abs().max())
    tok = np.zeros(3, np.int32)
    tok[slots] = outs[1].argmax(-1).numpy()
    for _ in range(4):
        outs = [lm.step(s, tok).float().cpu() for lm, s in zip(lms, sessions)]
        worst = max(worst, float((outs[0] - outs[1]).abs().max()))
        tok = outs[1].argmax(-1).numpy().astype(np.int32)
    check(worst <= TOL_LOGITS_FP32,
          f"small-model logits on the GPU differ from the CPU twins by {worst}")
    return worst


# --- phase 4: serve Llama-3-8B -------------------------------------------------------


def serve_config():
    import torch

    from neuronx_distributed_tpu_torch.models.llama import llama3_8b

    return llama3_8b(max_seq_len=4096, dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def serve_prompts(vocab: int, seed: int = 5):
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in SERVE_PROMPT_LENS]
    prompts[3][:SHARED_PREFIX] = prompts[2][:SHARED_PREFIX]
    return prompts


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def run_workload(lm, dev, block_steps, before_run=None):
    """One engine serving the smoke workload to the end; returns the engine,
    its completions and the wall seconds of ``run()``."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine

    engine = ServeEngine(lm, block_steps=block_steps)
    for i, p in enumerate(serve_prompts(lm.config.vocab_size)):
        # the second prefix sharer arrives one block later, after the first
        # has registered its pages
        engine.submit(p, MAX_NEW_TOKENS, arrival_block=1 if i == 3 else 0)
    if before_run is not None:
        before_run()
    _sync(dev)
    t0 = time.perf_counter()
    done = engine.run()
    _sync(dev)
    return engine, done, time.perf_counter() - t0


def profile_workload(lm, dev, block_steps, path: str) -> dict:
    """The workload once more under ``torch.profiler``, tracing device
    activity only (no per-operator host records, which slow the host the
    device waits on): the device's busy share of this same run's wall time
    and the kernels by device time (table at ``path``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, done, wall = run_workload(lm, dev, block_steps)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler recorded no device activity")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(sort_by="self_device_time_total",
                                                    row_limit=60))
    return dict(wall_s=wall, device_busy_s=busy_us / 1e6, device_busy_share=busy_us / 1e6 / wall,
                tokens=sum(len(c.tokens) for c in done),
                top=[dict(name=e.key[:90], calls=e.count, ms=e.self_device_time_total / 1e3,
                          share=e.self_device_time_total / busy_us) for e in kernels[:12]])


def serve(cfg, dev, counters, block_steps=8, max_batch=8, profile_path=None):
    """Serve the workload once with the launch counters zeroed just before
    ``run()``; returns the printed metrics (and a profile of a second run
    when ``profile_path`` is given)."""
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    lm = CausalLM(cfg, params, LlamaForCausalLM, buckets=(128, 512), max_batch=max_batch,
                  page_size=16, paged_attn_kernel=True, device=dev)
    del params
    finite = torch.ones((), dtype=torch.bool, device=dev)
    seen = []

    def watch(_module, _inputs, logits):
        nonlocal finite
        finite = finite & torch.isfinite(logits).all()
        seen.append(tuple(logits.shape))

    lm.model.register_forward_hook(watch)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    # warm-up on a throwaway engine (library handles, allocator)
    warm = ServeEngine(lm, block_steps=block_steps)
    warm.submit(serve_prompts(cfg.vocab_size, seed=6)[0][:130], 4)
    warm.run()
    seen.clear()

    def zero_counters():
        for c in counters:
            c.launches = 0

    engine, done, wall = run_workload(lm, dev, block_steps, before_run=zero_counters)
    launches = {c.__name__: c.launches for c in counters}

    check(bool(finite), "non-finite logits while serving")
    check(len(done) == len(SERVE_PROMPT_LENS),
          f"{len(done)} of {len(SERVE_PROMPT_LENS)} requests completed")
    for c in done:
        check(len(c.tokens) == MAX_NEW_TOKENS, f"request {c.request_id} gave {len(c.tokens)}")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"request {c.request_id} gave a token outside the vocabulary")
    check(all(s[-1] == cfg.vocab_size for s in seen), f"logit shapes {sorted(set(seen))}")
    ttft = sorted(c.token_ts[0] - c.submit_ts for c in done)
    tokens = sum(len(c.tokens) for c in done)
    pkv = engine.session.paged
    stats = dict(
        layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
        requests=len(done), generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1], setup_s=setup_s,
        kv_pool_bytes=lm.kv_cache_bytes(), decode_blocks=engine.decode_blocks,
        inserts=engine.inserts, prefix_hit_tokens=pkv.prefix_hit_tokens,
        launches=launches,
        launches_per_token={k: v / tokens for k, v in launches.items()})
    if profile_path is not None:
        del engine
        stats["profile"] = profile_workload(lm, dev, block_steps, profile_path)
    return stats


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="also serve the workload once under torch.profiler and write "
                             "the kernel table to PATH")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import neuronx_distributed_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: imported the port from {port.__file__}, not from {ROOT}",
              file=sys.stderr)
        return 1
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{n} {s:.1f} s" for n, s in _build.build_seconds.items()), flush=True)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)   # 256 MB > L2
    kernels = [run_flash(dev, flush), run_paged(dev, flush)]
    for k in kernels:
        print(f"kernel {k['name']}: {k['shape']}; max_abs_err {k['max_abs_err']:.3g} "
              f"(tol {k['tolerance']}); {k['ms']:.4f} ms, twin {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}) [{card}]", flush=True)
    del flush

    worst = reference_check(dev)
    print(f"check: small fp32 model, GPU kernels vs CPU twins, max |logit diff| "
          f"{worst:.3g} (tol {TOL_LOGITS_FP32})", flush=True)

    counters = (flash_block_forward, paged_decode_attention)
    stats = serve(serve_config(), dev, counters, profile_path=args.profile)
    print(f"serve: llama3_8b full width ({stats['layers']} layers, no depth cut), "
          f"{stats['requests']} requests, {stats['generated_tokens']} tokens in "
          f"{stats['wall_s']:.3f} s = {stats['tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{stats['ttft_s_p50'] * 1e3:.1f} ms max {stats['ttft_s_max'] * 1e3:.1f} ms, "
          f"KV pool {stats['kv_pool_bytes']} bytes, prefix hit tokens "
          f"{stats['prefix_hit_tokens']}, launches {stats['launches']} [{card}]", flush=True)
    for k in kernels:
        k["launches"] = stats["launches"][{"flash_fwd": "flash_block_forward",
                                           "paged_decode": "paged_decode_attention"}[k["name"]]]
        check(k["launches"] > 0, f"the serving path never launched {k['name']}")
    if "profile" in stats:
        prof = stats["profile"]
        print(f"profile: device busy {prof['device_busy_s']:.3f} s of the profiled run's "
              f"{prof['wall_s']:.3f} s wall ({prof['device_busy_share']:.1%}; the unprofiled "
              f"run took {stats['wall_s']:.3f} s); top kernels "
              + "; ".join(f"{t['name'][:48]} {t['ms']:.1f} ms x{t['calls']}"
                          for t in prof["top"][:6]) + f" [{card}]", flush=True)
    print(json.dumps({"serve": stats, "card": card}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{key: k[key] for key in keys}, **k} for k in kernels],
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
