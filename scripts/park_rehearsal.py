#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s park phase (4f) on the CPU and print each
pass's counts: the schedule is a function of the sessions and the fault
plan alone (greedy, no EOS), so a one-layer model at the phase's
scheduling shape predicts the card's counts of pass (x) exactly (parks,
exact resumes, degraded resumes, rejects, the injector's and the store's
counts). The output is what ``chip_smoke.PARK_PREDICTED`` holds. On the
CPU in fp32 re-prefill is exact, so the gates also hold (x)'s degraded
sessions to (u)'s streams.

    python3 scripts/park_rehearsal.py [--threads N] [--passes u,x] [--seeds 0,1,2]

``--seeds`` tries fault plans of those seeds in pass (x) and prints the
rungs each fired. The prompts' ids are folded into the small model's
512-token vocabulary, which moves no decision.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--passes", default=None, help="comma-separated labels (default: all)")
    parser.add_argument("--seeds", default=None, help="fault-plan seeds to try in pass (x)")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from neuronx_distributed_tpu_torch.models import llama as tl

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.set_num_threads(args.threads)
    cfg = tl.LlamaConfig(vocab_size=512, hidden_size=16, intermediate_size=32, num_layers=1,
                         num_heads=2, num_kv_heads=1, max_seq_len=4096, dtype=torch.float32)
    lm = smoke.trace_lm(cfg, "cpu", tl.init_params(cfg, torch.Generator().manual_seed(0)))
    trace = smoke.park_trace(128256)
    for it in trace:
        it["prompt"] = it["prompt"] % (cfg.vocab_size - 1) + 1
    labels = args.passes.split(",") if args.passes else None
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        passes = smoke.park_passes(lm, "cpu", (), Path(tmp), trace=trace, labels=labels)
        for label, st in passes.items():
            counts = {k: st["counts"][k] for k in smoke.PARK_COUNT_KEYS}
            same = counts == smoke.PARK_PREDICTED.get(label)
            print(f"pass ({label}): {json.dumps(counts)}; equal to PARK_PREDICTED: {same}; "
                  f"degraded {st['degraded']}; decode blocks {st['decode_blocks']}")
        if labels is None:
            problems = smoke.park_gates(passes, smoke.PARK_PREDICTED, exact_degraded=True)
            print("gates: " + ("all hold" if not problems else "; ".join(problems)))
        for seed in (args.seeds.split(",") if args.seeds else ()):
            plan = {**smoke.PARK_FAULT_PLAN, "seed": int(seed)}
            st = smoke.park_pass(lm, "cpu", trace, "x", (), Path(tmp) / f"seed{seed}", plan=plan)
            print(f"plan seed {seed}: {json.dumps(st['counts'])}")
    print(f"wall {time.perf_counter() - t0:.1f} s on the CPU ({args.threads} threads)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
