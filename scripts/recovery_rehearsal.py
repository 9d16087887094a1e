#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s recovery phase (4d) on the CPU and print the
counts of every pass: the schedule is a function of the trace and the fault
plan alone (greedy requests, no EOS), so a one-layer model at the phase's
scheduling shape predicts the card's counts exactly. The output is what
``chip_smoke.RECOVERY_PREDICTED`` holds.

    python3 scripts/recovery_rehearsal.py [--threads N] [--passes g,i]

About a minute with four threads. The prompts' ids are folded into the
small model's 512-token vocabulary, which moves no decision.
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
    lm = smoke.recovery_lm(cfg, "cpu", tl.init_params(cfg, torch.Generator().manual_seed(0)))
    trace = smoke.recovery_trace(128256)
    for it in trace:
        it["prompt"] = it["prompt"] % (cfg.vocab_size - 1) + 1
    labels = args.passes.split(",") if args.passes else None
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        passes = smoke.recovery_passes(lm, "cpu", (), Path(tmp) / "recovery.snap", trace=trace,
                                       labels=labels)
    for label, st in passes.items():
        counts = {k: st["counts"][k] for k in smoke.RECOVERY_COUNT_KEYS}
        same = counts == smoke.RECOVERY_PREDICTED.get(label)
        print(f"pass ({label}): {json.dumps(counts)}; equal to RECOVERY_PREDICTED: {same}")
    if labels is None:
        for st in passes.values():   # the CPU runs the kernels' twins: no launch counted
            st["launches"] = {}
        problems = smoke.recovery_gates(passes, smoke.RECOVERY_PREDICTED)
        print("gates: " + ("all hold" if not problems else "; ".join(problems)))
    print(f"wall {time.perf_counter() - t0:.1f} s on the CPU ({args.threads} threads)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
