#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s tenants phase (4e) on the CPU and print each
pass's counts: the adapter passes' schedule is a function of the trace
alone (greedy, no EOS, no grammar), so a one-layer model at the phase's
scheduling shape predicts the card's counts of passes (o) and (p) exactly.
The output is what ``chip_smoke.TENANT_PREDICTED`` holds. The grammar
passes' schedules follow the model's tokens: their counts here only show
that every gate can hold and which fault verdicts the chaos seed fires.

    python3 scripts/tenants_rehearsal.py [--threads N] [--passes o,p] [--seeds 0,1,2]

``--seeds`` tries chaos plans of those seeds in pass (s) and prints the
verdicts each fired. The prompts' ids are folded into the small model's
512-token vocabulary, which moves no decision of the adapter passes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--passes", default=None, help="comma-separated labels (default: all)")
    parser.add_argument("--seeds", default=None, help="chaos seeds to try in pass (s)")
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
    lm = smoke.tenant_lm(cfg, "cpu", tl.init_params(cfg, torch.Generator().manual_seed(0)))
    adapters = smoke.tenant_adapters(cfg)
    full_trace = smoke.tenant_trace

    def folded(vocab, grammars):
        trace = full_trace(128256, grammars)
        for it in trace:
            it["prompt"] = it["prompt"] % (cfg.vocab_size - 1) + 1
        return trace

    smoke.tenant_trace = folded
    labels = args.passes.split(",") if args.passes else None
    t0 = time.perf_counter()
    passes, traces = smoke.tenant_passes(lm, "cpu", (), adapters, labels=labels)
    for label, st in passes.items():
        counts = {k: st["counts"][k] for k in smoke.TENANT_COUNT_KEYS}
        same = counts == smoke.TENANT_PREDICTED.get(label)
        print(f"pass ({label}): {json.dumps(counts)}; equal to TENANT_PREDICTED: {same}; "
              f"finish {st['finish_reasons']}; parsed {st['parsed']} of {st['constrained']}; "
              f"faults {st['fault_stats']}; repairs {st['counts']['adapter_repairs']} / "
              f"{st['counts']['grammar_repairs']}")
    if labels is None:
        problems = smoke.tenant_gates({"n": dict(streams={}, launches={}, steady_ok=True,
                                                 blocks_ok=True), **passes},
                                      smoke.TENANT_PREDICTED, {}, traces)
        print("gates: " + ("all hold" if not problems else "; ".join(problems)))
    for seed in (args.seeds.split(",") if args.seeds else ()):
        plan = {**smoke.TENANT_CHAOS_PLAN, "seed": int(seed)}
        st = smoke.tenant_pass(lm, "cpu", folded(0, True), adapters, False, plan, ())
        print(f"chaos seed {seed}: faults {st['fault_stats']}, counts "
              f"{json.dumps(st['counts'])}")
    print(f"wall {time.perf_counter() - t0:.1f} s on the CPU ({args.threads} threads)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
