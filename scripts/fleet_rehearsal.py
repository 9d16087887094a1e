#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s fleet phase (4i) on the CPU over the
port's ``SimCausalLM`` and print each pass's counts: the router's, the
disaggregated fleet's and the autoscaler's decisions are functions of the
traffic, the fleet and the fault plans alone (greedy, no EOS; the sim does
the card's page and slot accounting at the trace cell's shape: 8 rows,
pages of 16, 2056 pages, buckets 128/512/4096), so these are the card's
counts. The output is what ``chip_smoke.FLEET_PREDICTED`` holds; each pass
says whether it equals it.

    python3 scripts/fleet_rehearsal.py [--passes z2,z3,z4]

About ten seconds; no model weights, no device work.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 128256   # Llama-3-8B's: the traffic draws the card's token ids


def predicted(passes: dict) -> dict:
    """The counts the card's gates compare, by pass label."""
    out = {}
    runs = {"z2": passes.get("z2")}
    runs.update({f"z3_{k}": v for k, v in passes.get("z3", {}).items()})
    runs["z4"] = passes.get("z4")
    for label, st in runs.items():
        if st is None:
            continue
        out[label] = dict(st["stats"], completed=st["completed"], rejected=st["rejected"],
                          blocks=st["blocks"])
    if "z4" in passes:
        out["z4_events"] = passes["z4"]["scale_events"]
        out["z4_time_to_ready"] = passes["z4"]["time_to_ready_blocks"]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--passes", default="z2,z3,z4", help="comma-separated passes")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mb, ps, seq = 8, 16, 4096
    sim = SimCausalLM(max_batch=mb, buckets=smoke.TRACE_BUCKETS, max_seq_len=seq,
                      vocab_size=VOCAB, page_size=ps, page_pool_pages=mb * (seq // ps) + mb)
    t0 = time.perf_counter()
    passes = {}
    labels = args.passes.split(",")
    if "z2" in labels:
        passes["z2"] = smoke.fleet_z2(sim, "cpu", ())
    if "z3" in labels:
        passes["z3"] = smoke.fleet_z3(sim, "cpu", ())
    if "z4" in labels:
        passes["z4"] = smoke.fleet_z4(sim, "cpu", ())
    counts = predicted(passes)
    for label, c in counts.items():
        print(f"{label}: {json.dumps(c)}; equal to FLEET_PREDICTED: "
              f"{c == smoke.FLEET_PREDICTED.get(label)}")
    problems = smoke.fleet_gates(passes, counts)
    print(f"gates on the rehearsal itself: {problems or 'all hold'}")
    print("FLEET_PREDICTED = " + json.dumps(counts))
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
