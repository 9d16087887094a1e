#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 4h alone on one NVIDIA GPU: build the
kernels, then the parts named by ``--parts`` (default all): ``kernels``
(B5 against its twin at every case, timed; one line a case with the route
and splits the shapes pick), ``q3`` (the 2-layer fp32 int8
Mixtral, GPU against CPU), ``q1`` (Llama-3-8B with int8 weights behind
``ServeEngine``, beside the bf16 pass) and ``q2`` (Mixtral-8x7B with int8
weights at full width and depth). Prints B5's build report and each part's
result as a JSON line, and the card's name and power limit.

    python3 scripts/quant_phase.py [--parts kernels,q3,q1,q2] [--profile PATH]

With ``--profile``, (q2)'s batch-1 selective ``generate`` runs once more
under ``torch.profiler`` (device activity only): its report gains the
device's busy time, B5's share of it and the top kernels, and the kernel
table goes to PATH; B5's kernel calls in the trace, by route, must equal
the run's launches by route.

It exits 1 when a gate fails or when no GPU is present.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default="kernels,q3,q1,q2")
    parser.add_argument("--profile", metavar="PATH",
                        help="also run (q2)'s batch-1 generate once more under torch.profiler "
                             "and write its kernel table to PATH")
    args = parser.parse_args(argv)
    parts = args.parts.split(",")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke
    from neuronx_distributed_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("quant_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    t0 = time.perf_counter()
    _build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0, "seconds": _build.build_seconds,
                      "w8a16_gemm": smoke.compile_report("w8a16_gemm"), "card": card}),
          flush=True)
    try:
        if "kernels" in parts:
            flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
            r = smoke.run_w8a16("cuda", flush)
            for case, t in r["cases"].items():
                print(f"kernel w8a16_gemm ({case}): {smoke.w8a16_line(t)} [{card}]", flush=True)
            print(json.dumps({"part": "kernels", **r, "card": card}, default=str), flush=True)
            del flush
        models = [p for p in parts if p != "kernels"]
        if models:
            out = smoke.run_quant_phase("cuda", parts=models, profile_path=args.profile)
            print(json.dumps({"part": "quant", **out, "card": card}, default=str), flush=True)
            smoke.quant_route_gates(out)
    except smoke.SmokeFailure as e:
        print(f"quant_phase: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"wall_s": time.perf_counter() - t0, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
