#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 4g (captured programs and speculation), or
parts of it, alone on one NVIDIA GPU: build the kernels, make the serve
phase's Llama-3-8B weights (``trace``, ``spec`` and ``medusa`` at the
smoke's ``SERVING_CUT_LAYERS`` depth), and run the parts named; print each
part's result as a JSON line, and the card's name and power limit.

    python3 scripts/program_phase.py [--parts check,trace,spec,medusa,bundle]

``check``: the small fp32 model's captured and eager programs
(``program_check``); ``trace``: the trace phase's three passes with captured
programs, then on the eager route (z1); ``spec``: speculation (z2);
``medusa``: Medusa (z3); ``bundle``: a saved and loaded program bundle
(z4). All parts took about 5 minutes on an H100 at full depth, ``trace``
about 3 of them.
It exits 1 when a gate fails or when no GPU is present.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("check", "trace", "spec", "medusa", "bundle")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default=",".join(PARTS),
                        help=f"comma-separated parts of {PARTS}")
    parts = parser.parse_args(argv).parts.split(",")
    if set(parts) - set(PARTS):
        parser.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.models.llama import init_params

    if not torch.cuda.is_available():
        print("program_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    dev, b1 = "cuda", (flash_block_forward,)
    out = {}
    try:
        if "check" in parts:
            out["check"] = smoke.program_check(dev)
            print(json.dumps({"part": "check", **out["check"], "card": card}), flush=True)
        cfg = smoke.serve_config()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        cut_cfg, cut_params = smoke.serving_cut(cfg, params)   # the smoke's depth
        if "trace" in parts:
            lm = smoke.trace_lm(cut_cfg, dev, cut_params)
            torch.cuda.reset_peak_memory_stats()
            trace = smoke.run_trace_phase(lm, dev, (flash_block_forward, paged_decode_attention))
            captured = trace.pop("streams")
            del trace["trace"]
            trace.update(capture_ms=dict(lm.capture_ms), pool_bytes=smoke.pool_bytes(
                lm._graph_pool()), peak_bytes=torch.cuda.max_memory_allocated())
            eager = smoke.run_eager_trace(lm, dev, (flash_block_forward, paged_decode_attention),
                                          captured)
            for label, st in eager["passes"].items():
                cap = trace["passes"][label]
                print(json.dumps({"part": "trace", "pass": label, "captured": cap, "eager": st,
                                  "insert_ms": [smoke.per_call_ms(cap, "insert"),
                                                smoke.per_call_ms(st, "insert")],
                                  "extend_ms": [smoke.per_call_ms(cap, "extend"),
                                                smoke.per_call_ms(st, "extend")],
                                  "card": card}, default=str), flush=True)
            print(json.dumps({"part": "trace", "capture_ms": trace["capture_ms"],
                              "pool_bytes": trace["pool_bytes"],
                              "peak_bytes": trace["peak_bytes"], "card": card}), flush=True)
            del lm
        for name, fn in (("spec", lambda: smoke.run_speculation(cut_cfg, dev, cut_params, b1)),
                         ("medusa", lambda: smoke.run_medusa(cut_cfg, dev, cut_params, b1))):
            if name in parts:
                t0 = time.perf_counter()
                out[name] = fn()
                print(json.dumps({"part": name, **out[name],
                                  "wall_s": time.perf_counter() - t0, "card": card},
                                 default=str), flush=True)
        if "bundle" in parts:
            with tempfile.TemporaryDirectory() as tmp:
                out["bundle"] = smoke.run_bundle(cfg, dev, params, b1, Path(tmp))
            print(json.dumps({"part": "bundle", **out["bundle"], "card": card}), flush=True)
    except smoke.SmokeFailure as e:
        print(f"program_phase: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
