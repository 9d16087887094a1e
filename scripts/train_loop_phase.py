#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phases alone on one NVIDIA GPU: build the
kernels, then (k3) the small fp32 model trained GPU vs CPU in five ways,
(k1) phase 4k, the LoRA train loop of Llama-3-8B at full depth with a
crash and a resume, and phase 5 with (k2) its variants. Prints the phases'
report lines, their readings as one JSON line (to ``--out`` too), and the
card's name and power limit.

    python3 scripts/train_loop_phase.py [--parts k3,k1,k2] [--out PATH]

About three minutes on an H100. It exits 1 when a gate fails or when no GPU
is present.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default="k3,k1,k2", help="which of k3, k1, k2 to run")
    parser.add_argument("--out", default=None, help="also write the readings' JSON here")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf

    if not torch.cuda.is_available():
        print("train_loop_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    counters = (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf)
    out = {}
    try:
        if "k3" in parts:
            out["train_check"] = smoke.train_check("cuda", counters)
            for name, r in out["train_check"].items():
                print(f"check ({name}): losses {r['losses_gpu']} vs {r['losses_cpu']}, max "
                      f"|loss diff| {r['loss_max_abs_err']:.3g}, max |weight diff| "
                      f"{r['param_max_abs_err']:.3g}, launches {r['launches']} [{card}]",
                      flush=True)
        if "k1" in parts:
            t = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                loop = smoke.run_train_loop(smoke.train_loop_config(), "cuda", counters, Path(tmp))
            loop["phase_s"] = time.perf_counter() - t
            out["train_loop"] = loop
            failures = smoke.train_loop_gates(loop)
            if failures:
                raise smoke.SmokeFailure("train loop (k1): " + "; ".join(failures))
            smoke.print_train_loop(loop, card)
        if "k2" in parts:
            out["train"] = smoke.train(smoke.train_config(), "cuda", counters)
            out["train_variants"] = smoke.train_variants(smoke.train_config(), "cuda", counters)
            for name, v in [("full", out["train"])] + list(out["train_variants"].items()):
                print(f"train ({name}): step {v['step_ms_mean']:.1f} ms, peak {v['peak_bytes']} "
                      f"bytes, launches a step {json.dumps(v['launches_per_step'])}, losses "
                      f"{[round(x, 4) for x in v['losses']]} [{card}]", flush=True)
    except smoke.SmokeFailure as e:
        print(f"train_loop_phase: FAILED: {e}", file=sys.stderr)
        print(json.dumps(out, default=str)[-8000:])
        return 1
    line = json.dumps({**out, "script_wall_s": time.perf_counter() - t0, "card": card},
                      default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line[-6000:])
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
