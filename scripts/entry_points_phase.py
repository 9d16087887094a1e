#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 4p alone on one NVIDIA GPU: build the
kernels, then the user's entry points (``run_entry_points_phase``): B5
and B1 held at the runner's 13B shapes; the serving runner at Llama-2-13B
((r0) benchmark and greedy generate, (r0 shell) that generate as a
process of the runner's module, (r1) serve on the paged pool with the
paged decode kernel, (r2) speculate, (r4) --quantize), (r3) check-accuracy
at fp32 and 10 layers and (r4 check) with --quantize, (r5) the --tiny
cases, and (l0) the lightning fit loop with a SIGTERM preemption, its
resume and MultiSteps accumulation. Prints the
report lines, the readings as one JSON line (to ``--out`` too; before the
gates are held, to ``--out`` with ``.partial.json`` for a suffix), and the
card's name and power limit.

    python3 scripts/entry_points_phase.py [--out PATH]

It exits 1 when a gate fails or when no GPU is present.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the readings' JSON here")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf

    if not torch.cuda.is_available():
        print("entry_points_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    try:
        dump = args.out and Path(args.out).with_suffix(".partial.json")
        st = smoke.run_entry_points_phase(
            "cuda", (flash_block_forward, paged_decode_attention, w8a16_gemm, flash_bwd_dkdv,
                     flash_bwd_dq, fused_adamw_leaf), dump=dump)
        smoke.print_entry_points(st, card)
    except smoke.SmokeFailure as e:
        print(f"entry_points_phase: FAILED: {e}", file=sys.stderr)
        return 1
    line = json.dumps({"phase": st, "launches_by_path": smoke.ep_launches_by_path(st),
                       "script_wall_s": time.perf_counter() - t0, "card": card}, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line[-4000:])
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
