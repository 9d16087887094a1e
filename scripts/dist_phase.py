#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s distributed-training phase (4l) alone on one
NVIDIA GPU: build the kernels, then ``run_dist_phase``: (d0) Llama-2-7B
widths on one rank, (d1) the Llama-2 TP+ZeRO-1+SP example as four processes
on the card over gloo, (d2) the small fp32 model on the same layout against
one CPU rank, with a multi-rank save and a resume. Prints the phase's report
lines, its readings as one JSON line (to ``--out`` too), and the card's name
and power limit.

    python3 scripts/dist_phase.py [--layers N] [--out PATH]

``--layers N`` sets the depth of (d0) and (d1) (default 4). It exits 1 when
a gate fails or when no GPU is present.
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
    parser.add_argument("--layers", type=int, default=None, help="depth of (d0) and (d1)")
    parser.add_argument("--out", default=None, help="also write the readings' JSON here")
    args = parser.parse_args()
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
        print("dist_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    try:
        out = smoke.run_dist_phase("cuda", (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq,
                                            fused_adamw_leaf),
                                   layers=args.layers or smoke.DIST_LAYERS)
    except smoke.SmokeFailure as e:
        print(f"dist_phase: FAILED: {e}", file=sys.stderr)
        return 1
    smoke.print_dist(out, card)
    line = json.dumps({**out, "script_wall_s": time.perf_counter() - t0, "card": card},
                      default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line[-4000:])
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
