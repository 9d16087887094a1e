#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s Mixtral expert-parallel phase (4n) alone on one
NVIDIA GPU: build the kernels, then ``run_moe_phase``: (m0) Mixtral-8x7B
widths at 2 layers on one rank through the trainer, the four rank
processes on the card over gloo ((m1) the ``mixtral_moe`` example at TP 2
x EP 2, (m2) the small fp32 Mixtral at TP 2 x EP 2 and EP 2 x edp 2 with
a multi-rank save and a resume, and the small DBRX model's step), then
(m2)'s CPU side. Prints the phase's report lines, its readings as one
JSON line (to ``--out`` too; before the gates are held, to ``--out`` with
``.partial.json`` for a suffix), and the card's name and power limit.

    python3 scripts/moe_phase.py [--layers N] [--out PATH]

``--layers N`` sets the depth of (m0) and (m1) (default 2). It exits 1
when a gate fails or when no GPU is present.
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
    parser.add_argument("--layers", type=int, default=None, help="depth of (m0) and (m1)")
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
        print("moe_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    try:
        out = smoke.run_moe_phase("cuda", (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq,
                                           fused_adamw_leaf),
                                  layers=args.layers or smoke.MOE_LAYERS,
                                  dump=args.out and Path(args.out).with_suffix(".partial.json"))
    except smoke.SmokeFailure as e:
        print(f"moe_phase: FAILED: {e}", file=sys.stderr)
        return 1
    smoke.print_moe(out, card)
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
