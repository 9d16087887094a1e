#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s context- and pipeline-parallel phase (4m) alone on
one NVIDIA GPU: build the kernels, then ``run_cp_pp_phase``: (c0) Llama-2-7B
widths on one 32768-token sequence on one rank, (p0) Llama-2-70B widths'
forward loss on one rank, the four rank processes on the card over gloo
((c1) CP 2 x TP 2 through the trainer, (c2) the small fp32 model and the
ring op against CPU ranks, (p1)/(p2) the Llama-2-70B TP x PP example at
TP 2 x PP 2, 1F1B and interleaved, (p3) the small fp32 model with a
multi-rank save and a resume), then ``measure_cp_ratio``. Prints the
phase's report lines, its readings as one JSON line (to ``--out`` too;
before the gates are held, to ``--out`` with ``.partial.json`` for a
suffix), and the card's name and power limit.

    python3 scripts/cp_pp_phase.py [--cp-layers N] [--out PATH]

``--cp-layers N`` sets the depth of (c0) and (c1) (default 2). It exits 1
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
    parser.add_argument("--cp-layers", type=int, default=None, help="depth of (c0) and (c1)")
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
        print("cp_pp_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    try:
        out = smoke.run_cp_pp_phase("cuda", (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq,
                                             fused_adamw_leaf),
                                    cp_layers=args.cp_layers or smoke.CP_LAYERS,
                                    dump=args.out and Path(args.out).with_suffix(".partial.json"))
    except smoke.SmokeFailure as e:
        print(f"cp_pp_phase: FAILED: {e}", file=sys.stderr)
        return 1
    smoke.print_cp_pp(out, card)
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
