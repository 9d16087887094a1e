#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s GPT-NeoX and BERT parts alone on one NVIDIA GPU:
build the kernels, then ``kernels`` (B1 and B3a/B3b held against their twins
and timed at the BERT-large and GPT-NeoX-20B shapes, ``run_family_kernels``)
and ``phase`` (phase 4o, ``run_families_phase``: (b0) BERT-large through its
example on one rank, (n0) GPT-NeoX-20B widths at 2 layers on one rank, the
four rank processes on the card over gloo ((n1) the NeoX example at TP 2 x
DP 2, (n2) the small fp32 NeoX and BERT), then (n2)'s CPU side). Prints the
report lines, the readings as one JSON line (to ``--out`` too; the phase's,
before its gates are held, to ``--out`` with ``.partial.json`` for a
suffix), and the card's name and power limit.

    python3 scripts/families_phase.py [--parts kernels,phase] [--layers N] [--out PATH]

``--layers N`` sets the depth of (n0) and (n1) (default 2). It exits 1 when
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
    parser.add_argument("--parts", default="kernels,phase")
    parser.add_argument("--layers", type=int, default=None, help="depth of (n0) and (n1)")
    parser.add_argument("--out", default=None, help="also write the readings' JSON here")
    args = parser.parse_args()
    parts = args.parts.split(",")
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
        print("families_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    out = {}
    try:
        if "kernels" in parts:
            flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
            out["kernels"], problems = smoke.run_family_kernels("cuda", flush)
            smoke.print_family_kernels(out["kernels"], card)
            del flush
            smoke.check(not problems, "family kernels: " + "; ".join(problems))
        if "phase" in parts:
            dump = args.out and Path(args.out).with_suffix(".partial.json")
            out["phase"] = smoke.run_families_phase(
                "cuda", (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf),
                layers=args.layers or smoke.FAM_NEOX_LAYERS, dump=dump)
            smoke.print_families(out["phase"], card)
    except smoke.SmokeFailure as e:
        print(f"families_phase: FAILED: {e}", file=sys.stderr)
        return 1
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
