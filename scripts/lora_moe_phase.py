#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 4r alone on one NVIDIA GPU: build the
kernels, then, with ``--parts v0v1`` (the default ``v0v1,v2``), phases 4l
and 4n (``run_dist_phase``, ``run_moe_phase``), whose rank processes carry
(v0) LoRA fine-tuning at TP 2 x DP 2 and (v1) Mixtral training at CP 2 x
EP 2 after their own cells, and with ``v2`` the multi-LoRA Mixtral serve
cell; then ``run_lora_moe_phase``'s gates. Prints the phases' report
lines, phase 4r's readings as one JSON line (to ``--out`` too; before the
gates are held, to ``--out`` with ``.partial.json`` for a suffix), and the
card's name and power limit.

    python3 scripts/lora_moe_phase.py [--parts v0v1,v2] [--out PATH]

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
    parser.add_argument("--parts", default="v0v1,v2", help="v0v1 and/or v2, comma-separated")
    parser.add_argument("--out", default=None, help="also write the readings' JSON here")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
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
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf

    if not torch.cuda.is_available():
        print("lora_moe_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    train = (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf)
    spent = {}
    try:
        dist = moe = None
        if "v0v1" in parts:
            t = time.perf_counter()
            dist = smoke.run_dist_phase("cuda", train)
            smoke.print_dist(dist, card)
            spent["dist"] = time.perf_counter() - t
            t = time.perf_counter()
            moe = smoke.run_moe_phase("cuda", train)
            smoke.print_moe(moe, card)
            spent["moe"] = time.perf_counter() - t
        out = smoke.run_lora_moe_phase(
            "cuda", (flash_block_forward, paged_decode_attention), dist, moe,
            dump=args.out and Path(args.out).with_suffix(".partial.json"))
    except smoke.SmokeFailure as e:
        print(f"lora_moe_phase: FAILED: {e}", file=sys.stderr)
        return 1
    smoke.print_lora_moe(out, card)
    line = json.dumps({**out, "phases_s": spent, "script_wall_s": time.perf_counter() - t0,
                       "card": card}, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line[-4000:])
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
