#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s tensor-parallel phase (4j) alone on one NVIDIA GPU:
build the kernels, make the serve phase's Llama-3-8B weights, and call
``run_tp_phase``: (t1) the serve workload without a group and over a
one-rank NCCL group, then (t2) two processes on the card over gloo, which
then run phase 4q's cells (``scripts/tp_rest_phase.py`` runs those
alone). Prints
the phase's report lines, its readings as one JSON line (to ``--out``
too), and the card's name and power limit.

    python3 scripts/tp_phase.py [--layers N] [--out PATH]

``--layers N`` cuts the depth of both legs (default: all 32 layers). It exits 1 when a gate
fails or when no GPU is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layers", type=int, default=None, help="depth of both legs")
    parser.add_argument("--out", default=None, help="also write the readings' JSON here")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.models.llama import init_params

    if not torch.cuda.is_available():
        print("tp_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    cfg = smoke.serve_config()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    try:
        out = smoke.run_tp_phase(cfg, "cuda", params, (flash_block_forward,
                                                        paged_decode_attention),
                                 layers=args.layers)
    except smoke.SmokeFailure as e:
        print(f"tp_phase: FAILED: {e}", file=sys.stderr)
        return 1
    smoke.print_tp(out, card)
    smoke.print_tp_rest(out["rest"], card)
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
