#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 4q (tensor-parallel serving, the rest)
alone on one NVIDIA GPU: build the kernels, start the two gloo rank
processes of phase 4j's (t2) on the card with only phase 4q's cells
((u0) B5 and B1 at a rank's shard shapes; (u1) ``runner generate --model
mixtral --quantize --tp 2`` and (u2) ``runner serve ... --paged
--paged-kernel`` on Mixtral-8x7B's int8 shards at 8 layers; (u3) ``runner
speculate``/``medusa --tp 2`` at Llama-2-13B's widths, 4 layers; (u4) the
small fp32 cases), then the TP=1 references in this process and the
gates. Prints the phase's report lines, its readings as one JSON line (to
``--out`` too), and the card's name and power limit.

    python3 scripts/tp_rest_phase.py [--out PATH]

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
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm

    if not torch.cuda.is_available():
        print("tp_rest_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    t2 = smoke.tp_t2("cuda", parts=("rest",))
    out = smoke.tpr_finish(t2, "cuda", (flash_block_forward, paged_decode_attention, w8a16_gemm))
    out["card_peak_used_bytes"], out["card_bytes"] = t2["card_peak_used_bytes"], t2["card_bytes"]
    out["processes_s"] = t2["wall_s"]
    smoke.print_tp_rest(out, card)
    line = json.dumps({**out, "script_wall_s": time.perf_counter() - t0, "card": card},
                      default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line[-4000:])
    print(card)
    if out["problems"]:
        print("tp_rest_phase: FAILED: " + "; ".join(out["problems"]), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
