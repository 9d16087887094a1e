#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s park phase (4f) alone on one NVIDIA GPU: build the
kernels, make the serve phase's Llama-3-8B weights, and call
``run_park_phase`` on the trace phase's ``CausalLM`` cut to the smoke's
depth (``SERVING_CUT_LAYERS``); print each pass and
the phase's report as JSON lines, and the card's name and power limit.

    python3 scripts/park_phase.py

It exits 1
when a gate fails or when no GPU is present.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.models.llama import init_params

    if not torch.cuda.is_available():
        print("park_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    _build.build()
    cfg = smoke.serve_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cut_cfg, cut_params = smoke.serving_cut(cfg, params)   # the smoke's depth
    lm = smoke.trace_lm(cut_cfg, "cuda", cut_params)
    t0 = time.perf_counter()
    try:
        out = smoke.run_park_phase(lm, "cuda", (flash_block_forward, paged_decode_attention))
    except smoke.SmokeFailure as e:
        print(f"park_phase: FAILED: {e}", file=sys.stderr)
        return 1
    for label, st in out.pop("passes").items():
        print(json.dumps({"pass": label, **st, "card": card}, default=str))
    print(json.dumps({**out, "wall_s": time.perf_counter() - t0, "card": card}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
