#!/usr/bin/env python3
"""Serve the PyTorch/CUDA port's smoke workload from one checkout, with bf16
and then int8 KV pages, for comparing two versions of the port on one card.

    python3 scripts/serve_ab.py TREE

``TREE`` is the root of a checkout (this repository, or an older commit
unpacked with ``git archive``). The script imports ``chip_smoke`` and the
port from ``TREE``, builds its kernels and runs ``chip_smoke.serve``
(Llama-3-8B full width, 8 requests, no profiler) twice on one set of
weights: bf16 pages, then int8 pages. It prints one line ``AB {json}``:
tokens/s, TTFT p50, wall and host operations a block of each pass, and the
card. Run it once per checkout in turns (A, B, B, A) in one call: two
machines may carry cards that differ.
"""

import gc
import json
import sys
from pathlib import Path


def main(tree: str) -> None:
    root = str(Path(tree).resolve())
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.models.llama import init_params

    if not cs.__file__.startswith(root):
        raise SystemExit(f"imported chip_smoke from {cs.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    cfg = cs.serve_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    counters = (flash_block_forward, paged_decode_attention)
    out = {}
    for page_dtype in (None, "int8"):
        st = cs.serve(cfg, "cuda", counters, params=params, page_dtype=page_dtype)
        out[page_dtype or "bf16"] = dict(tok_s=st["tokens_per_s"],
                                         ttft_p50_ms=st["ttft_s_p50"] * 1e3,
                                         wall_s=st["wall_s"], host_ops=st["host_ops_per_block"])
        gc.collect()
    print("AB", json.dumps(dict(tree=root, card=cs.card_line(), **out)), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
