#!/usr/bin/env python3
"""Serve and train the PyTorch/CUDA port's smoke workloads from one
checkout, for comparing two versions of the port on one card.

    python3 scripts/torch_ab.py TREE

``TREE`` is the root of a checkout (this repository, or an older commit
unpacked with ``git archive``). The script imports ``chip_smoke`` and the
port from ``TREE``, builds its kernels, runs ``chip_smoke.serve`` (Llama-3-8B
full width, 8 requests) and ``chip_smoke.train`` (Llama-3-8B widths at 4
layers, 2 x 4096 tokens, 2 warm-up and 5 timed steps), and prints one line
``AB {json}``: serve tokens/s, wall and TTFT (and, where the tree has
them, host operations a decode block and the capture seconds), step ms and
training tokens/s, the losses and the peak memory. Run it once per checkout in turns (A, B, B, A)
on one machine: two machines may carry cards that differ.
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
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf

    if not cs.__file__.startswith(root):
        raise SystemExit(f"imported chip_smoke from {cs.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    serve = cs.serve(cs.serve_config(), "cuda", (flash_block_forward, paged_decode_attention))
    gc.collect()
    torch.cuda.empty_cache()
    train = cs.train(cs.train_config(), "cuda",
                     (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf))
    print("AB", json.dumps(dict(
        tree=root, card=cs.card_line(), serve_tok_s=serve["tokens_per_s"],
        ttft_p50_ms=serve["ttft_s_p50"] * 1e3, ttft_max_ms=serve["ttft_s_max"] * 1e3,
        serve_wall_s=serve["wall_s"], host_ops_per_block=serve.get("host_ops_per_block"),
        capture_s=serve.get("capture_s"),
        step_ms=train["step_ms_mean"], steps=train["step_ms"],
        train_tok_s=train["tokens_per_s"], losses=train["losses"], peak=train["peak_bytes"])),
        flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
