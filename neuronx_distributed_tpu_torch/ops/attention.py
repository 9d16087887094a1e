"""Attention dispatch: the flash kernel path, or the dense reference when
``use_flash=False``. Counterpart of ``neuronx_distributed_tpu/ops/attention.py``.

Its mesh branch (JAX ``:30-72``, a ``shard_map`` with heads over ``tp``)
needs no code here: under tensor parallelism the GQA projection already
hands each rank its own heads (``parallel/layers.py``), so the kernel runs
on the rank's heads (Llama-3-8B at degree 2: 16 query and 4 KV heads) and
no collective touches attention."""

from __future__ import annotations

from typing import Optional

import torch

from neuronx_distributed_tpu_torch.kernels.flash_attn import (
    flash_attention,
    reference_attention,
)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None,
              use_flash: bool = True, block_q: int = 128, block_k: int = 128,
              q_positions: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention over BHSD tensors; K/V may carry fewer (GQA)
    heads. ``q_positions``/``kv_positions`` ((b, sq)/(b, sk) int32) select
    the position-based mask; defaults are (bottom-aligned) causal. Both
    branches are differentiable in q, k and v (the flash branch through its
    recompute backward)."""
    if not use_flash:
        return reference_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                   q_positions=q_positions, kv_positions=kv_positions)
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           block_q=block_q, block_k=block_k,
                           q_positions=q_positions, kv_positions=kv_positions)
