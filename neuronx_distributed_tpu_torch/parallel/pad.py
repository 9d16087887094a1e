"""Attention-head padding so the tensor-parallel degree divides the heads.

Counterpart of ``neuronx_distributed_tpu/parallel/pad.py`` (the reference's
``get_number_of_extra_heads`` and ``pad_model``), on the port's flat state
dicts of every family (Llama, Mixtral, GPT-NeoX, BERT): the Q/K/V kernels
``(hidden, heads, head_dim)`` and their per-head biases ``(heads,
head_dim)`` gain zero heads, and the attention output projection's kernel
``(heads * head_dim, hidden)`` (``o_proj``, BERT's ``attention.output``)
gains zero input rows. The padded heads' outputs meet only those zero
rows, so every logit equals the unpadded model's.
Multi-head attention only: a grouped-query model would regroup its heads
onto other KV heads (raise ``kv_size_multiplier`` instead).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch

_QKV = (".q_kernel", ".k_kernel", ".v_kernel")
_QKV_BIAS = (".q_bias", ".k_bias", ".v_bias")
# the attention output projections whose input rows are per head (their
# biases are per output feature and stay as they are)
_OUT_PROJ = (".o_proj.kernel", ".attention.output.kernel")


def get_number_of_extra_heads(num_heads: int, tp_degree: int) -> int:
    """Heads to add so ``tp_degree`` divides the total."""
    return (-num_heads) % tp_degree


def pad_model(params: Mapping[str, torch.Tensor], config,
              tp_degree: int) -> Tuple[Dict[str, torch.Tensor], Any]:
    """Zero-pad the attention heads of a Llama, Mixtral, GPT-NeoX or BERT
    state dict so ``num_heads % tp_degree == 0``; returns ``(padded params,
    padded config)`` (``head_dim`` made explicit)."""
    num_heads = config.num_heads
    num_kv = getattr(config, "num_kv_heads", num_heads)   # BERT: multi-head implicitly
    extra = get_number_of_extra_heads(num_heads, tp_degree)
    if extra == 0:
        return dict(params), config
    if num_kv != num_heads:
        raise ValueError(f"head padding supports MHA only (num_kv_heads == num_heads); got "
                         f"{num_kv} != {num_heads} — use kv_size_multiplier for GQA")
    d, n = config.head_dim_, num_heads
    out = {}
    for key, t in params.items():
        if key.endswith(_QKV):            # (hidden, N, D) -> (hidden, N + extra, D)
            t = torch.cat([t, t.new_zeros((t.shape[0], extra, d))], dim=1)
        elif key.endswith(_QKV_BIAS):     # (N, D) -> (N + extra, D)
            t = torch.cat([t, t.new_zeros((extra, d))], dim=0)
        elif key.endswith(_OUT_PROJ):   # (N*D, H) -> ((N + extra)*D, H): zero rows
            t = torch.cat([t, t.new_zeros((extra * d, t.shape[-1]))], dim=0)
        out[key] = t
    over = dict(num_heads=n + extra, head_dim=d)
    if hasattr(config, "num_kv_heads"):
        over["num_kv_heads"] = num_kv + extra
    return out, dataclasses.replace(config, **over)


def pad_llama_heads(params: Mapping[str, torch.Tensor], config,
                    tp_degree: int) -> Tuple[Dict[str, torch.Tensor], Any]:
    """The Llama family's name for :func:`pad_model`."""
    return pad_model(params, config, tp_degree)
