"""Attention-head padding so the tensor-parallel degree divides the heads.

Counterpart of ``neuronx_distributed_tpu/parallel/pad.py`` (the reference's
``get_number_of_extra_heads`` and ``pad_model``), on the port's flat state
dicts (``model.layers.{i}.attention.qkv.q_kernel`` ``(hidden, heads,
head_dim)``, ``...o_proj.kernel`` ``(heads * head_dim, hidden)``). The
padded query, key and value heads are zeros, and so are the rows of the
output projection they feed, so every logit equals the unpadded model's.
Multi-head attention only: a grouped-query model would regroup its heads
onto other KV heads (raise ``kv_size_multiplier`` instead).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch

_QKV = (".q_kernel", ".k_kernel", ".v_kernel")
_QKV_BIAS = (".q_bias", ".k_bias", ".v_bias")


def get_number_of_extra_heads(num_heads: int, tp_degree: int) -> int:
    """Heads to add so ``tp_degree`` divides the total."""
    return (-num_heads) % tp_degree


def pad_model(params: Mapping[str, torch.Tensor], config,
              tp_degree: int) -> Tuple[Dict[str, torch.Tensor], Any]:
    """Zero-pad the attention heads of a Llama or Mixtral state dict so
    ``num_heads % tp_degree == 0``; returns ``(padded params, padded
    config)`` (``head_dim`` made explicit). The model families the port has
    not ported (BERT, GPT-NeoX) raise by name."""
    name = type(config).__name__
    if name not in ("LlamaConfig", "MixtralConfig"):
        raise NotImplementedError(f"head padding for {name}: that model family is not "
                                  f"ported (ROADMAP queue A)")
    num_heads, num_kv = config.num_heads, config.num_kv_heads
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
        elif key.endswith(".o_proj.kernel"):   # (N*D, H) -> ((N + extra)*D, H): zero rows
            t = torch.cat([t, t.new_zeros((extra * d, t.shape[-1]))], dim=0)
        out[key] = t
    return out, dataclasses.replace(config, num_heads=n + extra, num_kv_heads=num_kv + extra,
                                    head_dim=d)


def pad_llama_heads(params: Mapping[str, torch.Tensor], config,
                    tp_degree: int) -> Tuple[Dict[str, torch.Tensor], Any]:
    """The Llama family's name for :func:`pad_model`."""
    return pad_model(params, config, tp_degree)
