"""Carry a flax Llama parameter tree over to the port's state dict.

The flax tree (``neuronx_distributed_tpu.models.llama.LlamaForCausalLM``,
unboxed, leaves as numpy arrays) stacks the decoder layers on a leading
axis under ``model/layers/block``; the port keeps one module per layer
under ``model.layers.{i}``. Kernels keep their ``(in, out)`` and
``(hidden, heads, head_dim)`` layouts, so the mapping is a rename plus an
unstack. ``lm_head/kernel`` is absent when ``tie_word_embeddings`` is set.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# flax path under model/layers/block -> port name under model.layers.{i}
_LAYER_LEAVES = {
    ("attention", "qkv", "q_kernel"): "attention.qkv.q_kernel",
    ("attention", "qkv", "k_kernel"): "attention.qkv.k_kernel",
    ("attention", "qkv", "v_kernel"): "attention.qkv.v_kernel",
    ("attention", "o_proj", "kernel"): "attention.o_proj.kernel",
    ("mlp", "gate_proj", "kernel"): "mlp.gate_proj.kernel",
    ("mlp", "up_proj", "kernel"): "mlp.up_proj.kernel",
    ("mlp", "down_proj", "kernel"): "mlp.down_proj.kernel",
    ("input_norm", "scale"): "input_norm.scale",
    ("post_attn_norm", "scale"): "post_attn_norm.scale",
}


def _get(tree: Mapping[str, Any], path) -> np.ndarray:
    node = tree
    for key in path:
        if key not in node:
            raise KeyError(f"flax tree has no {'/'.join(path)}")
        node = node[key]
    return np.array(node)   # a writable copy: torch tensors share it


def llama_params_from_jax(tree: Mapping[str, Any],
                          tie_word_embeddings: bool = False) -> Dict[str, torch.Tensor]:
    """Flax Llama params (``{"model": ..., "lm_head": ...}``, or the
    ``{"params": ...}`` wrapper) -> state dict of the port's
    ``LlamaForCausalLM``."""
    if "params" in tree and "model" not in tree:
        tree = tree["params"]
    block = ("model", "layers", "block")
    num_layers = _get(tree, block + ("input_norm", "scale")).shape[0]
    out: Dict[str, torch.Tensor] = {
        "model.embed.embedding": torch.from_numpy(_get(tree, ("model", "embed", "embedding"))),
        "model.final_norm.scale": torch.from_numpy(_get(tree, ("model", "final_norm", "scale"))),
    }
    for path, name in _LAYER_LEAVES.items():
        stacked = _get(tree, block + path)
        if stacked.shape[0] != num_layers:
            raise ValueError(f"{'/'.join(block + path)} stacks {stacked.shape[0]} layers, "
                             f"expected {num_layers}")
        for i in range(num_layers):
            out[f"model.layers.{i}.{name}"] = torch.from_numpy(np.ascontiguousarray(stacked[i]))
    if not tie_word_embeddings:
        out["lm_head.kernel"] = torch.from_numpy(_get(tree, ("lm_head", "kernel")))
    return out
