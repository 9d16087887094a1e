"""Carry a flax Llama parameter tree over to the port's state dict.

The flax tree (``neuronx_distributed_tpu.models.llama.LlamaForCausalLM``,
unboxed, leaves as numpy arrays) stacks the decoder layers on a leading
axis under ``model/layers/block``; the port keeps one module per layer
under ``model.layers.{i}``. Kernels keep their ``(in, out)`` and
``(hidden, heads, head_dim)`` layouts, so the mapping is a rename plus an
unstack. ``lm_head/kernel`` is absent when ``tie_word_embeddings`` is set.

``lora_params_from_jax`` carries an ``init_lora`` adapter tree over the same
way: keyed by the full flax path, a leading layer axis on stacked kernels,
into the port's per-layer tree keyed by the port's weight names.
``medusa_params_from_jax`` carries a ``MedusaLlamaForCausalLM`` tree: the
Llama part as above plus each head's ``medusa_res_{i}`` (kernel and bias)
and ``medusa_head_{i}`` (kernel) under the same names.
"""

from __future__ import annotations

import re
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


_FLAX_KEY = re.compile(r"\['([^']+)'\]")


def lora_params_from_jax(tree: Mapping[str, Any], config) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``init_lora`` tree (``{"['model']['layers']['block']...
    ['q_kernel']": {"lora_a": (L, fan_in, r), "lora_b": (L, r, fan_out)}}``)
    -> the port's tree, one entry a layer under the port's weight name
    (``model.layers.{i}.attention.qkv.q_kernel``): the keys the serving
    pool reads as ``q``/``k``/``v`` under the fused qkv and the module name
    elsewhere. Unstacked adapters (the embedding's) keep their shapes.
    ``config`` is the adapters' ``LoraConfig``; their rank must be its
    ``r``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    block = ("model", "layers", "block")
    for path, ad in tree.items():
        parts = tuple(_FLAX_KEY.findall(path))
        if not parts:
            raise ValueError(f"not a flax parameter path: {path!r}")
        a = np.array(ad["lora_a"], np.float32)
        b = np.array(ad["lora_b"], np.float32)
        if a.shape[-1] != config.r:
            raise ValueError(f"{path}: rank {a.shape[-1]}, the LoraConfig says {config.r}")
        if parts[:3] == block:
            name = _LAYER_LEAVES.get(parts[3:])
            if name is None:
                raise KeyError(f"no port weight for the stacked flax path {path}")
            for i in range(a.shape[0]):
                out[f"model.layers.{i}.{name}"] = {
                    "lora_a": torch.from_numpy(np.ascontiguousarray(a[i])),
                    "lora_b": torch.from_numpy(np.ascontiguousarray(b[i]))}
        else:
            out[".".join(parts)] = {"lora_a": torch.from_numpy(a), "lora_b": torch.from_numpy(b)}
    return out


def medusa_params_from_jax(tree: Mapping[str, Any],
                           tie_word_embeddings: bool = False) -> Dict[str, torch.Tensor]:
    """Flax ``MedusaLlamaForCausalLM`` params -> state dict of the port's
    ``MedusaLlamaForCausalLM``: :func:`llama_params_from_jax` for the base
    model, then ``medusa_res_{i}.kernel``/``.bias`` and
    ``medusa_head_{i}.kernel`` for every head the tree holds."""
    if "params" in tree and "model" not in tree:
        tree = tree["params"]
    out = llama_params_from_jax(tree, tie_word_embeddings)
    heads = sorted(int(k[len("medusa_res_"):]) for k in tree if k.startswith("medusa_res_"))
    if heads != list(range(len(heads))):
        raise ValueError(f"medusa heads {heads} are not numbered 0..{len(heads) - 1}")
    for i in heads:
        out[f"medusa_res_{i}.kernel"] = torch.from_numpy(_get(tree, (f"medusa_res_{i}", "kernel")))
        out[f"medusa_res_{i}.bias"] = torch.from_numpy(_get(tree, (f"medusa_res_{i}", "bias")))
        out[f"medusa_head_{i}.kernel"] = torch.from_numpy(
            _get(tree, (f"medusa_head_{i}", "kernel")))
    return out
