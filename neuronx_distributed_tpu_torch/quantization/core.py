"""Weight-only int8 quantization on the port's flat state dicts.

Counterpart of ``neuronx_distributed_tpu/quantization/core.py``.
:func:`quantize_params` turns each targeted float weight ``X`` of a state
dict into the pair ``X.qweight`` (int8, the weight's layout) and ``X.scale``
(fp32), with the JAX package's arithmetic: fp32 abs-max, ``max(absmax /
127, 1e-12)``, round half to even, clip, int8. Targets and exclusions are
the JAX patterns, matched against each name written as a flax path
(``model.layers.3.mlp.gate_proj.kernel`` is ``['model']['layers']['block']
['mlp']['gate_proj']['kernel']``, the path of the stacked tree the JAX
package quantizes).

Per output channel, the scale reduces the fan-in axis only. The port's
layers are unstacked, so a dense kernel ``(in, out)`` and a GQA kernel
``(H, N, D)`` reduce axis 0, and an expert kernel ``(E, H, I)`` (a name
matching ``expert_patterns``) reduces axis 1, one scale set per expert:
``(E, 1, I)``. On dense and attention leaves this is the JAX result of the
stacked tree, layer by layer. On expert leaves it is the JAX rule applied to
one layer: on a scan-stacked tree ``(L, E, H, I)`` the JAX package reduces
the expert axis instead (ROADMAP C7). ``stacked_patterns`` is kept for the
configuration's shape and never matches here. Per tensor, one scalar scale
per weight of one layer.

A model serves straight from such a dict: ``CausalLM`` swaps each
quantized weight for a :class:`~neuronx_distributed_tpu_torch.parallel.
layers.QuantizedKernel`, whose products run through B5 (the W8A16 GEMM) on
the card and through its twin, JAX's dequantize-then-matmul, on the CPU.
:func:`dequantize_params` is the float tree for a ``param_transform``.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.kernels.w8a16 import dequantize


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """The JAX ``QuantizationConfig`` and its patterns."""

    quantization_type: str = "per_channel_symmetric"  # | "per_tensor_symmetric"
    quantized_dtype: torch.dtype = torch.int8
    target_patterns: Tuple[str, ...] = ("kernel", r"\['(gate|up|down)'\]$")
    exclude_patterns: Tuple[str, ...] = ("embed", "lm_head", "norm", "bias", "router")
    expert_patterns: Tuple[str, ...] = ("expert", "moe", "mlp_fused")
    stacked_patterns: Tuple[str, ...] = (r"\['layers'\]",)


def flax_path(name: str) -> str:
    """A port weight name as the flax key path of the JAX package's stacked
    tree: ``layers.{i}`` becomes ``layers/block``."""
    parts = name.split(".")
    out = []
    for i, p in enumerate(parts):
        if p.isdigit() and i > 0 and parts[i - 1] == "layers":
            p = "block"
        out.append(f"['{p}']")
    return "".join(out)


def _is_target(path: str, cfg: QuantizationConfig) -> bool:
    if any(re.search(pat, path) for pat in cfg.exclude_patterns):
        return False
    return any(re.search(pat, path) for pat in cfg.target_patterns)


def quantize_tensor(w: torch.Tensor, axis: Optional[int],
                    qdtype: torch.dtype = torch.int8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric abs-max quantization of ``w``: reduce ``axis`` (kept as a
    size-1 axis) or, with None, the whole tensor (a 0-d scale). Returns
    ``(q, scale fp32)``."""
    info = torch.iinfo(qdtype)
    wf = w.float()
    absmax = wf.abs().amax() if axis is None else wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax / info.max, 1e-12)
    q = torch.clamp(torch.round(wf / scale), info.min, info.max).to(qdtype)
    return q, scale


def quantize_leaf(name: str, leaf, config: Optional[QuantizationConfig] = None
                  ) -> Dict[str, torch.Tensor]:
    """One state-dict entry, quantized when the config targets it:
    ``{name + ".qweight": int8, name + ".scale": fp32}``, else ``{name:
    leaf}`` unchanged."""
    cfg = config or QuantizationConfig()
    t = torch.as_tensor(leaf)
    path = flax_path(name)
    if t.dim() < 2 or not _is_target(path, cfg):
        return {name: leaf}
    if cfg.quantization_type == "per_channel_symmetric":
        expert = t.dim() >= 3 and any(re.search(p, path) for p in cfg.expert_patterns)
        axis = 1 if expert else 0
    elif cfg.quantization_type == "per_tensor_symmetric":
        axis = None
    else:
        raise ValueError(f"unknown quantization_type {cfg.quantization_type!r}")
    q, scale = quantize_tensor(t, axis, cfg.quantized_dtype)
    return {f"{name}.qweight": q, f"{name}.scale": scale}


def quantized_names(params: Mapping[str, object]) -> set:
    """The weights of ``params`` held as ``X.qweight``/``X.scale`` pairs."""
    return {k[: -len(".qweight")] for k in params
            if k.endswith(".qweight") and k[: -len(".qweight")] + ".scale" in params}


def quantize_params(params: Mapping[str, object],
                    config: Optional[QuantizationConfig] = None) -> Dict[str, torch.Tensor]:
    """Abs-max int8 quantization of the targeted weights of a state dict
    (JAX ``quantize_params``); pairs already quantized pass through."""
    done = quantized_names(params)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        base = name.rpartition(".")[0]
        if base in done and name in (f"{base}.qweight", f"{base}.scale"):
            out[name] = leaf
        else:
            out.update(quantize_leaf(name, leaf, config))
    return out


def dequantize_leaf(value, dtype: torch.dtype):
    """``(qweight * scale)`` cast to ``dtype`` for a quantized leaf (a
    mapping with ``qweight`` and ``scale``), else ``value`` unchanged (JAX
    ``dequantize_leaf``)."""
    if isinstance(value, Mapping) and "qweight" in value:
        return dequantize(value["qweight"], value["scale"], dtype)
    return value


def dequantize_params(qparams: Mapping[str, object],
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every ``X.qweight``/``X.scale`` pair back to a float ``X`` in
    ``dtype`` (JAX ``dequantize_params``); other entries pass through."""
    done = quantized_names(qparams)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in qparams.items():
        base = name.rpartition(".")[0]
        if base not in done:
            out[name] = leaf
        elif name == f"{base}.qweight":
            out[base] = dequantize(torch.as_tensor(leaf),
                                   torch.as_tensor(qparams[f"{base}.scale"]), dtype)
    return out
