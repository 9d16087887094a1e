"""LoRA adapters as a parameter transform, on PyTorch.

Counterpart of ``neuronx_distributed_tpu/lora/core.py``: for every
targeted kernel ``W (in, out...)`` of a state dict, ``init_lora`` makes
``A (in, r)`` and ``B (r, out)`` with ``W_eff = W + (alpha / r) * A @ B``,
and ``merge_lora`` materializes ``W_eff``. The port's state dict keeps one
entry per decoder layer (``model.layers.{i}...``), so adapters are per layer
as the JAX package's stacked ones are. Training with adapters, the dropout
form (``attach_adapters``), the merged export and the tensor-parallel specs
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

LoraTree = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """The reference ``LoraConfig`` surface."""

    r: int = 8
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    target_modules: Tuple[str, ...] = ("qkv", "o_proj", "gate_proj", "up_proj", "down_proj")

    @property
    def scaling(self) -> float:
        return self.lora_alpha / self.r


def _is_target(name: str, config: LoraConfig) -> bool:
    parts = name.split(".")
    return any(t in parts for t in config.target_modules)


def _is_weight(name: str) -> bool:
    # linear kernels (``kernel``, ``q_kernel``, ...) and the token embedding
    return name.endswith("kernel") or name.endswith("embedding")


def init_lora(model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
              config: LoraConfig, generator: torch.Generator,
              device: Optional[torch.device] = None) -> LoraTree:
    """Adapters for every targeted weight of a state dict (or a module's),
    keyed by the weight's name: ``{"lora_a": (fan_in, r), "lora_b": (r,
    fan_out)}`` in fp32, fan_out the product of the weight's trailing dims.
    ``A`` is normal with std ``1 / sqrt(fan_in)`` from ``generator``, ``B``
    zero, so ``W_eff == W`` until ``B`` is trained."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    out: LoraTree = {}
    for name, w in sd.items():
        shape = tuple(w.shape)
        if len(shape) < 2 or not _is_weight(name) or not _is_target(name, config):
            continue
        fan_in, fan_out = shape[0], math.prod(shape[1:])
        a = torch.randn((fan_in, config.r), generator=generator, dtype=torch.float32,
                        device=device) * (1.0 / fan_in ** 0.5)
        out[name] = {"lora_a": a,
                     "lora_b": torch.zeros((config.r, fan_out), dtype=torch.float32,
                                           device=device)}
    if not out:
        raise ValueError(f"no kernels matched target_modules {config.target_modules}")
    return out


def merge_lora(state_dict: Mapping[str, torch.Tensor], lora: Mapping[str, Mapping[str, torch.Tensor]],
               config: LoraConfig) -> Dict[str, torch.Tensor]:
    """``W + scaling * A @ B`` for each adapted weight, reshaped to ``W``'s
    shape and cast to its dtype; the other entries pass through."""
    out = {}
    for name, w in state_dict.items():
        ad = lora.get(name)
        if ad is None:
            out[name] = w
            continue
        delta = (ad["lora_a"].float() @ ad["lora_b"].float()) * config.scaling
        out[name] = w + delta.reshape(w.shape).to(device=w.device, dtype=w.dtype)
    return out
