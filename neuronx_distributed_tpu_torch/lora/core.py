"""LoRA adapters on PyTorch: initialization, the merge, the training form,
the merged export and the adapters' partition specs.

Counterpart of ``neuronx_distributed_tpu/lora/core.py``: for every
targeted kernel ``W (in, out...)`` of a state dict, ``init_lora`` makes
``A (in, r)`` and ``B (r, out)`` with ``W_eff = W + (alpha / r) * A @ B``,
and ``merge_lora`` materializes ``W_eff``. The port's state dict keeps one
entry per decoder layer (``model.layers.{i}...``), so adapters are per layer
as the JAX package's stacked ones are.

Training (:func:`attach_adapters`) uses the exact in-activation form of JAX
``parallel/layers.py:65-80`` at every dropout rate, 0 included: a targeted
linear kernel's layer adds ``(dropout(x) @ A) @ (s * B)``, computed in the
layer's compute dtype, to ``x @ W``, so the frozen ``W`` never gets a
gradient of its own size. JAX merges into ``W`` when the rate is 0; the two
agree within fp32 rounding. The dropout keep-masks come from
:class:`LoraDropout`: per step one seed per adapter, drawn from a
``torch.Generator`` (the train state's), each mask drawn from its seed when
the layer runs, so activation checkpointing recomputes the same mask; or
masks given explicitly (``LoraDropout.use_masks``), for example the ones
``jax.random.bernoulli`` draws for the JAX layer's key. The port does not
reproduce threefry. Embedding adapters are merged in weight space, as in
JAX (dropping out token ids means nothing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

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


def flat_lora(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """``{weight: {"lora_a", "lora_b"}}`` -> ``{"weight.lora_a": A, ...}``,
    the flat tree the optimizer and the train step work on."""
    return {f"{w}.{k}": ad[k] for w, ad in lora.items() for k in ("lora_a", "lora_b")}


def nest_lora(flat: Mapping[str, torch.Tensor]) -> LoraTree:
    """The inverse of :func:`flat_lora`."""
    out: LoraTree = {}
    for name, t in flat.items():
        w, _, k = name.rpartition(".")
        out.setdefault(w, {})[k] = t
    return out


class LoraDropout:
    """Where each adapter's dropout keep-mask comes from in one step (rate
    ``1 - keep``): :meth:`draw` takes one seed per adapter from a generator,
    and the adapter draws its mask ``rand(x.shape) < keep`` from a generator
    on ``x``'s device seeded with it; :meth:`use_masks` gives the masks
    themselves (bool, shaped like the adapter's input)."""

    def __init__(self, keep: float):
        self.keep = keep
        self.seeds: Optional[Dict[str, int]] = None
        self.masks: Optional[Mapping[str, torch.Tensor]] = None

    def draw(self, generator: torch.Generator, names: List[str]) -> None:
        seeds = torch.randint(0, 2 ** 62, (len(names),), generator=generator,
                              device=generator.device)
        self.seeds, self.masks = dict(zip(names, seeds.tolist())), None

    def use_masks(self, masks: Mapping[str, torch.Tensor]) -> None:
        self.seeds, self.masks = None, masks

    def apply(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x * mask / keep`` in ``x``'s dtype (``keep`` rounded to it
        first, as JAX casts it)."""
        if self.masks is not None:
            mask = self.masks[name].to(x.device)
        elif self.seeds is not None:
            g = torch.Generator(device=x.device)
            g.manual_seed(self.seeds[name])
            mask = torch.rand(x.shape, generator=g, device=x.device) < self.keep
        else:
            raise RuntimeError("LoRA dropout has no masks for this step: call draw() or "
                               "use_masks() first")
        keep = torch.tensor(self.keep, dtype=torch.float32, device=x.device).to(x.dtype)
        return x * mask.to(x.dtype) / keep


class Adapter:
    """One targeted weight's adapter: ``a (fan_in, r)`` and ``b (r,
    fan_out)`` (the trainable tensors themselves), its scaling and its
    dropout. Called on a layer's input ``x`` it returns ``(dropout(x) @ A)
    @ (s * B)`` in ``x``'s dtype, shaped ``(..., fan_out)``;
    :meth:`merged` gives ``W + s * A @ B`` for the weight-space form."""

    def __init__(self, name: str, a: torch.Tensor, b: torch.Tensor, scaling: float,
                 dropout: Optional[LoraDropout] = None):
        self.name, self.a, self.b, self.scaling, self.dropout = name, a, b, scaling, dropout

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            x = self.dropout.apply(self.name, x)
        return (x @ self.a.to(x.dtype)) @ (self.b * self.scaling).to(x.dtype)

    def merged(self, w: torch.Tensor) -> torch.Tensor:
        delta = (self.a @ self.b) * self.scaling
        return w + delta.reshape(w.shape).to(w.dtype)


def attach_adapters(module: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]],
                    config: LoraConfig) -> Optional[LoraDropout]:
    """Install an :class:`Adapter` on every layer of ``module`` that holds a
    weight of ``lora`` (keyed by state-dict name), reading the given
    tensors (the trainable leaves; rebinding their ``.data`` later is
    seen). Returns the :class:`LoraDropout` the adapters share when
    ``config.lora_dropout > 0`` (None otherwise)."""
    dropout = LoraDropout(1.0 - config.lora_dropout) if config.lora_dropout > 0 else None
    found = set()
    for prefix, mod in module.named_modules():
        slots = getattr(mod, "adapters", None)
        if slots is None:
            continue
        for attr in list(dict(mod.named_parameters(recurse=False))) + [
                n for n, _ in mod.named_children()]:
            name = f"{prefix}.{attr}" if prefix else attr
            ad = lora.get(name)
            if ad is None:
                continue
            if not isinstance(getattr(mod, attr), nn.Parameter):
                raise NotImplementedError(f"{name}: LoRA training on an int8 weight is not "
                                          f"ported")
            if getattr(mod, "tp", 1) > 1:
                raise NotImplementedError(f"{name}: LoRA training under tensor parallelism "
                                          f"comes with the parallel training slice")
            # embeddings merge in weight space (JAX attach_adapters)
            slots[attr] = Adapter(name, ad["lora_a"], ad["lora_b"], config.scaling,
                                  None if attr == "embedding" else dropout)
            found.add(name)
    missing = set(lora) - found
    if missing:
        raise KeyError(f"adapters for weights no layer of the module holds: {sorted(missing)[:4]}")
    return dropout


def export_merged_hf(params: Mapping[str, torch.Tensor],
                     lora: Mapping[str, Mapping[str, torch.Tensor]], config: LoraConfig,
                     model_config, out_dir: str, family: str = "llama",
                     dtype: Optional[torch.dtype] = None) -> str:
    """Merge ``W + s * A @ B`` and write an HF checkpoint of ``family``
    (``converters/hf.py``'s ``FAMILIES``) that serves with no LoRA
    machinery. Returns the path of ``model.safetensors``."""
    from neuronx_distributed_tpu_torch.converters.hf import FAMILIES
    from neuronx_distributed_tpu_torch.converters.hf_llama import save_hf_checkpoint

    to_hf = FAMILIES[family].nxd_to_hf
    return save_hf_checkpoint(to_hf(merge_lora(params, lora, config), model_config,
                                    dtype=dtype or torch.float32), out_dir)


Spec = Tuple[Optional[str], ...]


def lora_param_specs(lora: Mapping[str, Mapping[str, torch.Tensor]],
                     param_specs: Mapping[str, Spec]) -> Dict[str, Dict[str, Spec]]:
    """Each adapter's specs from its base weight's (``inference/partition``
    terms: ``"tp"`` on the sharded dim, ``()`` replicated): ``A`` keeps the
    weight's fan-in entry, ``B`` its first fan-out entry on its last dim."""
    out = {}
    for name in lora:
        entries = list(param_specs.get(name, ()))
        in_axis = entries[0] if entries else None
        out_axis = entries[1] if len(entries) > 1 else None
        out[name] = {"lora_a": (in_axis, None), "lora_b": (None, out_axis)}
    return out
