"""Model wrapper and its initialization, on one device.

Counterpart of ``neuronx_distributed_tpu/trainer/model.py``. The module is
built on the meta device, its config takes the trainer config's explicit
overrides (compute and param dtype, remat policy), and each weight is
materialized once on the target device: random from a seeded generator
(``model_init_config.seed``, through ``models.llama.init_params``) or taken
from a given state dict (for example one that
``converters.jax_params.llama_params_from_jax`` made). Parallel degrees
other than 1, LoRA and context parallelism raise: they come with later
slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from neuronx_distributed_tpu_torch._device import DeviceLike, resolve_device
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
_DEGREES = ("tensor_parallel_size", "pipeline_parallel_size", "expert_parallel_size",
            "context_parallel_size")


def resolve_dtype(name) -> torch.dtype:
    return _DTYPES[name] if isinstance(name, str) else name


@dataclasses.dataclass
class ParallelModel:
    """Module plus its weights by name. ``params`` holds tensors that share
    storage with the module's parameters: the tree the optimizer and the
    train step work on."""

    module: nn.Module
    params: Dict[str, torch.Tensor]
    device: torch.device

    def bind(self, params: Mapping[str, torch.Tensor]) -> None:
        """Point the module's parameters at ``params`` (no copy); a parameter
        that already uses its tensor's storage is left alone."""
        for name, p in self.module.named_parameters():
            t = params[name]
            if p.data_ptr() != t.data_ptr() or p.shape != t.shape or p.dtype != t.dtype:
                p.data = t

    def apply(self, params: Mapping[str, torch.Tensor], *args, method: str = "forward",
              **kwargs):
        """Run ``method`` of the module with ``params`` as its weights (see
        :meth:`bind`)."""
        self.bind(params)
        fn = self.module if method == "forward" else getattr(self.module, method)
        return fn(*args, **kwargs)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.values())


def _apply_config_overrides(module: nn.Module, nxd_config: Dict[str, Any]) -> nn.Module:
    """Apply the keys the user set explicitly (compute and param dtype,
    activation checkpointing) to the module's dataclass config, rebuilding
    it as ``type(module)(new_config)``; defaults never override a model's own
    choice."""
    cfg = getattr(module, "config", None)
    if cfg is None or not dataclasses.is_dataclass(cfg):
        return module
    over: Dict[str, Any] = {}
    mp = nxd_config.get("mixed_precision_config", {})
    explicit = nxd_config.get("_explicit_keys", {})
    for mp_key, field in (("compute_dtype", "dtype"), ("param_dtype", "param_dtype")):
        if mp_key in explicit.get("mixed_precision_config", ()) and hasattr(cfg, field):
            over[field] = resolve_dtype(mp[mp_key])
    ac = nxd_config.get("activation_checkpoint_config")
    if ac is not None and hasattr(cfg, "remat_policy"):
        over["remat_policy"] = ac
    if not over:
        return module
    return type(module)(dataclasses.replace(cfg, **over))


def initialize_parallel_model(nxd_config: Dict[str, Any], module_fn: Callable[[], nn.Module],
                              *example_args, device: DeviceLike = None,
                              params: Optional[Mapping[str, Any]] = None) -> ParallelModel:
    """Build the model of ``module_fn`` on ``device`` (``cuda`` unless asked
    otherwise) with the config's overrides, and make its weights trainable.
    ``example_args`` are accepted for the JAX signature; the port's modules
    know their shapes from their config. ``params`` (a state dict of tensors
    or arrays) replaces the seeded random init; each is copied to the device
    in the module's param dtype."""
    bad = {k: nxd_config.get(k, 1) for k in _DEGREES if nxd_config.get(k, 1) != 1}
    if bad:
        raise NotImplementedError(
            f"parallel degrees {bad}: the port trains on one device so far; tensor, pipeline, "
            "expert and context parallelism over torch.distributed come with a later slice "
            "(ROADMAP queue A, training line)")
    if nxd_config.get("lora_config") is not None:
        raise NotImplementedError("LoRA training is not ported yet (ROADMAP queue A)")
    dev = resolve_device(device)
    with torch.device("meta"):
        module = _apply_config_overrides(module_fn(), nxd_config)
    shapes = module.state_dict()
    if params is None:
        if not isinstance(module, LlamaForCausalLM):
            raise ValueError(f"a seeded init is defined for LlamaForCausalLM; pass params for "
                             f"{type(module).__name__}")
        seed = nxd_config.get("model_init_config", {}).get("seed", 0)
        state = init_params(module.config, torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
    else:
        # a copy: the train step updates the weights in place
        state = {n: torch.as_tensor(params[n]).to(device=dev, dtype=shapes[n].dtype, copy=True)
                 for n in shapes}
    module.load_state_dict(state, strict=True, assign=True)
    module.requires_grad_(True)
    return ParallelModel(module=module, device=dev,
                         params={n: p.detach() for n, p in module.named_parameters()})
