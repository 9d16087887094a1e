"""Model wrapper and its initialization, on one rank of a parallel world.

Counterpart of ``neuronx_distributed_tpu/trainer/model.py``. The module is
built on the meta device, its config takes the trainer config's explicit
overrides (compute and param dtype, remat policy, sequence parallelism),
and each weight is materialized once on the target device: random from a
seeded generator (``model_init_config.seed``, through
``models.llama.init_params``: the Llama, Mixtral, GPT-NeoX and BERT models)
or taken from a given state dict (for example
one that ``converters.jax_params.llama_params_from_jax`` made).

Parallel degrees (JAX ``trainer/model.py:86-184``): the mesh is the current
one (``parallel/mesh.py``), or is initialized from the config's degrees over
the default group. Under a tensor-parallel degree above 1 the module is
built with the mesh's TP group, and each rank materializes its shard of the
one global init: ``init_params`` draws every leaf whole and cuts the rank's
slice, and a given global state dict is sliced the same way (a dict of the
rank's shards is taken as it is), so every layout trains the same weights.
Data parallelism (``dp = edp * ep``, a dense model) needs nothing here: the
train step reduces the gradients over it. Expert parallelism (JAX
``:139-150``): a Mixtral model (a config with ``num_experts``) is built with
the mesh's ep and dp groups for its MoE blocks, and each rank takes its
(ep, tp) slice of every expert weight (the seeded init draws each leaf
whole and cuts it; a given global tree is cut the same way). MoE under
pipeline parallelism raises by name (``models/llama_pipeline.py``, fault
C13 of the reference). Context parallelism (JAX
``:110-117``): a mesh with ``cp > 1`` (or the config's
``context_parallel_size`` when this call makes the mesh) sets the model's
``context_parallel``, and the module is built with the mesh's cp group;
the step sums the gradients over it. A Mixtral model's MoE blocks then take
the cp group too: their capacity, drop order and auxiliary losses run over
the global batch and sequence (``moe/expert_mlps.py``). Pipeline
parallelism takes a ``models.llama_pipeline.PipelinedLlama`` (its
``as_parallel_model``), not this function.

LoRA (JAX ``trainer/model.py:39-86, 137-184``): with a ``lora_config`` the
base weights stay frozen (``requires_grad=False``: no gradient, no
optimizer state, no gradient GEMMs), ``init_lora`` draws the adapters from
a generator seeded ``seed + 1``, they are attached to the layers in the
in-activation form (``lora.core.attach_adapters``), and the trainable tree
is theirs: ``trainable_params`` (``"{weight}.lora_a"`` / ``.lora_b``),
``trainable_specs`` and ``merged_params``. Under a tensor-parallel degree
above 1 every adapter is drawn at its global shape (its weight's global
fan-in and fan-out) and each rank keeps its slice under
``lora_param_specs``, as the base weights are cut from one global init;
the dropout masks are the global batch's, each rank computing its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from neuronx_distributed_tpu_torch._device import DeviceLike, resolve_device
from neuronx_distributed_tpu_torch.inference.partition import (
    global_shape,
    param_partition_specs,
    shard_slice,
)
from neuronx_distributed_tpu_torch.lora.core import (
    LoraConfig,
    LoraDropout,
    attach_adapters,
    flat_lora,
    init_lora,
    lora_param_specs,
    merge_lora,
    nest_lora,
)
from neuronx_distributed_tpu_torch.models.bert import BertForPreTraining
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params
from neuronx_distributed_tpu_torch.parallel import mesh as ps
from neuronx_distributed_tpu_torch.parallel.partitioning import local_state_dict

# the modules ``init_params`` draws (Llama, Mixtral and GPT-NeoX are
# LlamaForCausalLM subclasses)
_SEEDED = (LlamaForCausalLM, BertForPreTraining)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
_DEGREES = ("tensor_parallel_size", "pipeline_parallel_size", "expert_parallel_size",
            "context_parallel_size")


def resolve_dtype(name) -> torch.dtype:
    return _DTYPES[name] if isinstance(name, str) else name


@dataclasses.dataclass
class ParallelModel:
    """Module plus its weights by name. ``params`` holds tensors that share
    storage with the module's parameters. Without LoRA they are the tree the
    optimizer and the train step work on; with LoRA that tree is the
    adapters' (``lora_leaves``: the tensors the layers read, which take the
    gradients) and ``params`` is the frozen base."""

    module: nn.Module
    params: Dict[str, torch.Tensor]
    device: torch.device
    seed: int = 0
    # the tensor-parallel group the module was built with (None: one rank)
    group: Any = None
    # the context-parallel group (None: no CP): the step sums gradients over it
    cp_group: Any = None
    # the pipeline-parallel group (None: no PP): a PipelinedLlama's stage;
    # the grad norm sums over it
    pp_group: Any = None
    lora_config: Optional[LoraConfig] = None
    lora_leaves: Optional[Dict[str, torch.Tensor]] = None
    lora_specs: Optional[Dict[str, Dict[str, tuple]]] = None
    lora_dropout: Optional[LoraDropout] = None

    def bind(self, params: Mapping[str, torch.Tensor]) -> None:
        """Point the module's parameters at ``params`` (no copy); a parameter
        that already uses its tensor's storage is left alone."""
        _rebind(dict(self.module.named_parameters()), params)

    def apply(self, params: Mapping[str, torch.Tensor], *args, method: str = "forward",
              **kwargs):
        """Run ``method`` of the module with ``params`` as its weights (see
        :meth:`bind`)."""
        self.bind(params)
        fn = self.module if method == "forward" else getattr(self.module, method)
        return fn(*args, **kwargs)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.values())

    def trainable_leaves(self) -> Dict[str, torch.Tensor]:
        """The tensors that take gradients, by trainable name."""
        if self.lora_config is not None:
            return self.lora_leaves
        return dict(self.module.named_parameters())

    @property
    def trainable_params(self) -> Dict[str, torch.Tensor]:
        return {n: t.detach() for n, t in self.trainable_leaves().items()}

    @property
    def trainable_specs(self) -> Dict[str, tuple]:
        """Partition specs (``inference/partition.py`` terms) of the
        trainable tree."""
        if self.lora_config is not None:
            return {f"{w}.{k}": spec for w, ad in self.lora_specs.items()
                    for k, spec in ad.items()}
        return param_partition_specs(self.module)

    def bind_trainable(self, params: Mapping[str, torch.Tensor]) -> None:
        """Point the trainable tensors at ``params`` (see :meth:`bind`)."""
        _rebind(self.trainable_leaves(), params)

    def merged_params(self, lora_params: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
        """The base with ``W + s * A @ B`` folded in (``lora_params``: a
        flat adapter tree, default the live one); the base itself without
        LoRA."""
        if self.lora_config is None:
            return self.params
        flat = self.trainable_params if lora_params is None else lora_params
        return merge_lora(self.params, nest_lora(flat), self.lora_config)


def _rebind(targets: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor]) -> None:
    for name, p in targets.items():
        t = params[name]
        if p.data_ptr() != t.data_ptr() or p.shape != t.shape or p.dtype != t.dtype:
            p.data = t


def _apply_config_overrides(module: nn.Module, nxd_config: Dict[str, Any],
                            group=None, cp_group=None, moe_groups=None) -> nn.Module:
    """Apply the keys the user set explicitly (compute and param dtype,
    activation checkpointing, sequence parallelism) and context parallelism
    (on whenever the mesh has ``cp > 1``) to the module's dataclass config,
    rebuilding it as ``type(module)(new_config)`` (``group=group`` under
    tensor parallelism, ``cp_group=cp_group`` under context parallelism,
    and a Mixtral model's ``moe_groups``: its ``ep_group``/``dp_group``);
    defaults never override a model's own choice."""
    cfg = getattr(module, "config", None)
    moe_groups = {k: g for k, g in (moe_groups or {}).items() if g is not None}
    if cfg is None or not dataclasses.is_dataclass(cfg):
        if group is not None or cp_group is not None or moe_groups:
            raise ValueError(f"{type(module).__name__} has no dataclass config to rebuild "
                             f"it over a parallel group")
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
    if explicit.get("sequence_parallel") and hasattr(cfg, "sequence_parallel"):
        over["sequence_parallel"] = bool(nxd_config.get("sequence_parallel"))
    if cp_group is not None and hasattr(cfg, "context_parallel"):
        # keyed on the mesh's cp, not the config's: a cp axis without ring
        # attention would run the whole forward on every rank
        over["context_parallel"] = True
    if not over and group is None and not moe_groups:
        return module
    new_cfg = dataclasses.replace(cfg, **over)
    kw = dict(moe_groups)
    if group is not None:
        kw["group"] = group
    if cp_group is not None:
        kw["cp_group"] = cp_group
    return type(module)(new_cfg, **kw)


def _mesh(nxd_config: Dict[str, Any]) -> None:
    """The current mesh, or one made from the config's degrees over the
    default group."""
    degrees = {k: int(nxd_config.get(k, 1)) for k in _DEGREES}
    if not ps.model_parallel_is_initialized() and any(v != 1 for v in degrees.values()):
        ps.initialize_model_parallel(
            tensor_model_parallel_size=degrees["tensor_parallel_size"],
            pipeline_model_parallel_size=degrees["pipeline_parallel_size"],
            expert_model_parallel_size=degrees["expert_parallel_size"],
            context_parallel_size=degrees["context_parallel_size"])


def initialize_parallel_model(nxd_config: Dict[str, Any], module_fn: Callable[[], nn.Module],
                              *example_args, device: DeviceLike = None,
                              params: Optional[Mapping[str, Any]] = None) -> ParallelModel:
    """Build the model of ``module_fn`` on ``device`` (``cuda`` unless asked
    otherwise) with the config's overrides, and make its weights trainable.
    ``example_args`` are accepted for the JAX signature; the port's modules
    know their shapes from their config. ``params`` (a state dict of tensors
    or arrays: the global weights, or this rank's shards) replaces the
    seeded random init; each is copied to the device in the module's param
    dtype."""
    _mesh(nxd_config)
    on_mesh = ps.model_parallel_is_initialized()
    tp = ps.get_tensor_model_parallel_size() if on_mesh else 1
    tp_rank = ps.tensor_model_parallel_rank() if on_mesh else 0
    group = ps.get_tensor_model_parallel_group() if tp > 1 else None
    cp = ps.get_context_parallel_size() if on_mesh else 1
    cp_group = ps.get_context_parallel_group() if cp > 1 else None
    ep = ps.get_expert_model_parallel_size() if on_mesh else 1
    ep_rank = ps.expert_model_parallel_rank() if on_mesh else 0
    dp = ps.get_data_parallel_size() if on_mesh else 1
    lora_cfg = nxd_config.get("lora_config")
    dev = resolve_device(device)
    with torch.device("meta"):
        module = module_fn()
        # the MoE blocks trade tokens over ep and count them over dp and cp
        moe = dict(ep_group=ps.get_expert_model_parallel_group() if ep > 1 else None,
                   dp_group=ps.get_data_parallel_group() if dp > 1 else None) \
            if hasattr(getattr(module, "config", None), "num_experts") else None
        module = _apply_config_overrides(module, nxd_config, group, cp_group, moe)
    if not moe:   # no expert leaves: nothing is cut over ep
        ep, ep_rank = 1, 0
    shapes = module.state_dict()
    seed = nxd_config.get("model_init_config", {}).get("seed", 0)
    if params is None:
        if not isinstance(module, _SEEDED):
            raise ValueError(f"a seeded init is defined for the Llama stack's families and "
                             f"BERT; pass params for {type(module).__name__}")
        state = init_params(module.config, torch.Generator(device=dev).manual_seed(seed),
                            device=dev, model_cls=type(module), tp_rank=tp_rank, tp_size=tp,
                            ep_rank=ep_rank, ep_size=ep)
    else:
        given = {n: params[n] for n in shapes}
        if group is not None or ep > 1:
            given = local_state_dict(given, param_partition_specs(module), tp_rank, tp,
                                     {n: t.shape for n, t in shapes.items()}, ep_rank, ep)
        # a copy: the train step updates the weights in place
        state = {n: torch.as_tensor(given[n]).to(device=dev, dtype=shapes[n].dtype, copy=True)
                 for n in shapes}
    module.load_state_dict(state, strict=True, assign=True)
    module.requires_grad_(lora_cfg is None)
    model = ParallelModel(module=module, device=dev, seed=seed, group=group, cp_group=cp_group,
                          params={n: p.detach() for n, p in module.named_parameters()})
    if lora_cfg is not None:
        if isinstance(lora_cfg, dict):
            lora_cfg = LoraConfig(**lora_cfg)
        specs = param_partition_specs(module)
        # drawn whole (the global shapes), then each rank's slice
        glob = {n: torch.empty(global_shape(p.shape, specs.get(n, ()), tp, ep), device="meta")
                for n, p in model.params.items()}
        lora = init_lora(glob, lora_cfg, torch.Generator(device=dev).manual_seed(seed + 1),
                         device=dev)
        model.lora_specs = lora_param_specs(lora, specs)
        lora = {w: {k: shard_slice(t, model.lora_specs[w][k], tp_rank, tp).contiguous()
                    for k, t in ad.items()} for w, ad in lora.items()}
        leaves = {n: t.requires_grad_(True) for n, t in flat_lora(lora).items()}
        model.lora_config, model.lora_leaves = lora_cfg, leaves
        cut = ((ps.data_parallel_rank(), dp), (ps.context_parallel_rank(), cp)) if on_mesh \
            else ((0, 1), (0, 1))
        model.lora_dropout = attach_adapters(module, nest_lora(leaves), lora_cfg, *cut)
    return model
