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
``torch.Generator`` (the train state's), each mask computed from its seed
when the layer runs (a row at a time, from a generator seeded by the seed and
the row's index), so activation checkpointing recomputes the same mask; or
masks given explicitly (``LoraDropout.use_masks``), for example the ones
``jax.random.bernoulli`` draws for the JAX layer's key. The port does not
reproduce threefry. Embedding adapters are merged in weight space, as in
JAX (dropping out token ids means nothing).

Tensor parallelism (JAX ``lora_param_specs``, ``layers.py:65-80`` under
GSPMD): a rank holds each adapter's slice of the one global draw, ``A``
cut like its weight's fan-in and ``B`` like its fan-out. So a
column-parallel (or GQA) layer's ``A`` is whole on every rank, a
row-parallel layer's and the embedding's ``B`` is whole, and a compact K/V
kernel's (``kv_size_multiplier > 1``) ``A`` and ``B`` are both whole. A
whole leaf is used by every rank on its own part of the product, so its
gradient is a rank's partial sum: :class:`Adapter` reads it through a copy
region, whose backward all-reduces the gradient over the group, and the
leaves stay bit-identical across the ranks. A row-parallel layer's delta is
a partial sum too and goes through the layer's one all-reduce with the
base product. The dropout masks are the global activation's: each row of
the global batch is drawn from its own generator, seeded by the adapter's
seed and the row's global index, at the row's global shape (every
context-parallel rank's positions, a row-parallel input's whole fan-in),
so a rank draws its own rows alone, keeps its block of them, and every
layout draws the masks one rank would; masks given for a step are global,
and the rank keeps its block of them.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel.mappings import copy_to_tensor_parallel_region

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


Cut = Tuple[int, int]   # (this rank's block, blocks) along one dim

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """The splitmix64 finalizer: a bijective 64-bit integer hash."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def row_seed(seed: int, row: int) -> int:
    """The generator seed of global row ``row`` of an adapter's mask."""
    return _splitmix64(seed ^ _splitmix64(row)) >> 1


class LoraDropout:
    """Where each adapter's dropout keep-mask comes from in one step (rate
    ``1 - keep``): :meth:`draw` takes one seed per adapter from a generator,
    and the adapter draws the rank's rows of its global mask from it, each
    row ``rand(the row's global shape) < keep`` from a generator seeded by
    the seed and the row's global index (:func:`row_seed`), cut to the
    rank's block of the sequence and features; :meth:`use_masks` gives the
    global masks themselves (bool, shaped like the global activation), of
    which the rank keeps its block. ``rows``/``seq``: this rank's block of
    the batch (data parallelism) and of the sequence (context
    parallelism)."""

    def __init__(self, keep: float, rows: Cut = (0, 1), seq: Cut = (0, 1)):
        self.keep = keep
        self.rows, self.seq = tuple(rows), tuple(seq)
        self.seeds: Optional[Dict[str, int]] = None
        self.masks: Optional[Mapping[str, torch.Tensor]] = None

    def draw(self, generator: torch.Generator, names: List[str]) -> None:
        seeds = torch.randint(0, 2 ** 62, (len(names),), generator=generator,
                              device=generator.device)
        self.seeds, self.masks = dict(zip(names, seeds.tolist())), None

    def use_masks(self, masks: Mapping[str, torch.Tensor]) -> None:
        self.seeds, self.masks = None, masks

    def _cuts(self, x: torch.Tensor, features: Optional[Cut]) -> List[Tuple[int, int, int]]:
        """``(dim, block, blocks)`` of each dim a rank holds a block of."""
        cuts = [(0, *self.rows)]
        if x.dim() >= 3:
            cuts.append((1, *self.seq))
        if features is not None:
            cuts.append((x.dim() - 1, *features))
        return [c for c in cuts if c[2] > 1]

    def apply(self, name: str, x: torch.Tensor, features: Optional[Cut] = None) -> torch.Tensor:
        """``x * mask / keep`` in ``x``'s dtype (``keep`` rounded to it
        first, as JAX casts it). ``features``: this rank's block of the
        input features (a row-parallel layer's fan-in)."""
        cuts = self._cuts(x, features)
        if self.masks is not None:
            mask = self.masks[name].to(x.device)
            for d, r, _ in cuts:   # the rank's block of the global mask
                mask = mask.narrow(d, r * x.shape[d], x.shape[d])
        elif self.seeds is not None:
            mask = self._drawn(self.seeds[name], x, cuts)
        else:
            raise RuntimeError("LoRA dropout has no masks for this step: call draw() or "
                               "use_masks() first")
        keep = torch.tensor(self.keep, dtype=torch.float32, device=x.device).to(x.dtype)
        return x * mask.to(x.dtype) / keep

    def _drawn(self, seed: int, x: torch.Tensor, cuts) -> torch.Tensor:
        """The rank's block of ``seed``'s global mask, a row at a time: only
        the rank's rows are drawn, each at its global shape, then cut."""
        row_shape = list(x.shape[1:])
        first = 0
        for d, r, n in cuts:
            if d == 0:
                first = r * x.shape[0]
            else:
                row_shape[d - 1] *= n
        g = torch.Generator(device=x.device)
        out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
        for i in range(x.shape[0]):
            g.manual_seed(row_seed(seed, first + i))
            row = torch.rand(row_shape, generator=g, device=x.device) < self.keep
            for d, r, _ in cuts:
                if d > 0:
                    row = row.narrow(d - 1, r * x.shape[d], x.shape[d])
            out[i] = row
        return out


class Adapter:
    """One targeted weight's adapter: ``a (fan_in, r)`` and ``b (r,
    fan_out)`` (the trainable tensors themselves, a rank's slices under
    TP), its scaling and its dropout. Called on a layer's input ``x`` it
    returns ``(dropout(x) @ A) @ (s * B)`` in ``x``'s dtype, shaped
    ``(..., fan_out)``; :meth:`merged` gives ``W + s * A @ B`` for the
    weight-space form. ``group``: the TP group over which ``whole`` names
    the leaves (``"lora_a"``, ``"lora_b"``) every rank holds whole, read
    through a copy region; ``features``: the rank's block of the input
    features (a row-parallel layer), for the dropout mask."""

    def __init__(self, name: str, a: torch.Tensor, b: torch.Tensor, scaling: float,
                 dropout: Optional[LoraDropout] = None, group=None,
                 whole: Tuple[str, ...] = (), features: Optional[Cut] = None):
        self.name, self.a, self.b, self.scaling, self.dropout = name, a, b, scaling, dropout
        self.group, self.whole, self.features = group, tuple(whole), features

    def _leaves(self) -> Tuple[torch.Tensor, torch.Tensor]:
        a, b = self.a, self.b
        if self.group is not None:
            # a whole leaf's gradient is the ranks' partial sums: summed once
            if "lora_a" in self.whole:
                a = copy_to_tensor_parallel_region(a, self.group)
            if "lora_b" in self.whole:
                b = copy_to_tensor_parallel_region(b, self.group)
        return a, b

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            x = self.dropout.apply(self.name, x, self.features)
        a, b = self._leaves()
        return (x @ a.to(x.dtype)) @ (b * self.scaling).to(x.dtype)

    def merged(self, w: torch.Tensor) -> torch.Tensor:
        a, b = self._leaves()
        delta = (a @ b) * self.scaling
        return w + delta.reshape(w.shape).to(w.dtype)


def attach_adapters(module: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]],
                    config: LoraConfig, rows: Cut = (0, 1),
                    seq: Cut = (0, 1)) -> Optional[LoraDropout]:
    """Install an :class:`Adapter` on every layer of ``module`` that holds a
    weight of ``lora`` (keyed by state-dict name), reading the given
    tensors (the trainable leaves, a rank's slices under a TP group;
    rebinding their ``.data`` later is seen). Returns the
    :class:`LoraDropout` the adapters share when ``config.lora_dropout >
    0`` (None otherwise), its masks cut to ``rows``/``seq`` (this rank's
    block of the batch and of the sequence)."""
    dropout = (LoraDropout(1.0 - config.lora_dropout, rows, seq) if config.lora_dropout > 0
               else None)
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
            tp = getattr(mod, "tp", 1)
            # the weight's sharded dim (None: whole on every rank): A takes
            # its fan-in cut (dim 0), B its fan-out cut, the other is whole
            dim = mod.tp_shard_dims.get(attr) if tp > 1 else None
            whole = () if tp == 1 else (("lora_a", "lora_b") if dim is None
                                        else ("lora_b",) if dim == 0 else ("lora_a",))
            features = (mod.tp_rank, tp) if tp > 1 and dim == 0 else None
            # embeddings merge in weight space (JAX attach_adapters)
            slots[attr] = Adapter(name, ad["lora_a"], ad["lora_b"], config.scaling,
                                  None if attr == "embedding" else dropout,
                                  group=mod.group if tp > 1 else None, whole=whole,
                                  features=features)
            found.add(name)
    missing = set(lora) - found
    if missing:
        raise KeyError(f"adapters for weights no layer of the module holds: {sorted(missing)[:4]}")
    return dropout


def export_merged_hf(params: Mapping[str, torch.Tensor],
                     lora: Mapping[str, Mapping[str, torch.Tensor]], config: LoraConfig,
                     model_config, out_dir: str, family: str = "llama",
                     dtype: Optional[torch.dtype] = None, *,
                     param_specs: Optional[Mapping[str, Spec]] = None,
                     group=None) -> str:
    """Merge ``W + s * A @ B`` and write an HF checkpoint of ``family``
    (``converters/hf.py``'s ``FAMILIES``) that serves with no LoRA
    machinery. Returns the path of ``model.safetensors``. Under a TP
    ``group`` the params and adapters are a rank's slices under
    ``param_specs`` (and :func:`lora_param_specs`): every rank gathers the
    global tensors over the group, merges them, and its rank 0 writes."""
    from neuronx_distributed_tpu_torch.converters.hf import FAMILIES
    from neuronx_distributed_tpu_torch.converters.hf_llama import save_hf_checkpoint
    from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size

    if group is not None and group_size(group) > 1:
        if param_specs is None:
            raise ValueError("a TP export needs the params' specs to gather them")
        params = _gather_tp(params, param_specs, group)
        specs = lora_param_specs(lora, param_specs)
        lora = {w: _gather_tp(ad, specs[w], group) for w, ad in lora.items()}
    path = os.path.join(out_dir, "model.safetensors")
    if group_rank(group) == 0:
        to_hf = FAMILIES[family].nxd_to_hf
        path = save_hf_checkpoint(to_hf(merge_lora(params, lora, config), model_config,
                                        dtype=dtype or torch.float32), out_dir)
    return path


def _gather_tp(tree: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
               group) -> Dict[str, torch.Tensor]:
    """The global tensors of a rank's TP slices (``specs``: each entry's
    spec, ``"tp"`` on its sharded dim), all-gathered over ``group`` in
    the tree's order; whole entries pass through."""
    from neuronx_distributed_tpu_torch.parallel.mappings import all_gather

    out = {}
    for name, t in tree.items():
        spec = tuple(specs.get(name, ()))
        out[name] = all_gather(t.detach(), spec.index("tp"), group) if "tp" in spec else t
    return out


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
