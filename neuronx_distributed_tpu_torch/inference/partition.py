"""Tensor-parallel partition specs of the serving state and the weights.

Counterpart of ``neuronx_distributed_tpu/inference/partition.py``. A spec
is a tuple with one entry a dim, ``"tp"`` on the dim that shards over the
tensor-parallel ranks and ``None`` elsewhere; ``()`` is replicated (JAX's
``PartitionSpec`` as a tuple). :func:`leaf_partition_spec` derives the
spec of one serving leaf from its name, rule for rule as the JAX package:

* KV pools and their int8 scales (``cached_key``, ``cached_value``,
  ``cached_key_scale``, ``cached_value_scale``): the KV-head axis ``-2``;
* adapter stacks ``lora_<target>_a`` ``(L, slots, fan_in, r)`` of the
  row-parallel targets (``o_proj``, ``down_proj``) over fan-in, and
  ``lora_<target>_b`` ``(L, slots, r, fan_out)`` of every other target
  over fan-out;
* grammar tables ``need``/``next`` over the vocabulary (the last axis);
* everything else replicated, and so is a dim that the degree does not
  divide.

The name is a JAX tree path (``"['cache']['cached_key']"``) or the port's
dotted one (``"layers.3.cached_key"``): the last identifier decides. The
weights' specs come from the layers that hold them (``tp_shard_dims`` in
``parallel/layers.py``, by state-dict name, and a module's own
``partition_specs``): :func:`param_partition_specs`. An expert weight has
a second axis (JAX ``moe/expert_mlps.py:55-67``): ``("ep", None, "tp")``
for ``gate``/``up`` ``(E, H, I)``, ``("ep", "tp", None)`` for ``down``, its
experts over the expert-parallel ranks and its intermediate dim over TP.
:func:`shard_slice` turns any spec into a rank's slice, along each axis
it names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from neuronx_distributed_tpu_torch.parallel import mesh

Spec = Tuple[Optional[str], ...]

ROW_PARALLEL_TARGETS = ("o_proj", "down_proj")
KV_LEAVES = ("cached_key", "cached_value", "cached_key_scale", "cached_value_scale")

_LORA_LEAF = re.compile(r"^lora_(\w+?)_(a|b|scale)$")
_IDENT = re.compile(r"[A-Za-z_]\w*")


def tp_degree() -> int:
    """The current thread's tensor-parallel degree (1 off-mesh)."""
    if not mesh.model_parallel_is_initialized():
        return 1
    return mesh.get_tensor_model_parallel_size()


def _shardable(dim: int, tp: int) -> bool:
    return tp > 1 and dim % tp == 0


def _leaf_name(path: str) -> str:
    names = _IDENT.findall(path)
    return names[-1] if names else path


def leaf_partition_spec(path: str, shape: Sequence[int], tp: int) -> Spec:
    """The serving spec of one leaf by its name (see the module
    docstring); replicated when the sharded dim does not divide ``tp``."""
    nd = len(shape)
    leaf = _leaf_name(path)
    if leaf in KV_LEAVES:
        if nd >= 2 and _shardable(shape[-2], tp):
            return (None,) * (nd - 2) + ("tp", None)
        return ()
    m = _LORA_LEAF.match(leaf)
    if m is not None:
        target, kind = m.group(1), m.group(2)
        if (kind == "a" and target in ROW_PARALLEL_TARGETS and nd == 4
                and _shardable(shape[2], tp)):
            return (None, None, "tp", None)
        if (kind == "b" and target not in ROW_PARALLEL_TARGETS and nd == 4
                and _shardable(shape[3], tp)):
            return (None, None, None, "tp")
        return ()
    if leaf in ("need", "next"):
        if nd >= 1 and _shardable(shape[-1], tp):
            return (None,) * (nd - 1) + ("tp",)
        return ()
    return ()


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim a spec shards over ``axis`` (None: not over it)."""
    return spec.index(axis) if axis in spec else None


def sharded_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards over TP (None: replicated over it)."""
    return axis_dim(spec, "tp")


def local_shape(shape: Sequence[int], spec: Spec, tp: int, ep: int = 1) -> Tuple[int, ...]:
    """A rank's shard shape of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for axis, n in (("tp", tp), ("ep", ep)):
        d = axis_dim(spec, axis)
        if d is not None:
            out[d] //= n
    return tuple(out)


def shard_slice(t: torch.Tensor, spec: Spec, rank: int, tp: int, ep_rank: int = 0,
                ep: int = 1) -> torch.Tensor:
    """The contiguous slice of the global tensor ``t`` under ``spec`` that
    tensor-parallel rank ``rank`` of ``tp`` (and, for an expert leaf,
    expert-parallel rank ``ep_rank`` of ``ep``) holds; ``t`` itself when
    replicated."""
    for axis, r, n in (("tp", rank, tp), ("ep", ep_rank, ep)):
        d = axis_dim(spec, axis)
        if d is None or n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over {n} ranks")
        c = t.shape[d] // n
        t = t.narrow(d, r * c, c)
    return t


def dim_spec(ndim: int, dim: Optional[int]) -> Spec:
    """The spec that shards ``dim`` of an ``ndim``-dim tensor."""
    if dim is None:
        return ()
    return tuple("tp" if i == dim % ndim else None for i in range(ndim))


def param_partition_specs(model: torch.nn.Module) -> Dict[str, Spec]:
    """Each weight of ``model`` by state-dict name: its spec (``()`` for
    the replicated ones): a TP layer's from its ``tp_shard_dims``, any
    other module's from its ``partition_specs`` (the expert weights)."""
    from neuronx_distributed_tpu_torch.parallel.layers import tp_shard_dims

    dims = tp_shard_dims(model)
    own = {f"{prefix}.{attr}" if prefix else attr: spec
           for prefix, mod in model.named_modules()
           for attr, spec in getattr(mod, "partition_specs", {}).items()}
    return {name: own[name] if name in own else dim_spec(t.dim(), dims.get(name))
            for name, t in model.state_dict().items()}


def sharded_fraction(named: Mapping[str, Tuple[Sequence[int], int]], tp: int) -> float:
    """The share of the bytes of ``named`` (leaf name -> (global shape,
    bytes)) whose leaves carry a sharded spec at degree ``tp``."""
    total = sharded = 0
    for name, (shape, nbytes) in named.items():
        total += nbytes
        if sharded_dim(leaf_partition_spec(name, shape, tp)) is not None:
            sharded += nbytes
    return sharded / total if total else 0.0
