"""ZeRO-1: the optimizer state sharded over the data-parallel ranks.

Counterpart of ``neuronx_distributed_tpu/optimizer/zero1.py`` (the
reference's ``NeuronZero1Optimizer``). The JAX package states ZeRO-1 as a
``PartitionSpec`` per state leaf that adds the DP axes to one dim and lets
GSPMD derive the dataflow; its kernel route writes that dataflow out under
``shard_map`` (``trainer/step.py:186-234``). Here it is that operational
dataflow, over the data-parallel group:

1. each gradient is reduce-scattered over DP (mean) along its ZeRO dim;
2. the rank updates its state shard (B4, ``fused_adamw_leaf``, where the
   shard is a supported leaf; the plain formula otherwise);
3. the new param shards are all-gathered along that dim.

:func:`zero1_param_spec` chooses the same dim per leaf as JAX's: the first
unsharded dim that stays divisible by the DP degree, then extending an
already sharded dim, else none (the leaf is all-reduced and keeps
replicated state). Specs are tuples in JAX's terms: per dim ``None``, an
axis name or a tuple of axis names (``("tp", "edp")``); ``()`` replicated.

Layout on a rank: a param is its tensor-parallel shard (``local``); its
ZeRO state is the ``dp_rank``-th of ``dp`` equal slices of that shard
along the ZeRO dim, a contiguous tensor of its own.

Expert leaves (JAX ``:19-23``, the reference's ``NeuronEPZero1Optimizer``):
a leaf whose spec uses ``ep`` (an expert weight, ``(ep, None, tp)``) is
already split over the expert-parallel ranks, so its state shards over
``edp`` alone, and its gradient, which its owner collects from every rank
of its ep group through the all-to-all, is reduced over the
expert-data-parallel group (the ranks that hold the same experts) and
divided by the whole DP degree, as every gradient is the mean over DP
(:meth:`Zero1Plan.reduction`). A slice along a dim
other than 0 is strided in the param, so the reduce-scatter is fed from a
staging copy arranged rank-major and the all-gather lands in one before
the param takes it; ``staging_copies`` counts those copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from neuronx_distributed_tpu_torch.parallel import mappings
from neuronx_distributed_tpu_torch.parallel import mesh as ps

DP_AXES = (ps.EDP_AXIS, ps.EP_AXIS)

Spec = Tuple


def _entries(spec: Optional[Sequence], ndim: int) -> list:
    entries = list(spec) if spec else []
    return entries + [None] * (ndim - len(entries))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def axis_sizes() -> Dict[str, int]:
    """The current mesh's axis sizes (every axis 1 off-mesh)."""
    if not ps.model_parallel_is_initialized():
        return {axis: 1 for axis in ps.MESH_AXES}
    shape = ps.rank_layout(ps.get_world_size(), ps.get_tensor_model_parallel_size(),
                           ps.get_pipeline_model_parallel_size(),
                           ps.get_expert_model_parallel_size(),
                           ps.get_context_parallel_size())["shape"]
    return dict(zip(ps.MESH_AXES, shape))


def zero1_param_spec(spec: Optional[Sequence], shape: Sequence[int],
                     sizes: Optional[Mapping[str, int]] = None) -> Spec:
    """A param's spec (global ``shape``) with the DP axes added to one dim:
    the first unsharded dim that stays divisible, then an already sharded
    one; the spec unchanged when nothing divides (JAX ``zero1_param_spec``)."""
    sizes = axis_sizes() if sizes is None else sizes
    entries = _entries(spec, len(shape))
    used = {ax for e in entries for ax in _entry_axes(e)}
    dp_axes = tuple(ax for ax in DP_AXES if ax not in used and sizes.get(ax, 1) > 1)
    if not dp_axes:
        return tuple(entries) if any(e is not None for e in entries) else ()
    dp_size = 1
    for ax in dp_axes:
        dp_size *= sizes[ax]

    def divisor(entry) -> int:
        d = 1
        for ax in _entry_axes(entry):
            d *= sizes.get(ax, 1)
        return d

    for want_unsharded in (True, False):
        for i, dim in enumerate(shape):
            e = entries[i]
            if want_unsharded != (e is None):
                continue
            if dim % (divisor(e) * dp_size) == 0:
                entries[i] = (_entry_axes(e) + dp_axes if e is not None
                              else (dp_axes if len(dp_axes) > 1 else dp_axes[0]))
                return tuple(entries)
    return tuple(entries) if any(e is not None for e in entries) else ()


def zero1_opt_state_specs(param_specs: Mapping[str, Spec],
                          shapes: Mapping[str, Sequence[int]],
                          sizes: Optional[Mapping[str, int]] = None) -> Dict[str, Spec]:
    """Each leaf's ZeRO-1 state spec (``shapes``: global shapes)."""
    return {n: zero1_param_spec(param_specs.get(n, ()), shapes[n], sizes) for n in shapes}


def zero_dim(param_spec: Spec, state_spec: Spec, ndim: int) -> Optional[int]:
    """The dim where ``state_spec`` extends ``param_spec`` by DP axes (None:
    the state is laid out as the param). Raises if it does not extend it
    (JAX ``step.py:107-115``)."""
    pe, se = _entries(param_spec, ndim), _entries(state_spec, ndim)
    for d in range(ndim):
        pa, sa = _entry_axes(pe[d]), _entry_axes(se[d])
        if sa != pa:
            if sa[:len(pa)] != pa:
                raise ValueError(f"state spec {se} does not extend param spec {pe}")
            return d
    return None


def _axis_dim(spec: Spec, axis: str) -> Optional[int]:
    for d, e in enumerate(spec or ()):
        if axis in _entry_axes(e):
            return d
    return None


def _tp_dim(spec: Spec) -> Optional[int]:
    return _axis_dim(spec, ps.TP_AXIS)


@dataclasses.dataclass
class Zero1Plan:
    """Per trainable leaf: its spec (``param_specs``), its state spec in
    JAX's terms (``state_specs``) and the dim its state shards over DP
    (``dims``; None: all-reduced, state as the param). ``dp_group`` (None
    off-mesh or at DP 1), ``dp`` and ``dp_rank``; ``tp``/``tp_rank`` and
    ``ep``/``ep_rank`` the tensor- and expert-parallel degrees and ranks
    the specs were made for; ``expert`` the leaves sharded over ``ep``,
    whose gradients and state go over ``edp_group`` (``edp``,
    ``edp_rank``) instead of the DP group."""

    param_specs: Dict[str, Spec]
    state_specs: Dict[str, Spec]
    dims: Dict[str, Optional[int]]
    dp_group: object = None
    dp: int = 1
    dp_rank: int = 0
    tp: int = 1
    tp_rank: int = 0
    ep: int = 1
    ep_rank: int = 0
    edp_group: object = None
    edp: int = 1
    edp_rank: int = 0
    expert: frozenset = frozenset()

    def reduction(self, name: str) -> Tuple[object, int, int]:
        """The leaf's gradient reduction ``(group, ranks, rank)``: the
        expert-data-parallel group for an expert leaf, else the DP group.
        Every gradient is divided by ``dp`` all the same."""
        if name in self.expert:
            return self.edp_group, self.edp, self.edp_rank
        return self.dp_group, self.dp, self.dp_rank

    def zero(self, name: str) -> bool:
        """Whether the leaf's state is split over its reduction's ranks."""
        return self.dims.get(name) is not None and self.reduction(name)[1] > 1

    @property
    def sharded(self) -> bool:
        """Whether any leaf's state is split over the data-parallel ranks."""
        return any(self.zero(n) for n in self.dims)

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO slice of the local tensor ``t`` of leaf ``name``
        (a view; ``t`` itself when the leaf's state is not DP-sharded)."""
        if not self.zero(name):
            return t
        d = self.dims[name]
        _, n, r = self.reduction(name)
        c = t.shape[d] // n
        return t.narrow(d, r * c, c)

    def tp_dim(self, name: str) -> Optional[int]:
        """The dim the leaf's param shards over TP (None: replicated)."""
        return _tp_dim(self.param_specs.get(name, ()))

    def ep_dim(self, name: str) -> Optional[int]:
        """The dim the leaf's param shards over EP (None: not an expert leaf)."""
        return _axis_dim(self.param_specs.get(name, ()), ps.EP_AXIS)

    def global_shape(self, name: str, local: Sequence[int]) -> Tuple[int, ...]:
        out = list(local)
        for d, n in ((self.tp_dim(name), self.tp), (self.ep_dim(name), self.ep)):
            if d is not None:
                out[d] *= n
        return tuple(out)

    def param_offset(self, name: str, local: Sequence[int]) -> Tuple[int, ...]:
        """Where the rank's (ep, tp) shard starts in the global tensor."""
        off = [0] * len(local)
        for d, r in ((self.tp_dim(name), self.tp_rank), (self.ep_dim(name), self.ep_rank)):
            if d is not None:
                off[d] = r * local[d]
        return tuple(off)

    def state_offset(self, name: str, local: Sequence[int]) -> Tuple[int, ...]:
        """Where the rank's state shard starts in the global tensor."""
        off = list(self.param_offset(name, local))
        if self.zero(name):
            d = self.dims[name]
            _, n, r = self.reduction(name)
            off[d] += r * (local[d] // n)
        return tuple(off)


def make_zero1_plan(param_specs: Mapping[str, Spec], params: Mapping[str, torch.Tensor],
                    augment: bool = True) -> Zero1Plan:
    """The plan for the trainable ``params`` (this rank's TP shards) under
    the current mesh. ``augment=False`` (ZeRO off): the state mirrors the
    params' own TP layout and every gradient is all-reduced over DP."""
    sizes = axis_sizes()
    on_mesh = ps.model_parallel_is_initialized()
    tp, ep, edp = sizes[ps.TP_AXIS], sizes[ps.EP_AXIS], sizes[ps.EDP_AXIS]
    tp_rank = ps.tensor_model_parallel_rank() if on_mesh else 0
    shapes = {}
    for n, p in params.items():
        spec = param_specs.get(n, ())
        shape = list(p.shape)
        for d, k in ((_tp_dim(spec), tp), (_axis_dim(spec, ps.EP_AXIS), ep)):
            if d is not None:
                shape[d] *= k
        shapes[n] = tuple(shape)
    if augment:
        state_specs = zero1_opt_state_specs(param_specs, shapes, sizes)
    else:
        state_specs = {n: tuple(param_specs.get(n, ())) for n in shapes}
    dims = {n: zero_dim(param_specs.get(n, ()), state_specs[n], len(shapes[n]))
            for n in shapes}
    dp = ps.get_data_parallel_size() if on_mesh else 1
    expert = frozenset(n for n in shapes if _axis_dim(param_specs.get(n, ()), ps.EP_AXIS)
                       is not None)
    return Zero1Plan(param_specs={n: tuple(param_specs.get(n, ())) for n in shapes},
                     state_specs=state_specs, dims=dims,
                     dp_group=ps.get_data_parallel_group() if dp > 1 else None, dp=dp,
                     dp_rank=ps.data_parallel_rank() if on_mesh else 0, tp=tp, tp_rank=tp_rank,
                     ep=ep, ep_rank=ps.expert_model_parallel_rank() if on_mesh else 0,
                     edp_group=ps.get_expert_data_parallel_group() if edp > 1 else None,
                     edp=edp, edp_rank=ps.expert_data_parallel_rank() if on_mesh else 0,
                     expert=expert)


# --- the dataflow's collectives ------------------------------------------------------

# staging copies made for shards strided in their params (along a dim other
# than 0), one per reduce-scatter or all-gather of such a leaf
staging_copies = 0


def reduce_scatter_mean(g: torch.Tensor, d: int, group, n: int,
                        divisor: Optional[int] = None) -> torch.Tensor:
    """The sum over ``group`` (``n`` ranks) of ``g`` divided by ``divisor``
    (default ``n``: the mean), this rank's slice along ``d``: a new
    contiguous tensor in the shard's natural layout."""
    global staging_copies
    c = g.shape[d] // n
    shard = list(g.shape)
    shard[d] = c
    if d == 0:
        src = g.contiguous()
    else:   # rank-major: each rank's slice contiguous
        src = g.unflatten(d, (n, c)).movedim(d, 0).contiguous()
        staging_copies += 1
    out = torch.empty(shard, dtype=g.dtype, device=g.device)
    mappings._rs(out.view(-1), src.view(-1), group)
    return out.mul_(1.0 / (divisor or n))


def all_reduce_mean_(g: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over ``group`` of the contiguous ``g`` divided by ``n``, in
    place (the mean when ``n`` is the group's size)."""
    mappings.all_reduce_sum_(g, group)
    return g.mul_(1.0 / n)


def all_gather_into(out: torch.Tensor, shard: torch.Tensor, d: int, group, n: int) -> None:
    """The ranks' ``shard`` (contiguous) concatenated along ``d`` in rank
    order, written into ``out`` (the rank's param)."""
    global staging_copies
    if d == 0 and out.is_contiguous():
        mappings._ag(out.view(-1), shard.view(-1), group)
        return
    buf = torch.empty((n, *shard.shape), dtype=shard.dtype, device=shard.device)
    mappings._ag(buf.view(-1), shard.view(-1), group)
    out.copy_(buf.movedim(0, d).flatten(d, d + 1))
    staging_copies += 1
