"""Parallel state over ``torch.distributed``: the rank layout, its groups,
and the launchers.

Counterpart of ``neuronx_distributed_tpu/parallel/mesh.py``. The JAX
package lays its devices out as a mesh with axes ``(pp, edp, ep, cp, tp)``,
TP innermost; here the same row-major layout of the ranks
(:func:`rank_layout`, a pure function of the world size and the degrees)
gives each axis its ``torch.distributed`` groups, and every rank creates
every group in the same order. The data-parallel group is ``(edp, ep)``
combined, as in the JAX package.

Where the state lives: the layers take their group when they are built
(``parallel/layers.py``), so the state below matters only while a model is
being constructed. It is thread-local, so that the tests can run a world
of ranks as threads in one process, each over its own gloo groups.

Two launches:

* a process per rank: :func:`init_distributed` joins the default group
  from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
  arguments, and binds the rank's local card for ``resolve_device``; then
  :func:`initialize_model_parallel` builds the axis groups with
  ``new_group``;
* a rank per thread: :func:`run_in_threads` gives every thread
  :func:`initialize_model_parallel` over one ``Store`` (gloo groups made
  directly over prefixes of that store, no default group).

Every group is made with a timeout, so a rank that dies fails its peers'
next collective instead of hanging them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch import _device

PP_AXIS, EDP_AXIS, EP_AXIS, CP_AXIS, TP_AXIS = "pp", "edp", "ep", "cp", "tp"
MESH_AXES = (PP_AXIS, EDP_AXIS, EP_AXIS, CP_AXIS, TP_AXIS)
# the groups a rank belongs to: one per mesh axis, and dp = (edp, ep) combined
GROUP_AXES = MESH_AXES + ("dp",)

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def rank_layout(world_size: int, tensor_model_parallel_size: int = 1,
                pipeline_model_parallel_size: int = 1, expert_model_parallel_size: int = 1,
                context_parallel_size: int = 1) -> Dict[str, object]:
    """The JAX mesh's layout over ranks ``0 .. world_size - 1``: ``shape``
    ``(pp, edp, ep, cp, tp)`` (row-major, TP innermost and contiguous),
    ``ranks`` that array, and ``groups``: per axis of :data:`GROUP_AXES`
    the list of rank lists along it. Raises the JAX package's divisibility
    errors."""
    tp, pp = tensor_model_parallel_size, pipeline_model_parallel_size
    ep, cp = expert_model_parallel_size, context_parallel_size
    if min(world_size, tp, pp, ep, cp) < 1:
        raise ValueError(f"sizes must be >= 1: world {world_size}, tp {tp}, pp {pp}, "
                         f"ep {ep}, cp {cp}")
    if world_size % (tp * pp * cp) != 0:
        raise ValueError(
            f"world size {world_size} is not divisible by tp({tp}) * pp({pp}) * cp({cp})")
    dp = world_size // (tp * pp * cp)
    if dp % ep != 0:
        raise ValueError(f"data parallel size {dp} is not divisible by ep({ep})")
    shape = (pp, dp // ep, ep, cp, tp)
    ranks = np.arange(world_size).reshape(shape)
    groups: Dict[str, List[List[int]]] = {}
    for i, axis in enumerate(MESH_AXES):
        groups[axis] = np.moveaxis(ranks, i, -1).reshape(-1, shape[i]).tolist()
    # dp = (edp, ep) combined, row-major (the JAX package's DP_AXES)
    groups["dp"] = np.moveaxis(ranks, (1, 2), (3, 4)).reshape(-1, dp).tolist()
    return {"shape": shape, "ranks": ranks, "groups": groups}


@dataclasses.dataclass(frozen=True)
class ParallelState:
    """This rank's view of the initialized world: its rank and the world
    size, the degrees, and per axis of :data:`GROUP_AXES` its group and
    its rank in that group."""

    world_size: int
    rank: int
    tensor_model_parallel_size: int
    pipeline_model_parallel_size: int
    expert_model_parallel_size: int
    data_parallel_size: int
    expert_data_parallel_size: int
    context_parallel_size: int
    groups: Dict[str, object]
    group_ranks: Dict[str, List[int]]
    # the key-value store every rank of this world reaches (the checkpoint
    # protocol agrees through it; None: no store known)
    store: object = None

    def coords(self) -> Dict[str, int]:
        """Position along each axis (``dp`` the combined one)."""
        return {axis: self.group_ranks[axis].index(self.rank) for axis in GROUP_AXES}


_LOCAL = threading.local()


def _state() -> Optional[ParallelState]:
    return getattr(_LOCAL, "state", None)


def _require_state() -> ParallelState:
    st = _state()
    if st is None:
        raise RuntimeError("model parallel is not initialized; call "
                           "initialize_model_parallel() first")
    return st


def _gloo_group(store, rank: int, size: int, timeout: datetime.timedelta):
    return dist.ProcessGroupGloo(store, rank, size, timeout)


def initialize_model_parallel(tensor_model_parallel_size: int = 1,
                              pipeline_model_parallel_size: int = 1,
                              expert_model_parallel_size: int = 1,
                              context_parallel_size: int = 1, *,
                              store=None, rank: Optional[int] = None,
                              world_size: Optional[int] = None,
                              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> ParallelState:
    """Build this rank's groups for every axis (JAX
    ``initialize_model_parallel``). Without ``store``: over the default
    group (:func:`init_distributed`), every group made with ``new_group``
    on every rank in the same order, on the default group's backend. With
    ``store`` (and ``rank``, ``world_size``): gloo groups made directly
    over prefixes of the store, the rank-per-thread launch. Raises if this
    thread already holds a state, and the JAX divisibility errors."""
    if _state() is not None:
        raise RuntimeError("model parallel already initialized; call "
                           "destroy_model_parallel() first")
    if store is None:
        if not dist.is_initialized():
            raise RuntimeError("no default process group: call init_distributed() (or "
                               "torch.distributed.init_process_group) first, or pass a "
                               "store with rank and world_size")
        world, me = dist.get_world_size(), dist.get_rank()
    else:
        if rank is None or world_size is None:
            raise ValueError("a store launch needs rank and world_size")
        world, me = int(world_size), int(rank)
    lay = rank_layout(world, tensor_model_parallel_size, pipeline_model_parallel_size,
                      expert_model_parallel_size, context_parallel_size)
    shared = store if store is not None else _default_store()
    groups, group_ranks = {}, {}
    for axis in GROUP_AXES:
        for i, members in enumerate(lay["groups"][axis]):
            if store is None:
                # collective: every rank makes every group, in this order
                g = dist.new_group(members, timeout=timeout)
            elif me in members:
                g = _gloo_group(dist.PrefixStore(f"{axis}/{i}", store),
                                members.index(me), len(members), timeout)
            else:
                continue
            if me in members:
                groups[axis], group_ranks[axis] = g, list(members)
    pp, edp, ep, cp, tp = lay["shape"]
    st = ParallelState(world_size=world, rank=me, tensor_model_parallel_size=tp,
                       pipeline_model_parallel_size=pp, expert_model_parallel_size=ep,
                       data_parallel_size=edp * ep, expert_data_parallel_size=edp,
                       context_parallel_size=cp, groups=groups, group_ranks=group_ranks,
                       store=None if shared is None else dist.PrefixStore("nxd", shared))
    _LOCAL.state = st
    return st


def _default_store():
    try:
        return dist.distributed_c10d._get_default_store()
    except (RuntimeError, AttributeError, ValueError):
        return None


def model_parallel_is_initialized() -> bool:
    return _state() is not None


def destroy_model_parallel() -> None:
    """Forget this thread's state. Layers built under it keep their groups."""
    _LOCAL.state = None


def get_state() -> ParallelState:
    return _require_state()


def get_tensor_model_parallel_size() -> int:
    return _require_state().tensor_model_parallel_size


def get_tensor_model_parallel_rank() -> int:
    return _require_state().coords()[TP_AXIS]


def get_tensor_model_parallel_group():
    return _require_state().groups[TP_AXIS]


def get_pipeline_model_parallel_size() -> int:
    return _require_state().pipeline_model_parallel_size


def get_expert_model_parallel_size() -> int:
    return _require_state().expert_model_parallel_size


def get_data_parallel_size() -> int:
    return _require_state().data_parallel_size


def get_expert_data_parallel_size() -> int:
    return _require_state().expert_data_parallel_size


def get_context_parallel_size() -> int:
    return _require_state().context_parallel_size


def get_world_size() -> int:
    return _require_state().world_size


def get_data_parallel_group():
    """The combined ``(edp, ep)`` group: the ranks that hold the same
    shards and split the batch."""
    return _require_state().groups["dp"]


def get_expert_model_parallel_group():
    """The ranks that differ only in ``ep``: they hold different experts
    and trade tokens through the expert all-to-all."""
    return _require_state().groups[EP_AXIS]


def get_expert_data_parallel_group():
    """The ranks that differ only in ``edp``: they hold the same experts
    (an expert leaf's gradient is summed over them)."""
    return _require_state().groups[EDP_AXIS]


# --- this rank's coordinates (JAX's in-graph ranks are axis indices inside
# shard_map; here every rank knows its own) -----------------------------------

def tensor_model_parallel_rank() -> int:
    return _require_state().coords()[TP_AXIS]


def expert_model_parallel_rank() -> int:
    return _require_state().coords()[EP_AXIS]


def expert_data_parallel_rank() -> int:
    return _require_state().coords()[EDP_AXIS]


def data_parallel_rank() -> int:
    """The combined ``(edp, ep)`` rank, row-major (JAX ``data_parallel_rank``)."""
    return _require_state().coords()["dp"]


def local_mesh_coords() -> Dict[str, int]:
    """This rank's position on every axis, ``dp`` the combined one (JAX
    ``local_mesh_coords``)."""
    c = _require_state().coords()
    return {axis: c[axis] for axis in (PP_AXIS, EDP_AXIS, EP_AXIS, CP_AXIS, TP_AXIS, "dp")}


def data_batch_slice(global_batch_size: int) -> slice:
    """The rows of a global batch this rank feeds: the counterpart of JAX's
    ``data_pspec`` (the batch dim sharded over the combined DP axes), one
    contiguous slice a data-parallel rank, the same on every rank of its
    tensor-parallel group. Off-mesh: the whole batch."""
    if not model_parallel_is_initialized():
        return slice(0, global_batch_size)
    dp, r = get_data_parallel_size(), data_parallel_rank()
    if global_batch_size % dp:
        raise ValueError(f"global batch {global_batch_size} not divisible by data parallel "
                         f"size {dp}")
    per = global_batch_size // dp
    return slice(r * per, (r + 1) * per)


def context_parallel_rank() -> int:
    return _require_state().coords()[CP_AXIS]


def get_context_parallel_group():
    return _require_state().groups[CP_AXIS]


def pipeline_model_parallel_rank() -> int:
    """This rank's stage (its position along ``pp``)."""
    return _require_state().coords()[PP_AXIS]


def get_pipeline_model_parallel_group():
    return _require_state().groups[PP_AXIS]


def pipeline_next_stage() -> Optional[int]:
    """The next stage's rank in the pp group (None on the last stage)."""
    r = pipeline_model_parallel_rank()
    return r + 1 if r + 1 < get_pipeline_model_parallel_size() else None


def pipeline_prev_stage() -> Optional[int]:
    """The previous stage's rank in the pp group (None on the first)."""
    r = pipeline_model_parallel_rank()
    return r - 1 if r > 0 else None


def context_seq_slice(seq_len: int) -> slice:
    """The rank's contiguous block of a global sequence under CP: the
    counterpart of GSPMD's ``cp`` sharding of the sequence dim (JAX
    ``ACT_CP``). Under ``cp_layout="zigzag"`` the caller has permuted the
    sequence first (``ops.ring_attention.zigzag_indices``); the block is
    still the rank's contiguous one of the permuted sequence. Off-mesh:
    the whole sequence."""
    if not model_parallel_is_initialized():
        return slice(0, seq_len)
    cp, r = get_context_parallel_size(), context_parallel_rank()
    if seq_len % cp:
        raise ValueError(f"global seq {seq_len} not divisible by cp={cp}")
    per = seq_len // cp
    return slice(r * per, (r + 1) * per)


def rmsg(msg: str) -> str:
    """Rank-tagged message (JAX ``rmsg``)."""
    st = _state()
    if st is None:
        return f"[rank_{dist.get_rank() if dist.is_initialized() else 0}] {msg}"
    c = st.coords()
    return f"[rank_{st.rank}_pp{c[PP_AXIS]}_tp{c[TP_AXIS]}_dp{c['dp']}] {msg}"


# --- launchers -------------------------------------------------------------

def init_distributed(backend: Optional[str] = None, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, local_rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> int:
    """Join the default group as one process of a process-per-rank launch,
    from explicit arguments or ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``init_method`` defaults to
    ``env://``). ``backend`` defaults to ``nccl`` with a GPU, else
    ``gloo``. Binds ``local_rank`` for :func:`_device.resolve_device`,
    which then picks ``cuda:{local_rank}``. Returns the local rank."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else int(rank)
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    _device.bind_local_rank(local_rank)
    if backend == "nccl":
        _device.resolve_device()   # sets the rank's card before NCCL forms
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=timeout)
    return local_rank


def run_in_threads(world_size: int, fn: Callable[[int], object], *,
                   tensor_model_parallel_size: Optional[int] = None,
                   timeout: datetime.timedelta = datetime.timedelta(seconds=60),
                   **degrees) -> List[object]:
    """Run ``fn(rank)`` on ``world_size`` threads, each inside its own
    :func:`initialize_model_parallel` over one ``HashStore`` (gloo groups;
    TP degree ``tensor_model_parallel_size``, default the whole world).
    Returns the results by rank; re-raises the first rank's error."""
    store = dist.HashStore()
    tp = world_size if tensor_model_parallel_size is None else tensor_model_parallel_size
    results: List[object] = [None] * world_size
    errors: List[Optional[BaseException]] = [None] * world_size

    def body(r: int) -> None:
        from neuronx_distributed_tpu_torch.parallel import mappings

        mappings.bind_thread_stats()   # each thread rank counts its own collectives
        try:
            initialize_model_parallel(tp, store=store, rank=r, world_size=world_size,
                                      timeout=timeout, **degrees)
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[r] = e
        finally:
            destroy_model_parallel()

    threads = [threading.Thread(target=body, args=(r,), name=f"tp-rank-{r}")
               for r in range(world_size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def group_size(group) -> int:
    """A group's size; 1 for None (no group: no collective)."""
    return 1 if group is None else group.size()


def group_rank(group) -> int:
    return 0 if group is None else group.rank()


def group_backend(group) -> Optional[str]:
    """``"nccl"``, ``"gloo"``, ...; None without a group."""
    if group is None:
        return None
    name = group.name() if callable(getattr(group, "name", None)) else None
    if name in ("nccl", "gloo"):
        return name
    return str(dist.get_backend(group))

