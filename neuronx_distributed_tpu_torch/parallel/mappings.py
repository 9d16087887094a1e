"""Tensor-parallel regions over a ``torch.distributed`` group.

Counterpart of ``neuronx_distributed_tpu/parallel/mappings.py``. The JAX
file is thin because JAX differentiates through its collectives under one
global view; torch's autograd sees only the rank's own tensors, so each
region here is a ``torch.autograd.Function`` with Megatron's conjugate
backward (the reference ``mappings.py:165-338``):

================================  =================  ====================
region                            forward            backward
================================  =================  ====================
``copy_to_tensor_parallel``       identity           all-reduce
``reduce_from_tensor_parallel``   all-reduce         identity
``scatter_to_tensor_parallel``    keep own slice     all-gather
``gather_from_tensor_parallel``   all-gather         keep own slice
``scatter_to_sequence_parallel``  keep own slice     all-gather
``gather_from_sequence_parallel`` all-gather         reduce-scatter
``reduce_scatter_to_sequence_p``  reduce-scatter     all-gather
================================  =================  ====================

``all_gather``, ``reduce_scatter`` and ``all_reduce`` are the plain
collectives with the same conjugates; ``all_reduce_sum_`` and
``all_reduce_max_`` reduce a tensor in place outside autograd (the
vocab-parallel loss, the gradient norm, the data-parallel reduction).
Every function takes the group (``None`` is no group: the identity, no
collective) and issues its collective at every group size, 1 included, so
a degree-1 group really runs its backend.

All-to-all (JAX ``mappings.py:99-113``, the reference ``:311-338``):
:func:`all_to_all_in_expert_parallel_region` splits a tensor along one dim
into a chunk a rank, sends chunk ``j`` to rank ``j`` and concatenates what
arrives along another dim in rank order (JAX's ``tiled`` all-to-all); its
backward is the reverse all-to-all. The MoE block sends its tokens to
their experts' owners and back with it (``moe/expert_mlps.py``).
:func:`nonzero_partition_dim_swap` is the same collective over the
tensor-parallel group, moving an activation's sharded dim. Gloo's
all-to-all reads host memory: on gloo a CUDA tensor goes through a host
buffer, one device-to-host and one host-to-device copy a call, counted as
``all_to_all_staging``.

Point to point (JAX ``mappings.py:128-140``): :func:`ppermute_next` and
:func:`ppermute_prev` send each rank's tensor one step round the group
(``wrap=False``: the end rank sends nothing and rank 0, or the last rank,
receives zeros), as autograd regions whose backward permutes the other
way; :func:`isend`/:func:`recv` are the plain pair the pipeline matches
rank against rank. Each transfer carries a tag, so a receive matches its
send whatever else is in flight between the two ranks. Gloo's send and
receive read a host pointer, so a CUDA tensor goes through a host buffer
on gloo: one device-to-host copy a send and one host-to-device copy a
receive, counted as ``p2p_staging``.

Both backends take CUDA tensors as they are (gloo copies through the
host itself, and cannot run inside a CUDA graph capture; NCCL can).
``collective_stats`` counts every collective issued here by kind, with the
bytes of its input (``reset_collective_stats`` zeroes it): one table a
process, or a thread's own under ``mesh.run_in_threads``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size

# kind -> [calls, input bytes]: one table a process (a rank of a card run is
# a process, and its CUDA backward runs on autograd's device thread, which
# must count into the rank's table), or one a thread for the ranks that
# mesh.run_in_threads starts in one process (a CPU backward runs on the
# thread that called it)
_PROCESS_TABLE: Dict[str, List[int]] = {}
_STATS = threading.local()


def bind_thread_stats() -> None:
    """Give the calling thread a table of its own (a thread rank)."""
    _STATS.table = {}


def collective_stats() -> Dict[str, List[int]]:
    """This rank's collectives since the last reset: kind -> ``[calls,
    bytes]`` (``all_reduce``, ``all_reduce_max``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``, ``send``, ``recv``;
    ``p2p_staging`` and ``all_to_all_staging``: the host copies of CUDA
    tensors on gloo), backward included."""
    table = getattr(_STATS, "table", None)
    return _PROCESS_TABLE if table is None else table


def reset_collective_stats() -> None:
    global _PROCESS_TABLE
    if getattr(_STATS, "table", None) is None:
        _PROCESS_TABLE = {}
    else:
        _STATS.table = {}


def _count(kind: str, t: torch.Tensor) -> None:
    entry = collective_stats().setdefault(kind, [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


# the group's own methods rather than torch.distributed's functions: those
# refuse or rename a group made outside the default world (the thread-rank
# launch) from one torch release to the next
def _ar(t, group, op=None) -> None:
    if op is None:
        _count("all_reduce", t)
        group.allreduce([t]).wait()
        return
    _count("all_reduce_max", t)
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    group.allreduce([t], opts).wait()


def _ag(out, t, group) -> None:
    _count("all_gather", t)
    group._allgather_base(out, t).wait()


def _rs(out, t, group) -> None:
    _count("reduce_scatter", t)
    group._reduce_scatter_base(out, t).wait()


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` (contiguous) over ``group`` in place, outside autograd."""
    if group is not None:
        _ar(t, group)
    return t


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` (contiguous) over ``group``, in place."""
    if group is not None:
        _ar(t, group, dist.ReduceOp.MAX)
    return t


def _wire(t: torch.Tensor) -> torch.Tensor:
    # bool travels as uint8 (neither backend reduces or gathers bool)
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, as a new tensor."""
    y = _wire(x).contiguous().clone()
    _ar(y, group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim``, in rank order."""
    n = group_size(group)
    d = dim % x.dim()
    src = _wire(x).contiguous()
    # the ranks' tensors stacked on dim 0
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    _ag(out, src, group)
    out = out.view(n, *src.shape)
    return out.movedim(0, d).flatten(d, d + 1).to(x.dtype)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group, each rank keeping its slice along ``dim``."""
    n = group_size(group)
    d = dim % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"dim {dim} of size {x.shape[d]} does not split over {n} ranks")
    src = x.movedim(d, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype, device=src.device)
    _rs(out, src, group)
    return out.movedim(0, d)


def local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``."""
    n, r = group_size(group), group_rank(group)
    d = dim % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"dim {dim} of size {x.shape[d]} does not split over {n} ranks")
    c = x.shape[d] // n
    return x.narrow(d, r * c, c).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return local_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.group), None, None


class _GatherReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


# --- tensor-parallel regions (reference mappings.py:165-235) ----------------

def copy_to_tensor_parallel_region(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering a TP computation: identity forward,
    all-reduced gradient."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_tensor_parallel_region(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce partial sums out of a TP region."""
    return x if group is None else _Reduce.apply(x, group)


def scatter_to_tensor_parallel_region(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Keep this rank's slice of a replicated activation along ``dim``."""
    return x if group is None else _Scatter.apply(x, dim, group)


def gather_from_tensor_parallel_region(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """All-gather the ranks' outputs along ``dim``."""
    return x if group is None else _Gather.apply(x, dim, group)


# --- sequence-parallel regions (reference mappings.py:237-309) --------------

def scatter_to_sequence_parallel_region(x: torch.Tensor, group,
                                        seq_dim: int = 1) -> torch.Tensor:
    return x if group is None else _Scatter.apply(x, seq_dim, group)


def gather_from_sequence_parallel_region(x: torch.Tensor, group,
                                         seq_dim: int = 1) -> torch.Tensor:
    return x if group is None else _GatherReduceScatter.apply(x, seq_dim, group)


def reduce_scatter_to_sequence_parallel_region(x: torch.Tensor, group,
                                               seq_dim: int = 1) -> torch.Tensor:
    return x if group is None else _ReduceScatter.apply(x, seq_dim, group)


# --- the plain collectives ---------------------------------------------------

def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherReduceScatter.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Reduce.apply(x, group)


# --- all-to-all (JAX mappings.py:99-113) -------------------------------------

def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """``x`` cut along ``split_dim`` into a chunk a rank; chunk ``j`` goes
    to rank ``j``, and the chunks that arrive are concatenated along
    ``concat_dim`` in rank order."""
    n = group_size(group)
    sd, cd = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[sd] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[sd]} does not split over {n} ranks")
    # rank-major: chunk j contiguous at index j of dim 0
    src = x.unflatten(sd, (n, x.shape[sd] // n)).movedim(sd, 0).contiguous()
    shape, dtype = src.shape, src.dtype
    # the bytes travel (a copy, no arithmetic): every dtype on every backend
    src = src.reshape(n, -1).view(torch.uint8)
    staged = _staged(src, group)
    if staged:
        _count("all_to_all_staging", src)
        src = src.to("cpu")
    out = torch.empty_like(src)
    _count("all_to_all", src)
    group.alltoall_base(out, src, [], []).wait()
    if staged:
        _count("all_to_all_staging", out)
        out = out.to(x.device)
    # out[j] is rank j's chunk: stack the chunks along concat_dim
    return out.view(dtype).reshape(shape).movedim(0, cd).flatten(cd, cd + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all_in_expert_parallel_region(x: torch.Tensor, split_dim: int, concat_dim: int,
                                         group) -> torch.Tensor:
    """Token dispatch and return across the expert-parallel group (JAX
    ``all_to_all_in_expert_parallel_region``); the gradient takes the
    reverse all-to-all."""
    return x if group is None else _AllToAll.apply(x, split_dim, concat_dim, group)


def nonzero_partition_dim_swap(x: torch.Tensor, from_dim: int, to_dim: int,
                               group) -> torch.Tensor:
    """Move an activation's sharded dim from ``from_dim`` to ``to_dim``
    with one all-to-all over ``group`` (JAX ``nonzero_partition_dim_swap``:
    split ``to_dim``, concatenate ``from_dim``)."""
    return x if group is None else _AllToAll.apply(x, to_dim, from_dim, group)


# --- point to point (JAX mappings.py:128-140) -------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    from neuronx_distributed_tpu_torch.parallel.mesh import capturable

    return not capturable(t.device, group)


class P2PWork:
    """A transfer in flight: :meth:`wait` blocks until it completed and
    returns the received tensor (a receive) or None (a send). Holds the
    buffers the transfer reads or writes until then."""

    def __init__(self, work, buf: torch.Tensor, out: Optional[torch.Tensor] = None):
        self._work, self._buf, self._out = work, buf, out

    def wait(self) -> Optional[torch.Tensor]:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._out is not None and self._out is not self._buf:
            _count("p2p_staging", self._buf)
            self._out.copy_(self._buf)
        return self._out


def isend(t: torch.Tensor, peer: int, group, tag: int = 0) -> P2PWork:
    """Start sending ``t`` to the group rank ``peer``; the returned work's
    ``wait`` ends it (``t`` may change once it returned)."""
    buf = t.contiguous()
    if _staged(buf, group):
        _count("p2p_staging", buf)
        buf = buf.to("cpu")
    _count("send", buf)
    return P2PWork(group.send([buf], peer, tag), buf)


def irecv(shape, dtype: torch.dtype, device, peer: int, group, tag: int = 0) -> P2PWork:
    """Start receiving a tensor of ``shape``/``dtype`` on ``device`` from
    the group rank ``peer``; ``wait`` returns it."""
    out = torch.empty(shape, dtype=dtype, device=device)
    buf = torch.empty(shape, dtype=dtype) if _staged(out, group) else out
    _count("recv", buf)
    return P2PWork(group.recv([buf], peer, tag), buf, out)


def recv(shape, dtype: torch.dtype, device, peer: int, group, tag: int = 0) -> torch.Tensor:
    """Receive a tensor from the group rank ``peer`` (blocking)."""
    return irecv(shape, dtype, device, peer, group, tag).wait()


def _permute(x: torch.Tensor, group, step: int, wrap: bool) -> torch.Tensor:
    """Each rank's ``x`` moved ``step`` (+1 or -1) ranks round the group;
    without ``wrap`` the rank past the end receives zeros."""
    n, r = group_size(group), group_rank(group)
    dst, src = (r + step) % n, (r - step) % n
    sends = wrap or 0 <= r + step < n
    recvs = wrap or 0 <= r - step < n
    if n == 1:
        return x.clone() if wrap else torch.zeros_like(x)
    pending = irecv(x.shape, x.dtype, x.device, src, group, _PERMUTE_TAG) if recvs else None
    sent = isend(x, dst, group, _PERMUTE_TAG) if sends else None
    out = pending.wait() if pending is not None else torch.zeros_like(x)
    if sent is not None:
        sent.wait()
    return out


# ring permutes share one tag: a pair of ranks exchanges them in one order
_PERMUTE_TAG = 1 << 20


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step, wrap):
        ctx.group, ctx.step, ctx.wrap = group, step, wrap
        return _permute(x, group, step, wrap)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), ctx.group, -ctx.step, ctx.wrap), None, None, None


def ppermute_next(x: torch.Tensor, group, wrap: bool = True) -> torch.Tensor:
    """Rank ``r``'s ``x`` arrives at rank ``r + 1`` (JAX ``ppermute_next``);
    the gradient travels back to ``r``."""
    return x if group is None else _Permute.apply(x, group, 1, wrap)


def ppermute_prev(x: torch.Tensor, group, wrap: bool = True) -> torch.Tensor:
    """Rank ``r``'s ``x`` arrives at rank ``r - 1`` (JAX ``ppermute_prev``)."""
    return x if group is None else _Permute.apply(x, group, -1, wrap)
