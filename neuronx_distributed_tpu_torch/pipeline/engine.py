"""The pipeline engine: one rank's stage running a schedule over p2p sends.

Counterpart of ``neuronx_distributed_tpu/pipeline/engine.py``. The JAX
engine is one ``shard_map`` program whose ``lax.scan`` ticks rotate
activations with ``ppermute`` and whose backward comes from differentiating
the scan (``pipeline``, ``pipeline_scalars``, ``pipeline_1f1b``,
``pipeline_interleaved``). Here each rank runs its own stage, as the
reference's ``NxDPPModel`` does, and exchanges activations and their
gradients with its neighbours over the pp group (``parallel/mappings.py``
``isend``/``irecv``, one tag a message).

A unit is ``(kind, microbatch, virtual stage)``: ``"F"`` runs virtual
stage ``v``'s layers forward on microbatch ``m``, ``"B"`` its backward.
Virtual stage ``v`` lives on rank ``v % pp`` as its chunk ``v // pp``;
with one chunk ``v`` is the rank. A forward receives its input from the
rank of ``v - 1`` (virtual stage 0 embeds the microbatch's ids) and sends
its output to the rank of ``v + 1``; the last virtual stage computes the
microbatch's loss instead (norm, head and cross entropy as the microbatch
drains: full-batch logits never exist, JAX ``pipeline_scalars``). A
backward receives its output's gradient (or seeds the loss), runs
autograd over the stashed graph and sends its input's gradient back.

Schedules (:func:`rank_units`): ``"gpipe"`` (every forward, then every
backward in reverse), ``"1f1b"`` with one chunk (``train_1f1b_schedule``:
at most ``pp - rank`` microbatches stashed, the reference's
``Train1F1BSchedule`` bound) and, with ``num_chunks > 1``, interleaved
1F1B from the global tick table (``interleaved_1f1b_global``). Each
rank's order agrees with one global order in which every send comes
before its receive; sends are asynchronous and receives block, so no rank
waits on a peer that waits on it. ``stash_peak`` counts the units whose
forward ran and whose backward has not (microbatches with one chunk).

A send holds its tensor (on a backend that does not stage it, the
activation or gradient itself) until it is waited on. Both neighbours' unit
orders are known, so the engine waits on a send as soon as a message from
its peer shows that the peer has received it, or is about to: the peer sent
that message at the end of one unit, and the send is received by that unit
or by the receive that opens the next one. Such a wait blocks on nothing
but the peer's receive of a message already sent, so it adds no cycle;
``sends_peak`` is the most sends held at once.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_tpu_torch.parallel import mappings
from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size
from neuronx_distributed_tpu_torch.pipeline import schedules as S

Unit = Tuple[str, int, int]   # (kind "F" or "B", microbatch, virtual stage)
SCHEDULES = ("1f1b", "gpipe")


def microbatch(x, num_microbatches: int) -> List:
    """``(B, ...)`` -> ``num_microbatches`` views of ``B / num_microbatches``
    rows each."""
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(f"batch {b} not divisible by num_microbatches {num_microbatches}")
    m = b // num_microbatches
    return [x[i * m:(i + 1) * m] for i in range(num_microbatches)]


def vpp_layer_order(num_layers: int, num_stages: int, num_chunks: int) -> List[int]:
    """JAX's VPP parameter layout: position ``r*(chunks*Lc) + c*Lc + i``
    holds canonical layer ``(c*pp + r)*Lc + i`` (virtual stage ``c*pp + r``
    is rank ``r``'s chunk ``c``)."""
    if num_layers % (num_stages * num_chunks) != 0:
        raise ValueError(f"num_layers {num_layers} not divisible by stages*chunks "
                         f"({num_stages}*{num_chunks})")
    lc = num_layers // (num_stages * num_chunks)
    order = []
    for r in range(num_stages):
        for c in range(num_chunks):
            v = c * num_stages + r
            order.extend(range(v * lc, (v + 1) * lc))
    return order


def stage_layers(num_layers: int, num_stages: int, num_chunks: int, rank: int) -> List[List[int]]:
    """The canonical layers of each of ``rank``'s chunks."""
    order = vpp_layer_order(num_layers, num_stages, num_chunks)
    lc = num_layers // (num_stages * num_chunks)
    mine = order[rank * num_chunks * lc:(rank + 1) * num_chunks * lc]
    return [mine[c * lc:(c + 1) * lc] for c in range(num_chunks)]


def rank_units(rank: int, num_stages: int, num_microbatches: int, num_chunks: int = 1,
               schedule: str = "1f1b", train: bool = True) -> List[Unit]:
    """``rank``'s units in the order it runs them."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    st, mb, ch = num_stages, num_microbatches, num_chunks
    if ch == 1 and schedule == "1f1b" and train:
        out = []
        for step in S.train_1f1b_schedule(rank, st, mb):
            for t in step:
                if isinstance(t, S.ForwardStep):
                    out.append(("F", t.microbatch, rank))
                elif isinstance(t, S.BackwardStep):
                    out.append(("B", t.microbatch, rank))
        return out
    if ch > 1 and schedule == "1f1b" and train:
        g = S.interleaved_1f1b_global(st, mb, ch)
        timed = [(t, 0, ("F", m, v)) for (m, v), t in g.exec_f.items() if v % st == rank]
        timed += [(t, 1, ("B", m, v)) for (m, v), t in g.exec_b.items() if v % st == rank]
        return [u for _, _, u in sorted(timed)]
    # the forward ticks of JAX's gpipe engines: microbatch m enters at
    # e_m = (m // pp) * V + m % pp and unit (m, c) runs on rank r at tick
    # e_m + c * pp + r (one chunk: tick m + r)
    if ch > 1 and mb % st:
        raise ValueError(f"interleaved (num_chunks={ch}) requires num_microbatches ({mb}) "
                         f"divisible by num_stages ({st})")
    v_all = st * ch
    ticks = sorted(((m // st) * v_all + m % st + c * st + rank, m, c * st + rank)
                   for m in range(mb) for c in range(ch))
    fwd = [("F", m, v) for _, m, v in ticks]
    if not train:
        return fwd
    return fwd + [("B", m, v) for _, m, v in reversed(ticks)]


class PipelineEngine:
    """One rank's executor of a pipeline schedule over the pp ``group``
    (None: one stage). :meth:`run` takes the stage's functions:
    ``first_fn(ids) -> x`` (virtual stage 0's embedding), ``chunk_fns[c](x)
    -> y`` (chunk ``c``'s layers), ``last_fn(y, aux) -> out`` (the last
    virtual stage's head: ``(loss_sum, count)`` when training)."""

    def __init__(self, num_stages: int, num_microbatches: int, num_chunks: int = 1,
                 schedule: str = "1f1b", group=None, remat: bool = False):
        if group_size(group) != num_stages:
            raise ValueError(f"num_stages ({num_stages}) must equal the pp group's size "
                             f"({group_size(group)})")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        self.num_stages, self.num_microbatches = num_stages, num_microbatches
        self.num_chunks, self.schedule, self.group = num_chunks, schedule, group
        self.rank = group_rank(group)
        self.remat = remat
        # units forwarded whose backward has not run: now, and the run's peak
        self.stashed = 0
        self.stash_peak = 0
        # sends not yet waited on: the run's peak
        self.sends_peak = 0

    def _tag(self, kind: int, m: int, v: int) -> int:
        return (kind * self.num_stages * self.num_chunks + v) * self.num_microbatches + m

    def units(self, train: bool = True) -> List[Unit]:
        return rank_units(self.rank, self.num_stages, self.num_microbatches, self.num_chunks,
                          self.schedule, train)

    def run(self, first_fn: Callable, chunk_fns: Sequence[Callable], last_fn: Callable,
            ids_mb: Sequence[torch.Tensor], aux_mb: Sequence, act_shape, act_dtype, device,
            train: bool = True, loss_scale: Optional[torch.Tensor] = None) -> List:
        """Run this rank's units. Training: every backward accumulates into
        the ``.grad`` of the leaves its graph reaches (the stage's
        parameters), the loss sums seeded by ``loss_scale``. Returns
        ``last_fn``'s results by microbatch on the rank of the last virtual
        stage (None elsewhere)."""
        last_v = self.num_stages * self.num_chunks - 1
        outs: List = [None] * self.num_microbatches
        stash = {}
        sends = []   # (work, peer, the index of the peer's unit that receives it)
        self.stashed = self.stash_peak = self.sends_peak = 0

        def peer(v: int) -> int:
            return v % self.num_stages

        order = {p: {u: i for i, u in enumerate(rank_units(
            p, self.num_stages, self.num_microbatches, self.num_chunks, self.schedule, train))}
            for p in {peer(self.rank - 1), peer(self.rank + 1)}}

        def send(t, p: int, unit: Unit, tag: int) -> None:
            sends.append((mappings.isend(t, p, self.group, tag), p, order[p][unit]))
            self.sends_peak = max(self.sends_peak, len(sends))

        def received(p: int, unit: Unit) -> None:
            # ``p`` sent what arrived at the end of its ``unit``: every
            # receive it ran up to that unit has ended, and the one its next
            # unit starts with waits on nothing but the sender
            at = order[p][unit] + 1
            for s in [s for s in sends if s[1] == p and s[2] <= at]:
                s[0].wait()
                sends.remove(s)

        for kind, m, v in self.units(train):
            c = v // self.num_stages
            if kind == "F":
                with torch.set_grad_enabled(train):
                    if v == 0:
                        x = first_fn(ids_mb[m])
                    else:
                        x = mappings.recv(act_shape, act_dtype, device, peer(v - 1), self.group,
                                          self._tag(0, m, v))
                        received(peer(v - 1), ("F", m, v - 1))
                        x.requires_grad_(train)
                    fn = chunk_fns[c]
                    y = checkpoint(fn, x, use_reentrant=False) if (
                        self.remat and train) else fn(x)
                    if v == last_v:
                        outs[m] = last_fn(y, aux_mb[m])
                        y = outs[m][0] if train else None
                    else:
                        send(y.detach(), peer(v + 1), ("F", m, v + 1), self._tag(0, m, v + 1))
                if train:
                    stash[(m, v)] = (x, y)
                    self.stashed += 1
                    self.stash_peak = max(self.stash_peak, self.stashed)
                continue
            x, y = stash.pop((m, v))
            if v == last_v:
                dy = loss_scale.to(y.dtype)
            else:
                dy = mappings.recv(act_shape, act_dtype, device, peer(v + 1), self.group,
                                   self._tag(1, m, v))
                received(peer(v + 1), ("B", m, v + 1))
            torch.autograd.backward(y, dy)
            self.stashed -= 1
            if v > 0:
                dx = x.grad if x.grad is not None else torch.zeros_like(x)
                send(dx, peer(v - 1), ("B", m, v - 1), self._tag(1, m, v - 1))
            del x, y
        for work, _, _ in sends:
            work.wait()
        return outs
