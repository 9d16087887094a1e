"""Pipeline schedules as pure-logic task generators.

The port's own copy of ``neuronx_distributed_tpu/pipeline/schedules.py``
(pure logic; the port imports nothing of the JAX package): the task
classes, ``inference_schedule``, ``train_1f1b_schedule``,
``interleaved_schedule`` and the tick-aligned ``GlobalInterleaved1F1B``
table (``interleaved_1f1b_global``), the reference's
``pipeline/scheduler.py`` re-expressed with frozen dataclasses.

Role in the port: ``pipeline/engine.py`` runs them. A stage executes its
rank's units in the schedule's order, and the matched send/receive
sequences of adjacent ranks (``train_1f1b_schedule``'s invariant) or the
global tick table (interleaved 1F1B: every payload crosses to its
neighbour by the next tick) make the point-to-point transfers line up.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Task:
    microbatch: int
    chunk: int = 0  # model-chunk index for interleaved (VPP) schedules


@dataclasses.dataclass(frozen=True)
class ForwardStep(Task):
    pass


@dataclasses.dataclass(frozen=True)
class BackwardStep(Task):
    pass


@dataclasses.dataclass(frozen=True)
class RecvForward(Task):
    pass


@dataclasses.dataclass(frozen=True)
class SendForward(Task):
    pass


@dataclasses.dataclass(frozen=True)
class RecvBackward(Task):
    pass


@dataclasses.dataclass(frozen=True)
class SendBackward(Task):
    pass


@dataclasses.dataclass(frozen=True)
class ReduceGrads(Task):
    pass


def inference_schedule(pp_rank: int, pp_size: int, num_microbatches: int) -> Iterator[List[Task]]:
    """Forward-only (reference ``InferenceSchedule``, scheduler.py:144)."""
    for mb in range(num_microbatches):
        step: List[Task] = []
        if pp_rank > 0:
            step.append(RecvForward(mb))
        step.append(ForwardStep(mb))
        if pp_rank < pp_size - 1:
            step.append(SendForward(mb))
        yield step


def train_1f1b_schedule(pp_rank: int, pp_size: int, num_microbatches: int) -> Iterator[List[Task]]:
    """1F1B: warmup forwards, steady-state alternating fwd/bwd, cooldown
    backwards (reference ``Train1F1BSchedule``, scheduler.py:157-254).

    Invariants (unit-tested): every rank executes exactly ``num_microbatches``
    forwards and backwards; in-flight microbatches never exceed
    ``pp_size - pp_rank``; send/recv sequences of adjacent ranks match.
    """
    first, last = pp_rank == 0, pp_rank == pp_size - 1
    warmup = min(pp_size - pp_rank - 1, num_microbatches)
    steady = num_microbatches - warmup

    fwd_mb = 0
    bwd_mb = 0

    # warmup: forwards only
    for _ in range(warmup):
        step: List[Task] = []
        if not first:
            step.append(RecvForward(fwd_mb))
        step.append(ForwardStep(fwd_mb))
        if not last:
            step.append(SendForward(fwd_mb))
        fwd_mb += 1
        yield step

    # steady state: 1 forward + 1 backward per step
    for i in range(steady):
        step = []
        if not first:
            step.append(RecvForward(fwd_mb))
        step.append(ForwardStep(fwd_mb))
        if not last:
            step.append(SendForward(fwd_mb))
            step.append(RecvBackward(bwd_mb))
        step.append(BackwardStep(bwd_mb))
        if not first:
            step.append(SendBackward(bwd_mb))
        fwd_mb += 1
        bwd_mb += 1
        yield step

    # cooldown: drain remaining backwards
    while bwd_mb < num_microbatches:
        step = []
        if not last:
            step.append(RecvBackward(bwd_mb))
        step.append(BackwardStep(bwd_mb))
        if not first:
            step.append(SendBackward(bwd_mb))
        bwd_mb += 1
        yield step

    yield [ReduceGrads(0)]


def interleaved_schedule(
    pp_rank: int, pp_size: int, num_microbatches: int, num_chunks: int
) -> Iterator[List[Task]]:
    """Interleaved / virtual-pipeline schedule (reference
    ``TrainInterleavedSchedule``, scheduler.py:256-541): each rank owns
    ``num_chunks`` model chunks; forwards sweep chunks in blocks of
    ``pp_size`` microbatches, backwards in reverse chunk order.

    This generator emits the *logical* fwd/bwd order (chunk-major blocks);
    send/recv pairing is derivable from (microbatch, chunk) adjacency.
    """
    if num_microbatches % pp_size != 0:
        raise ValueError(
            f"interleaved schedule requires num_microbatches ({num_microbatches}) "
            f"divisible by pp_size ({pp_size})"
        )
    total_f = num_microbatches * num_chunks
    # canonical megatron ordering of (chunk, microbatch) forward units
    fwd_order = [
        (chunk, blk * pp_size + m)
        for blk in range(num_microbatches // pp_size)
        for chunk in range(num_chunks)
        for m in range(pp_size)
    ]
    bwd_order = [(num_chunks - 1 - c, m) for (c, m) in fwd_order]
    warmup = min((pp_size - pp_rank - 1) * 2 + (num_chunks - 1) * pp_size, total_f)

    fi = bi = 0
    for _ in range(warmup):
        c, m = fwd_order[fi]
        fi += 1
        yield [ForwardStep(m, chunk=c)]
    while fi < total_f:
        c, m = fwd_order[fi]
        fi += 1
        cb, mb = bwd_order[bi]
        bi += 1
        yield [ForwardStep(m, chunk=c), BackwardStep(mb, chunk=cb)]
    while bi < total_f:
        cb, mb = bwd_order[bi]
        bi += 1
        yield [BackwardStep(mb, chunk=cb)]
    yield [ReduceGrads(0)]


# --- tick-aligned global interleaved 1F1B (drives the engine's interleaved run) -


@dataclasses.dataclass(frozen=True)
class GlobalInterleaved1F1B:
    """Tick-aligned interleaved-1F1B schedule + stash-slot assignment for the
    engine's interleaved 1F1B run (``engine.PipelineEngine`` with chunks > 1).

    Per (tick, rank): at most one forward chunk-unit and one backward
    chunk-unit. ``exec_f[(m, v)] / exec_b[(m, v)]`` give each virtual-stage
    unit's tick; ``x_slot/dy_slot`` assign each unit a stash slot on its rank
    such that lifetimes never overlap (verified at construction). Stash
    capacity is the schedule's true peak — flat in microbatch count, the
    1F1B property.
    """

    pp_size: int
    num_microbatches: int
    num_chunks: int
    ticks: int
    exec_f: Dict[Tuple[int, int], int]   # (m, v) -> tick
    exec_b: Dict[Tuple[int, int], int]
    x_slot: Dict[Tuple[int, int], int]   # (m, v) -> stash slot on rank v%S
    dy_slot: Dict[Tuple[int, int], int]
    x_slots: int                          # stash capacities (max over ranks)
    dy_slots: int

    def units_at(self, t: int, rank: int):
        """(fwd_unit, bwd_unit) at tick t on rank — each (m, v) or None."""
        f = next(((m, v) for (m, v), tt in self.exec_f.items()
                  if tt == t and v % self.pp_size == rank), None)
        b = next(((m, v) for (m, v), tt in self.exec_b.items()
                  if tt == t and v % self.pp_size == rank), None)
        return f, b


def interleaved_1f1b_global(
    pp_size: int, num_microbatches: int, num_chunks: int
) -> GlobalInterleaved1F1B:
    """Simulate the interleaved 1F1B schedule with explicit ring latency.

    Model: one global tick runs (≤1 fwd unit + ≤1 bwd unit) per rank; a unit's
    ring payload (activation forward, dx backward) is available to its
    neighbor from the NEXT tick. Per rank, forwards issue in the Megatron
    chunk-block order under the warmup in-flight cap
    ``2*(S-r-1) + (C-1)*S + 1`` (scheduler.py:256-541 warmup count + 1 in
    flight during steady state); backwards issue greedily oldest-first —
    which reproduces 1F1B's alternating steady state and its bounded
    activation footprint.
    """
    S, C, MB = pp_size, num_chunks, num_microbatches
    if MB % S != 0:
        raise ValueError(
            f"interleaved 1F1B requires num_microbatches ({MB}) divisible by "
            f"pp_size ({S})")
    V = S * C
    # per-rank forward issue order (Megatron chunk-block order)
    fwd_order = [
        (blk * S + m, chunk)
        for blk in range(MB // S)
        for chunk in range(C)
        for m in range(S)
    ]
    cap = [min(2 * (S - r - 1) + (C - 1) * S + 1, C * MB) for r in range(S)]

    exec_f: Dict[Tuple[int, int], int] = {}
    exec_b: Dict[Tuple[int, int], int] = {}
    next_f = [0] * S                      # index into fwd_order per rank
    pend_b: List[List[Tuple[int, int]]] = [[] for _ in range(S)]  # fwd-done, bwd-pending (issue order)
    in_flight = [0] * S
    t = 0
    total_units = S * C * MB
    while len(exec_b) < total_units:
        if t > 4 * (total_units + 2 * V):  # safety: schedule must terminate
            raise RuntimeError("interleaved 1F1B schedule did not converge")
        # backward first (1F1B drain priority); dy of (m, v) is ready if
        # v == V-1 and its OWN forward runs this tick (loss vjp, same tick),
        # or the downstream backward ran at a strictly earlier tick.
        for r in range(S):
            i = next_f[r]
            if i < len(fwd_order):
                m, c = fwd_order[i]
                v = c * S + r
                ready = v == 0 or exec_f.get((m, v - 1), t) < t
                if ready and in_flight[r] < cap[r]:
                    exec_f[(m, v)] = t
                    next_f[r] += 1
                    in_flight[r] += 1
                    pend_b[r].append((m, v))
        for r in range(S):
            chosen: Optional[Tuple[int, int]] = None
            for u in pend_b[r]:           # oldest-first
                m, v = u
                if v == V - 1:
                    ready = exec_f[u] <= t
                else:
                    ready = exec_b.get((m, v + 1), t) < t
                if ready:
                    chosen = u
                    break
            if chosen is not None:
                exec_b[chosen] = t
                pend_b[r].remove(chosen)
                in_flight[r] -= 1
        t += 1
    ticks = t

    def alloc(lifetimes: Dict[Tuple[int, int], Tuple[int, int, int]]):
        """Greedy per-rank slot assignment; lifetime = [birth, death] ticks
        inclusive. Returns (slot map, max slots over ranks)."""
        slot: Dict[Tuple[int, int], int] = {}
        peak = 0
        for r in range(S):
            units = sorted(
                (u for u, (rr, _, _) in lifetimes.items() if rr == r),
                key=lambda u: (lifetimes[u][1], u))
            free: List[int] = []
            nslots = 0
            releases: List[Tuple[int, int]] = []  # (death, slot)
            for u in units:
                _, birth, death = lifetimes[u]
                releases.sort()
                while releases and releases[0][0] < birth:
                    free.append(releases.pop(0)[1])
                if free:
                    s = free.pop(0)
                else:
                    s = nslots
                    nslots += 1
                slot[u] = s
                releases.append((death, s))
            peak = max(peak, nslots)
        return slot, peak

    # x stash on rank v%S: input of fwd unit (m, v). Born when it lands in the
    # stash (ring arrival for v>0, the unit's own tick for v==0), dies after
    # the backward's vjp replay reads it.
    x_life = {
        (m, v): (v % S,
                 exec_f[(m, v)] if v == 0 else exec_f[(m, v - 1)] + 1,
                 exec_b[(m, v)])
        for (m, v) in exec_f
    }
    # dy stash on rank v%S: cotangent consumed by bwd unit (m, v). Born at the
    # loss vjp tick (v == V-1) or ring arrival, dies when the backward runs.
    dy_life = {
        (m, v): (v % S,
                 exec_f[(m, v)] if v == V - 1 else exec_b[(m, v + 1)] + 1,
                 exec_b[(m, v)])
        for (m, v) in exec_b
    }
    x_slot, x_slots = alloc(x_life)
    dy_slot, dy_slots = alloc(dy_life)

    # sanity: no two units sharing a slot may have overlapping lifetimes
    for life, slots in ((x_life, x_slot), (dy_life, dy_slot)):
        by_rs: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for u, (r, b, d) in life.items():
            by_rs.setdefault((r, slots[u]), []).append((b, d))
        for spans in by_rs.values():
            spans.sort()
            for (b1, d1), (b2, d2) in zip(spans, spans[1:]):
                if b2 <= d1:
                    raise AssertionError("stash slot lifetime overlap")

    return GlobalInterleaved1F1B(
        pp_size=S, num_microbatches=MB, num_chunks=C, ticks=ticks,
        exec_f=exec_f, exec_b=exec_b, x_slot=x_slot, dy_slot=dy_slot,
        x_slots=x_slots, dy_slots=dy_slots)
