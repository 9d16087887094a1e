"""The engine's admission backlog and the router's placement backlog:
heaps for EDF admission, shed victims, deadline expiry and WFQ placement,
with O(1) counters.

The port's own copy of ``AdmissionQueue``, ``PendingQueue``,
``admission_deadline`` and ``shed_deadline_key``
(``neuronx_distributed_tpu/inference/schedq.py``), stdlib only. Every entry carries a deque-position token: ``append`` hands
out positions toward +inf and ``appendleft`` toward -inf, so "stable sort by
queue position" (FIFO by arrival, a requeued request ahead of the rest) is
the EDF tie-break, exactly as in the reference: the schedules of the two
engines depend on it. Removal marks an entry dead in O(1); heap entries
are checked against the entry's current token when popped, and the heaps
are compacted once dead entries outnumber live ones.

``PendingQueue`` orders the router's backlog by (replay first, WFQ finish
tag, request id), a total order, and keeps per-(role, tenant) integer
arrived-cost sums and per-tenant newest-victim heaps for tenant-aware
shedding and the autoscaler's signals.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Optional, Set, Tuple

_INF = float("inf")


def admission_deadline(r) -> float:
    """EDF key of one request: the deadline that binds its admission, the
    first token's when set, else the whole stream's, else never."""
    if r.ttft_deadline_block is not None:
        return float(r.ttft_deadline_block)
    if r.deadline_block is not None:
        return float(r.deadline_block)
    return _INF


def shed_deadline_key(r) -> Tuple[float, int]:
    """The ``deadline`` shed policy's victim order (the largest is shed):
    the laxest effective deadline, no deadline laxer than any, the newest
    request on a tie."""
    ttft = _INF if r.ttft_deadline_block is None else r.ttft_deadline_block
    full = _INF if r.deadline_block is None else r.deadline_block
    return (min(ttft, full), r.request_id)


class AdmissionQueue:
    """The admission backlog (a drop-in for a ``deque`` of requests):
    iteration and :meth:`ordered` give deque order; :meth:`peek_edf`,
    :meth:`peek_tail_victim`, :meth:`peek_lax_victim` and
    :meth:`expire_due` read the heaps; :meth:`arrived_count` and
    :meth:`tokens` are counters."""

    def __init__(self):
        self._req: Dict[int, object] = {}       # rid -> request
        self._pos: Dict[int, int] = {}          # rid -> deque-position token
        self._front = 0                         # next appendleft position + 1
        self._back = 0                          # next append position
        self._now = -(10 ** 9)                  # the last block advanced to
        self._arrived: Set[int] = set()
        self._tokens = 0                        # sum of max_new_tokens, live entries
        self._future: List[Tuple[int, int, int]] = []       # (arrival, pos, rid)
        self._edf: List[Tuple[float, int, int]] = []        # (deadline, pos, rid)
        self._tail: List[Tuple[int, int, int, int]] = []    # (-arrival, -rid, pos, rid)
        self._lax: List[Tuple[float, int, int, int]] = []   # (-deadline, -rid, pos, rid)
        self._exp: List[Tuple[float, int, int]] = []        # (expire_at, pos, rid)
        self._dead = 0                          # stale heap entries, about

    # --- deque-like mutation ----------------------------------------------

    def __len__(self) -> int:
        return len(self._req)

    def __bool__(self) -> bool:
        return bool(self._req)

    def __iter__(self) -> Iterator:
        return iter(self.ordered())

    def ordered(self) -> List:
        """Live requests in deque order."""
        return [self._req[rid] for rid in sorted(self._req, key=self._pos.__getitem__)]

    def append(self, req) -> None:
        self._insert(req, self._back)
        self._back += 1

    def appendleft(self, req) -> None:
        self._front -= 1
        self._insert(req, self._front)

    def extendleft(self, reqs) -> None:
        """``deque.extendleft``: each request goes to the front in turn, so
        the last one given ends up first."""
        for r in reqs:
            self.appendleft(r)

    def _insert(self, req, pos: int) -> None:
        rid = req.request_id
        if rid in self._req:
            raise ValueError(f"request {rid} already queued")
        self._req[rid] = req
        self._pos[rid] = pos
        self._tokens += int(req.max_new_tokens)
        dls = [d for d in (req.ttft_deadline_block, req.deadline_block) if d is not None]
        if dls:
            heapq.heappush(self._exp, (float(min(dls)), pos, rid))
        if req.arrival_block <= self._now:
            self._mark_arrived(req, pos)
        else:
            heapq.heappush(self._future, (int(req.arrival_block), pos, rid))

    def _mark_arrived(self, req, pos: int) -> None:
        rid = req.request_id
        self._arrived.add(rid)
        heapq.heappush(self._edf, (admission_deadline(req), pos, rid))
        heapq.heappush(self._tail, (-int(req.arrival_block), -rid, pos, rid))
        heapq.heappush(self._lax, (-shed_deadline_key(req)[0], -rid, pos, rid))

    def remove(self, rid: int):
        """Drop the request with id ``rid``; returns it, or None. Its heap
        entries go stale and are dropped when met."""
        req = self._req.pop(int(rid), None)
        if req is None:
            return None
        self._pos.pop(req.request_id, None)
        self._arrived.discard(req.request_id)
        self._tokens -= int(req.max_new_tokens)
        self._dead += 4
        self._maybe_compact()
        return req

    def find(self, rid: int):
        return self._req.get(int(rid))

    # --- the clock ----------------------------------------------------------

    def advance(self, now: int) -> None:
        """Move requests whose arrival block is at or before ``now`` into
        the arrived heaps. The clock never goes back."""
        if now <= self._now:
            return
        self._now = int(now)
        while self._future and self._future[0][0] <= now:
            _arrival, pos, rid = heapq.heappop(self._future)
            if self._pos.get(rid) == pos and rid not in self._arrived:
                self._mark_arrived(self._req[rid], pos)

    # --- counters -----------------------------------------------------------

    def arrived_count(self, now: int) -> int:
        self.advance(now)
        return len(self._arrived)

    def tokens(self) -> int:
        """Sum of ``max_new_tokens`` over the queued requests (the
        retry-after estimate's numerator)."""
        return self._tokens

    # --- ordered reads --------------------------------------------------------

    def _valid(self, pos: int, rid: int) -> bool:
        return self._pos.get(rid) == pos and rid in self._arrived

    def peek_edf(self, now: int, skip, k: int) -> List:
        """Up to ``k`` arrived requests in admission order (earliest
        deadline first, deque position on a tie), leaving out the ids in
        ``skip``. Removes nothing."""
        self.advance(now)
        out, popped = [], []
        h = self._edf
        while h and len(out) < k:
            item = heapq.heappop(h)
            _dl, pos, rid = item
            if not self._valid(pos, rid):
                self._dead = max(self._dead - 1, 0)
                continue
            popped.append(item)
            if rid not in skip:
                out.append(self._req[rid])
        for item in popped:
            heapq.heappush(h, item)
        return out

    def _peek_victim(self, heap, now: int):
        self.advance(now)
        while heap:
            item = heap[0]
            pos, rid = item[-2], item[-1]
            if self._valid(pos, rid):
                return self._req[rid]
            heapq.heappop(heap)
            self._dead = max(self._dead - 1, 0)
        return None

    def peek_tail_victim(self, now: int):
        """The newest arrived request (largest ``(arrival_block,
        request_id)``): the ``tail`` policy's victim."""
        return self._peek_victim(self._tail, now)

    def peek_lax_victim(self, now: int):
        """The arrived request with the laxest deadline (largest
        :func:`shed_deadline_key`): the ``deadline`` policy's victim."""
        return self._peek_victim(self._lax, now)

    def expire_due(self, now: int) -> List:
        """Remove and return, in deque order, every queued request whose
        effective deadline ``min(ttft, full)`` lies before ``now``."""
        out = []
        while self._exp and self._exp[0][0] < now:
            _d, pos, rid = heapq.heappop(self._exp)
            if self._pos.get(rid) != pos:
                self._dead = max(self._dead - 1, 0)
                continue
            out.append((pos, self._req[rid]))
            self.remove(rid)
        out.sort(key=lambda t: t[0])
        return [r for _pos, r in out]

    # --- upkeep ---------------------------------------------------------------

    def _maybe_compact(self) -> None:
        if self._dead <= 64 + 4 * len(self._req):
            return
        self._dead = 0
        live = set(self._req)
        self._future = [t for t in self._future
                        if self._pos.get(t[2]) == t[1] and t[2] not in self._arrived]
        self._edf = [t for t in self._edf if self._valid(t[1], t[2])]
        self._tail = [t for t in self._tail if self._valid(t[2], t[3])]
        self._lax = [t for t in self._lax if self._valid(t[2], t[3])]
        self._exp = [t for t in self._exp if t[2] in live and self._pos.get(t[2]) == t[1]]
        for h in (self._future, self._edf, self._tail, self._lax, self._exp):
            heapq.heapify(h)


class PendingQueue:
    """The router's placement backlog: entries are ``router._Entry``
    objects; the placement order ((replay-first, WFQ finish tag, rid)) is a
    total order so no deque positions are needed. Arrival/backoff gates
    (``max(arrival_block, not_before)``) ride a future heap; per-(role,
    tenant) INTEGER arrived-cost sums and per-tenant newest-victim heaps
    make tenant-aware shedding and the autoscaler's weighted-backlog signal
    O(1)-per-mutation instead of O(backlog)-per-block."""

    def __init__(self):
        self._entries: Dict[int, object] = {}
        self._gen: Dict[int, int] = {}          # rid -> insertion token
        self._seq = 0
        self._now = -(10 ** 9)
        self._future: List[Tuple[int, int, int]] = []
        self._ready: List[Tuple[Tuple[int, float, int], int, int]] = []
        self._ready_set: Set[int] = set()
        # arrived-cost sums (ints — prompt + budget tokens), per role pool
        # and tenant; the cost/weight division happens at read time so the
        # sum is exact regardless of mutation history
        self._cost: Dict[Tuple[str, str], int] = {}
        self._ready_role: Dict[str, int] = {"prefill": 0, "decode": 0}
        self._victims: Dict[str, List[Tuple[int, int, int]]] = {}
        self._pending_tokens = 0                # sum(max_new - delivered)
        self._n_decode_replay = 0               # replay entries w/ tokens
        self._dead = 0

    # --- role/cost helpers ------------------------------------------------

    @staticmethod
    def entry_role(e) -> str:
        """Which worker pool a pending entry loads: mid-stream replays are
        decode work, everything else is prefill work (mirrors
        ``DisaggRouter._viable_replicas``; a classic fleet sums both)."""
        return "decode" if (e.replay and e.generated) else "prefill"

    @staticmethod
    def entry_cost(e) -> int:
        return int(e.req.prompt.size) + int(e.req.max_new_tokens)

    # --- mutation ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def __iter__(self) -> Iterator:
        return iter(list(self._entries.values()))

    def append(self, e) -> None:
        rid = e.req.request_id
        if rid in self._entries:
            raise ValueError(f"entry {rid} already pending")
        self._seq += 1
        self._entries[rid] = e
        self._gen[rid] = self._seq
        self._pending_tokens += (int(e.req.max_new_tokens)
                                 - len(e.generated))
        if e.replay and e.generated:
            self._n_decode_replay += 1
        gate = max(int(e.req.arrival_block), int(e.not_before))
        if gate <= self._now:
            self._mark_ready(e, self._seq)
        else:
            heapq.heappush(self._future, (gate, self._seq, rid))

    # failover/migration re-entries used appendleft on the old deque; the
    # placement order is key-total, so front/back insertion is equivalent
    appendleft = append

    def _mark_ready(self, e, seq: int) -> None:
        rid = e.req.request_id
        self._ready_set.add(rid)
        key = (0 if e.replay else 1, float(e.finish_tag), rid)
        heapq.heappush(self._ready, (key, seq, rid))
        role = self.entry_role(e)
        tenant = e.req.tenant
        self._cost[(role, tenant)] = (self._cost.get((role, tenant), 0)
                                      + self.entry_cost(e))
        self._ready_role[role] += 1
        if not e.replay:
            heapq.heappush(self._victims.setdefault(tenant, []),
                           (-rid, seq, rid))

    def remove(self, e) -> None:
        rid = e.req.request_id if hasattr(e, "req") else int(e)
        ent = self._entries.pop(rid, None)
        if ent is None:
            return
        self._gen.pop(rid, None)
        self._pending_tokens -= (int(ent.req.max_new_tokens)
                                 - len(ent.generated))
        if ent.replay and ent.generated:
            self._n_decode_replay -= 1
        if rid in self._ready_set:
            self._ready_set.discard(rid)
            role = self.entry_role(ent)
            k = (role, ent.req.tenant)
            left = self._cost.get(k, 0) - self.entry_cost(ent)
            if left > 0:
                self._cost[k] = left
            else:
                self._cost.pop(k, None)
            self._ready_role[role] -= 1
        self._dead += 3
        self._maybe_compact()

    def get(self, rid: int):
        return self._entries.get(int(rid))

    # --- clock ------------------------------------------------------------

    def advance(self, now: int) -> None:
        if now <= self._now:
            return
        self._now = int(now)
        while self._future and self._future[0][0] <= now:
            _g, seq, rid = heapq.heappop(self._future)
            if self._gen.get(rid) == seq and rid not in self._ready_set:
                self._mark_ready(self._entries[rid], seq)

    # --- counters ---------------------------------------------------------

    def ready_count(self, now: int, role: Optional[str] = None) -> int:
        self.advance(now)
        if role is None or role == "both":
            return len(self._ready_set)
        return self._ready_role.get(role, 0)

    def pending_tokens(self) -> int:
        return self._pending_tokens

    def fresh_count(self) -> int:
        """Entries that are prefill work (fresh admissions + zero-token
        replays) — the disagg liveness check's numerator."""
        return len(self._entries) - self._n_decode_replay

    def decode_replay_count(self) -> int:
        return self._n_decode_replay

    def role_tenant_cost(self, role: Optional[str]) -> Dict[str, int]:
        """Arrived WFQ cost (integer tokens) per tenant for one role pool
        (None/'both' = both pools) — the autoscaler's weighted-backlog
        numerator and the tenant-shed usage table, O(tenants) to read."""
        out: Dict[str, int] = {}
        for (r, t), c in self._cost.items():
            if role in (None, "both") or r == role:
                out[t] = out.get(t, 0) + c
        return out

    # --- ordered reads ----------------------------------------------------

    def iter_ready(self, now: int):
        """Yield arrived entries in placement order (replays first, then
        WFQ finish tags, ids as tiebreak). The caller may ``remove()`` the
        yielded entry (a placement); everything merely inspected is
        restored. New entries pushed DURING iteration (requeue backoffs)
        are gated into the future, never yielded twice."""
        self.advance(now)
        popped = []
        try:
            while self._ready:
                item = heapq.heappop(self._ready)
                _key, seq, rid = item
                if self._gen.get(rid) != seq or rid not in self._ready_set:
                    self._dead = max(self._dead - 1, 0)
                    continue
                popped.append(item)
                yield self._entries[rid]
        finally:
            for item in popped:
                if self._gen.get(item[2]) == item[1]:
                    heapq.heappush(self._ready, item)

    def newest_victim(self, tenant: str):
        """Newest (max request id) arrived NON-REPLAY entry of ``tenant``
        — the tenant-over-budget shed victim; None when the tenant has
        only replay (or no) arrived entries."""
        h = self._victims.get(tenant)
        while h:
            _nr, seq, rid = h[0]
            if (self._gen.get(rid) == seq and rid in self._ready_set):
                return self._entries[rid]
            heapq.heappop(h)
            self._dead = max(self._dead - 1, 0)
        return None

    # --- maintenance ------------------------------------------------------

    def _maybe_compact(self) -> None:
        if self._dead <= 64 + 3 * len(self._entries):
            return
        self._dead = 0
        self._future = [t for t in self._future
                        if self._gen.get(t[2]) == t[1]
                        and t[2] not in self._ready_set]
        self._ready = [t for t in self._ready
                       if self._gen.get(t[2]) == t[1]
                       and t[2] in self._ready_set]
        heapq.heapify(self._future)
        heapq.heapify(self._ready)
        vic = {}
        for tenant, h in self._victims.items():
            keep = [t for t in h if self._gen.get(t[2]) == t[1]
                    and t[2] in self._ready_set]
            if keep:
                heapq.heapify(keep)
                vic[tenant] = keep
        self._victims = vic
