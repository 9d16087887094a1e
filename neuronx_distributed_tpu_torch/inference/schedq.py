"""The engine's admission backlog: heaps for EDF admission, shed victims and
deadline expiry, with O(1) arrived-depth and token-budget counters.

The port's own copy of ``AdmissionQueue``, ``admission_deadline`` and
``shed_deadline_key`` (``neuronx_distributed_tpu/inference/schedq.py``),
stdlib only. Every entry carries a deque-position token: ``append`` hands
out positions toward +inf and ``appendleft`` toward -inf, so "stable sort by
queue position" (FIFO by arrival, a requeued request ahead of the rest) is
the EDF tie-break, exactly as in the reference: the schedules of the two
engines depend on it. Removal marks an entry dead in O(1); heap entries
are checked against the entry's current token when popped, and the heaps
are compacted once dead entries outnumber live ones.

The router's ``PendingQueue`` waits for the router (ROADMAP A8.6).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Set, Tuple

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
