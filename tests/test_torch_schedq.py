"""The port's admission backlog (``inference/schedq.py``) against the JAX
package's, operation by operation.

One seeded numpy sequence of 600 operations on stub requests
(``append``, ``appendleft``, ``extendleft``, ``remove``, ``advance`` and
``expire_due``; arrivals ahead of the clock, TTFT and completion deadlines
or none) drives both queues. After every operation both give the same
``ordered`` ids, ``peek_edf`` for several ``k`` and skip sets,
``peek_tail_victim``, ``peek_lax_victim``, ``arrived_count`` and
``tokens``: exact equality. Enough removals happen for both to compact
their heaps.
"""

import dataclasses
from typing import Optional

import numpy as np
import pytest

from neuronx_distributed_tpu.inference import schedq as jsq
from neuronx_distributed_tpu_torch.inference import schedq as tsq


@dataclasses.dataclass
class _Req:
    request_id: int
    arrival_block: int
    max_new_tokens: int
    ttft_deadline_block: Optional[int] = None
    deadline_block: Optional[int] = None


def _new(rng, rid, now):
    ttft = full = None
    if rng.random() < 0.5:
        ttft = now + int(rng.integers(1, 12))
    if rng.random() < 0.5:
        full = now + int(rng.integers(1, 25))
    return _Req(request_id=rid, arrival_block=now + int(rng.integers(-2, 4)),
                max_new_tokens=int(rng.integers(1, 40)), ttft_deadline_block=ttft,
                deadline_block=full)


def _ids(reqs):
    return [None if r is None else r.request_id for r in reqs]


def _state(q, now, rng):
    skip = set(int(i) for i in rng.integers(0, 400, 6))
    return dict(
        ordered=_ids(q.ordered()), listed=_ids(list(q)), length=len(q),
        edf=[_ids(q.peek_edf(now, skip, k)) for k in (1, 3, 8)],
        edf_all=_ids(q.peek_edf(now, (), 10 ** 6)),
        tail=_ids([q.peek_tail_victim(now)]), lax=_ids([q.peek_lax_victim(now)]),
        arrived=q.arrived_count(now), tokens=q.tokens())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_queue_equals_jax_on_a_seeded_operation_sequence(seed):
    rng = np.random.default_rng(seed)
    jq, tq = jsq.AdmissionQueue(), tsq.AdmissionQueue()
    now, next_id, compacted = 0, 0, False
    for _ in range(600):
        op = rng.choice(["append", "appendleft", "extendleft", "remove", "advance", "expire"],
                        p=[0.25, 0.08, 0.05, 0.42, 0.12, 0.08])
        if op in ("append", "appendleft"):
            r = _new(rng, next_id, now)
            next_id += 1
            for q in (jq, tq):
                getattr(q, op)(r)
        elif op == "extendleft":
            rs = [_new(rng, next_id + i, now) for i in range(int(rng.integers(1, 4)))]
            next_id += len(rs)
            for q in (jq, tq):
                q.extendleft(list(rs))
        elif op == "remove":
            live = jq.ordered()
            rid = (live[int(rng.integers(len(live)))].request_id
                   if live and rng.random() < 0.9 else int(rng.integers(0, next_id + 5)))
            dead = tq._dead
            assert _ids([jq.remove(rid)]) == _ids([tq.remove(rid)])
            compacted |= dead + 4 > 64 + 4 * len(tq) and tq._dead == 0
        elif op == "advance":
            now += int(rng.integers(0, 3))
            for q in (jq, tq):
                q.advance(now)
        else:
            assert _ids(jq.expire_due(now)) == _ids(tq.expire_due(now))
        seed_skip = int(rng.integers(1 << 30))   # the same skip sets on both sides
        assert (_state(jq, now, np.random.default_rng(seed_skip))
                == _state(tq, now, np.random.default_rng(seed_skip)))
        for rid in (0, next_id // 2, next_id - 1):
            assert _ids([jq.find(rid)]) == _ids([tq.find(rid)])
    assert next_id > 150 and compacted


def test_sort_keys_equal_jax():
    rng = np.random.default_rng(9)
    for rid in range(200):
        r = _new(rng, rid, int(rng.integers(0, 50)))
        assert tsq.admission_deadline(r) == jsq.admission_deadline(r)
        assert tsq.shed_deadline_key(r) == jsq.shed_deadline_key(r)


def test_requeue_jumps_the_edf_tie_and_duplicates_raise():
    """Equal deadlines: a request put back at the front is admitted first;
    a request queued twice raises in both."""
    for m in (jsq, tsq):
        q = m.AdmissionQueue()
        a, b, c = (_Req(i, 0, 4, ttft_deadline_block=9) for i in range(3))
        q.append(a)
        q.append(b)
        q.appendleft(c)
        assert _ids(q.peek_edf(0, (), 3)) == [2, 0, 1]
        with pytest.raises(ValueError, match="already queued"):
            q.append(a)
