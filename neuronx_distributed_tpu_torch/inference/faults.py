"""Deterministic fault injection for the serving engine.

The port's own copy of ``neuronx_distributed_tpu/inference/faults.py``
(numpy and the standard library only). A seeded :class:`FaultPlan` drives
one :class:`FaultInjector` per engine run, so a chaos run is replayable:
the same plan over the same trace makes the same decisions in the same
order, in this package and in the reference (the per-seam ``RandomState``
seeds are the reference's formula, bit for bit).

Seams, each a stream of its own (seed folded with the seam name, so draws
at one seam never shift another's schedule):

* **alloc** (``PageAllocator.fault_hook``): an allocation that would have
  succeeded fails for ``pool_storm_len`` consecutive calls, a
  ``PagePoolExhausted`` storm the scheduler defers or rolls back through;
* **dispatch** (:meth:`FaultInjector.before_dispatch`): an insert, extend
  or decode launch raises :class:`TransientDispatchError` before it runs,
  up to ``dispatch_max_failures`` times in a row; the engine retries with
  exponential backoff and raises :class:`DispatchFailed` past its budget;
* **corrupt** (:meth:`FaultInjector.pages_to_corrupt`): per scheduling
  round, a live KV page is garbled on the device; the engine repairs it
  from the host tier or re-prefills the requests reading through it;
* **tier** (:meth:`FaultInjector.on_tier_restore`): a host-tier read
  fails, or its bytes are garbled and the checksum catches it; either way
  the admission re-prefills;
* **replica**, **adapter**, **grammar**, **migrate** and **park**: the
  router, multi-LoRA, grammar, disaggregation and conversation-tier seams
  of the reference, kept here with their draws for the slices that port
  those features.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Dict, List, Optional, Sequence


class TransientDispatchError(RuntimeError):
    """A program launch failed before running (injected, or a transient
    failure of the device runtime). Safe to retry: no device state was
    mutated."""


class DispatchFailed(RuntimeError):
    """A dispatch kept failing past the engine's retry budget — the
    fail-stop escalation (snapshot/restore is the recovery path)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded chaos schedule. All probabilities are per-event; zero
    disables a seam. ``pool_storm_len`` / ``dispatch_max_failures`` bound
    how long one injected failure episode lasts — keep
    ``dispatch_max_failures <= ServeEngine(dispatch_retries=...)`` for a
    recoverable storm (larger values test the fail-stop escalation)."""

    seed: int = 0
    pool_exhaust_prob: float = 0.0
    pool_storm_len: int = 1
    dispatch_fail_prob: float = 0.0
    dispatch_max_failures: int = 1
    corrupt_page_prob: float = 0.0
    replica_crash_prob: float = 0.0
    max_replica_crashes: int = 1
    tier_restore_fail_prob: float = 0.0
    tier_corrupt_prob: float = 0.0
    adapter_load_fail_prob: float = 0.0
    adapter_corrupt_prob: float = 0.0
    grammar_load_fail_prob: float = 0.0
    grammar_corrupt_prob: float = 0.0
    migrate_fail_prob: float = 0.0
    migrate_corrupt_prob: float = 0.0
    park_write_fail_prob: float = 0.0
    park_read_fail_prob: float = 0.0
    park_corrupt_prob: float = 0.0

    def __post_init__(self):
        for name in ("pool_exhaust_prob", "dispatch_fail_prob",
                     "corrupt_page_prob", "replica_crash_prob",
                     "tier_restore_fail_prob", "tier_corrupt_prob",
                     "adapter_load_fail_prob", "adapter_corrupt_prob",
                     "grammar_load_fail_prob", "grammar_corrupt_prob",
                     "migrate_fail_prob", "migrate_corrupt_prob",
                     "park_write_fail_prob", "park_read_fail_prob",
                     "park_corrupt_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.tier_restore_fail_prob + self.tier_corrupt_prob > 1.0:
            raise ValueError(
                "tier_restore_fail_prob + tier_corrupt_prob must be <= 1 "
                "(one verdict per restore)")
        if self.adapter_load_fail_prob + self.adapter_corrupt_prob > 1.0:
            raise ValueError(
                "adapter_load_fail_prob + adapter_corrupt_prob must be <= 1 "
                "(one verdict per acquire)")
        if self.grammar_load_fail_prob + self.grammar_corrupt_prob > 1.0:
            raise ValueError(
                "grammar_load_fail_prob + grammar_corrupt_prob must be <= 1 "
                "(one verdict per acquire)")
        if self.migrate_fail_prob + self.migrate_corrupt_prob > 1.0:
            raise ValueError(
                "migrate_fail_prob + migrate_corrupt_prob must be <= 1 "
                "(one verdict per handoff)")
        if self.park_read_fail_prob + self.park_corrupt_prob > 1.0:
            raise ValueError(
                "park_read_fail_prob + park_corrupt_prob must be <= 1 "
                "(one verdict per resume read)")
        if self.pool_storm_len < 1 or self.dispatch_max_failures < 1:
            raise ValueError("storm lengths must be >= 1")
        if self.max_replica_crashes < 0:
            raise ValueError(
                f"max_replica_crashes must be >= 0, got "
                f"{self.max_replica_crashes}")

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Build from a JSON object string (the ``--fault_plan`` CLI
        surface; the runner resolves file paths before calling this)."""
        d = json.loads(spec)
        if not isinstance(d, dict):
            raise ValueError(f"fault plan must be a JSON object, got {d!r}")
        return cls(**d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FaultInjector:
    """Stateful executor of one :class:`FaultPlan`. One injector per engine
    run — its per-seam streams and storm counters ARE the run's fault
    schedule, so two engines must not share one."""

    def __init__(self, plan: FaultPlan):
        import numpy as np

        self.plan = plan
        # independent per-seam streams: the seam name is folded into the
        # seed, so one seam's draw count never shifts another's schedule
        self._rs = {
            seam: np.random.RandomState(
                (plan.seed * 0x9E3779B1 + zlib.crc32(seam.encode())) % (2**32))
            for seam in ("alloc", "dispatch", "corrupt", "replica", "tier",
                         "adapter", "grammar", "migrate", "park")
        }
        self._storm_left = 0
        self._fail_left: Dict[str, int] = {}
        self._replica_crashes_done = 0
        self.stats = {"alloc_faults": 0, "dispatch_faults": 0,
                      "pages_corrupted": 0, "replica_crashes": 0,
                      "tier_restore_faults": 0, "tier_corruptions": 0,
                      "adapter_load_faults": 0, "adapter_corruptions": 0,
                      "grammar_load_faults": 0, "grammar_corruptions": 0,
                      "migrate_faults": 0, "migrate_corruptions": 0,
                      "park_write_faults": 0, "park_torn_manifests": 0,
                      "park_read_faults": 0, "park_corruptions": 0}

    # --- allocator seam --------------------------------------------------

    def on_alloc(self, n: int) -> bool:
        """Called by ``PageAllocator.alloc`` when the request WOULD succeed;
        True forces the exhausted path (the storm pretends the pool is
        empty)."""
        if self._storm_left > 0:
            self._storm_left -= 1
            self.stats["alloc_faults"] += 1
            return True
        p = self.plan.pool_exhaust_prob
        if p and self._rs["alloc"].random_sample() < p:
            self._storm_left = self.plan.pool_storm_len - 1
            self.stats["alloc_faults"] += 1
            return True
        return False

    # --- dispatch seam ---------------------------------------------------

    def before_dispatch(self, kind: str) -> None:
        """Raise :class:`TransientDispatchError` to fail the upcoming
        ``kind`` dispatch (insert/extend/decode). Runs BEFORE the compiled
        program, so an injected failure never leaves device state half
        mutated."""
        left = self._fail_left.get(kind, 0)
        if left > 0:
            self._fail_left[kind] = left - 1
            self.stats["dispatch_faults"] += 1
            raise TransientDispatchError(f"injected {kind} dispatch failure")
        p = self.plan.dispatch_fail_prob
        if p and self._rs["dispatch"].random_sample() < p:
            self._fail_left[kind] = self.plan.dispatch_max_failures - 1
            self.stats["dispatch_faults"] += 1
            raise TransientDispatchError(f"injected {kind} dispatch failure")

    # --- replica seam ----------------------------------------------------

    def replica_crash(self, alive: Sequence[int]) -> Optional[int]:
        """Per ROUTER block: pick at most one live replica to crash (None =
        no fault this block). Bounded by ``max_replica_crashes`` so a plan
        cannot take the whole fleet down; the Router additionally refuses
        to crash the last live replica (there would be nowhere to fail
        over, i.e. a correlated total outage — out of scope for the
        single-router recovery story)."""
        p = self.plan.replica_crash_prob
        if (not p or not len(alive)
                or self._replica_crashes_done
                >= self.plan.max_replica_crashes):
            return None
        rs = self._rs["replica"]
        if rs.random_sample() < p:
            victim = int(sorted(int(x) for x in alive)[
                rs.randint(len(alive))])
            self._replica_crashes_done += 1
            self.stats["replica_crashes"] += 1
            return victim
        return None

    # --- tier seam -------------------------------------------------------

    def on_tier_restore(self) -> Optional[str]:
        """Called by ``HostPageTier.get`` before each restore/repair read:
        one draw decides the verdict — ``'fail'`` (read error: the tier
        drops the entry and raises), ``'corrupt'`` (the tier garbles the
        entry's host bytes; the checksum then catches it), or None (clean
        read). One draw per read keeps the seam's schedule independent of
        which verdict fired."""
        frp = self.plan.tier_restore_fail_prob
        tcp = self.plan.tier_corrupt_prob
        if not (frp or tcp):
            return None
        u = self._rs["tier"].random_sample()
        if u < frp:
            self.stats["tier_restore_faults"] += 1
            return "fail"
        if u < frp + tcp:
            self.stats["tier_corruptions"] += 1
            return "corrupt"
        return None

    # --- migrate seam ----------------------------------------------------

    def on_migrate(self) -> Optional[str]:
        """Called by the disaggregation router per prefill→decode KV-page
        handoff delivery: one draw decides the verdict — ``'fail'`` (the
        transfer is lost in flight: the decode side re-prefills the stream
        locally), ``'corrupt'`` (the handoff's host bytes are garbled; the
        per-page crc32 sealed at send catches it on adopt and the path
        degrades to the same local re-prefill), or None (clean transfer).
        One draw per delivery keeps the seam's schedule independent of
        which verdict fired — the tier/adapter seams' discipline."""
        mfp = self.plan.migrate_fail_prob
        mcp = self.plan.migrate_corrupt_prob
        if not (mfp or mcp):
            return None
        u = self._rs["migrate"].random_sample()
        if u < mfp:
            self.stats["migrate_faults"] += 1
            return "fail"
        if u < mfp + mcp:
            self.stats["migrate_corruptions"] += 1
            return "corrupt"
        return None

    # --- park seam -------------------------------------------------------

    def on_park_write(self) -> Optional[str]:
        """Called by the conversation park store per park WRITE: one draw
        decides the verdict — ``'fail'`` (the KV shard write raises after
        retries: the park degrades to a state-only manifest, so the next
        resume re-prefills), ``'torn'`` (shards and manifest land but the
        done marker never does — the crash-mid-park shape; readers never
        see the partial park, the quarantine path reclaims it), or None
        (clean park). Both failure shapes share ``park_write_fail_prob``
        (one draw split down the middle) so the seam stays one-draw-per-op
        and plans replay identically."""
        p = self.plan.park_write_fail_prob
        if not p:
            return None
        u = self._rs["park"].random_sample()
        if u < p * 0.5:
            self.stats["park_write_faults"] += 1
            return "fail"
        if u < p:
            self.stats["park_torn_manifests"] += 1
            return "torn"
        return None

    def on_park_read(self) -> Optional[str]:
        """Called by the conversation park store per resume READ: one draw
        decides the verdict — ``'fail'`` (the manifest/shard read raises:
        resume degrades to re-prefill from the parked request state),
        ``'corrupt'`` (the stored bytes are garbled at rest; the per-shard
        sha256 / per-page crc32 catches it, the manifest is quarantined,
        and the path degrades to the same re-prefill), or None (clean
        read). One draw per read keeps the seam's schedule independent of
        which verdict fired — the tier/migrate seams' discipline."""
        frp = self.plan.park_read_fail_prob
        pcp = self.plan.park_corrupt_prob
        if not (frp or pcp):
            return None
        u = self._rs["park"].random_sample()
        if u < frp:
            self.stats["park_read_faults"] += 1
            return "fail"
        if u < frp + pcp:
            self.stats["park_corruptions"] += 1
            return "corrupt"
        return None

    # --- adapter seam ----------------------------------------------------

    def on_adapter_acquire(self) -> Optional[str]:
        """Called by ``AdapterPool.acquire`` before each pin: one draw
        decides the verdict — ``'fail'`` (load IO error: the admission
        requeues and retries a later block), ``'corrupt'`` (the resident
        slot's device bytes are garbled; the pool's checksum catches it and
        repairs from the host registry), or None. One draw per acquire
        keeps the seam's schedule independent of which verdict fired —
        the same discipline as the tier seam."""
        flp = self.plan.adapter_load_fail_prob
        acp = self.plan.adapter_corrupt_prob
        if not (flp or acp):
            return None
        u = self._rs["adapter"].random_sample()
        if u < flp:
            self.stats["adapter_load_faults"] += 1
            return "fail"
        if u < flp + acp:
            self.stats["adapter_corruptions"] += 1
            return "corrupt"
        return None

    # --- grammar seam ----------------------------------------------------

    def on_grammar_acquire(self) -> Optional[str]:
        """Called by ``GrammarPool.acquire`` before each pin: one draw
        decides the verdict — ``'fail'`` (table load IO error: the
        admission requeues and retries a later block), ``'corrupt'`` (the
        resident slot's device mask table is garbled; the pool's checksum
        catches it and repairs from the host registry), or None. One draw
        per acquire keeps the seam's schedule independent of which verdict
        fired — the adapter/tier seams' discipline."""
        flp = self.plan.grammar_load_fail_prob
        gcp = self.plan.grammar_corrupt_prob
        if not (flp or gcp):
            return None
        u = self._rs["grammar"].random_sample()
        if u < flp:
            self.stats["grammar_load_faults"] += 1
            return "fail"
        if u < flp + gcp:
            self.stats["grammar_corruptions"] += 1
            return "corrupt"
        return None

    # --- corruption seam -------------------------------------------------

    def pages_to_corrupt(self, live_pages: Sequence[int]) -> List[int]:
        """Per decode block: pick at most one live page to corrupt (empty
        list = no fault this block). The engine garbles the page's bytes and
        runs the detect/invalidate/replay recovery."""
        p = self.plan.corrupt_page_prob
        if not p or not len(live_pages):
            return []
        rs = self._rs["corrupt"]
        if rs.random_sample() < p:
            page = int(sorted(int(x) for x in live_pages)[
                rs.randint(len(live_pages))])
            self.stats["pages_corrupted"] += 1
            return [page]
        return []


def resolve_fault_plan(
        spec: Optional[str]) -> Optional[FaultPlan]:
    """CLI helper: ``spec`` is None (no faults), a path to a JSON file, or
    an inline JSON object string."""
    if not spec:
        return None
    import os

    if os.path.exists(spec):
        with open(spec) as f:
            spec = f.read()
    return FaultPlan.from_spec(spec)
