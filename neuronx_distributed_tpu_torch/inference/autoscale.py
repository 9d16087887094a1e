"""SLO-driven autoscaling: an elastic replica fleet on the virtual block
clock.

The port's own copy of ``neuronx_distributed_tpu/inference/autoscale.py``
(host logic, the standard library only). An :class:`Autoscaler` runs inside
the :class:`~.router.Router`/:class:`~.disagg.DisaggRouter` block loop
(``Router(autoscaler=...)``), once per block after drains finish and before
placement, and changes the fleet live:

* **scale-up** spawns a replica of a role pool when an SLO burn rule
  latches on a live replica of it, when the pool's weighted router backlog
  (WFQ cost over tenant weight) exceeds ``backlog_high_blocks`` blocks of
  the pool's service rate for ``up_patience_blocks`` blocks in a row, or
  when every live replica's page pool is at ``pool_high``; warm from a
  drained replica's snapshot when one of the role exists
  (``ServeEngine.from_snapshot``), cold otherwise. A cold replica is a new
  session on the shared ``CausalLM``: its programs are captured at first
  use, while the other sessions go on serving.
* **scale-down** drains the least-loaded live replica once the pool's
  utilization (active slots, engine backlogs and the router's arrived
  backlog over its slot capacity) stays under ``down_utilization`` for
  ``down_patience_blocks`` blocks; the drained replica's snapshot parks as
  the next warm spawn's image.
* On a :class:`~.disagg.DisaggRouter` the prefill and decode pools scale
  apart, each on its own signals (``per_role=``); the decode pool also
  counts handoffs it could not adopt yet.

Every signal is a block-clock quantity, so a (trace, policy, seed) triple
replays to the same ``scale_events``; ``cooldown_blocks`` separates the
events of one pool, and a pool below ``min_replicas`` is refilled at once.
Scale decisions land on the ``("router", "scale")`` lane, in the
``router_scale_events_total`` counters and, with a flight recorder armed,
as ``scale`` incident bundles.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["AutoscalePolicy", "Autoscaler"]


@dataclasses.dataclass
class AutoscalePolicy:
    """Knobs of one role pool's elasticity (the classic Router is one pool
    of role ``"both"``; a DisaggRouter runs a ``"prefill"`` and a
    ``"decode"`` pool, each with its own policy via
    ``Autoscaler(per_role=...)``).

    Thresholds are dimensionless on the virtual clock:
    ``backlog_high_blocks`` is weighted-backlog-tokens over the live
    pool's per-block service rate (1.0 = one full block of undispatched
    work per replica already queued at the router), ``pool_high`` a page
    occupancy fraction that must hold on EVERY live replica (one cold pool
    means capacity exists), ``down_utilization`` the busy fraction of
    fleet slot capacity under which the pool is oversized. Patience
    counts consecutive blocks (one bursty block must not spawn a
    replica); ``cooldown_blocks`` separates consecutive scale events of
    one pool so a spawn's effect is observed before the next decision —
    ``min_replicas`` enforcement (a crashed pool refilled to its floor)
    deliberately ignores the cooldown."""

    min_replicas: int = 1
    max_replicas: int = 4
    backlog_high_blocks: float = 1.0
    pool_high: float = 0.95
    slo_scale_up: bool = True
    up_patience_blocks: int = 2
    down_utilization: float = 0.4
    down_patience_blocks: int = 8
    cooldown_blocks: int = 8
    warm_from_park: bool = True

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")
        if self.backlog_high_blocks <= 0:
            raise ValueError(
                f"backlog_high_blocks must be > 0, got "
                f"{self.backlog_high_blocks}")
        if not 0.0 < self.pool_high <= 1.0:
            raise ValueError(f"pool_high must be in (0, 1], got "
                             f"{self.pool_high}")
        if not 0.0 <= self.down_utilization < 1.0:
            raise ValueError(
                f"down_utilization must be in [0, 1), got "
                f"{self.down_utilization}")
        if self.up_patience_blocks < 1 or self.down_patience_blocks < 1:
            raise ValueError("patience blocks must be >= 1")
        if self.cooldown_blocks < 0:
            raise ValueError(
                f"cooldown_blocks must be >= 0, got {self.cooldown_blocks}")


@dataclasses.dataclass
class _Signals:
    """One pool's deterministic per-block reading (all block-clock
    quantities — see the module docstring's determinism statement)."""

    live: List[int]
    backlog_blocks: float
    pool_pressure: Optional[float]   # min live-replica page occupancy
    slo_alerting: bool
    utilization: float
    up_reason: Optional[str] = None


class Autoscaler:
    """The policy object a Router hosts (``Router(autoscaler=...)``); one
    instance per router — it keeps per-pool patience/cooldown state and
    the deterministic ``scale_events`` log the replay tests compare."""

    def __init__(self, policy: Optional[AutoscalePolicy] = None,
                 per_role: Optional[Dict[str, AutoscalePolicy]] = None):
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.per_role = dict(per_role or {})
        # the deterministic event log: (block, action, role, replica,
        # reason, warm) — NO wall quantities (those ride the router's
        # stats/metrics) so replay comparisons are exact
        self.scale_events: List[dict] = []
        self._unresolved_ups: set = set()
        self._over: Dict[str, int] = {}
        self._idle: Dict[str, int] = {}
        # signal-staleness credit latched when an over/idle run STARTS:
        # under async_loop the state transition that
        # opened the run was itself observed late, and by the time it is
        # visible the pipeline may have drained (instantaneous staleness
        # back to 0) — so the deficit must be remembered for the run
        self._over_carry: Dict[str, int] = {}
        self._idle_carry: Dict[str, int] = {}
        self._last_event: Dict[str, int] = {}
        self._parked_seen: set = set()
        # up-event index -> blocks-to-first-placement, resolved eagerly
        # each block (a later re-spawn of the same index resets the
        # router's marker, so resolution cannot be deferred to run end)
        self._ttr: Dict[int, int] = {}

    def policy_for(self, role: str) -> AutoscalePolicy:
        return self.per_role.get(role, self.policy)

    # --- signals ----------------------------------------------------------

    @staticmethod
    def _entry_role(e) -> str:
        """Which pool a pending router entry loads: mid-stream replays are
        decode work, everything else (fresh admissions and zero-token
        replays) is prefill work — mirrors DisaggRouter._viable_replicas.
        On a classic fleet every entry matches the single "both" pool."""
        return "decode" if (e.replay and e.generated) else "prefill"

    def _signals(self, router, role: str, live: List[int]) -> _Signals:
        pol = self.policy_for(role)
        # per-block CACHED load summaries (router._rload — refreshed once
        # after each engine steps) instead of a fresh O(slots + trie)
        # load_summary() per replica per block, and the router queue's
        # incremental per-(role, tenant) integer cost sums instead of a
        # full backlog scan (policy signal reads do not scale with the
        # fleet-wide in-flight count)
        loads = [router._rload[i] for i in live]
        eng0 = router.engines[live[0]] if live else router.engines[0]
        slots = eng0.lm.max_batch
        rate = slots * eng0.block_steps          # tokens per replica-block
        router.pending.advance(router.blocks)
        cost = router.pending.role_tenant_cost(role)
        w_tokens = sum(c / router._tenant(t).weight
                       for t, c in sorted(cost.items()))
        arrived_n = router.pending.ready_count(router.blocks, role)
        extra_slots = 0
        if role == "decode":
            # handoffs the decode pool could not adopt are decode backlog
            # the router queue never sees (the adoption deferral path)
            handoffs = list(getattr(router, "_handoffs", ()))
            w_tokens += sum(h.req.max_new_tokens for h in handoffs)
            extra_slots = len(handoffs)
        n = max(len(live), 1)
        backlog_blocks = w_tokens / float(n * rate)
        occ = [l.pages_in_use / max(l.pages_in_use + l.pages_free, 1)
               for l in loads
               if l.pages_in_use is not None and l.pages_free is not None]
        pool_pressure = min(occ) if occ and len(occ) == len(loads) else None
        slo = any(l.slo_alerting for l in loads)
        # busy = occupied slots + work WAITING for one (queued + replays;
        # mid-prefill slots are already inside active_slots — counting
        # them again would read a prefill-heavy fleet as >100% busy)
        busy = (sum(l.active_slots + l.queue_depth + l.replays
                    for l in loads)
                + arrived_n + extra_slots)
        utilization = busy / float(n * slots)
        up = None
        if slo and pol.slo_scale_up:
            up = "slo_burn"
        elif backlog_blocks > pol.backlog_high_blocks:
            up = "queue_depth"
        elif pool_pressure is not None and pool_pressure >= pol.pool_high:
            up = "pool_pressure"
        return _Signals(live=live, backlog_blocks=backlog_blocks,
                        pool_pressure=pool_pressure, slo_alerting=slo,
                        utilization=utilization, up_reason=up)

    # --- the per-block decision -------------------------------------------

    def observe_block(self, router) -> None:
        """One policy evaluation per router block; runs BEFORE placement
        so freshly spawned capacity takes this block's arrivals. The
        router calls this — nothing here is wall-clock.

        Async block loop: when replicas run ``async_loop=True`` every
        signal read here (queue depths, utilization, SLO pressure) lags
        the in-flight block by exactly one harvest — the same one-block
        lag the engines' own retire path has. Because both sides commit on
        the virtual block clock, the lag shifts WHEN a threshold trips by
        at most one block and never reorders decisions, so scale events
        stay deterministic for a given trace (pinned by the async==sync
        matrix). Draining a pipelined replica is already safe: the park
        path waits on ``has_decode_work()`` (which counts in-flight
        blocks) and ``snapshot()`` drains the pipeline before encoding."""
        self._resolve_ttr(router)
        for i in sorted(router._drained):
            if i not in self._parked_seen and i in router.snapshots:
                self._parked_seen.add(i)
                self._note(router, {
                    "block": int(router.blocks), "action": "parked",
                    "role": router.role_of(i), "replica": int(i),
                    "reason": "drain_complete", "warm": None})
        for role in router.fleet_roles():
            self._observe_role(router, role)

    def _observe_role(self, router, role: str) -> None:
        pol = self.policy_for(role)
        live = [i for i in router._live_replicas()
                if router.role_of(i) == role]
        # floor enforcement first, cooldown-exempt: a crash that dropped
        # the pool under its minimum is a capacity emergency, not a tuning
        # decision (this is also what replaces crashed replicas)
        while len(live) < pol.min_replicas:
            self._scale_up(router, role, pol, "min_replicas")
            live = [i for i in router._live_replicas()
                    if router.role_of(i) == role]
        sig = self._signals(router, role, live)
        prev_over = self._over.get(role, 0)
        self._over[role] = prev_over + 1 if sig.up_reason else 0
        idle = (sig.up_reason is None
                and sig.utilization < pol.down_utilization)
        prev_idle = self._idle.get(role, 0)
        self._idle[role] = prev_idle + 1 if idle else 0
        # async_loop replicas report load one block stale
        # (observed_block = the newest block whose device effects the
        # summary reflects; the in-flight pipeline block lags it).  The
        # state transition that OPENS an over/idle run was itself observed
        # that much late, so patience counters measured against stale
        # signals would fire one block LATER than the sync fleet on the
        # same trace.  Latch the staleness when the run starts (by the
        # time the run is several blocks old the pipeline may have drained
        # and instantaneous staleness read 0 again) and credit it toward
        # patience so scale events land on the same virtual block either
        # way.  The policy runs BEFORE this block's step, so the freshest
        # possible stamp is router.blocks - 1; a sync fleet always
        # latches 0 and is untouched.
        stale = 0
        obs = [router._rload[i].observed_block for i in live
               if router._rload[i].observed_block]
        if obs:
            stale = max(0, int(router.blocks) - 1 - min(obs))
        if sig.up_reason is not None:
            if prev_over == 0:
                self._over_carry[role] = stale
        else:
            self._over_carry[role] = 0
        if idle:
            if prev_idle == 0:
                self._idle_carry[role] = stale
        else:
            self._idle_carry[role] = 0
        last = self._last_event.get(role)
        cooled = last is None or router.blocks - last >= pol.cooldown_blocks
        draining_role = any(router.role_of(i) == role
                            for i in router._draining)
        if (sig.up_reason is not None and cooled
                and (self._over[role] + self._over_carry.get(role, 0)
                     >= pol.up_patience_blocks)
                and len(live) < pol.max_replicas):
            self._scale_up(router, role, pol, sig.up_reason)
        elif (cooled and not draining_role
                and (self._idle[role] + self._idle_carry.get(role, 0)
                     >= pol.down_patience_blocks)
                and len(live) > pol.min_replicas):
            loads = {i: router._rload[i] for i in live}
            victim = min(live, key=lambda i: (
                loads[i].active_slots + loads[i].backlog, -i))
            self._scale_down(router, role, victim)

    def _scale_up(self, router, role: str, pol: AutoscalePolicy,
                  reason: str) -> None:
        i = router.add_replica(role=role, warm=pol.warm_from_park)
        self._over[role] = 0
        self._idle[role] = 0
        self._last_event[role] = int(router.blocks)
        self._parked_seen.discard(i)
        self._note(router, {
            "block": int(router.blocks), "action": "up", "role": role,
            "replica": int(i), "reason": reason,
            "warm": bool(router.last_spawn["warm"])})

    def _scale_down(self, router, role: str, victim: int) -> None:
        router.drain(victim)
        router.stats["scale_downs"] += 1
        self._idle[role] = 0
        self._last_event[role] = int(router.blocks)
        self._note(router, {
            "block": int(router.blocks), "action": "down", "role": role,
            "replica": int(victim), "reason": "idle", "warm": None})

    def _note(self, router, ev: dict) -> None:
        if ev["action"] == "up":
            self._unresolved_ups.add(len(self.scale_events))
        self.scale_events.append(ev)
        router.metrics.counter(
            "router_scale_events_total", help="autoscaler fleet mutations",
            action=ev["action"], role=ev["role"]).inc()
        if router.tracer.enabled:
            router.tracer.instant(
                f"scale_{ev['action']}" if ev["action"] != "parked"
                else "scale_parked",
                ("router", "scale"), block=router.blocks, args=dict(ev))
        if router.incident is not None and ev["action"] in ("up", "down"):
            router.incident.trigger(
                "scale", router.blocks, details=dict(ev),
                state=router.state_summary())

    # --- reporting --------------------------------------------------------

    def _resolve_ttr(self, router) -> None:
        for idx in sorted(self._unresolved_ups):
            ev = self.scale_events[idx]
            fp = router._first_place_block.get(ev["replica"])
            if fp is not None and fp >= ev["block"]:
                self._ttr[idx] = int(fp) - int(ev["block"])
                self._unresolved_ups.discard(idx)

    def time_to_ready_blocks(self, router) -> List[int]:
        """Per scale-up event: blocks from the decision to the new
        replica's FIRST placement (0 = it took work the same block — the
        scaler runs ahead of placement); events whose replica never
        received work before re-parking are omitted. Spawn wall cost is a
        separate, non-deterministic number
        (``router.last_spawn['spawn_ms']`` / ``serve_scaleup_spawn_ms``)."""
        self._resolve_ttr(router)
        return [self._ttr[i] for i in sorted(self._ttr)]

    def report(self, router) -> dict:
        """The serve report's ``autoscale`` section."""
        ttr = self.time_to_ready_blocks(router)
        return {
            "scale_events": [dict(ev) for ev in self.scale_events],
            "scale_ups": sum(1 for ev in self.scale_events
                             if ev["action"] == "up"),
            "scale_downs": sum(1 for ev in self.scale_events
                               if ev["action"] == "down"),
            "warm_spawns": int(router.stats["warm_spawns"]),
            "cold_spawns": int(router.stats["cold_spawns"]),
            "replicas_active": len(router._live_replicas()),
            "replica_blocks": int(router.stats["replica_blocks"]),
            "time_to_ready_blocks_mean": (round(sum(ttr) / len(ttr), 2)
                                          if ttr else None),
            "time_to_ready_blocks_max": max(ttr) if ttr else None,
            "last_spawn_ms": router.last_spawn.get("spawn_ms"),
        }
