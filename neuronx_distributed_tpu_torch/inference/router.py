"""Multi-replica serving front door: a fault-tolerant :class:`Router`
driving N :class:`ServeEngine` replicas on one shared virtual block clock.

The port's counterpart of ``neuronx_distributed_tpu/inference/router.py``.
Every replica is a session of ONE :class:`CausalLM` (the weights exist
once; each session holds its own KV pools, slot state and captured
programs) and every replica takes the same ``seed``: token t of request r
draws the noise of ``request_seed(seed, r)`` at counter t wherever it
runs, so a stream can move between replicas mid-flight and stay the
stream a single engine would have served. The router assigns globally
unique request ids and pins them at the engines (``submit_request``).

Placement (per block, over the arrived backlog in fairness order):

* **prefix affinity** — the replicas that may hold a request's first page
  hot are probed with ``PagedKVCache.prefix_peek`` (read-only, tiered
  entries included); the request goes where the longest page-aligned
  prefix of its prompt is resident;
* **least loaded** — otherwise the replica with the earliest feasible TTFT
  (free slots first, then the shortest backlog, then fewest pages in use);
  a :class:`Rejected` a replica bounces re-queues the request with the
  verdict's ``retry_after_blocks`` backoff (capped), up to
  ``max_requeues`` times before the rejection surfaces;
* **round_robin** — the baseline.

Per-tenant fairness is start-time fair queueing over token cost (prompt +
budget over the tenant's weight): placement is in virtual finish-tag order,
and when ``max_pending`` overflows the victim is the newest request of the
tenant furthest over its weighted share.

Replica failure and drain:

* a replica "goes dark" mid-block (``FaultPlan.replica_crash_prob`` or a
  scheduled ``crash_at``): its block's emissions are lost and its heartbeat
  stops. After ``heartbeat_miss_blocks`` the router fails every request
  placed there over to the survivors, from its own per-request delivery
  records (``record_streams``) or the replica's last snapshot
  (``snapshot_every_blocks``); ``last_failover_ms`` is the wall cost. The
  dead replica's session is closed: a block it left in flight on the
  device writes only into that session's pages and is fetched by no one;
* ``drain(i)`` stops placement on ``i``, migrates its queued, mid-prefill
  and pending-replay work to peers (the chunked admission rolls back
  atomically), lets its decoding streams finish in place, then snapshots
  it into ``snapshots[i]`` and closes its session (the autoscaler's warm
  spawn restores from that snapshot).

Observability: one shared tracer carries every replica's lanes (each under
its own ``replica<i>`` name) plus the router's ``("router",
"place"|"clock"|"faults"|"drain")`` lanes; the router's registry holds the
tenant-labelled families (``router_tenant_requests_total{tenant=...}``...),
the engines keep their own.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from neuronx_distributed_tpu_torch.inference.engine import (
    Completion,
    Rejected,
    ReplicaLoad,
    Request,
    ServeEngine,
    interblock_gap_report,
    per_tenant_report,
)
from neuronx_distributed_tpu_torch.inference.faults import FaultInjector, FaultPlan
from neuronx_distributed_tpu_torch.inference.schedq import PendingQueue
from neuronx_distributed_tpu_torch.observability import (
    FlightRecorder,
    MetricsRegistry,
    Tracer,
)
from neuronx_distributed_tpu_torch.observability import attribution as _attribution


class NoLiveReplicas(RuntimeError):
    """Every replica is dead or drained while work is still pending — the
    router has nowhere left to place; a supervisor must restart capacity
    (the drained snapshots + router records make that restart exact)."""


@dataclasses.dataclass
class _Tenant:
    """Start-time-fair-queueing state for one tenant: the weight is its
    share, ``finish`` the virtual-time frontier its next request queues
    behind."""

    weight: float = 1.0
    finish: float = 0.0
    submitted: int = 0


@dataclasses.dataclass
class _Entry:
    """One router-queue item awaiting placement. ``replay`` entries carry a
    ``generated`` prefix (failover work — they place ahead of everything,
    through the engine's resume path); ``not_before`` is the earliest
    placement block (arrival time or a rejection's retry-after backoff)."""

    req: Request
    v_start: float = 0.0
    finish_tag: float = 0.0
    not_before: int = 0
    replay: bool = False
    generated: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Record:
    """The router's authoritative per-request bookkeeping: where it is
    placed, what was already delivered to the client (the failover replay
    source), and how often it was bounced (the re-queue cap)."""

    req: Request
    tenant: str
    finish_tag: float
    v_start: float
    replica: Optional[int] = None
    delivered: List[int] = dataclasses.field(default_factory=list)
    requeues: int = 0


class Router:
    """Front door over ``num_replicas`` :class:`ServeEngine` replicas.

    ``**engine_kw`` (block_steps, fused, prefill_chunk_tokens, max_queue,
    shed_policy, block_time_ms, ...) is forwarded to every replica, so the
    fleet is homogeneous; ``placement`` picks the routing policy
    ('affinity' — prefix-affinity with least-loaded fallback, the default —
    'least_loaded', or 'round_robin', the bench baseline). ``faults``
    arms the shared :class:`FaultInjector` at every replica's
    engine seams AND the router's replica-crash seam."""

    def __init__(
        self,
        lm,
        num_replicas: int = 2,
        *,
        placement: str = "affinity",
        tenant_weights: Optional[Dict[str, float]] = None,
        max_pending: Optional[int] = None,
        heartbeat_miss_blocks: int = 2,
        max_requeues: int = 8,
        retry_after_cap_blocks: int = 16,
        replica_queue_depth: int = 0,
        snapshot_every_blocks: int = 0,
        record_streams: bool = True,
        keep_completions: bool = True,
        record_block_wall: bool = True,
        faults: Optional[Union[FaultPlan, FaultInjector]] = None,
        crash_at: Sequence[Tuple[int, int]] = (),
        autoscaler=None,
        seed: int = 0,
        trace: bool = False,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        incident_dir: Optional[str] = None,
        **engine_kw,
    ):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if placement not in ("affinity", "least_loaded", "round_robin"):
            raise ValueError(
                f"placement must be 'affinity', 'least_loaded' or "
                f"'round_robin', got {placement!r}")
        if heartbeat_miss_blocks < 1:
            raise ValueError(
                f"heartbeat_miss_blocks must be >= 1, got "
                f"{heartbeat_miss_blocks}")
        if max_pending is not None and max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.placement = placement
        self.max_pending = max_pending
        self.heartbeat_miss_blocks = int(heartbeat_miss_blocks)
        self.max_requeues = int(max_requeues)
        self.retry_after_cap_blocks = int(retry_after_cap_blocks)
        self.replica_queue_depth = int(replica_queue_depth)
        self.snapshot_every_blocks = int(snapshot_every_blocks)
        self.record_streams = bool(record_streams)
        # memory bounds: keep_completions=False folds finished streams into
        # aggregate counters (the streaming report's source) instead of the
        # completed/rejected lists; record_block_wall=False drops the
        # per-replica per-block wall ledger (the disagg decode clock needs
        # it; a long soak does not)
        self.keep_completions = bool(keep_completions)
        self.record_block_wall = bool(record_block_wall)
        # every replica draws with this seed (the stream contract above)
        self.seed = int(seed)
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=bool(trace))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._injector: Optional[FaultInjector] = None
        if faults is not None:
            self._injector = (faults if isinstance(faults, FaultInjector)
                              else FaultInjector(faults))
        # ONE flight recorder across the fleet: a replica-crash bundle must
        # see every replica's timeline, and the bundle budget is a per-
        # process bound, not per-replica
        self.incident: Optional[FlightRecorder] = None
        if incident_dir:
            self.incident = FlightRecorder(
                incident_dir, tracer=self.tracer, metrics=self.metrics,
                source="router")
        if self.incident is not None:
            engine_kw = dict(engine_kw, incident=self.incident)
        # the fleet: one lm (the weights once), N sessions, all on the SAME
        # seed — with router-assigned globally unique ids that makes streams
        # replica-independent by construction. lm + engine_kw are retained:
        # the autoscaler spawns replicas with the SAME recipe mid-run
        self.lm = lm
        # fleet-global park store: ONE ConversationParkStore
        # shared by every replica — including autoscaler-spawned ones — so
        # a conversation parked by a replica that later drains, scales
        # down, or crashes resumes on any survivor by request id alone
        if engine_kw.get("park_dir") is not None:
            from neuronx_distributed_tpu_torch.inference.conversation_tier import (
                ConversationParkStore)
            engine_kw = dict(engine_kw)
            engine_kw["park_store"] = ConversationParkStore(
                engine_kw.pop("park_dir"))
        self._engine_kw = dict(engine_kw)
        self.engines: List[ServeEngine] = self._build_engines(
            lm, num_replicas, engine_kw)
        self.crash_at = [(int(b), int(i)) for b, i in crash_at]
        for _b, i in self.crash_at:
            if not 0 <= i < num_replicas:
                raise ValueError(f"crash_at names unknown replica {i}")
        n = num_replicas
        self.blocks = 0
        # per-replica per-block wall seconds (index == router block; skipped
        # replicas record 0.0): the per-WORKER clock the disaggregation
        # report reads decode-side latency off (a dedicated decode host
        # never pays a co-scheduled prefill's wall time — this harness runs
        # everything in one thread, so the split must be measured per engine)
        self._eng_block_wall: List[List[float]] = [[] for _ in range(n)]
        self._next_id = 0
        self._vtime = 0.0
        self._tenants: Dict[str, _Tenant] = {}
        self._tenant_weights = dict(tenant_weights or {})
        # heap-backed placement backlog (inference/schedq.py): WFQ order,
        # arrival/backoff gates, per-(role, tenant) cost sums and shed
        # victims in O(log n) instead of per-block sorts/scans
        self.pending: PendingQueue = PendingQueue()
        self.completed: List[Completion] = []
        self.rejected: List[Rejected] = []
        self._records: Dict[int, _Record] = {}
        self._tenant_of: Dict[int, str] = {}
        self._alive = [True] * n
        self._dark: set = set()
        self._draining: set = set()
        self._drained: set = set()
        self._hb = [0] * n                      # last heartbeat block
        self._hc = [0] * n                      # harvested completions
        self._hr = [0] * n                      # harvested rejections
        self._drain_t0: Dict[int, float] = {}
        self.snapshots: Dict[int, dict] = {}
        self._rr_next = 0
        self.last_failover_ms: Optional[float] = None
        self.last_drain_ms: Optional[float] = None
        # elastic-fleet bookkeeping (inference/autoscale.py): the policy
        # object evaluated once per block, per-replica first-placement
        # blocks (the scale-up time-to-ready surface), the fleet-wide
        # LoRA registry re-applied to spawned replicas, and the last
        # spawn's wall cost (the only non-deterministic scale quantity —
        # it stays OUT of the scale-event log)
        self.autoscaler = autoscaler
        self._first_place_block: Dict[int, int] = {}
        self._adapter_registry: Dict[str, Tuple] = {}
        self._grammar_registry: Dict[str, dict] = {}
        self.last_spawn: Dict[str, object] = {}
        # incrementally-maintained placement state: one
        # ReplicaLoad per replica refreshed ONCE per block (after its
        # engine steps) and mirrored through every router-side mutation
        # (placements, resumes, extracts), so _can_take/_load_score stop
        # recomputing per request x per replica; running fleet sums back
        # the O(1) _free_capacity/_retry_after; the affinity index maps a
        # prompt's first-page key to the replicas that MAY hold it hot
        # (placement-recorded, peek-confirmed — false positives decay on
        # probe, false negatives cannot occur because every prefix enters
        # a replica's radix through a router-recorded placement)
        self._rload: List[ReplicaLoad] = []
        self._contrib: List[bool] = []
        self._fleet_free_slots = 0
        self._fleet_rate = 0
        self._fleet_inflight_tokens = 0
        self._open: set = set()
        # least-loaded fast path: a lazy heap over the open
        # set ordered by the REQUEST-INDEPENDENT score prefix; valid (and
        # exact) whenever the top replica passes the request's pool check
        # — placement is then O(log fleet) instead of a full score scan.
        # Subclasses that filter viability by role (DisaggRouter) fall
        # back to the scan automatically.
        self._open_heap: List[Tuple] = []
        self._uniform_viability = (
            type(self)._viable_replicas is Router._viable_replicas)
        self._affinity: Dict[Tuple, set] = {}
        pkv0 = getattr(self.engines[0].session, "paged", None)
        self._aff_ps = pkv0.page_size if pkv0 is not None else 0
        # streaming-report aggregates (filled by _harvest regardless of
        # keep_completions — cheap, and the two report paths then agree)
        self._agg = {"completed": 0, "tokens": 0, "ontime_tokens": 0,
                     "expired": 0, "missed": 0, "cancelled": 0,
                     "ttft_blocks_sum": 0, "queue_blocks_sum": 0}
        for i, eng in enumerate(self.engines):
            self._rload.append(eng.load_summary())
            self._contrib.append(False)
            self._contrib_on(i)
        self.stats = {
            "placements": 0, "affinity_placements": 0, "requeues": 0,
            "rejected": 0, "shed_evictions": 0, "crashes": 0,
            "heartbeat_misses": 0, "failovers": 0, "failed_over_requests": 0,
            "drains": 0, "drain_migrated_requests": 0, "snapshots_taken": 0,
            "scale_ups": 0, "scale_downs": 0, "warm_spawns": 0,
            "cold_spawns": 0, "replica_blocks": 0,
        }
        self._m_pending = self.metrics.gauge(
            "router_pending_depth", help="arrived router backlog")
        self._m_placements = self.metrics.counter(
            "router_placements_total", help="requests placed on replicas")
        self._m_replicas = self.metrics.gauge(
            "serve_replicas_active", help="live (placeable) replicas")
        self._m_replicas.set(len(self._live_replicas()))

    def _build_engines(self, lm, num_replicas: int,
                       engine_kw: dict) -> List[ServeEngine]:
        """Construct the replica fleet — the seam :class:`DisaggRouter`
        overrides to assign per-replica roles."""
        return [
            ServeEngine(lm, seed=self.seed, name=f"replica{i}",
                        tracer=self.tracer, faults=self._injector,
                        **engine_kw)
            for i in range(num_replicas)
        ]

    # --- elastic fleet membership (inference/autoscale.py) ----------------

    def role_of(self, i: int) -> str:
        """Replica ``i``'s disaggregation role ('both' on a classic
        homogeneous fleet) — the pool key autoscaling groups by."""
        return getattr(self.engines[i], "role", "both")

    def fleet_roles(self) -> List[str]:
        """The distinct role pools this fleet runs (['both'] classically;
        ['decode', 'prefill'] disaggregated) in deterministic order."""
        return sorted({self.role_of(i) for i in range(len(self.engines))})

    def add_replica(self, role: str = "both", warm: bool = True) -> int:
        """Grow the fleet by one replica of ``role``, live, mid-run. WARM
        reuse first: a parked (drained) replica of the same role restores
        from its snapshot via :meth:`ServeEngine.from_snapshot` — same
        index, same seed, scheduler state replayed; otherwise a COLD
        engine appends at a fresh index. Either way the weights are shared
        (a new session: its programs are captured at first use unless it
        takes over a closed session's state), registered adapters are
        re-registered, and the
        replica is placeable from THIS block. Returns the replica index;
        ``last_spawn`` records {replica, warm, spawn_ms} (the wall cost is
        deliberately outside the deterministic scale-event log)."""
        t0 = time.perf_counter()
        idx = None
        if warm:
            for i in sorted(self._drained):
                if i in self.snapshots and self.role_of(i) == role:
                    idx = self._unpark(i)
                    break
        was_warm = idx is not None
        if idx is None:
            idx = self._spawn(role)
        self._first_place_block.pop(idx, None)
        spawn_ms = round((time.perf_counter() - t0) * 1e3, 3)
        self.stats["scale_ups"] += 1
        self.stats["warm_spawns" if was_warm else "cold_spawns"] += 1
        self.last_spawn = {"replica": idx, "warm": was_warm,
                           "spawn_ms": spawn_ms}
        self.metrics.gauge(
            "serve_scaleup_spawn_ms",
            help="last replica spawn wall ms (warm restore or cold "
                 "construct)").set(spawn_ms)
        self._m_replicas.set(len(self._live_replicas()))
        return idx

    def _spawn_overrides(self, role: str) -> dict:
        """Ctor kwargs a snapshot's config section does NOT carry (infra
        objects + the role), supplied at unpark time so the restored
        engine is wired exactly like its `_build_engines` siblings."""
        extra = {k: self._engine_kw[k]
                 for k in ("slos", "incident", "trace")
                 if k in self._engine_kw}
        if role != "both":
            extra["role"] = role
        return extra

    def _unpark(self, i: int) -> int:
        """Warm scale-up: rebuild replica ``i`` from its parked snapshot
        on a fresh session (the snapshot restore path — queued work re-enters,
        in-flight streams would replay bit-identical; a cleanly drained
        park restores empty) and return it to placement."""
        eng = ServeEngine.from_snapshot(
            self.lm, self.snapshots[i],
            adapters=(dict(self._adapter_registry)
                      if self._adapter_registry else None),
            grammars=(dict(self._grammar_registry)
                      if self._grammar_registry else None),
            name=f"replica{i}", tracer=self.tracer, faults=self._injector,
            **self._spawn_overrides(self.role_of(i)))
        self.engines[i] = eng
        self._drained.discard(i)
        self._alive[i] = True
        self._hb[i] = self.blocks
        self._hc[i] = 0
        self._hr[i] = 0
        self._rload[i] = eng.load_summary()
        self._contrib_on(i)
        return i

    def _spawn(self, role: str) -> int:
        """Cold scale-up: append a fresh replica at a new index (same
        recipe as `_build_engines` — shared lm, shared seed, shared
        tracer/injector — so the fleet stays homogeneous)."""
        i = len(self.engines)
        kw = dict(self._engine_kw)
        if role != "both":
            kw["role"] = role
        eng = ServeEngine(self.lm, seed=self.seed, name=f"replica{i}",
                          tracer=self.tracer, faults=self._injector, **kw)
        for name, (lp, lc) in self._adapter_registry.items():
            eng.register_adapter(name, lp, lc)
        for name, spec in self._grammar_registry.items():
            eng.register_grammar(name, **spec)
        self.engines.append(eng)
        self._alive.append(True)
        self._hb.append(self.blocks)
        self._hc.append(0)
        self._hr.append(0)
        # keep the per-replica wall ledger block-aligned: the newcomer was
        # provisioned for zero of the elapsed blocks
        self._eng_block_wall.append(
            [0.0] * len(self._eng_block_wall[0])
            if self._eng_block_wall and self.record_block_wall else [])
        self._rload.append(eng.load_summary())
        self._contrib.append(False)
        self._contrib_on(i)
        self._note_new_replica(i, role)
        return i

    def _note_new_replica(self, i: int, role: str) -> None:
        """Post-append hook — :class:`DisaggRouter` extends its role
        table here."""

    # --- per-block load cache ----------------------------------------------

    def _contrib_on(self, i: int) -> None:
        if self._contrib[i]:
            return
        rl = self._rload[i]
        self._fleet_free_slots += rl.free_slots
        self._fleet_inflight_tokens += rl.inflight_tokens + rl.queued_tokens
        eng = self.engines[i]
        self._fleet_rate += eng.lm.max_batch * eng.block_steps
        self._contrib[i] = True

    def _contrib_off(self, i: int) -> None:
        if not self._contrib[i]:
            return
        rl = self._rload[i]
        self._fleet_free_slots -= rl.free_slots
        self._fleet_inflight_tokens -= rl.inflight_tokens + rl.queued_tokens
        eng = self.engines[i]
        self._fleet_rate -= eng.lm.max_batch * eng.block_steps
        self._contrib[i] = False

    def _refresh_load(self, i: int) -> None:
        """Re-read replica ``i``'s typed load summary (once per block,
        after its engine stepped — plus after router-driven mutations like
        drain extraction), keeping the live-fleet running sums exact."""
        fresh = self.engines[i].load_summary()
        if self._contrib[i]:
            old = self._rload[i]
            self._fleet_free_slots += fresh.free_slots - old.free_slots
            self._fleet_inflight_tokens += (
                (fresh.inflight_tokens + fresh.queued_tokens)
                - (old.inflight_tokens + old.queued_tokens))
        self._rload[i] = fresh

    def _mirror_place(self, i: int, e: "_Entry") -> None:
        """Apply one placement's effect to the cached summary — exactly
        what a fresh load_summary() would report (placement only ever
        queues work; slots/pages change when the engine steps)."""
        rl = self._rload[i]
        rl.backlog += 1
        if e.replay:
            rl.replays += 1
        else:
            rl.queue_depth += 1
            rl.queued_tokens += int(e.req.max_new_tokens)
            if self._contrib[i]:
                self._fleet_inflight_tokens += int(e.req.max_new_tokens)
        if not (rl.free_slots > rl.queue_depth
                or rl.queue_depth < self.replica_queue_depth):
            self._open.discard(i)

    def _note_affinity(self, req: Request, i: int) -> None:
        """Record that replica ``i`` is about to hold ``req``'s prompt
        prefix (its admission registers the pages) — the affinity probe
        set for future placements of the same first page."""
        ps = self._aff_ps
        if (not ps or req.prompt.size <= ps
                or self.placement != "affinity"):
            # only the affinity policy reads the index; recording under
            # least_loaded/round_robin would grow one key per distinct
            # first-page prefix for nothing (the soak's leak budget)
            return
        key = (req.adapter, req.prompt[:ps].tobytes())
        self._affinity.setdefault(key, set()).add(i)

    def _affinity_candidates(self, req: Request) -> set:
        ps = self._aff_ps
        if not ps or req.prompt.size <= ps:
            return set()
        return self._affinity.get((req.adapter, req.prompt[:ps].tobytes()),
                                  set())

    # --- tenants / fairness ----------------------------------------------

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(
                weight=float(self._tenant_weights.get(name, 1.0)))
            if t.weight <= 0:
                raise ValueError(
                    f"tenant {name!r} weight must be > 0, got {t.weight}")
        return t

    def set_tenant_weight(self, name: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self._tenant_weights[name] = float(weight)
        self._tenant(name).weight = float(weight)

    @staticmethod
    def _cost(req: Request) -> float:
        """WFQ service cost of one request: its whole token footprint.
        Prompt tokens count too — a prefill occupies the replica exactly
        like decode work does."""
        return float(req.prompt.size + req.max_new_tokens)

    def _arrived(self, e: _Entry) -> bool:
        return (e.req.arrival_block <= self.blocks
                and e.not_before <= self.blocks)

    # --- submission -------------------------------------------------------

    def register_adapter(self, name: str, lora_params, lora_config) -> None:
        """Register a LoRA adapter fleet-wide (every replica's pool learns
        the host bytes; device residency stays per-replica — which is what
        adapter-affinity placement keys on). The registry is retained so
        replicas the autoscaler spawns later learn the same adapters."""
        self._adapter_registry[name] = (lora_params, lora_config)
        for eng in self.engines:
            eng.register_adapter(name, lora_params, lora_config)

    def register_grammar(self, name: str, regex=None,
                         json_schema=None) -> None:
        """Register a grammar fleet-wide (every replica's pool compiles
        and stores the token DFA; device residency stays per-replica).
        The registry is retained so replicas the autoscaler spawns later
        learn the same grammars, and failed-over constrained streams can
        re-pin wherever they land."""
        spec = ({"regex": regex} if regex is not None
                else {"json_schema": json_schema})
        self._grammar_registry[name] = spec
        for eng in self.engines:
            eng.register_grammar(name, **spec)

    def submit(self, prompt, max_new_tokens: int, *,
               tenant: str = "default", sampler=None,
               eos_token_id: Optional[int] = None, arrival_block: int = 0,
               ttft_deadline_ms: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               adapter: Optional[str] = None,
               grammar: Optional[str] = None) -> Union[int, Rejected]:
        """Queue a request with the router (placement happens at block
        boundaries); returns its globally-unique id, or a structured
        :class:`Rejected` when tenant-aware shedding refuses it. Deadlines
        are budgets relative to ``arrival_block`` on the SHARED clock — a
        wait in the router queue spends the budget exactly like a wait in a
        replica queue would."""
        probe = self.engines[0]
        prompt, sampler, greedy = probe._validate_submit(
            prompt, max_new_tokens, sampler, eos_token_id)
        probe._validate_tenancy(adapter, grammar, int(max_new_tokens))
        rid = self._next_id
        self._next_id += 1
        req = Request(
            request_id=rid, prompt=prompt,
            max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
            temperature=0.0 if greedy else float(sampler.temperature),
            greedy=greedy, arrival_block=int(arrival_block),
            submit_block=self.blocks,
            ttft_deadline_block=probe._deadline_block(
                arrival_block, ttft_deadline_ms, "ttft_deadline_ms"),
            deadline_block=probe._deadline_block(
                arrival_block, deadline_ms, "deadline_ms"),
            tenant=str(tenant),
            adapter=adapter,
            grammar=grammar,
        )
        t = self._tenant(req.tenant)
        t.submitted += 1
        start = max(self._vtime, t.finish)
        t.finish = start + self._cost(req) / t.weight
        entry = _Entry(req=req, v_start=start, finish_tag=t.finish,
                       not_before=int(arrival_block))
        if self.keep_completions:
            # the per-rid tenant map only feeds the retained-report's
            # rejected-tenant table; in streaming mode it would be the one
            # O(trace)-growth dict left (the RSS leak detector's job is to
            # prove there are none)
            self._tenant_of[rid] = req.tenant
        self.metrics.counter("router_tenant_requests_total",
                             help="requests submitted per tenant",
                             tenant=req.tenant).inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "route_submit", ("router", "place"), block=self.blocks,
                args={"rid": rid, "tenant": req.tenant,
                      "prompt_len": int(prompt.size),
                      "max_new_tokens": int(max_new_tokens),
                      "finish_tag": round(t.finish, 3)})
        if (self.max_pending is not None
                and req.arrival_block <= self.blocks):
            arrived_n = self.pending.ready_count(self.blocks)
            if arrived_n >= self.max_pending + self._free_capacity():
                verdict = self._shed_tenant(entry, arrived_n)
                if verdict is not None:
                    return verdict
        self.pending.append(entry)
        self._records[rid] = _Record(req=req, tenant=req.tenant,
                                     finish_tag=entry.finish_tag,
                                     v_start=entry.v_start)
        self._m_pending.set(self.pending.ready_count(self.blocks))
        return rid

    # --- conversation tier ------------------------------------------------

    def _park_store(self):
        return self._engine_kw.get("park_store")

    def parked_ids(self) -> List[int]:
        """Ids resumable from the fleet-global park store (plus any
        replica's in-process park records) — ``resume_parked`` accepts any
        of them, on any live decode-capable replica."""
        ids: set = set()
        for i in self._live_replicas():
            if self.engines[i].park_store is not None:
                ids.update(self.engines[i].parked_ids())
        return sorted(ids)

    def resume_parked(self, request_id: int) -> Union[int, Rejected]:
        """Resume a parked conversation on a live decode-capable replica.
        The store is fleet-global, so the parking replica does NOT need to
        survive: a drained, scaled-down, or crashed replica's parked
        conversations resume anywhere. Prefers the replica still holding
        the in-process park record (wall-stamp continuity), else the
        least-loaded one. The engine's structured verdicts pass through
        (``park_deferred`` — retry later, record untouched;
        ``park_unresumable`` — nothing durable survived)."""
        rid = int(request_id)
        cands = [i for i in self._live_replicas()
                 if self.role_of(i) != "prefill"
                 and self.engines[i].park_store is not None]
        if not cands:
            raise NoLiveReplicas(
                "no live decode-capable replica with a park store")
        holder = next((i for i in cands
                       if rid in self.engines[i]._parked), None)
        i = holder if holder is not None else min(cands, key=self._score0)
        verdict = self.engines[i].resume_parked(rid)
        if isinstance(verdict, Rejected):
            return verdict
        self._next_id = max(self._next_id, rid + 1)
        rec = self._records.get(rid)
        if rec is None:
            # parked before this router existed (restart) or record was
            # dropped: rebuild from the resumed stream so failover and
            # delivery tracking cover it like any placed request
            req = next((r for r in self.engines[i].slots
                        if r is not None and r.request_id == rid), None)
            if req is not None:
                rec = _Record(req=req, tenant=req.tenant, finish_tag=0.0,
                              v_start=0.0)
                self._records[rid] = rec
                if self.keep_completions:
                    self._tenant_of[rid] = req.tenant
        if rec is not None:
            rec.replica = i
            toks = self.engines[i]._out.get(rid)
            if toks is not None and len(toks) > len(rec.delivered):
                rec.delivered = list(toks)
        self._refresh_load(i)
        if self.tracer.enabled:
            self.tracer.instant(
                "route_resume", ("router", "place"), block=self.blocks,
                args={"rid": rid, "replica": i})
        return rid

    def _free_capacity(self) -> int:
        # running sum over the live fleet's cached load summaries — O(1)
        # per submit instead of an every-replica slot scan
        return self._fleet_free_slots

    def _retry_after(self) -> int:
        """Fleet-wide backlog-drain estimate in blocks (the shed verdict's
        resubmission hint): undelivered token budget over the live
        replicas' aggregate K*slots service rate — all running sums."""
        pend = self.pending.pending_tokens()
        return max(1, -(-(pend + self._fleet_inflight_tokens)
                        // max(self._fleet_rate, 1)))

    def _shed_tenant(self, newcomer: _Entry,
                     arrived_n: int) -> Optional[Rejected]:
        """Tenant-aware overflow: the victim tenant is the one FURTHEST
        over its weighted share of the arrived backlog (integer token cost
        over weight, read off the pending queue's incremental sums), and
        within it the newest entry sheds first — a burst eats its own
        tail. Returns the newcomer's verdict, or None when a queued entry
        shed instead (the newcomer is admitted in its place)."""
        usage: Dict[str, float] = {
            t: c / self._tenant(t).weight
            for t, c in self.pending.role_tenant_cost(None).items()}
        tn = self._tenant(newcomer.req.tenant)
        usage[newcomer.req.tenant] = (usage.get(newcomer.req.tenant, 0.0)
                                      + self._cost(newcomer.req) / tn.weight)
        victim_tenant = max(sorted(usage), key=lambda k: usage[k])
        if victim_tenant == newcomer.req.tenant:
            # the newcomer is always the newest entry of its own tenant
            victim = newcomer
        else:
            victim = (self.pending.newest_victim(victim_tenant)
                      or newcomer)
        rej = Rejected(
            request_id=victim.req.request_id,
            retry_after_blocks=min(self._retry_after(),
                                   self.retry_after_cap_blocks),
            queue_depth=arrived_n,
            reason="tenant_over_budget")
        if self.keep_completions:
            self.rejected.append(rej)
        self.stats["rejected"] += 1
        self.metrics.counter("router_tenant_shed_total",
                             help="requests shed per tenant",
                             tenant=victim.req.tenant).inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "shed", ("router", "place"), block=self.blocks,
                args={"rid": victim.req.request_id,
                      "tenant": victim.req.tenant,
                      "reason": rej.reason,
                      "retry_after_blocks": rej.retry_after_blocks})
        if victim is newcomer:
            return rej
        self.pending.remove(victim)
        self._records.pop(victim.req.request_id, None)
        self.stats["shed_evictions"] += 1
        return None

    # --- placement --------------------------------------------------------

    def _live_replicas(self) -> List[int]:
        return [i for i in range(len(self.engines))
                if self._alive[i] and i not in self._dark
                and i not in self._draining and i not in self._drained]

    def _can_take(self, i: int, req: Request) -> bool:
        """Placement admission gate: a replica takes new work only while it
        has an UNCLAIMED free slot (free slots beyond its own queued
        backlog) and pool room — deeper backlogs stay at the router, where
        fairness ordering and affinity still apply. Work pushed eagerly
        into a replica queue could neither be re-ordered fairly nor
        re-routed to a hotter prefix: replica-side queueing front-runs WFQ,
        so it is off by default (``replica_queue_depth=0``); raising the
        knob trades fairness granularity for placement latency."""
        rl = self._rload[i]
        if (rl.free_slots > rl.queue_depth
                and self.engines[i]._pool_can_admit(req)):
            return True
        return rl.queue_depth < self.replica_queue_depth

    def _load_score(self, i: int, req: Request) -> Tuple:
        """Least-loaded / deadline-aware ordering key (smaller is better):
        ADAPTER AFFINITY first — a replica whose pool already holds the
        request's adapter beats every cold one (the prefix-affinity
        economics applied to adapter loads: a resident hit costs nothing,
        a cold load pays the device write and may evict a neighbour's hot
        adapter) — then estimated TTFT in blocks (0 with a free slot +
        pool room, else the soonest retirement estimate plus the queued
        backlog), then backlog depth, then fewest pages in use."""
        load = self._rload[i]
        adapter_miss = 0
        if req.adapter is not None and load.adapters_resident is not None:
            adapter_miss = 0 if req.adapter in load.adapters_resident else 1
        if load.free_slots and load.backlog == 0 \
                and self.engines[i]._pool_can_admit(req):
            est_ttft = 0
        else:
            est_ttft = load.pool_retry_after_blocks + load.backlog
        return (adapter_miss, est_ttft, load.backlog, -load.free_slots,
                load.pages_in_use or 0, i)

    def _score0(self, i: int) -> Tuple:
        """Request-independent placement score (the full ``_load_score``
        with ``adapter_miss=0`` and the pool check assumed to pass): a
        LOWER BOUND on any request's actual score for this replica, which
        is what makes the heap fast path exact — see ``_fast_pick``."""
        rl = self._rload[i]
        est0 = (0 if rl.free_slots and rl.backlog == 0
                else rl.pool_retry_after_blocks + rl.backlog)
        return (0, est0, rl.backlog, -rl.free_slots,
                rl.pages_in_use or 0, i)

    def _fast_pick(self, e: _Entry) -> Optional[int]:
        """O(log fleet) least-loaded pick off the open heap. Returns the
        EXACT argmin of ``_load_score`` over the viable set, or None to
        fall back to the full scan — whenever the heap top fails the
        request's pool-feasibility check (its actual score then exceeds
        its optimistic key, so some other replica might win) or the
        request carries an adapter (the affinity term re-orders)."""
        if e.req.adapter is not None or not self._uniform_viability:
            return None
        h = self._open_heap
        while h:
            key, i = h[0]
            if i not in self._open:
                heapq.heappop(h)
                continue
            cur = self._score0(i)
            if cur != key:
                heapq.heapreplace(h, (cur, i))
                continue
            rl = self._rload[i]
            if not self.engines[i]._pool_can_admit(e.req):
                # pool-blocked top: its true score is larger than the key
                # and _can_take may reject it — only the full scan is
                # exact now (rare: the fleet is page-bound)
                return None
            if (rl.free_slots > rl.queue_depth
                    or rl.queue_depth < self.replica_queue_depth):
                return i
            heapq.heappop(h)   # stale open membership
        return None

    def _viable_replicas(self, e: _Entry) -> List[int]:
        """Replicas from the open set (live, with an unclaimed slot or
        queue room — maintained per block + per placement) that can take
        this entry right now — the seam :class:`DisaggRouter` overrides
        with role filtering (fresh work → prefill workers, mid-stream
        replays → decode workers)."""
        return [i for i in sorted(self._open)
                if self._can_take(i, e.req)]

    def _pick_replica(self, e: _Entry) -> Tuple[Optional[int], int]:
        """Choose a replica for one entry; returns (replica, prefix_hit
        tokens) — (None, 0) when nobody can take it this block. The
        least-loaded decision goes through the O(log fleet) heap fast
        path when it is provably exact (``_fast_pick``); otherwise the
        full viable-set scan runs — identical ordering either way."""
        if self.placement == "round_robin":
            viable = self._viable_replicas(e)
            if not viable:
                return None, 0
            pick = viable[self._rr_next % len(viable)]
            self._rr_next += 1
            return pick, 0
        if self.placement == "affinity":
            hits = {}
            cands = self._affinity_candidates(e.req)
            if cands:
                toks = e.req.prompt.tolist()
                key = (e.req.adapter, e.req.prompt[:self._aff_ps].tobytes())
                # probe only index candidates, but through the VIABLE set
                # (role filtering lives in the subclass override — a
                # decode replay must never probe its old prefill worker)
                for i in self._viable_replicas(e):
                    if i not in cands:
                        continue
                    pkv = self.engines[i].session.paged
                    if pkv is None:
                        continue
                    # affinity probes under the request's adapter
                    # namespace: only a SAME-adapter prefix is a real hit
                    h = pkv.prefix_peek(toks, ns=e.req.adapter)
                    if h > 0:
                        hits[i] = h
                    else:
                        # the prefix went cold there (evicted): decay the
                        # index entry — it re-arms on the next placement
                        cands.discard(i)
                if not cands:
                    self._affinity.pop(key, None)
            best = max(hits.values()) if hits else 0
            if best > 0:
                hot = [i for i, h in hits.items() if h == best]
                return min(hot, key=lambda i: self._load_score(i, e.req)), best
        pick = self._fast_pick(e)
        if pick is not None:
            return pick, 0
        viable = self._viable_replicas(e)
        if not viable:
            return None, 0
        return min(viable, key=lambda i: self._load_score(i, e.req)), 0

    def _place(self) -> None:
        # open set: live replicas with an unclaimed free slot or queue
        # room — the request-independent half of _can_take, refreshed per
        # block and shrunk as placements claim capacity, so a saturated
        # fleet skips the backlog scan entirely
        self._open = {
            i for i in self._live_replicas()
            if (self._rload[i].free_slots > self._rload[i].queue_depth
                or self._rload[i].queue_depth < self.replica_queue_depth)}
        if not self._open:
            return
        # sorted(): heap pops are key-ordered regardless of build order,
        # but the heap ARRAY layout (and any tie-broken peek a future
        # change adds) would inherit set-iteration order — keep the build
        # deterministic
        self._open_heap = [(self._score0(i), i) for i in sorted(self._open)]
        heapq.heapify(self._open_heap)
        for e in self.pending.iter_ready(self.blocks):
            if not self._open:
                break
            i, hit = self._pick_replica(e)
            if i is None:
                continue
            eng = self.engines[i]
            rec = self._records.get(e.req.request_id)
            self._first_place_block.setdefault(i, self.blocks)
            if e.replay:
                eng.resume(e.req, e.generated)
                out: Union[int, Rejected] = e.req.request_id
            else:
                out = eng.submit_request(e.req)
            if isinstance(out, Rejected):
                # the replica bounced it (its own queue bound / pool
                # pressure). Drop the entry here; the harvest pass — which
                # also sees sheds the engine decides mid-run — honors the
                # verdict's retry_after with a capped backoff re-queue
                # (processing it in BOTH places would duplicate the
                # request)
                self.pending.remove(e)
                continue
            self.pending.remove(e)
            self._mirror_place(i, e)
            self._note_affinity(e.req, i)
            self._vtime = max(self._vtime, e.v_start)
            if rec is not None:
                rec.replica = i
            self.stats["placements"] += 1
            self._m_placements.inc()
            self.metrics.counter("router_replica_placements_total",
                                 help="placements per replica",
                                 replica=str(i)).inc()
            if hit:
                self.stats["affinity_placements"] += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "place", ("router", "place"), block=self.blocks,
                    args={"rid": e.req.request_id, "replica": i,
                          "tenant": e.req.tenant, "policy": self.placement,
                          "prefix_hit_tokens": int(hit),
                          "replay": bool(e.replay),
                          "resumed_at": len(e.generated) if e.replay
                          else None})

    def _requeue_or_reject(self, e: _Entry, rej: Rejected) -> None:
        rec = self._records.get(e.req.request_id)
        if rec is not None:
            rec.requeues += 1
            rec.replica = None
            requeues = rec.requeues
        else:
            requeues = self.max_requeues + 1   # no record left: surface it
        if requeues > self.max_requeues:
            if self.keep_completions:
                self.rejected.append(rej)
            self.stats["rejected"] += 1
            self._records.pop(e.req.request_id, None)
            if self.tracer.enabled:
                self.tracer.instant(
                    "reject", ("router", "place"), block=self.blocks,
                    args={"rid": e.req.request_id, "reason": rej.reason,
                          "requeues": requeues})
            return
        e.not_before = self.blocks + max(
            1, min(rej.retry_after_blocks, self.retry_after_cap_blocks))
        if rec is not None:
            rec.replica = None
        self.pending.append(e)
        self.stats["requeues"] += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "requeue", ("router", "place"), block=self.blocks,
                args={"rid": e.req.request_id, "reason": rej.reason,
                      "not_before": e.not_before})

    # --- failure injection / detection / failover -------------------------

    def crash_replica(self, i: int) -> None:
        """Take replica ``i`` dark NOW (ops drill / test seam): its current
        block's emissions are lost and its heartbeat stops; the router
        notices after ``heartbeat_miss_blocks`` and fails its requests
        over."""
        if not (0 <= i < len(self.engines)):
            raise ValueError(f"unknown replica {i}")
        if not self._alive[i] or i in self._dark or i in self._drained:
            raise ValueError(f"replica {i} is not live")
        self._go_dark(i, "manual")

    def _go_dark(self, i: int, why: str) -> None:
        self._dark.add(i)
        self._draining.discard(i)
        self._contrib_off(i)
        self._open.discard(i)
        self.stats["crashes"] += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "fault:replica_crash", ("router", "faults"),
                block=self.blocks,
                args={"replica": i, "why": why,
                      "last_heartbeat_block": self._hb[i]})
        if self.incident is not None:
            placed = sum(1 for rec in self._records.values()
                         if rec.replica == i)
            self.incident.trigger(
                "replica_crash", self.blocks,
                details={"replica": i, "why": why,
                         "placed_requests": placed,
                         "last_heartbeat_block": self._hb[i]},
                state=self.state_summary())

    def _inject_crashes(self) -> None:
        for b, i in self.crash_at:
            if (b == self.blocks and self._alive[i]
                    and i not in self._dark and i not in self._drained):
                self._go_dark(i, "scheduled")
        if self._injector is not None:
            live = self._live_replicas()
            if len(live) >= 2:     # never crash the last live replica
                victim = self._injector.replica_crash(live)
                if victim is not None:
                    self._go_dark(victim, "injected")

    def _detect_failures(self) -> None:
        for i in sorted(self._dark):
            if self.blocks - self._hb[i] > self.heartbeat_miss_blocks:
                self.stats["heartbeat_misses"] += 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "heartbeat_miss", ("router", "faults"),
                        block=self.blocks,
                        args={"replica": i,
                              "last_heartbeat_block": self._hb[i],
                              "missed_blocks": self.blocks - self._hb[i]})
                self._failover(i)

    def _failover(self, i: int) -> None:
        """Fail every request placed on dark replica ``i`` over to the
        survivors: resume records come from the router's per-request
        delivery log (``record_streams``) or, when the router does not keep
        one, the replica's last snapshot — a request in neither replays
        from scratch, which the seed contract makes equally exact (the
        client just re-receives a deterministic prefix)."""
        t0 = time.perf_counter()
        self._dark.discard(i)
        self._alive[i] = False
        # the dead replica's device state goes back to the lm (a block it
        # left in flight writes only into its own pages; nothing fetches it)
        self.engines[i].close()
        snap = self.snapshots.get(i)
        snap_gen: Dict[int, List[int]] = {}
        if snap is not None:
            snap_gen = {int(r["request_id"]): [int(t) for t in r["generated"]]
                        for r in snap.get("requests", ())}
        moved = 0
        store = self._park_store()
        for rid in sorted(self._records, reverse=True):
            rec = self._records[rid]
            if rec.replica != i:
                continue
            gen = (list(rec.delivered) if self.record_streams
                   else snap_gen.get(rid, []))
            rec.replica = None
            rec.delivered = list(gen)
            self.pending.appendleft(self._make_replay_entry(rec, gen))
            moved += 1
            # the replica may have parked this stream the very block it
            # died (before harvest un-pinned the record): the failover
            # replay is now the one true stream — drop the stale durable
            # park so a later resume can never fork it
            if store is not None and store.contains(rid):
                store.remove(rid)
        self.stats["failovers"] += 1
        self.stats["failed_over_requests"] += moved
        self.last_failover_ms = round((time.perf_counter() - t0) * 1e3, 3)
        if self.tracer.enabled:
            self.tracer.complete(
                "failover", ("router", "faults"), t0, time.perf_counter(),
                block=self.blocks,
                args={"replica": i, "requests": moved,
                      "from_snapshot": not self.record_streams
                      and snap is not None})

    def _make_replay_entry(self, rec: _Record, gen: List[int]) -> _Entry:
        """Failover re-entry for one request (original fairness tags —
        a crash must not re-charge the tenant). The DisaggRouter override
        flips zero-token replays back to fresh prefill work."""
        return _Entry(req=rec.req, v_start=rec.v_start,
                      finish_tag=rec.finish_tag, replay=True, generated=gen)

    # --- graceful drain ---------------------------------------------------

    def drain(self, i: int) -> None:
        """Begin a graceful drain of replica ``i`` (rolling restarts):
        placement stops immediately, its queued + mid-prefill + pending-
        replay requests migrate to peers (mid-prefill pages roll back
        atomically — zero tokens lost), live decoding streams finish in
        place; once the last one retires the replica's state is
        snapshotted into ``snapshots[i]`` and it parks."""
        if not (0 <= i < len(self.engines)):
            raise ValueError(f"unknown replica {i}")
        if not self._alive[i] or i in self._dark or i in self._drained:
            raise ValueError(f"replica {i} is not live")
        if i in self._draining:
            return
        self._draining.add(i)
        self._contrib_off(i)
        self._open.discard(i)
        self._drain_t0[i] = time.perf_counter()
        self._migrate_placeable(i)
        if self.tracer.enabled:
            self.tracer.instant(
                "drain_begin", ("router", "drain"), block=self.blocks,
                args={"replica": i})

    def _migrate_placeable(self, i: int) -> None:
        """Pull everything not actively decoding off replica ``i`` and
        re-queue it at the router (front, original fairness tags — a
        migration must not re-charge the tenant)."""
        eng = self.engines[i]
        moved: List[_Entry] = []
        for req in eng.extract_queued():
            moved.append(self._reentry(req, replay=False))
        for req in eng.extract_prefilling():
            moved.append(self._reentry(req, replay=False))
        for req, gen in eng.extract_replays():
            moved.append(self._reentry(req, replay=True, generated=gen))
        for e in sorted(moved, key=lambda e: e.req.request_id, reverse=True):
            self.pending.appendleft(e)
        self.stats["drain_migrated_requests"] += len(moved)
        self._refresh_load(i)

    def _reentry(self, req: Request, replay: bool,
                 generated: Optional[List[int]] = None) -> _Entry:
        rec = self._records.get(req.request_id)
        if rec is not None:
            rec.replica = None
            e = _Entry(req=req, v_start=rec.v_start,
                       finish_tag=rec.finish_tag, replay=replay,
                       generated=list(generated or []))
        else:
            e = _Entry(req=req, replay=replay,
                       generated=list(generated or []))
        return e

    def _finish_drains(self) -> None:
        for i in sorted(self._draining):
            eng = self.engines[i]
            # corruption recovery may have parked replays mid-drain:
            # migrate them too rather than re-prefilling on a dying replica
            if eng._replay_q:
                self._migrate_placeable(i)
            if eng.has_decode_work():
                continue
            self.snapshots[i] = eng.snapshot()
            eng.close()   # parked: its device state goes back to the lm
            self._draining.discard(i)
            self._drained.add(i)
            self.stats["drains"] += 1
            t0 = self._drain_t0.pop(i, time.perf_counter())
            self.last_drain_ms = round((time.perf_counter() - t0) * 1e3, 3)
            if self.tracer.enabled:
                self.tracer.complete(
                    "drain", ("router", "drain"), t0, time.perf_counter(),
                    block=self.blocks, args={"replica": i})

    # --- the block loop ---------------------------------------------------

    def _harvest(self, i: int) -> None:
        """Pull replica ``i``'s freshly-finished completions/rejections and
        refresh the router's per-request delivery records — the records a
        failover replays from, updated every block so at most ONE block of
        deliveries is ever re-sent. Delivery records refresh INCREMENTALLY:
        only streams that emitted THIS block (``eng._emitted``), and only
        the new token suffix — the old full rebuild walked every in-flight
        stream's whole token list per block, an O(streams x tokens) cost
        that scaled with the fleet-wide in-flight count."""
        eng = self.engines[i]
        if len(eng.completed) > self._hc[i]:
            for c in eng.completed[self._hc[i]:]:
                self._records.pop(c.request_id, None)
                self.metrics.counter("router_tenant_tokens_total",
                                     help="tokens delivered per tenant",
                                     tenant=c.tenant).inc(len(c.tokens))
                self._agg["completed"] += 1
                self._agg["tokens"] += len(c.tokens)
                self._agg["ttft_blocks_sum"] += c.ttft_blocks
                self._agg["queue_blocks_sum"] += c.queue_blocks
                if c.expired:
                    self._agg["expired"] += 1
                if c.deadline_missed:
                    self._agg["missed"] += 1
                if c.cancelled:
                    self._agg["cancelled"] += 1
                if not (c.deadline_missed or c.expired or c.cancelled):
                    self._agg["ontime_tokens"] += len(c.tokens)
                if self.keep_completions:
                    self.completed.append(c)
            if self.keep_completions:
                self._hc[i] = len(eng.completed)
            else:
                # streaming mode: the engine-side list is drained every
                # block, so a 1M-request soak holds O(in-flight) memory
                eng.completed.clear()
                self._hc[i] = 0
        if len(eng.rejected) > self._hr[i]:
            for rej in eng.rejected[self._hr[i]:]:
                rec = self._records.get(rej.request_id)
                if rec is None:
                    continue
                e = _Entry(req=rec.req, v_start=rec.v_start,
                           finish_tag=rec.finish_tag)
                self._requeue_or_reject(e, rej)
            if self.keep_completions:
                self._hr[i] = len(eng.rejected)
            else:
                eng.rejected.clear()
                self._hr[i] = 0
        if self.record_streams and eng._emitted:
            for rid in eng._emitted:
                rec = self._records.get(rid)
                if rec is None:
                    continue
                toks = eng._out.get(rid)
                if toks is not None and len(toks) > len(rec.delivered):
                    rec.delivered.extend(toks[len(rec.delivered):])
        # park mirroring: a stream the replica parked this block now lives
        # in the fleet-global store, not on the replica — un-pin the record
        # so a later crash of replica i does NOT failover-replay it (that
        # would fork the stream against its own durable park); delivery
        # records sync to the parked token list for the replay-ladder rung
        for rid, prec in eng._parked.items():
            rec = self._records.get(rid)
            if rec is not None and rec.replica == i:
                rec.replica = None
                gen = prec["state"].get("generated", [])
                if len(gen) > len(rec.delivered):
                    rec.delivered = [int(t) for t in gen]

    def _pump_handoffs(self) -> None:
        """Prefill→decode handoff choreography — a no-op here; the
        :class:`DisaggRouter` (inference/disagg.py) overrides it."""

    def _observe_block(self) -> None:
        depth = self.pending.ready_count(self.blocks)
        self._m_pending.set(depth)
        live = len(self._live_replicas())
        self._m_replicas.set(live)
        if self.tracer.enabled:
            self.tracer.counter("router_pending", ("router", "clock"),
                                depth, block=self.blocks)
            self.tracer.counter("replicas_active", ("router", "scale"),
                                live, block=self.blocks)

    def step_block(self) -> bool:
        """One router round on the shared clock: inject/detect crashes,
        finish drains, place the arrived backlog, advance every live
        replica one engine block (their clocks are pinned to the router's),
        harvest deliveries. Returns False when nothing is left anywhere."""
        self._inject_crashes()
        self._detect_failures()
        self._finish_drains()
        if self.autoscaler is not None:
            # the policy runs AFTER drain completion (parked snapshots are
            # warm-spawn images) and BEFORE placement (spawned capacity
            # takes this very block's arrivals) — all on the block clock
            self.autoscaler.observe_block(self)
        self._place()
        progressed = False
        rec_wall = self.record_block_wall
        for i, eng in enumerate(self.engines):
            if (not self._alive[i] or i in self._dark
                    or i in self._drained):
                if rec_wall:
                    self._eng_block_wall[i].append(0.0)
                continue
            # provisioned-capacity ledger: every stepped replica (draining
            # ones included — they still hold hardware) is one replica-
            # block, the denominator of goodput-per-provisioned-capacity
            self.stats["replica_blocks"] += 1
            eng.blocks = self.blocks
            t0 = time.perf_counter()
            if eng.step_block():
                progressed = True
            if rec_wall:
                self._eng_block_wall[i].append(time.perf_counter() - t0)
            self._hb[i] = self.blocks
            self._harvest(i)
            # the once-per-block load read every placement/autoscale/shed
            # decision shares until the next step
            self._refresh_load(i)
        self._pump_handoffs()
        if (self.snapshot_every_blocks
                and (self.blocks + 1) % self.snapshot_every_blocks == 0):
            for i in self._live_replicas():
                self.snapshots[i] = self.engines[i].snapshot()
                self.stats["snapshots_taken"] += 1
        self._observe_block()
        self.blocks += 1
        work_left = (progressed or bool(self.pending) or bool(self._dark)
                     or bool(self._draining))
        if (self.pending and not self._live_replicas()
                and not self._dark and not self._draining):
            raise NoLiveReplicas(
                f"{len(self.pending)} requests pending with every replica "
                f"dead or drained")
        return work_left

    def close(self) -> None:
        """End every replica's session (the fleet's device state goes back
        to the ``CausalLM``); the router's records stay readable."""
        for eng in self.engines:
            eng.close()

    def run(self, max_blocks: Optional[int] = None) -> List[Completion]:
        """Drive blocks until the fleet drains (or ``max_blocks`` elapse);
        returns completions in finish order."""
        n = 0
        while self.step_block():
            n += 1
            if max_blocks is not None and n >= max_blocks:
                break
        return self.completed

    # --- introspection ----------------------------------------------------

    def state_summary(self) -> dict:
        """The incident bundle's router section: fleet topology + per-
        replica cards + the router's own queue/fairness state."""
        return {
            "router": True,
            "blocks": int(self.blocks),
            "pending": len(self.pending),
            "placed": sum(1 for rec in self._records.values()
                          if rec.replica is not None),
            "tenants": {name: {"weight": t.weight,
                               "submitted": t.submitted}
                        for name, t in sorted(self._tenants.items())},
            "stats": dict(self.stats),
            "replicas": self.replica_states(),
        }

    def attribution_report(self) -> dict:
        """Fleet-wide critical-path report off the SHARED tracer (per-
        replica + per-tenant phase mixes included). See
        ``observability/attribution.py``."""
        return _attribution.attribution_report(self.tracer)

    def request_attribution(self, request_id: int) -> Optional[dict]:
        return _attribution.request_attribution(self.tracer, request_id)

    def explain_deadline_miss(self, request_id: int) -> dict:
        """Name the phase that burned a missed deadline's budget, router
        waits (requeue backoff, placement) included."""
        return _attribution.explain_deadline_miss(self.tracer, request_id)

    def replica_states(self) -> List[dict]:
        """Per-replica cards: router-level membership state + heartbeat
        layered over the engine's typed :class:`ReplicaLoad` summary (one
        struct shared with placement `_load_score`, the autoscaler policy
        and the incident state card)."""
        out = []
        for i, eng in enumerate(self.engines):
            state = ("dark" if i in self._dark
                     else "drained" if i in self._drained
                     else "draining" if i in self._draining
                     else "live" if self._alive[i] else "dead")
            out.append({
                "replica": i, "state": state,
                "last_heartbeat_block": self._hb[i],
                # the shared load struct flattens in whole: role, queue /
                # backlog depths, est TTFT, free/tier pages, resident
                # adapters, burn status — everything the policy layers see
                **eng.load_summary().to_dict(),
            })
        return out


def run_router_trace(router: Router, trace,
                     max_blocks: Optional[int] = None) -> dict:
    """Submit a synthetic trace to the Router and drive the fleet to
    completion; returns the serving report in ``run_trace``'s shape plus
    the router surface (per-replica states, placements, failovers, drains)
    and the per-tenant isolation table. Turns tracing on (the wall
    ITL surface reads the shared tracer's token events) exactly like
    ``run_trace``.

    ``trace`` is a list (submitted up-front, the historic shape) or ANY
    iterator — e.g. the raw :func:`synthetic_trace_stream` generator: the
    streamed form pulls one item at a time and submits it only once the
    shared clock reaches its arrival block, so the request list is never
    materialized and the run keeps the clock
    alive through arrival gaps — the idle valleys autoscaling scales down
    into. Token streams are identical either way (the per-request seed
    contract); WFQ tags and wall accounting differ slightly in basis
    (streamed submission happens inside the timed loop).

    STREAMING REPORT (``Router(keep_completions=False)``): tracing is NOT
    force-enabled, no per-request lists are materialized anywhere — the
    report reads the harvest aggregates and the per-replica log-bucket
    latency histograms merged explicitly (percentiles are bucket upper
    edges). The memory-bounded mode the 1M-request soak runs
    (a long soak)."""
    streaming = not getattr(router, "keep_completions", True)
    if not streaming and not router.tracer.enabled:
        router.tracer.enabled = True
    # O(1)-per-request bookkeeping (tenant label + deadline flag) — the
    # report's denominator; deliberately NOT the items themselves
    meta: List[Tuple[str, bool]] = []
    counts = {"submitted": 0, "deadlines": False}

    def _submit(item):
        router.submit(item["prompt"], item["max_new_tokens"],
                      eos_token_id=item.get("eos_token_id"),
                      arrival_block=item.get("arrival_block", 0),
                      ttft_deadline_ms=item.get("ttft_deadline_ms"),
                      deadline_ms=item.get("deadline_ms"),
                      tenant=item.get("tenant", "default"),
                      adapter=item.get("adapter"),
                      grammar=item.get("grammar"))
        counts["submitted"] += 1
        counts["deadlines"] = counts["deadlines"] or bool(
            item.get("deadline_ms") or item.get("ttft_deadline_ms"))
        if not streaming:
            meta.append((item.get("tenant", "default"),
                         bool(item.get("deadline_ms")
                              or item.get("ttft_deadline_ms"))))

    if isinstance(trace, (list, tuple)):
        for item in trace:
            _submit(item)
        t0 = time.perf_counter()
        completions = router.run(max_blocks=max_blocks)
        wall_s = time.perf_counter() - t0
    else:
        it = iter(trace)
        nxt = next(it, None)
        t0 = time.perf_counter()
        n = 0
        while True:
            while (nxt is not None
                   and int(nxt.get("arrival_block", 0)) <= router.blocks):
                _submit(nxt)
                nxt = next(it, None)
            more = router.step_block()
            n += 1
            if max_blocks is not None and n >= max_blocks:
                break
            if not more and nxt is None:
                break
        completions = router.completed
        wall_s = time.perf_counter() - t0
    if streaming:
        return _streaming_router_report(router, wall_s,
                                        counts["submitted"],
                                        counts["deadlines"])
    total_tokens = int(sum(len(c.tokens) for c in completions))
    tok_ts = {
        rid: np.asarray([ev["ts"] for ev in evs if ev["name"] == "tok"],
                        np.float64)
        for rid, evs in router.tracer.by_request().items()}
    gaps_ms: List[float] = []
    for c in completions:
        ts = tok_ts.get(c.request_id, np.zeros((0,)))
        g = np.diff(ts) * 1e3 if ts.size > 1 else np.zeros((0,))
        gaps_ms.extend(g[g > 0.0].tolist())
    submitted = len(meta)
    rejected = len(router.rejected)
    expired = sum(1 for c in completions if c.expired)
    missed = sum(1 for c in completions if c.deadline_missed)
    has_deadlines = any(flag for _t, flag in meta)
    ontime_tokens = sum(
        len(c.tokens) for c in completions
        if not (c.deadline_missed or c.expired or c.cancelled))
    report = {
        "replicas": len(router.engines),
        "placement": router.placement,
        "requests_completed": len(completions),
        "total_generated_tokens": total_tokens,
        "wall_s": round(wall_s, 4),
        "tokens_per_sec": (round(total_tokens / wall_s, 1)
                           if wall_s > 0 else None),
        "goodput_tokens_per_sec": (round(ontime_tokens / wall_s, 1)
                                   if wall_s > 0 else None),
        "blocks": router.blocks,
        "rejected": rejected,
        "expired": expired,
        "deadline_miss_rate": (round((rejected + missed) / submitted, 4)
                               if has_deadlines and submitted else None),
        "itl_p50_ms": round(float(np.percentile(gaps_ms, 50)), 3)
        if gaps_ms else None,
        "itl_p99_ms": round(float(np.percentile(gaps_ms, 99)), 3)
        if gaps_ms else None,
        "ttft_blocks_mean": round(float(np.mean(
            [c.ttft_blocks for c in completions])), 2)
        if completions else None,
        # pipeline surface aggregated over every replica lane that ever
        # dispatched (parked replicas contribute no spans)
        "async_loop": any(getattr(e, "async_loop", False)
                          for e in router.engines if e is not None),
        **interblock_gap_report(
            router.tracer,
            [e.lane for e in router.engines if e is not None]),
        # provisioned capacity actually consumed (replica-blocks): the
        # denominator of the autoscale-vs-fixed goodput-per-capacity key
        "replica_blocks": router.stats["replica_blocks"],
        "placements": router.stats["placements"],
        "affinity_placements": router.stats["affinity_placements"],
        "requeues": router.stats["requeues"],
        "crashes": router.stats["crashes"],
        "failovers": router.stats["failovers"],
        "failed_over_requests": router.stats["failed_over_requests"],
        "drains": router.stats["drains"],
        "last_failover_ms": router.last_failover_ms,
        "last_drain_ms": router.last_drain_ms,
        "replica_states": router.replica_states(),
        "trace_events": len(router.tracer.events()),
        "trace_events_dropped": router.tracer.dropped,
    }
    tiered = [eng.session.paged for eng in router.engines
              if eng.paged and eng.session.paged is not None
              and eng.session.paged.tier is not None]
    if tiered:
        # fleet-aggregate host-tier surface (per-replica residency is in
        # replica_states): spills/restores/repairs summed across replicas
        report.update({
            "tier_pages_resident": sum(p.tier_pages() for p in tiered),
            "tier_spilled_pages": sum(p.tier_spilled_pages for p in tiered),
            "tier_restored_pages": sum(p.tier_restored_pages for p in tiered),
            "tier_restore_failures": sum(p.tier_restore_failures for p in tiered),
            "tier_repaired_pages": sum(p.tier_repaired_pages for p in tiered),
        })
    lora_engines = [eng for eng in router.engines
                    if getattr(eng, "lora", False)]
    if lora_engines:
        # fleet-aggregate multi-LoRA surface (per-replica residency is in
        # replica_states): loads/evictions/repairs summed across replicas
        report.update({
            "multilora": True,
            "adapter_loads": sum(
                eng.session.adapters.loads for eng in lora_engines),
            "adapter_evictions": sum(
                eng.session.adapters.evictions for eng in lora_engines),
            "adapter_repairs": sum(
                eng.session.adapters.repairs for eng in lora_engines),
            "adapter_rejects": sum(
                int(eng.adapter_rejects) for eng in lora_engines),
        })
    tenants = {t for t, _flag in meta}
    if tenants != {"default"}:
        report["per_tenant"] = per_tenant_report(
            completions, tok_ts, wall_s,
            [router._tenant_of.get(r.request_id, "default")
             for r in router.rejected])
    if router._injector is not None:
        report["fault_stats"] = dict(router._injector.stats)
    if router.autoscaler is not None:
        # elastic-fleet surface: the deterministic scale-event log plus
        # warm/cold spawn counts and scale-up time-to-ready blocks
        report["autoscale"] = router.autoscaler.report(router)
    return report


def _streaming_router_report(router: Router, wall_s: float,
                             submitted: int, has_deadlines: bool) -> dict:
    """Memory-bounded fleet report (``keep_completions=False``): built from
    the harvest aggregates and the per-replica latency histograms merged
    bucket-wise — no per-request lists, no tracer."""
    agg = router._agg
    completed = agg["completed"]
    total_tokens = agg["tokens"]
    itls = [eng._m_itl for eng in router.engines]
    ttfts = [eng._m_ttft for eng in router.engines]
    itl = itls[0].merged(*itls[1:]) if itls else None
    ttft = ttfts[0].merged(*ttfts[1:]) if ttfts else None
    rejected = int(router.stats["rejected"])
    report = {
        "streaming": True,
        "percentile_basis": "log-bucket histogram upper edges",
        "replicas": len(router.engines),
        "placement": router.placement,
        "requests_submitted": submitted,
        "requests_completed": completed,
        "total_generated_tokens": total_tokens,
        "wall_s": round(wall_s, 4),
        "tokens_per_sec": (round(total_tokens / wall_s, 1)
                           if wall_s > 0 else None),
        "goodput_tokens_per_sec": (
            round(agg["ontime_tokens"] / wall_s, 1) if wall_s > 0 else None),
        # total host wall over completed
        # requests — with a sim lm there is no device time to hide behind,
        # so this IS the scheduler+bookkeeping cost per request
        "sched_overhead_us_per_request": (
            round(wall_s * 1e6 / completed, 2) if completed else None),
        "blocks": router.blocks,
        "rejected": rejected,
        "expired": agg["expired"],
        "cancelled": agg["cancelled"],
        "deadline_miss_rate": (
            round((rejected + agg["missed"]) / submitted, 4)
            if has_deadlines and submitted else None),
        "itl_p50_ms": (round(itl.percentile(50), 3)
                       if itl is not None and itl.count else None),
        "itl_p99_ms": (round(itl.percentile(99), 3)
                       if itl is not None and itl.count else None),
        "ttft_ms_p99": (round(ttft.percentile(99), 3)
                        if ttft is not None and ttft.count else None),
        "ttft_blocks_mean": (round(agg["ttft_blocks_sum"] / completed, 2)
                             if completed else None),
        "queue_blocks_mean": (round(agg["queue_blocks_sum"] / completed, 2)
                              if completed else None),
        "replica_blocks": router.stats["replica_blocks"],
        "placements": router.stats["placements"],
        "affinity_placements": router.stats["affinity_placements"],
        "requeues": router.stats["requeues"],
        "crashes": router.stats["crashes"],
        "failovers": router.stats["failovers"],
        "drains": router.stats["drains"],
        "replicas_active": len(router._live_replicas()),
    }
    if router.autoscaler is not None:
        report["autoscale"] = router.autoscaler.report(router)
    return report
