"""Prefill/decode disaggregation: dedicated prefill workers hand finished
KV pages to the decode pool (DistServe, Zhong et al. 2024; Splitwise,
Patel et al. 2024).

The port's counterpart of ``neuronx_distributed_tpu/inference/disagg.py``.
Chunked prefill bounds the interference of long prompts with decoding but
cannot remove it: every round still splits the block between chunk
dispatches and the decode block. A :class:`DisaggRouter` stops sharing the
worker: prefill workers (``ServeEngine(role="prefill")``) run only inserts
and chunk extends, decode workers (``role="decode"``) only the fused decode
block plus page adoption, so a long prompt never enters a decode worker's
block. All workers are sessions of one ``CausalLM``.

One request's migration:

1. the router places it on a prefill worker (chunked prefill is kept
   within the worker);
2. the worker finishes the prompt's KV and draws its FIRST token — token t
   of request r draws the noise of ``request_seed(seed, r)`` at counter t
   wherever it runs, so token 0 drawn here is token 0 anywhere;
3. the worker reads the prompt's pages (one batched device-to-host copy a
   leaf) into a :class:`KVHandoff` sealed with one crc32 a page (the host
   tier's framing, under the reference's cache-leaf paths) and frees the
   slot; its prefix index keeps the prompt hot;
4. the router delivers the handoff to a decode worker
   (:meth:`ServeEngine.adopt_handoff`): pages allocated (reclaim first),
   checksums verified, bytes written, the path registered in its prefix
   index, and the stream enters decoding at token index 1, between blocks;
5. a failed or corrupted handoff (the ``migrate`` fault seam) degrades to a
   re-prefill on the decode side (``resume(req, [first_token])``): a
   latency event, never a wrong token.

The handoff moves bytes through the host, as the reference does; no kernel
is involved. A disaggregated fleet's streams are the streams one
``ServeEngine`` serves for the same submissions, fused or stepwise, greedy
or sampled, with or without handoff faults.

This harness steps every worker in one Python thread, so the wall gaps
between a stream's tokens include the co-scheduled prefill workers' time.
:func:`decode_clock_itl` also reports each decode worker's own clock (its
per-block wall seconds, adoptions included), the timeline a decode worker
on a host of its own would deliver.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from neuronx_distributed_tpu_torch.inference.engine import Request, ServeEngine
from neuronx_distributed_tpu_torch.inference.paged_cache import HostPageTier
from neuronx_distributed_tpu_torch.inference.router import (
    NoLiveReplicas,
    Router,
    _Entry,
    run_router_trace,
)


@dataclasses.dataclass
class KVHandoff:
    """One migrated stream in flight between a prefill worker and the
    decode pool: the request, its first (already-sampled) token, and the
    prompt-covering KV pages as host byte payloads — one
    ``{cache-leaf path: (L, page_size, kv, hd) array}`` dict per page, the
    ``HostPageTier`` framing — sealed with per-page crc32 checksums so a
    corrupted transfer is CAUGHT on adopt rather than decoded into wrong
    tokens."""

    req: Request
    first_token: int
    first_ts: float                  # wall stamp of the first token's fetch
    page_size: int
    payloads: List[Dict[str, np.ndarray]]
    crcs: List[int] = dataclasses.field(default_factory=list)
    src_replica: Optional[int] = None
    # TP degree of the SEALING worker. The payloads are gathered at seal
    # (full KV width: every rank's heads), so the bytes do not depend on
    # it; an adopter on another degree degrades to a re-prefill rather
    # than trust framing it cannot check.
    tp_degree: int = 1
    # storage dtype of the SEALING worker's page pool ("float32"/
    # "bfloat16"/"int8"; int8 payloads carry the quantized pages PLUS
    # their fp32 scale leaves). Same contract as ``tp_degree``: an
    # adopter whose pool dtype differs cannot write these bytes — it
    # degrades to a local re-prefill rather than rescale/re-quantize KV
    # mid-stream (a silent numerics fork the exactness oracle forbids).
    page_dtype: str = "float32"
    # wall ms of the prefill side's page read and seal
    seal_ms: float = 0.0

    def seal(self) -> "KVHandoff":
        self.crcs = [HostPageTier._crc(p) for p in self.payloads]
        return self

    def verify(self) -> bool:
        """Re-checksum every page payload against the seal. False = the
        bytes changed in flight (the ``migrate`` seam's corruption, or any
        real transport fault) — the handoff is poison and must degrade."""
        return (len(self.crcs) == len(self.payloads)
                and all(HostPageTier._crc(p) == c
                        for p, c in zip(self.payloads, self.crcs)))

    def corrupt(self) -> None:
        """Physically garble one byte of the first payload (the fault
        seam's 'corrupt' verdict) — the flip is REAL, so :meth:`verify`
        failing proves the checksum caught actual damage."""
        first = self.payloads[0]
        key = next(iter(sorted(first)))
        arr = first[key].copy()
        arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
        first[key] = arr

    @property
    def pages(self) -> int:
        return len(self.payloads)

    def nbytes(self) -> int:
        return sum(v.nbytes for p in self.payloads for v in p.values())


class DisaggRouter(Router):
    """Role-split front door: ``prefill_replicas`` of the ``num_replicas``
    fleet run only insert/extend programs, the rest run only the fused
    decode scan plus page adoption. Placement routes fresh work to prefill
    workers (prefix affinity intact — a prefill worker's radix is where
    prompt prefixes live now) and mid-stream replays to decode workers;
    finished prefills migrate as :class:`KVHandoff` buffers pumped once per
    router block. Everything else — per-tenant WFQ, heartbeat failover,
    graceful drain, snapshots — is inherited from :class:`Router` and
    works per role: draining a prefill worker migrates its queued and
    mid-chunk work to the other prefill workers (atomic page rollback,
    zero token loss); a crashed prefill worker's un-adopted requests replay
    as fresh prefill work, a crashed decode worker's streams replay onto
    the surviving decode workers from the router's delivery records."""

    def __init__(self, lm, num_replicas: int = 2, *,
                 prefill_replicas: int = 1, **kw):
        if not getattr(lm, "paged", False):
            raise ValueError(
                "DisaggRouter requires a paged CausalLM — the handoff "
                "moves KV as physical pages")
        if not 1 <= prefill_replicas < num_replicas:
            raise ValueError(
                f"prefill_replicas must be in [1, num_replicas), got "
                f"{prefill_replicas} of {num_replicas} (a disaggregated "
                f"fleet needs at least one worker of each role)")
        if "role" in kw:
            raise ValueError("role is assigned per replica by the router")
        # per-index role table (a LIST, not a count: the autoscaler grows
        # each pool independently, so roles are no longer index-contiguous
        # — prefill_replicas becomes the derived count property below)
        self.roles: List[str] = [
            "prefill" if i < int(prefill_replicas) else "decode"
            for i in range(num_replicas)]
        self._handoffs: deque = deque()
        self._decode_home: Dict[int, int] = {}
        super().__init__(lm, num_replicas, **kw)
        self.stats.update({
            "handoffs_sent": 0, "handoffs_adopted": 0,
            "handoffs_degraded": 0, "handoffs_deferred": 0,
            "handoff_pages": 0, "handoff_bytes": 0,
        })
        # per handoff, the prefill side's read-and-seal ms (the decode
        # side's adoption is each engine's serve_handoff_adopt_ms)
        self.handoff_seal_ms: List[float] = []

    # --- roles ------------------------------------------------------------

    @property
    def prefill_replicas(self) -> int:
        return sum(1 for r in self.roles if r == "prefill")

    def role_of(self, i: int) -> str:
        return self.roles[i]

    def fleet_roles(self) -> List[str]:
        # both pools are always scale targets, even while one has no live
        # member (the min_replicas floor re-spawns it)
        return ["decode", "prefill"]

    def _note_new_replica(self, i: int, role: str) -> None:
        assert i == len(self.roles)
        self.roles.append(role)

    def add_replica(self, role: str = "decode", warm: bool = True) -> int:
        if role not in ("prefill", "decode"):
            raise ValueError(
                f"a disaggregated replica is 'prefill' or 'decode', "
                f"got {role!r}")
        return super().add_replica(role=role, warm=warm)

    def _build_engines(self, lm, num_replicas: int,
                       engine_kw: dict) -> List[ServeEngine]:
        return [
            ServeEngine(lm, seed=self.seed, name=f"replica{i}",
                        tracer=self.tracer, faults=self._injector,
                        role=self.role_of(i), **engine_kw)
            for i in range(num_replicas)
        ]

    def _live_prefill(self) -> List[int]:
        return [i for i in self._live_replicas()
                if self.role_of(i) == "prefill"]

    def _live_decode(self) -> List[int]:
        return [i for i in self._live_replicas()
                if self.role_of(i) == "decode"]

    # --- placement --------------------------------------------------------

    def submit(self, prompt, max_new_tokens, **kw):
        if kw.get("adapter") is not None:
            raise ValueError(
                "multi-LoRA disaggregation is not supported yet — the "
                "adopted KV is adapter-specific and the pin would have to "
                "migrate with the pages")
        # grammars DO disaggregate: the token DFA rides the SAMPLER, not
        # the KV — the prefill side constrains the first token and
        # releases its pin at handoff; the adopting decode worker re-pins
        # the (fleet-registered) grammar and walks the delivered token to
        # restore the DFA state (ServeEngine.adopt_handoff)
        return super().submit(prompt, max_new_tokens, **kw)

    def _viable_replicas(self, e: _Entry) -> List[int]:
        """Role-aware viability: a mid-stream replay (failover / degraded
        handoff with delivered tokens) must land where decoding happens;
        everything else — fresh admissions AND replays that never produced
        a token — is prefill work."""
        want = "decode" if (e.replay and e.generated) else "prefill"
        return [i for i in sorted(self._open)
                if self.role_of(i) == want and self._can_take(i, e.req)]

    def _place(self) -> None:
        super()._place()
        # refresh the per-request decode home (the decode-clock report's
        # stream→worker map): replays placed onto decode workers move it
        for rid, rec in self._records.items():
            if (rec.replica is not None
                    and self.role_of(rec.replica) == "decode"):
                self._decode_home[rid] = rec.replica

    # --- failure ----------------------------------------------------------

    def _make_replay_entry(self, rec, gen):
        """Role-aware failover re-entry: a handoff already pumped to the
        router is SAFE (the bytes live in host memory, source-independent)
        and keeps flowing; a request that died on the replica itself with
        ZERO delivered tokens is plain prefill work again — the entry is
        built as a fresh placement (a prefill worker cannot resume a
        decode stream)."""
        e = super()._make_replay_entry(rec, gen)
        if not gen:
            e.replay = False
        return e

    # --- the handoff pump -------------------------------------------------

    def _degrade(self, h: KVHandoff, why: str) -> None:
        """Failed/corrupted handoff: the decode side re-prefills the
        stream locally from (prompt, first token) — bit-identical by the
        per-request seed contract. The least-loaded live decode worker
        takes it through the replay machinery."""
        live = self._live_decode()
        j = min(live, key=lambda j: self._load_score(j, h.req))
        self.engines[j].resume(h.req, [h.first_token])
        self._refresh_load(j)
        self._note_affinity(h.req, j)
        rec = self._records.get(h.req.request_id)
        if rec is not None:
            rec.replica = j
            rec.delivered = [h.first_token]
        self._decode_home[h.req.request_id] = j
        self.stats["handoffs_degraded"] += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "migrate_degrade", ("req", h.req.request_id),
                block=self.blocks,
                args={"why": why, "replica": j,
                      "src": h.src_replica})
            self.tracer.instant(
                "fault:migrate", ("router", "migrate"), block=self.blocks,
                args={"rid": h.req.request_id, "why": why, "replica": j})

    def _pump_handoffs(self) -> None:
        """Once per router block: collect every live prefill worker's
        outbox, then deliver queued handoffs to decode workers. A dark
        worker's outbox is LOST with its block (the crash semantics) — its
        requests replay through the normal failover path. Un-deliverable
        handoffs (decode pool full) stay queued; the migrate fault seam
        draws one verdict per delivery attempt."""
        for i, role in enumerate(self.roles):
            if role != "prefill":
                continue
            eng = self.engines[i]
            if not eng.outbox:
                continue
            if not self._alive[i] or i in self._dark:
                eng.outbox.clear()   # crashed mid-block: emissions lost
                continue
            for h in eng.outbox:
                h.src_replica = i
                self.stats["handoff_bytes"] += h.nbytes()
                self.handoff_seal_ms.append(h.seal_ms)
                rec = self._records.get(h.req.request_id)
                if rec is not None:
                    rec.replica = None     # in transit: safe at the router
                self._handoffs.append(h)
                self.stats["handoffs_sent"] += 1
                self.stats["handoff_pages"] += h.pages
            eng.outbox.clear()
        still: deque = deque()
        while self._handoffs:
            h = self._handoffs.popleft()
            rec = self._records.get(h.req.request_id)
            if rec is None:
                continue               # cancelled/shed while in flight
            live = self._live_decode()
            if not live:
                still.append(h)
                continue
            verdict = (self._injector.on_migrate()
                       if self._injector is not None else None)
            if verdict == "fail":
                self._degrade(h, "injected_failure")
                continue
            if verdict == "corrupt":
                h.corrupt()            # the adopt-side checksum must catch
            placed = False
            for j in sorted(live,
                            key=lambda j: self._load_score(j, h.req)):
                t0 = time.perf_counter()
                out = self.engines[j].adopt_handoff(h)
                dt = time.perf_counter() - t0
                if self._eng_block_wall[j]:
                    # adoption is decode-side host work: charge it to the
                    # adopting worker's block on the per-worker clock
                    self._eng_block_wall[j][-1] += dt
                if out == "adopted":
                    rec.replica = j
                    rec.delivered = [h.first_token]
                    self._decode_home[h.req.request_id] = j
                    self.stats["handoffs_adopted"] += 1
                    self._refresh_load(j)
                    self._note_affinity(h.req, j)
                    placed = True
                    break
                if out == "degraded":
                    self._degrade(h, "checksum")
                    placed = True
                    break
            if not placed:
                self.stats["handoffs_deferred"] += 1
                still.append(h)
        self._handoffs = still

    def step_block(self) -> bool:
        more = super().step_block()
        if not more:
            # a handoff adopted THIS block entered the decode pool after
            # the engines already stepped (the pump runs post-harvest), so
            # the base work_left never saw it — keep the clock running
            # while any live worker still holds a stream
            more = any(self.engines[i].has_decode_work()
                       for i in self._live_replicas())
        if self._handoffs:
            if (not self._live_decode() and not self._dark
                    and not self._draining):
                raise NoLiveReplicas(
                    f"{len(self._handoffs)} handoffs pending with every "
                    f"decode worker dead or drained")
            return True
        if (self.pending and not self._dark and not self._draining):
            fresh = self.pending.fresh_count()
            if fresh and not self._live_prefill():
                raise NoLiveReplicas(
                    f"{fresh} requests pending with every prefill "
                    f"worker dead or drained")
            if (self.pending.decode_replay_count()
                    and not self._live_decode()):
                raise NoLiveReplicas(
                    "mid-stream replays pending with every decode worker "
                    "dead or drained")
        return more

    # --- introspection ----------------------------------------------------

    def state_summary(self) -> dict:
        out = super().state_summary()
        out["disagg"] = {
            "prefill_replicas": self.prefill_replicas,
            "handoffs_in_flight": len(self._handoffs),
        }
        return out


def decode_clock_itl(router: DisaggRouter,
                     long_prompt_cutoff: Optional[int] = None) -> dict:
    """Decode-side latency surface on the per-worker clock: each stream's
    token i is stamped with its home decode worker's CUMULATIVE wall
    seconds through the block that delivered it (that worker's dispatches,
    fetches, and adoption writes only — not the co-scheduled prefill
    workers this single-threaded harness interleaves). Returns delivery-gap
    percentiles plus the long-prompt interference verdict:
    ``decode_stall_excess_ms`` — the worst gap a SHORT request saw beyond
    the run's median gap (``long_prompt_cutoff`` defaults to the longest
    prompt in the run, so "short" = everything shorter than the tail). On
    a fleet where prompts never touch decode workers this is ≈ 0 — the
    number chunked prefill could only bound, eliminated."""
    tok_blocks: Dict[int, List[int]] = {}
    for rid, evs in router.tracer.by_request().items():
        tok_blocks[rid] = [ev["block"] for ev in evs
                           if ev["name"] == "tok" and ev["block"] is not None]
    cum = {j: np.cumsum(np.asarray(w, np.float64))
           for j, w in enumerate(router._eng_block_wall)}
    gaps_ms: List[float] = []
    handoff_gaps_ms: List[float] = []
    short_max: List[float] = []
    all_max: List[float] = []
    plens = {c.request_id: c.prompt_len for c in router.completed}
    if long_prompt_cutoff is None:
        long_prompt_cutoff = max(plens.values(), default=0)
    for c in router.completed:
        j = router._decode_home.get(c.request_id)
        blocks = tok_blocks.get(c.request_id)
        if j is None or not blocks or cum[j].size == 0:
            continue
        ts = np.asarray([cum[j][min(b, cum[j].size - 1)] for b in blocks])
        g_all = np.diff(ts) * 1e3
        if g_all.size:
            # the token0→token1 gap is MIGRATION latency, not decode ITL:
            # token 0 lands early on the prefill side and the stream then
            # waits for adoption + a decode slot — that wait is reported
            # separately (and attributed to the 'migration' phase); the
            # steady-state decode surface starts at token 1
            handoff_gaps_ms.append(float(g_all[0]))
            g = g_all[1:]
        else:
            g = g_all
        g = g[g > 0.0]
        gaps_ms.extend(g.tolist())
        if g.size:
            all_max.append(float(g.max()))
            if c.prompt_len < long_prompt_cutoff:
                short_max.append(float(g.max()))
    p50 = round(float(np.percentile(gaps_ms, 50)), 3) if gaps_ms else None
    p99 = round(float(np.percentile(gaps_ms, 99)), 3) if gaps_ms else None
    if not short_max:
        short_max = all_max      # uniform-length trace: no tail to exclude
    excess = None
    if short_max and p50 is not None:
        excess = round(max(0.0, max(short_max) - p50), 3)
    return {
        "itl_p50_ms_decode_clock": p50,
        "itl_p99_ms_decode_clock": p99,
        "decode_stall_excess_ms": excess,
        "handoff_gap_ms_p99": (
            round(float(np.percentile(handoff_gaps_ms, 99)), 3)
            if handoff_gaps_ms else None),
    }


def run_disagg_trace(router: DisaggRouter, trace: List[dict],
                     max_blocks: Optional[int] = None) -> dict:
    """Drive a synthetic trace through the disaggregated fleet; returns
    ``run_router_trace``'s report plus the disaggregation surface: roles,
    the handoff lifecycle counters, and the decode-clock latency numbers
    (see :func:`decode_clock_itl` for the clock's basis — the in-process
    wall ``itl_*`` keys remain in the report for the caveat trail)."""
    report = run_router_trace(router, trace, max_blocks=max_blocks)
    long_lens = [len(item["prompt"]) for item in trace]
    cutoff = max(long_lens) if long_lens else None
    report.update({
        "disagg": True,
        "prefill_replicas": router.prefill_replicas,
        "decode_replicas": len(router.engines) - router.prefill_replicas,
        "handoffs_sent": router.stats["handoffs_sent"],
        "handoffs_adopted": router.stats["handoffs_adopted"],
        "handoffs_degraded": router.stats["handoffs_degraded"],
        "handoffs_deferred": router.stats["handoffs_deferred"],
        "handoff_pages": router.stats["handoff_pages"],
        "adopted_pages": sum(
            eng.session.paged.adopted_pages
            for eng in router.engines if eng.session.paged is not None),
        "handoff_bytes": router.stats["handoff_bytes"],
        "handoff_seal_ms": list(router.handoff_seal_ms),
    })
    report.update(decode_clock_itl(router, long_prompt_cutoff=cutoff))
    return report
