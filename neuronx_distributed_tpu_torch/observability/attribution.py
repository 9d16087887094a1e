"""Per-request critical-path attribution computed from tracer events alone:
the port's own copy of ``neuronx_distributed_tpu/observability/
attribution.py`` (numpy only), phase for phase and key for key.

The tracer records the raw event stream (every lifecycle fact lands on a
per-request lane at block boundaries), so a deadline miss can be *read* off
the timeline — by a human, one request at a time. This module automates
that read. It is
the Dapper -> "Tail at Scale" step: recording events tells you WHAT
happened; attributing the end-to-end span to named phases tells you WHICH
stage burned the budget, which is the question an operator actually asks.

The decomposition runs on the VIRTUAL BLOCK CLOCK (the scheduler's
deterministic time base — wall stamps ride along as a secondary surface).
Each request's span from its effective arrival to its terminal event
(retire / expire / cancel / shed) is partitioned into contiguous,
non-overlapping phase segments:

* ``queued``          — arrived, waiting for a slot (router + engine queue);
* ``requeue_backoff`` — bounced by a replica (queue bound / pool pressure),
  waiting out the verdict's ``retry_after_blocks`` at the router;
* ``pool_wait``       — admission deferred or unwound by page-pool
  exhaustion (``pool_defer`` / ``prefill_abort`` with requeue), waiting for
  retirements to return pages;
* ``adapter_load``    — admission blocked on the request's LoRA adapter
  (``adapter_defer``: an injected/transient load fault requeued it — the
  blocks until the retrying admission lands are the adapter-load price);
* ``prefill``         — chunked prefill rounds (``chunk_begin`` to
  ``first_token``); one-shot inserts admit and sample the first token in
  the same block, so their prefill phase is 0 blocks wide by construction;
* ``decode``          — first token to the terminal event, minus any
  recovery interruption;
* ``migration``       — prefill/decode disaggregation handoff: the span
  between the prefill worker sealing the request's KV pages
  (``migrate_send``) and the decode worker adopting them
  (``migrate_adopt``) — or, when the handoff failed/corrupted, the
  ``replay_admit`` that resumed the stream after the local re-prefill
  (the whole degraded path is migration price);
* ``corrupt_replay``  — a corrupted-page re-prefill (``corrupt_replay`` to
  the ``replay_admit`` that resumed the stream);
* ``failover_replay`` — a replica crash: the blocks between the last
  delivered token and the survivor's ``replay_admit`` (lost block +
  heartbeat detection + replay — exactly the failover price);
* ``park_resume``     — the persistent conversation tier: the span between
  an idle stream spilling to durable storage (``park``) and the exact
  page re-adoption that resumed it (``resume``) — or, when the durable
  record was unusable, the ``replay_admit`` after the degraded re-prefill
  (the whole park→re-enter gap is the park price, never a crash's).

HARD INVARIANT: the phase widths sum to the measured end-to-end latency —
``sum(phases_blocks.values()) == end_block - origin_block``, exactly, for
every request, in every mode (faults, tier, failover included). The walker
only ever advances a cursor to event blocks and charges every advance to
exactly one phase, so the invariant holds by construction; the chaos test
in ``tests/test_attribution.py`` pins it anyway.

Everything here is post-hoc host-side analysis over the ring buffer:
nothing is recorded for it, so tracing costs what it cost before and the
streams stay bit-identical. :func:`attribution_report` groups the ring
buffer by request once instead of scanning it once per request.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

PHASES = ("queued", "requeue_backoff", "pool_wait", "adapter_load",
          "prefill", "decode", "migration", "corrupt_replay",
          "failover_replay", "park_resume")

# terminal lifecycle events: the walker closes the open phase here
_TERMINALS = ("retire", "expire", "cancel", "shed", "reject")


def _request_events(tracer, request_id: int) -> List[dict]:
    """The request's attribution-relevant events in recording order: its
    own ``("req", rid)`` lane plus router-lane events tagged with its rid
    (placement, requeue backoff, router-side shedding)."""
    return _events_by_request(tracer).get(request_id, [])


def _events_by_request(tracer) -> Dict[int, List[dict]]:
    """:func:`_request_events` for every request id at once, in one pass
    over the ring buffer."""
    out: Dict[int, List[dict]] = {}
    for ev in tracer.events():
        lane = ev["lane"]
        if lane[0] == "req":
            out.setdefault(lane[1], []).append(ev)
        elif lane[0] == "router":
            rid = (ev["args"] or {}).get("rid")
            if rid is not None:
                out.setdefault(rid, []).append(ev)
    return out


def known_request_ids(tracer) -> List[int]:
    """Every request id the trace knows about — per-request lanes plus
    router-shed requests that never reached an engine lane."""
    rids = set(tracer.by_request())
    for ev in tracer.events():
        if ev["lane"][0] == "router":
            rid = (ev["args"] or {}).get("rid")
            if rid is not None:
                rids.add(rid)
    return sorted(rids)


def request_attribution(tracer, request_id: int,
                        events: Optional[List[dict]] = None) -> Optional[dict]:
    """Decompose one request's submit->terminal span into named phases on
    the virtual block clock (wall ms riding along per phase). Returns None
    when the trace holds no events for the id (tracing off, or the lane
    aged out of the ring buffer). ``events``: the request's events when
    the caller grouped them already (:func:`_events_by_request`)."""
    evs = _request_events(tracer, request_id) if events is None else events
    if not evs:
        return None

    phases: Dict[str, int] = {}
    wall: Dict[str, float] = {}
    segments: List[dict] = []
    origin = cur = None          # blocks
    origin_ts = cur_ts = None    # wall seconds (tracer basis)
    phase = "queued"
    last_tok_block = None
    last_tok_ts = None
    terminal = None
    term_args: dict = {}
    submit_args: dict = {}
    annotations = {"prefill_chunks": 0, "requeues": 0, "pool_defers": 0,
                   "tier_restored_pages": 0, "replays": 0,
                   "adapter_defers": 0, "adapter_loads": 0,
                   "handoff_pages": 0, "migrate_degrades": 0,
                   "parks": 0}
    first_token_block = None

    def close(upto_block, upto_ts, name=None):
        """Charge [cur, upto_block] to ``name`` (default: the open phase)
        and advance the cursor. Zero-width advances record nothing."""
        nonlocal cur, cur_ts
        if cur is None or upto_block is None:
            return
        b = max(int(upto_block), cur)
        p = name or phase
        if b > cur:
            phases[p] = phases.get(p, 0) + (b - cur)
            segments.append({"phase": p, "start_block": cur, "end_block": b})
        if upto_ts is not None and cur_ts is not None and upto_ts > cur_ts:
            wall[p] = wall.get(p, 0.0) + (upto_ts - cur_ts) * 1e3
            cur_ts = upto_ts
        cur = b

    for ev in evs:
        name, blk, ts = ev["name"], ev["block"], ev["ts"]
        args = ev["args"] or {}
        if ev["ph"] == "X":
            continue   # spans duplicate what the instants already mark
        if name in ("route_submit", "submit"):
            if origin is None:
                origin = cur = int(blk if blk is not None else 0)
                origin_ts = cur_ts = ts
            if name == "submit":
                submit_args = dict(args)
                arr = args.get("arrival_block")
                # a future arrival starts the clock at arrival, not submit —
                # safe to rebase while nothing has been charged yet
                if arr is not None and not segments and int(arr) > cur:
                    origin = cur = int(arr)
            continue
        if origin is None:          # lane started mid-buffer: anchor here
            origin = cur = int(blk if blk is not None else 0)
            origin_ts = cur_ts = ts
        if name == "requeue":
            close(blk, ts)
            phase = "requeue_backoff"
            annotations["requeues"] += 1
        elif name == "pool_defer":
            close(blk, ts)
            phase = "pool_wait"
            annotations["pool_defers"] += 1
        elif name == "adapter_defer":
            close(blk, ts)
            phase = "adapter_load"
            annotations["adapter_defers"] += 1
        elif name == "adapter_load":
            annotations["adapter_loads"] += 1
        elif name == "chunk_begin":
            close(blk, ts)
            phase = "prefill"
        elif name == "prefill_chunk":
            annotations["prefill_chunks"] += 1
        elif name == "prefill_abort":
            close(blk, ts, "prefill")
            phase = "pool_wait"
        elif name == "tier_restore":
            annotations["tier_restored_pages"] += int(args.get("pages", 0))
        elif name == "admit":
            close(blk, ts)
        elif name == "place":
            # a replay placement is the failover path: leave the cursor
            # where the stream died so the replay_admit that follows can
            # split the gap into decode + failover_replay
            if not args.get("replay"):
                close(blk, ts)
        elif name == "first_token":
            close(blk, ts)
            phase = "decode"
            if first_token_block is None:
                first_token_block = blk
        elif name == "tok":
            last_tok_block, last_tok_ts = blk, ts
        elif name == "migrate_send":
            close(blk, ts)
            phase = "migration"
            annotations["handoff_pages"] += int(args.get("pages", 0))
        elif name == "migrate_adopt":
            close(blk, ts, "migration")
            phase = "decode"
        elif name == "migrate_degrade":
            annotations["migrate_degrades"] += 1
        elif name == "corrupt_replay":
            close(blk, ts)
            phase = "corrupt_replay"
            annotations["replays"] += 1
        elif name == "park":
            # the stream left the machines for the durable tier: everything
            # until the resume (exact or degraded) is the park price
            close(blk, ts)
            phase = "park_resume"
            annotations["parks"] += 1
        elif name == "resume":
            close(blk, ts, "park_resume")
            phase = "decode"
        elif name == "replay_admit":
            if phase == "migration":
                # a degraded handoff's local re-prefill resumed the stream:
                # the whole send→resume gap is the migration price
                close(blk, ts, "migration")
                annotations["replays"] += 1
            elif phase == "corrupt_replay":
                close(blk, ts, "corrupt_replay")
            elif phase == "park_resume":
                # a degraded park resume re-enters through the replay
                # machinery: the whole park→re-prefill gap stays charged
                # to the park, not to a crash
                close(blk, ts, "park_resume")
                annotations["replays"] += 1
            else:
                # crash gap: decode ran until the last delivered token,
                # everything after is the failover price
                if last_tok_block is not None:
                    close(last_tok_block, last_tok_ts)
                close(blk, ts, "failover_replay")
                annotations["replays"] += 1
            phase = "decode"
        elif name in _TERMINALS:
            close(blk, ts)
            terminal = name
            term_args = dict(args)
            break

    end = cur
    e2e = max(end - origin, 0)
    total_wall = sum(wall.values())
    assert sum(phases.values()) == e2e, (request_id, phases, origin, end)
    return {
        "request_id": request_id,
        "origin_block": origin,
        "end_block": end,
        "e2e_blocks": e2e,
        "phases_blocks": phases,
        "wall_ms": round(total_wall, 3),
        "phases_wall_ms": {k: round(v, 3) for k, v in wall.items()},
        "segments": segments,
        "terminal": terminal,
        "in_flight": terminal is None,
        "first_token_block": first_token_block,
        "tenant": submit_args.get("tenant", "default"),
        "engine": submit_args.get("engine"),
        "ttft_deadline_block": submit_args.get("ttft_deadline_block"),
        "deadline_block": submit_args.get("deadline_block"),
        "deadline_missed": bool(term_args.get("deadline_missed", False)),
        "generated": term_args.get("generated"),
        "annotations": annotations,
    }


def _clip_phases(segments: List[dict], lo: int, hi: int) -> Dict[str, int]:
    """Phase widths restricted to the block window [lo, hi]."""
    out: Dict[str, int] = {}
    for s in segments:
        a = max(s["start_block"], lo)
        b = min(s["end_block"], hi)
        if b > a:
            out[s["phase"]] = out.get(s["phase"], 0) + (b - a)
    return out


def explain_deadline_miss(tracer, request_id: int) -> dict:
    """The manual timeline read, automated: name the phase
    that burned a missed deadline's budget. Returns ``{"missed": False}``
    (plus the attribution) when the request met its deadlines or had none;
    otherwise the binding deadline, how late the request ran, and the
    per-phase budget spend inside the deadline window with the top burner
    called out in a one-line narrative."""
    att = request_attribution(tracer, request_id)
    if att is None:
        return {"request_id": request_id, "missed": False,
                "error": "no trace events for this request id"}
    shed = att["terminal"] in ("shed", "reject")
    if not att["deadline_missed"] and not shed:
        return {"request_id": request_id, "missed": False,
                "attribution": att}
    if shed:
        return {
            "request_id": request_id, "missed": True, "kind": "shed",
            "narrative": (
                f"request {request_id} was load-shed at block "
                f"{att['end_block']} after {att['e2e_blocks']} queued "
                f"block(s) — it never reached a slot"),
            "attribution": att,
        }
    ttft_dl = att["ttft_deadline_block"]
    full_dl = att["deadline_block"]
    # the binding deadline: first token late (or never sampled) binds the
    # TTFT budget; otherwise the completion budget. The explicit
    # first_token_block beats the first decode segment's start — under
    # disaggregation the first token lands BEFORE the migration phase.
    first_tok = att.get("first_token_block")
    if first_tok is None:
        for s in att["segments"]:
            if s["phase"] == "decode":
                first_tok = s["start_block"]
                break
    if ttft_dl is not None and (first_tok is None or first_tok > ttft_dl):
        kind, dl = "ttft", int(ttft_dl)
    elif full_dl is not None:
        kind, dl = "completion", int(full_dl)
    else:
        kind, dl = "completion", att["end_block"]
    burned = _clip_phases(att["segments"], att["origin_block"], dl)
    # the expired tail past the deadline still names what the request was
    # stuck in when the budget ran out
    overrun = _clip_phases(att["segments"], dl, att["end_block"])
    budget = max(dl - att["origin_block"], 1)
    culprit = (max(burned, key=lambda k: burned[k]) if burned
               else max(overrun, key=lambda k: overrun[k]) if overrun
               else "queued")
    spent = burned.get(culprit, 0)
    return {
        "request_id": request_id,
        "missed": True,
        "kind": kind,
        "deadline_block": dl,
        "missed_by_blocks": max(att["end_block"] - dl, 0),
        "budget_blocks": budget,
        "burned_blocks": burned,
        "overrun_blocks": overrun,
        "culprit_phase": culprit,
        "narrative": (
            f"request {request_id} missed its {kind} deadline (block {dl}) "
            f"by {max(att['end_block'] - dl, 0)} block(s); '{culprit}' "
            f"consumed {spent}/{budget} budget block(s) "
            f"({round(100.0 * spent / budget, 1)}%)"),
        "attribution": att,
    }


def _aggregate(atts: List[dict]) -> dict:
    e2e = [a["e2e_blocks"] for a in atts]
    total = sum(e2e)
    phases: Dict[str, int] = {}
    for a in atts:
        for k, v in a["phases_blocks"].items():
            phases[k] = phases.get(k, 0) + v
    return {
        "requests": len(atts),
        "completed": sum(1 for a in atts if a["terminal"] == "retire"),
        "deadline_misses": sum(1 for a in atts if a["deadline_missed"]),
        "shed": sum(1 for a in atts if a["terminal"] in ("shed", "reject")),
        "e2e_blocks": {
            "mean": round(float(np.mean(e2e)), 2) if e2e else None,
            "p99": int(np.percentile(e2e, 99)) if e2e else None,
            "max": int(max(e2e)) if e2e else None,
        },
        "phases_blocks": {
            k: {"total": v,
                "mean": round(v / len(atts), 2),
                "share": round(v / total, 4) if total else 0.0}
            for k, v in sorted(phases.items())
        },
    }


def attribution_report(tracer) -> dict:
    """Fleet-level critical-path report over every request in the trace:
    the aggregate phase mix (which stage the fleet's latency actually lives
    in) plus per-tenant and per-replica breakdowns — the two groupings the
    Router's fairness and placement decisions are judged by."""
    grouped = _events_by_request(tracer)
    atts = [a for a in (request_attribution(tracer, rid, grouped.get(rid, []))
                        for rid in known_request_ids(tracer))
            if a is not None]
    report = _aggregate(atts) if atts else {"requests": 0}
    tenants = sorted({a["tenant"] for a in atts})
    if len(tenants) > 1 or (tenants and tenants != ["default"]):
        report["per_tenant"] = {
            t: _aggregate([a for a in atts if a["tenant"] == t])
            for t in tenants}
    engines = sorted({a["engine"] for a in atts if a["engine"] is not None})
    if len(engines) > 1:
        report["per_replica"] = {
            e: _aggregate([a for a in atts if a["engine"] == e])
            for e in engines}
    return report
