"""The analysis layer in the port (``observability/{attribution,slo,
incident}.py`` and their engine seams), held against the JAX package.

- Attribution (``tests/test_attribution.py``, all but the disaggregation
  case, which waits for the router): every request's phases sum to its
  end-to-end blocks, segments contiguous, on plain lanes, under pool
  pressure with chunked prefill, and on a chaos run (small pool, host
  tier, dispatch faults, page corruption, parks with park faults) on one
  engine, the router's crash and failover waiting with the router; a
  parked request pays a non-zero ``park_resume`` phase;
  ``explain_deadline_miss`` names the queue; queued + pool_wait equals the
  completion's ``queue_blocks``. The JAX engine on the same runs gives the
  same attributions (phases, segments, terminals, annotations), the same
  explanations and the same report.
- SLOs and incidents (``tests/test_observability.py:384-550``): the
  multi-window burn monitor alerts, de-latches and re-alerts as JAX's does;
  the error-ratio objective; the engine's ``slos=`` wiring; the flight
  recorder's bounds and schema gate (each package's validator accepts the
  other's bundles); a deadline-miss burst dumps one bundle whose state
  card holds the engine's counters, as the JAX engine's does.

Tiny model: 2 layers, hidden 32, 3 slots, pages of 4, a 13-page pool, K =
4, fp32, one intra-op thread.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu import observability as jobs
from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference.faults import FaultPlan as JaxPlan
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.observability import attribution as jatt
from neuronx_distributed_tpu_torch import observability as tobs
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.observability import attribution as tatt

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
K = 4
PAGE = 4
SMALL_POOL = 13
# what the attribution holds besides the wall-clock overlay
SAME = ("request_id", "origin_block", "end_block", "e2e_blocks", "phases_blocks", "segments",
        "terminal", "in_flight", "first_token_block", "tenant", "engine", "ttft_deadline_block",
        "deadline_block", "deadline_missed", "generated", "annotations")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lms():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"])
    sd = llama_params_from_jax(params)
    small = dict(page_size=PAGE, page_pool_pages=SMALL_POOL, **LM)
    return {"port": CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **small),
            "jax": JaxLM(jcfg, params, jl.LlamaForCausalLM, **small).compile(),
            "port_contig": CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM),
            "jax_contig": JaxLM(jcfg, params, jl.LlamaForCausalLM, **LM).compile()}


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def _engine(lms, side, key="", seed=7, faults=None, **kw):
    if side == "jax":
        return JaxEngine(lms["jax" + key], block_steps=K, rng=jax.random.key(seed),
                         faults=None if faults is None else JaxPlan(**faults), **kw)
    return ServeEngine(lms["port" + key], block_steps=K, seed=seed,
                       faults=None if faults is None else FaultPlan(**faults), **kw)


def _both(lms, drive, side_kw=lambda side: {}, **kw):
    """Run ``drive(engine)`` on a port and a JAX engine built alike
    (``side_kw(side)``: the knobs that differ, such as directories)."""
    out = {}
    for side in ("port", "jax"):
        eng = _engine(lms, side, **kw, **side_kw(side))
        drive(eng)
        out[side] = eng
    return out["port"], out["jax"]


def _check_invariant(tracer, att=tatt):
    """The acceptance gate on every request the trace knows."""
    rids = att.known_request_ids(tracer)
    assert rids, "trace knows no requests"
    atts = {}
    for rid in rids:
        a = att.request_attribution(tracer, rid)
        assert a is not None, rid
        assert sum(a["phases_blocks"].values()) == a["e2e_blocks"], (rid, a)
        assert set(a["phases_blocks"]) <= set(att.PHASES), (rid, a)
        cur = a["origin_block"]
        for seg in a["segments"]:
            assert seg["start_block"] == cur and seg["end_block"] > seg["start_block"]
            cur = seg["end_block"]
        assert cur == a["end_block"], (rid, a["segments"])
        assert sum(a["phases_wall_ms"].values()) == pytest.approx(
            a["wall_ms"], abs=5e-3 * max(len(a["phases_wall_ms"]), 1))
        atts[rid] = a
    return atts


def _same(port, ref):
    """The two engines' attributions, request for request, wall aside."""
    a, b = _check_invariant(port.tracer), _check_invariant(ref.tracer, jatt)
    assert sorted(a) == sorted(b)
    for rid in a:
        assert {k: a[rid][k] for k in SAME} == {k: b[rid][k] for k in SAME}, rid
    return a


def _strip_wall(rep):
    if isinstance(rep, dict):
        return {k: _strip_wall(v) for k, v in rep.items() if "wall" not in k}
    return rep


def test_phases_are_jax_phases():
    assert tatt.PHASES == jatt.PHASES and tatt._TERMINALS == jatt._TERMINALS


def test_base_lane_decomposition(lms):
    """``:97``: queued wait, chunked prefill, pool-pressure deferral and
    decode land in their phases for every request, as in the JAX engine."""
    short = _prompts(5, s=8, seed=3)
    long16 = _prompts(1, s=16, seed=5)[0]
    tiny4 = _prompts(1, s=4, seed=8)[0]

    def drive(eng):
        eng.submit(long16, 6)
        eng.submit(tiny4, 6)
        for p in short[1:]:
            eng.submit(p, 8, arrival_block=1)
        eng.run(max_blocks=300)

    port, ref = _both(lms, drive, trace=True, prefill_chunk_tokens=5)
    atts = _same(port, ref)
    a = atts[0]
    assert a["phases_blocks"].get("prefill", 0) > 0 and a["annotations"]["prefill_chunks"] == 4
    assert a["terminal"] == "retire" and not a["in_flight"]
    assert "prefill" not in atts[1]["phases_blocks"]
    assert atts[1]["phases_blocks"].get("decode", 0) > 0
    waited = [atts[r] for r in range(2, 6)]
    assert any(w["phases_blocks"].get("queued", 0) + w["phases_blocks"].get("pool_wait", 0) > 0
               for w in waited)
    if port.deferred_admissions > 0:
        assert any("pool_wait" in w["phases_blocks"] for w in waited)
    assert _strip_wall(port.attribution_report()) == _strip_wall(ref.attribution_report())


def test_attribution_empty_without_tracing(lms):
    eng = _engine(lms, "port")
    eng.submit(_prompts(1)[0], 4)
    eng.run()
    assert eng.request_attribution(0) is None
    assert eng.attribution_report() == {"requests": 0}


def test_explain_deadline_miss_names_queued_burn(lms):
    """``:144``: an overloaded 3-slot pool expires queued requests; the
    explanation names the queue (or the pool), as JAX's does."""
    p = _prompts(6, s=8, seed=9)

    def drive(eng):
        for pr in p:
            eng.submit(pr, 10, ttft_deadline_ms=3.0, deadline_ms=30.0)
        eng.run(max_blocks=300)

    port, ref = _both(lms, drive, seed=3, trace=True)
    _same(port, ref)
    comps = {c.request_id: c for c in port.completed}
    expired = [r for r in comps if comps[r].expired]
    served = [r for r in comps if not comps[r].deadline_missed and not comps[r].expired]
    assert expired
    ex = port.explain_deadline_miss(expired[0])
    assert ex["missed"] and ex["kind"] == "ttft"
    assert ex["culprit_phase"] in ("queued", "pool_wait") and ex["culprit_phase"] in ex["narrative"]
    assert ex["attribution"]["e2e_blocks"] >= ex["budget_blocks"]
    if served:
        ok = port.explain_deadline_miss(served[0])
        assert ok["missed"] is False and "attribution" in ok
    assert "error" in port.explain_deadline_miss(10 ** 6)
    for rid in sorted(comps):
        got, want = port.explain_deadline_miss(rid), ref.explain_deadline_miss(rid)
        assert _strip_wall(got) == _strip_wall(want), rid


def test_chaos_attribution_invariant_parks_and_incidents(lms, tmp_path):
    """``:190`` on one engine: a small pool with a host tier, dispatch
    faults, page corruption and park faults, two streams parked mid-decode
    and resumed. Every request's phases sum to its end-to-end blocks, a
    parked request pays a ``park_resume`` phase, each incident bundle
    passes both validators, and the JAX engine attributes the same run the
    same way."""
    rs = np.random.RandomState(1)
    prefix = rs.randint(1, 127, (8,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rs.randint(1, 127, (8,)).astype(np.int32)])
               for _ in range(6)]
    plan = dict(seed=3, dispatch_fail_prob=0.15, dispatch_max_failures=1, corrupt_page_prob=0.1,
                park_write_fail_prob=0.5, park_read_fail_prob=0.25)

    def drive(eng):
        for i, p in enumerate(prompts):
            eng.submit(p, 14, arrival_block=i // 2, tenant=f"t{i % 2}")
        for _ in range(3):
            eng.step_block()
        parked = [r.request_id for s, r in enumerate(eng.slots)
                  if r is not None and s not in eng._prefilling and not eng._done[s]][:2]
        for rid in parked:
            assert eng.park(rid) == "parked"
        eng.step_block()
        for rid in parked:
            eng.submit(resume=rid)
        eng.run(max_blocks=400)
        eng.parked_rids = parked

    port, ref = _both(lms, drive, seed=42, trace=True, host_tier_pages=24, faults=plan,
                      side_kw=lambda side: {"park_dir": str(tmp_path / side)})
    atts = _same(port, ref)
    assert len(atts) == 6 and port.dispatch_retry_count > 0
    for rid in port.parked_rids:
        assert atts[rid]["phases_blocks"].get("park_resume", 0) > 0
        assert atts[rid]["annotations"]["parks"] == 1
    rep = port.attribution_report()
    assert rep["requests"] == 6 and set(rep["per_tenant"]) == {"t0", "t1"}
    assert "park_resume" in rep["phases_blocks"]
    assert sum(v["total"] for v in rep["phases_blocks"].values()) == sum(
        a["e2e_blocks"] for a in atts.values())
    assert _strip_wall(rep) == _strip_wall(ref.attribution_report())


def test_chaos_run_dumps_valid_bundles(lms, tmp_path):
    """The chaos run with a flight recorder: every bundle passes the port's
    and the JAX validator, with the same kinds as the JAX engine's."""
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, 127, (8,)).astype(np.int32) for _ in range(6)]
    kinds = {}
    for side in ("port", "jax"):
        eng = _engine(lms, side, seed=42, trace=True, host_tier_pages=24,
                      incident_dir=str(tmp_path / side), incident_burst_threshold=2,
                      faults=dict(seed=3, corrupt_page_prob=0.3, pool_exhaust_prob=0.3))
        for i, p in enumerate(prompts):
            eng.submit(p, 10, arrival_block=i // 3, ttft_deadline_ms=2.0)
        eng.run(max_blocks=400)
        assert eng.incident.bundles
        got = []
        for b in eng.incident.bundles:
            s = tobs.validate_incident_bundle(b)
            assert s == jobs.validate_incident_bundle(b)
            got.append(s["kind"])
            doc = json.loads(open(b).read())
            assert doc["state"]["engine"] == "engine" and "stats" in doc["state"]
        kinds[side] = got
    assert kinds["port"] == kinds["jax"]
    assert "page_corruption" in kinds["port"]


def test_attribution_matches_run_trace_queue_accounting(lms):
    """``:252``: queued + pool_wait blocks equal each completion's
    ``queue_blocks`` (two derivations of one quantity)."""
    p = _prompts(6, s=8, seed=4)
    eng = _engine(lms, "port", seed=5, trace=True)
    ids = [eng.submit(pr, 6, arrival_block=i) for i, pr in enumerate(p)]
    comps = {c.request_id: c for c in eng.run(max_blocks=300)}
    for rid in ids:
        a = tatt.request_attribution(eng.tracer, rid)
        waited = a["phases_blocks"].get("queued", 0) + a["phases_blocks"].get("pool_wait", 0)
        assert waited == comps[rid].queue_blocks, rid


# --- SLOs -------------------------------------------------------------------------


def test_slo_monitor_multiwindow_burn_alerts_match_jax():
    """``:384``: an objective whose error rate jumps to 100 % alerts once
    both windows burn, de-latches when the short window recovers and
    alerts again on a second burn; the JAX monitor fed the same
    observations alerts at the same blocks with the same burns."""
    out = []
    for obs in (tobs, jobs):
        reg, tr = obs.MetricsRegistry(), obs.Tracer()
        h = reg.histogram("lat_ms", lo=1.0, growth=2.0, n_buckets=10)
        mon = obs.SLOMonitor(reg, [obs.SLObjective(name="lat", target=0.9, metric="lat_ms",
                                                   objective_ms=8.0)],
                             rules=[obs.BurnRule(long_blocks=8, short_blocks=2, factor=2.0)],
                             tracer=tr, lane="engine")
        fired, statuses = [], []
        for block, v in enumerate([2.0] * 4 + [100.0] * 6 + [2.0] * 6 + [100.0] * 4):
            h.observe(v)
            fired.append(mon.observe_block(block))
            statuses.append(mon.status())
        assert len(mon.alerts) == 2 and len(tr.events("slo_alert")) == 2
        assert reg.counter("serve_slo_alerts_total", slo="lat", rule="8b/2b x2").value == 2
        assert not any(r and r["alerting"] for r in statuses[15]["lat"]["rules"].values())
        out.append((fired, statuses, mon.latched(), mon.alerting()))
    assert out[0] == out[1]


def test_slo_error_ratio_objective():
    reg = tobs.MetricsRegistry()
    bad, total = reg.counter("serve_expired"), reg.counter("serve_inserted_requests")
    mon = tobs.SLOMonitor(reg, [tobs.SLObjective(name="completion", target=0.9,
                                                 kind="error_ratio", bad="serve_expired",
                                                 total="serve_inserted_requests")],
                          rules=[tobs.BurnRule(4, 2, 1.5)])
    for b in range(4):
        total.inc(5)
        assert mon.observe_block(b) == []
    total.inc(5)
    bad.inc(4)
    fired = mon.observe_block(4)
    total.inc(5)
    bad.inc(4)
    fired = fired or mon.observe_block(5)
    assert fired and fired[0]["slo"] == "completion"
    with pytest.raises(ValueError, match="error_ratio"):
        tobs.SLObjective(name="x", target=0.9, kind="error_ratio")
    with pytest.raises(ValueError, match="target"):
        tobs.SLObjective(name="x", target=1.5, metric="m", objective_ms=1.0)
    with pytest.raises(ValueError, match="long_blocks"):
        tobs.BurnRule(2, 4, 1.0)
    assert [o.name for o in tobs.default_slos(ttft_ms=5.0)] == ["ttft", "completion"]
    assert tobs.DEFAULT_RULES == tuple(tobs.BurnRule(r.long_blocks, r.short_blocks, r.factor)
                                       for r in jobs.DEFAULT_RULES)


def test_engine_slo_wiring_and_status(lms):
    """``:468``: an impossible objective alerts and a trivial one does not,
    both through ``slo_status()``; an engine without objectives builds no
    monitor. The serving counters the error-ratio objective reads are the
    engine's ``serve_<key>`` counters: the completion objective reads the
    engine's ``expired`` and ``inserted_requests``."""
    eng = _engine(lms, "port", seed=11, trace=True, slos=[
        tobs.SLObjective(name="tight", target=0.9, metric="serve_ttft_ms", objective_ms=1e-6),
        tobs.SLObjective(name="loose", target=0.9, metric="serve_ttft_ms", objective_ms=1e9),
        *[o for o in tobs.default_slos() if o.name == "completion"]])
    for i, p in enumerate(_prompts(4, seed=13)):
        eng.submit(p, 6, arrival_block=i)
    eng.run()
    st = eng.slo_status()
    assert st["tight"]["compliance"] == 0.0 and st["tight"]["alerts"] >= 1
    assert st["loose"]["compliance"] == 1.0 and st["loose"]["alerts"] == 0
    assert st["completion"]["observations"] == eng.inserted_requests == 4
    assert eng.tracer.events("slo_alert")
    assert isinstance(eng.load_summary().slo_alerting, bool)
    bare = _engine(lms, "port")
    assert bare._slo is None and bare.slo_status() is None


# --- the incident flight recorder -------------------------------------------------


def test_flight_recorder_bounds_and_schema(tmp_path):
    """``:492``: the window, the event cap, the per-kind gap and the bundle
    budget bound what is written; each package's validator accepts the
    other's bundle with the same summary and refuses a malformed one."""
    tr, reg = tobs.Tracer(), tobs.MetricsRegistry()
    reg.counter("c").inc(3)
    for b in range(30):
        tr.instant("tok", ("req", 1), block=b)
    rec = tobs.FlightRecorder(str(tmp_path), tracer=tr, metrics=reg, window_blocks=5,
                              max_events=4, max_bundles=2, min_gap_blocks=8)
    p1 = rec.trigger("manual", 20, details={"x": 1}, state={"blocks": 20})
    s = tobs.validate_incident_bundle(p1)
    assert s == jobs.validate_incident_bundle(p1)
    assert s["kind"] == "manual" and s["has_metrics"] and s["events"] <= 4 and s["truncated"]
    doc = json.loads(open(p1).read())
    assert all(15 <= ev["block"] <= 20 for ev in doc["trace"]["events"])
    assert rec.trigger("manual", 24) is None and rec.suppressed == 1
    assert rec.trigger("page_corruption", 29) is not None
    assert rec.trigger("deadline_miss_burst", 29) is None and len(rec.bundles) == 2
    with pytest.raises(ValueError, match="unknown incident kind"):
        rec.trigger("nope", 1)
    assert tobs.INCIDENT_KINDS == jobs.INCIDENT_KINDS
    with pytest.raises(ValueError, match="schema_version"):
        tobs.validate_incident_bundle({"kind": "manual"})
    bad = json.loads(open(p1).read())
    bad["trace"]["events"].append({"name": "late", "ph": "i", "lane": ["req", 1], "block": 99})
    with pytest.raises(ValueError, match="postdates"):
        tobs.validate_incident_bundle(bad)
    jrec = jobs.FlightRecorder(str(tmp_path / "jax"), tracer=None, metrics=None)
    assert tobs.validate_incident_bundle(jrec.trigger("manual", 3))["kind"] == "manual"


def test_deadline_burst_dumps_incident_bundle(lms, tmp_path):
    """``:521``: an overload expiring a burst of deadlines trips the burst
    detector once; the bundle holds the trace slice, the state card (with
    the engine's counters and load card) and the metrics; the JAX engine
    dumps the same bundle kinds with the same details."""
    docs = {}
    for side in ("port", "jax"):
        eng = _engine(lms, side, key="_contig", seed=3, trace=True,
                      incident_dir=str(tmp_path / side), incident_burst_threshold=3,
                      incident_burst_window=8)
        for p in _prompts(6, s=8, seed=9):
            eng.submit(p, 10, ttft_deadline_ms=2.0)
        comps = eng.run(max_blocks=300)
        assert sum(1 for c in comps if c.expired) >= 3
        bundles = [b for b in eng.incident.bundles if "deadline_miss_burst" in b]
        assert len(bundles) == 1
        s = tobs.validate_incident_bundle(bundles[0])
        assert s["kind"] == "deadline_miss_burst" and "expire" in s["names"]
        docs[side] = json.loads(open(bundles[0]).read())
    port, ref = docs["port"], docs["jax"]
    assert port["details"] == ref["details"] and port["block"] == ref["block"]
    assert port["details"]["misses_in_window"] >= 3
    assert port["state"]["engine"] == "engine" and port["state"]["stats"]["expired"] >= 3
    assert set(port["state"]["stats"]) <= set(ref["state"]["stats"])
    for k in ("expired", "completed", "inserted_requests", "decode_blocks", "rejected"):
        assert port["state"]["stats"][k] == ref["state"]["stats"][k], k
    assert set(port["state"]) == set(ref["state"])
    assert set(port["state"]["load"]) == set(ref["state"]["load"])
    assert "serve_ttft_ms" in port["metrics"]
    # compile spans land where each side built its programs: left out
    assert {e["name"] for e in port["trace"]["events"] if not e["name"].startswith("compile:")} \
        == {e["name"] for e in ref["trace"]["events"] if not e["name"].startswith("compile:")}
