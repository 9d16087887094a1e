"""The port's tracer and metrics registry (``observability/``) against the
JAX package's, and the engine's observability seams against the JAX
engine's.

- The same calls on both registries give the same Prometheus text and
  snapshot, the same ``percentile``/``count_le``/``merged``; each
  ``parse_prometheus`` reads the other's text (label values with quotes,
  backslashes and newlines round-trip).
- The same calls on both tracers (explicit stamps, both epochs set alike)
  give equal events, ``by_request``, Chrome events and drops at a small
  capacity; each package's ``validate_chrome_trace`` accepts the other's
  export with the same summary; ``interblock_gaps`` is equal on the same
  spans.
- Engines (the JAX package's ``tests/test_observability.py:183`` and
  ``:217``, on both): the ITL percentiles ``run_trace`` reads off the
  tracer equal the ones of the completions' ``token_ts``; traced and
  untraced streams are bit-identical and tracing captures nothing anew;
  request timelines hold the same events at the same blocks as JAX's; the
  port's metric families are JAX's families, of the same types (the
  handoff's wait for disaggregation; ``compile_ms`` holds each program's
  first call, a CUDA-graph capture on the card); a small ring buffer's
  drops reach the drop counter and the report. Compile spans are left out
  of the lane comparisons on both sides: where a program is built depends
  on what the shared ``CausalLM`` s built before.
- The cache lanes and the counters: a paged ``SimCausalLM`` trace with
  shared prefixes on a small pool, and a tiny Llama trace with a host tier,
  each through both engines, give the same event names on every lane
  (``prefix_hit``, ``evict``, ``pool_exhausted`` on ``("cache", "pool")``,
  ``tier:spill``/``tier:restore`` on ``("cache", "tier")``), the same
  metric families of the same types, and every ``serve_<key>`` counter at
  the JAX engine's value; the engine's counter attributes read those
  counters.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference.engine import run_trace as jax_run_trace
from neuronx_distributed_tpu.inference.engine import synthetic_trace as jax_trace
from neuronx_distributed_tpu.inference.simlm import SimCausalLM as JaxSim
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.observability import metrics as jmet
from neuronx_distributed_tpu.observability import tracer as jtr
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import STAT_KEYS, ServeEngine, run_trace
from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.observability import metrics as tmet
from neuronx_distributed_tpu_torch.observability import tracer as ttr


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
K = 4
ODD_LABEL = 'we"ird\\label\nx}'
# JAX families of features the port does not have yet: none since the
# disaggregation handoff's counters and histogram were ported
LEFT_OUT = set()


# --- metrics -------------------------------------------------------------------


def _registry(m, values):
    reg = m.MetricsRegistry()
    reg.counter("reqs_total", help="requests").inc(41)
    reg.counter("reqs_total").inc()
    g = reg.gauge("depth", help="queue depth")
    for v in (7, 3, 9, 2):
        g.set(v)
    g.inc(2)
    g.dec()
    h = reg.histogram("lat_ms", help="latency", lo=1.0, growth=2.0, n_buckets=8)
    for v in values:
        h.observe(v)
    reg.histogram("serve_dispatch_ms", kind="decode").observe(0.37)
    reg.counter("dispatch_total", kind="insert").inc(3)
    reg.counter("dispatch_total", kind=ODD_LABEL).inc(2)
    reg.gauge("ratio").set(0.1 + 0.2)
    return reg


@pytest.fixture(scope="module")
def registries():
    values = np.random.default_rng(4).lognormal(1.0, 2.0, 300).tolist() + [0.5, 1e9, 1.0]
    return _registry(jmet, values), _registry(tmet, values)


def test_registry_exposition_and_snapshot_equal_jax(registries, tmp_path):
    jreg, treg = registries
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.snapshot() == jreg.snapshot()
    for reg, name in ((jreg, "j"), (treg, "t")):
        reg.dump(str(tmp_path / f"{name}.prom"))
        reg.dump(str(tmp_path / f"{name}.json"))
    assert (tmp_path / "t.prom").read_text() == (tmp_path / "j.prom").read_text()
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())


def test_histogram_reads_equal_jax(registries):
    jh, th = (reg.histogram("lat_ms", lo=1.0, growth=2.0, n_buckets=8) for reg in registries)
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q)
    for v in (0.1, 1.0, 3.0, 64.0, 128.0, 1e6, float("inf")):
        assert th.count_le(v) == jh.count_le(v)
    other = [m.Histogram("lat_ms", lo=1.0, growth=2.0, n_buckets=8) for m in (jmet, tmet)]
    for h in other:
        for v in (2.0, 5.0, 300.0):
            h.observe(v)
    jm, tm = jh.merged(other[0]), th.merged(other[1])
    assert (tm.counts, tm.sum, tm.count) == (jm.counts, jm.sum, jm.count)
    assert tmet.Histogram("x").percentile(50) is None
    for m in (jmet, tmet):
        with pytest.raises(ValueError, match="different bucketing"):
            m.Histogram("a", lo=1.0).merged(m.Histogram("b", lo=2.0))
        with pytest.raises(ValueError, match="already registered"):
            reg = m.MetricsRegistry()
            reg.counter("dual")
            reg.gauge("dual")
        with pytest.raises(ValueError, match="invalid metric name"):
            m.MetricsRegistry().counter("bad name")


def test_parse_prometheus_round_trips_across_packages(registries):
    jreg, treg = registries
    for text in (jreg.to_prometheus(), treg.to_prometheus()):
        parsed = tmet.parse_prometheus(text)
        assert parsed == jmet.parse_prometheus(text)
        samples = parsed["dispatch_total"]["samples"]
        assert samples[("dispatch_total", (("kind", ODD_LABEL),))] == 2.0
        assert parsed["lat_ms"]["type"] == "histogram"
        assert parsed["lat_ms"]["samples"][("lat_ms_bucket", (("le", "+Inf"),))] == 303.0
    with pytest.raises(ValueError, match="precedes its TYPE"):
        tmet.parse_prometheus("orphan 1\n")
    with pytest.raises(ValueError, match="malformed sample"):
        tmet.parse_prometheus("# TYPE x counter\nx{a=\"1\" 2\n")


# --- the tracer --------------------------------------------------------------------


def _tracer(m, capacity=65536):
    tr = m.Tracer(capacity=capacity)
    tr._t0 = 1000.0
    rng = np.random.default_rng(8)
    ts = 1000.0
    for i in range(60):
        ts += float(rng.exponential(0.002))
        block, kind = i // 4, i % 4
        if kind == 0:
            tr.instant("tok", ("req", i % 5), block=block, ts=ts, args={"t": i, "i": block})
        elif kind == 1:
            tr.complete("decode", ("engine", "dispatch"), ts, ts + 0.001, block=block)
        elif kind == 2:
            tr.complete("fetch", ("engine", "dispatch"), ts + 0.0012, ts + 0.0015, block=block,
                        args={"inflight": 1})
        else:
            tr.counter("queue_depth", ("engine", "queue"), i % 7, block=block, ts=ts)
    tr.complete("queued", ("req", 7), 1000.0005, ts, block=0, args={"queue_blocks": 3})
    return tr


def _strip(evs):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")} for ev in evs]


@pytest.mark.parametrize("capacity", [65536, 16])
def test_tracer_events_and_export_equal_jax(capacity):
    jt, tt = _tracer(jtr, capacity), _tracer(ttr, capacity)
    assert tt.events() == jt.events()
    assert tt.events("tok", "req") == jt.events("tok", "req")
    assert tt.by_request() == jt.by_request()
    assert tt.dropped == jt.dropped == (0 if capacity > 100 else 61 - 16)
    assert tt.chrome_events() == jt.chrome_events()
    assert tt.export_chrome() == jt.export_chrome()
    for doc in (tt.export_chrome(), jt.export_chrome()):
        summary = ttr.validate_chrome_trace(doc)
        assert summary == jtr.validate_chrome_trace(doc)
        assert summary["dropped_events"] == tt.dropped
    assert ttr.interblock_gaps(tt, "engine") == jtr.interblock_gaps(jt, "engine")
    assert ttr.interblock_gaps(jt, "engine") == jtr.interblock_gaps(tt, "engine")


def test_tracer_spans_switches_and_schema_errors(tmp_path):
    """``span`` (wall stamps: compared without them), a failing span marks
    its error, a disabled tracer records nothing, the export lands on disk,
    and the validators refuse the same broken documents."""
    traces = []
    for m in (jtr, ttr):
        tr = m.Tracer()
        with tr.span("insert", ("engine", "dispatch"), block=2, args={"rows": 3}):
            pass
        with pytest.raises(KeyError):
            with tr.span("extend", ("engine", "dispatch"), block=3):
                raise KeyError("boom")
        tr.instant("submit", ("req", 1), block=0)
        tr.enabled = False
        tr.instant("lost", ("req", 1))
        tr.counter("lost", ("engine", "queue"), 1)
        traces.append(tr)
        tr.export_chrome(str(tmp_path / f"{m.__name__}.json"))
    assert _strip(traces[1].events()) == _strip(traces[0].events())
    assert traces[1].events()[1]["args"] == {"error": "KeyError"}
    doc = json.loads((tmp_path / f"{ttr.__name__}.json").read_text())
    assert jtr.validate_chrome_trace(doc)["names"] == {"insert", "extend", "submit"}
    bad = [{"traceEvents": []}, {"nope": 1},
           {"traceEvents": [{"name": "x", "ph": "Q", "pid": 1, "tid": 0, "ts": 0}]},
           {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0, "ts": 0}]}]
    for d in bad:
        for m in (jtr, ttr):
            with pytest.raises(ValueError):
                m.validate_chrome_trace(d)
    with pytest.raises(ValueError, match="request lanes"):
        ttr.validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "i", "pid": 1, "tid": 0, "ts": 0.0}]})


# --- the engines ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def lms():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return {"jax": JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=4, **LM).compile(),
            "port": CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", page_size=4, **LM)}


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def test_itl_percentiles_match_the_token_ts_path(lms):
    """``test_observability.py:183``: the ITL percentiles read off the
    tracer's token events equal the ones of the completions' ``token_ts``
    (gaps between deliveries only), on both engines; the streams and the
    per-request blocks equal JAX's."""
    knobs = dict(prompt_lens=(6, 8, 12), max_new_tokens=8, mean_interarrival_blocks=0.5,
                 seed=11)
    per_request = {}
    for side, cls, make, run in (("jax", JaxEngine, jax_trace, jax_run_trace),
                                 ("port", ServeEngine, synthetic_trace, run_trace)):
        eng = cls(lms[side], block_steps=K, trace=True)
        report = run(eng, make(6, 128, **knobs))
        gaps, legacy = [], {}
        for c in eng.completed:
            g = np.diff(c.token_ts) * 1e3 if len(c.token_ts) > 1 else np.zeros((0,))
            g = g[g > 0.0]
            gaps.extend(g.tolist())
            legacy[c.request_id] = round(float(g.max()), 2) if g.size else 0.0
        assert gaps
        assert report["itl_p50_ms"] == pytest.approx(round(float(np.percentile(gaps, 50)), 3))
        assert report["itl_p99_ms"] == pytest.approx(round(float(np.percentile(gaps, 99)), 3))
        assert report["max_itl_gap_ms"] == pytest.approx(round(float(np.max(gaps)), 2))
        for pr in report["per_request"]:
            assert pr["max_itl_gap_ms"] == pytest.approx(legacy[pr["request_id"]])
        per_request[side] = ({c.request_id: c.tokens.tolist() for c in eng.completed},
                             [{k: v for k, v in pr.items() if k != "max_itl_gap_ms"}
                              for pr in report["per_request"]])
    assert per_request["port"] == per_request["jax"]


@pytest.mark.parametrize("async_loop", [False, True])
def test_streams_bitwise_traced_vs_untraced(lms, async_loop):
    """``test_observability.py:217``: tracing on or off gives bit-identical
    streams and schedules and captures no program anew (the port's captured
    blocks are keyed per ``CausalLM``); the greedy streams equal JAX's."""
    p = _prompts(3, seed=9)
    submits = [dict(prompt=p[0], max_new_tokens=8),
               dict(prompt=p[1], max_new_tokens=6, arrival_block=1),
               dict(prompt=p[2], max_new_tokens=7, arrival_block=2)]
    results = {}
    for trace in (True, False):
        keys = set(lms["port"]._fused)
        eng = ServeEngine(lms["port"], block_steps=K, trace=trace, async_loop=async_loop)
        ids = [eng.submit(**kw) for kw in submits]
        comps = {c.request_id: c for c in eng.run()}
        assert set(lms["port"]._fused) == keys or not keys
        results[trace] = {r: (comps[r].tokens.tolist(), comps[r].queue_blocks,
                              comps[r].decode_blocks) for r in ids}
        assert bool(eng.tracer.events()) == trace
    assert results[True] == results[False]
    jeng = JaxEngine(lms["jax"], block_steps=K)
    for kw in submits:
        jeng.submit(**kw)
    assert {c.request_id: c.tokens.tolist() for c in jeng.run()} == {
        r: v[0] for r, v in results[True].items()}


def _chunked_overload(side, make):
    """A chunked, overloaded, deadline-bound run with a cancel, traced."""
    cls = ServeEngine if side == "port" else JaxEngine
    return cls, make(10, 128, prompt_lens=(5, 8), max_new_tokens=8,
                     mean_interarrival_blocks=0.3, long_prompt_frac=0.25, long_prompt_len=16,
                     ttft_deadline_ms=5.0, deadline_ms=7.0, seed=6)


def test_timelines_metrics_and_chrome_export_match_jax(lms):
    """The request timelines (event names and blocks, span durations where
    spans), the Chrome export (accepted by both validators, the same event
    names on the request lanes) and the metric families of one chunked,
    overloaded, deadline-bound run with a cancel, on both engines."""
    out = {}
    for side, make in (("jax", jax_trace), ("port", synthetic_trace)):
        cls, trace = _chunked_overload(side, make)
        eng = cls(lms[side], block_steps=K, prefill_chunk_tokens=5, max_queue=1, trace=True)
        for it in trace:
            eng.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"],
                       ttft_deadline_ms=it["ttft_deadline_ms"], deadline_ms=it["deadline_ms"])
        eng.step_block()
        eng.step_block()
        live = [r.request_id for r in eng.slots if r is not None]
        assert eng.cancel(live[0])
        eng.run()
        rids = sorted(eng.tracer.by_request())
        timelines = {r: [(e["name"], e["block"], "dur_ms" in e) for e in eng.request_timeline(r)]
                     for r in rids}
        doc = eng.tracer.export_chrome()
        summary = ttr.validate_chrome_trace(doc)
        assert summary == jtr.validate_chrome_trace(doc)
        req_names = {e["name"] for e in doc["traceEvents"]
                     if e["ph"] != "M" and e["pid"] == next(
                         m["pid"] for m in doc["traceEvents"]
                         if m["ph"] == "M" and m["name"] == "process_name"
                         and m["args"]["name"] == "req")}
        fams = {name: f["type"] for name, f in
                tmet.parse_prometheus(eng.metrics.to_prometheus()).items()}
        # compile spans: where each side built its programs (left out)
        names = {n for n in summary["names"] if not n.startswith("compile:")}
        out[side] = (timelines, req_names, fams, names)
    timelines, req_names, fams, names = out["port"]
    assert timelines == out["jax"][0]
    assert req_names == out["jax"][1]
    assert {"submit", "queued", "admit", "first_token", "tok", "retire", "expire", "shed",
            "cancel", "chunk_begin", "prefill_chunk"} <= req_names
    assert {"decode_block", "decode", "fetch", "insert", "extend", "queue_depth",
            "pages_in_use"} <= names
    assert fams == {k: v for k, v in out["jax"][2].items() if k not in LEFT_OUT}
    assert {"serve_ttft_ms", "serve_itl_ms", "serve_dispatch_ms", "serve_queue_depth",
            "serve_page_pool_in_use", "trace_dropped_events"} <= set(fams)


def test_ring_buffer_drops_reach_the_counter_and_the_report(lms):
    tracer = ttr.Tracer(capacity=32)
    eng = ServeEngine(lms["port"], block_steps=K, tracer=tracer, name="replica0")
    rep = run_trace(eng, synthetic_trace(4, 128, prompt_lens=(6,), max_new_tokens=8, seed=2))
    assert rep["trace_events"] == 32 and rep["trace_events_dropped"] == tracer.dropped > 0
    assert eng.metrics.counter("trace_dropped_events").value == tracer.dropped
    assert {ev["lane"][0] for ev in tracer.events(lane_group="replica0")} == {"replica0"}
    hist = eng.metrics.histogram("serve_ttft_ms")
    assert hist.count == rep["requests_completed"] == 4


# --- the cache lanes and the serve_<key> counters (C5) -----------------------------


def _lane_names(tracer):
    """Event names by lane: every request lane together under ``"req"``,
    the others by (group, track)."""
    out = {}
    for ev in tracer.events():
        lane = ev["lane"]
        out.setdefault("req" if lane[0] == "req" else tuple(lane), set()).add(ev["name"])
    return out


@pytest.fixture(scope="module")
def tier_lms():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    small = dict(page_size=4, page_pool_pages=13, **LM)
    return {"jax": JaxLM(jcfg, params, jl.LlamaForCausalLM, **small).compile(),
            "port": CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **small)}


@pytest.mark.parametrize("case", ["sim", "tier"])
def test_cache_lanes_and_counter_families_match_jax(tier_lms, case):
    """Traces with shared prefixes through both engines: a paged
    ``SimCausalLM`` on a 12-page pool (prefix hits, evictions, pool
    exhaustion), and the tiny Llama on a 13-page pool with a host tier
    (a prefix spilled by a burst of other requests, then restored). Every
    lane carries the JAX engine's event names, the registry JAX's families
    and types, and every ``serve_<key>`` counter JAX's value."""
    rng = np.random.default_rng(7)
    fam_a, fam_b = (rng.integers(1, 127, (8,)).astype(np.int32) for _ in range(2))
    tail = lambda: rng.integers(1, 127, (4,)).astype(np.int32)  # noqa: E731
    pressure = ([dict(prompt=np.concatenate([fam_a, tail()]), max_new_tokens=8)]
                + [dict(prompt=np.concatenate([fam_b, tail()]), max_new_tokens=8,
                        arrival_block=4) for _ in range(3)]
                + [dict(prompt=np.concatenate([fam_a, tail()]), max_new_tokens=8,
                        arrival_block=12)])
    out = {}
    for side in ("port", "jax"):
        make = synthetic_trace if side == "port" else jax_trace
        trace = (make(6, 128, prompt_lens=(8,), max_new_tokens=6, shared_prefix_len=8,
                      prefix_families=2, seed=1) if case == "sim" else pressure)
        if case == "sim":
            sim = (SimCausalLM if side == "port" else JaxSim)(
                max_batch=3, buckets=(8, 16), page_size=4, page_pool_pages=12, vocab_size=128)
            eng = (ServeEngine(sim, block_steps=K) if side == "port"
                   else JaxEngine(sim, block_steps=K))
        elif side == "port":
            eng = ServeEngine(tier_lms["port"], block_steps=K, host_tier_pages=8)
        else:
            eng = JaxEngine(tier_lms["jax"], block_steps=K, host_tier_pages=8)
        rep = (run_trace if side == "port" else jax_run_trace)(eng, trace)
        fams = {name: f["type"] for name, f in
                tmet.parse_prometheus(eng.metrics.to_prometheus()).items()}
        counters = {k: eng.metrics.counter("serve_" + k).value for k in STAT_KEYS}
        out[side] = (_lane_names(eng.tracer), fams, counters, rep["requests_completed"], eng)
    lanes, fams, counters, done, port = out["port"]
    # compile spans land where a program is built, which depends on what the
    # shared CausalLMs built before: both sides leave that lane out
    lanes = {k: v for k, v in lanes.items() if k != ("engine", "compile")}
    jlanes = {k: v for k, v in out["jax"][0].items() if k != ("engine", "compile")}
    assert lanes == jlanes
    assert fams == {k: v for k, v in out["jax"][1].items() if k not in LEFT_OUT}
    assert counters == out["jax"][2] and done == out["jax"][3] == len(trace)
    pool = lanes[("cache", "pool")]
    if case == "sim":
        assert {"prefix_hit", "evict", "pool_exhausted"} <= pool
    else:
        assert "prefix_hit" in pool and {"tier:spill", "tier:restore"} <= lanes[("cache", "tier")]
        assert port.session.paged.tier_restored_pages > 0
    # the attributes are the counters
    assert port.inserts == counters["inserts"] and port.blocks == counters["blocks"]
    assert port.completed_count == counters["completed"]
    assert len(port.rejected) == counters["rejected"]
    assert {"serve_prefix_hit_tokens", "serve_park_ms", "serve_park_resume_ms"} <= set(fams)
