"""Serving under overload: deadlines, EDF admission, load shedding and
``run_trace``'s report, the port's ``ServeEngine`` against the JAX one.

One seeded flax init is carried over with ``llama_params_from_jax``; fp32
on both sides, 2 layers, hidden 64, buckets (8, 16), 3 slots, K = 4,
greedy requests (the two engines draw sampled tokens from different noise,
so a sampled stream is compared only within one engine).

- Parity on one synthetic trace with TTFT and completion deadlines (short
  prompts a quarter of the long ones' TTFT budget, as ``chip_smoke.py``
  gives them), two tenants, ``max_queue=1`` and chunks of 5 tokens, for
  both shed policies, the port's synchronous and pipelined loops against
  the JAX synchronous loop: the same completions (tokens, finish reason,
  ``expired``, ``deadline_missed``, tenant, queue/TTFT/decode blocks), the
  same ``rejected`` lists (id, reason, retry-after, queue depth), the same
  per-request tracer event names with their blocks, and the same
  deterministic ``run_trace`` values; wall-clock values are checked for
  presence and type. The JAX pipelined loop is not the reference for the
  schedule: it retires a stream that ends on its budget a block after its
  synchronous loop does, and so admits and sheds otherwise under load; the
  port's pipelined loop keeps the synchronous schedule.
- The JAX package's oracle tests of overload (``tests/test_serving_faults.py``
  and ``tests/test_async_loop.py``), each run on both engines with the same
  inputs: the port must give JAX's results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import Rejected as JaxRejected
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference.engine import run_trace as jax_run_trace
from neuronx_distributed_tpu.inference.engine import synthetic_trace as jax_trace
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import Rejected, ServeEngine, run_trace
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
PAGE = 4
K = 4
# the parity trace: 16 requests, every 4th a 16-token prompt (chunked at 5)
TRACE = dict(prompt_lens=(5, 8, 11), max_new_tokens=10, mean_interarrival_blocks=0.4,
             long_prompt_frac=0.25, long_prompt_len=16, tenants=2, ttft_deadline_ms=12.0,
             deadline_ms=6.0, seed=3)
ENGINE = dict(prefill_chunk_tokens=5, max_queue=1)
# run_trace values that depend on the schedule only
DETERMINISTIC = (
    "requests_completed", "total_generated_tokens", "blocks", "decode_blocks", "block_steps",
    "fused", "inserts", "inserted_requests", "program_calls", "queue_blocks_mean",
    "decode_blocks_mean", "prefill_chunk_tokens", "chunk_program_calls",
    "prefill_chunk_tokens_done", "prefill_aborts", "ttft_blocks_mean", "ttft_blocks_max",
    "rejected", "expired", "shed_evictions", "max_queue", "shed_policy", "deadline_miss_rate",
    "paged", "page_size", "page_pool_pages", "prefix_hits", "prefix_hit_tokens",
    "pages_in_use_peak", "evicted_pages", "deferred_admissions")
WALL = ("wall_s", "tokens_per_sec", "goodput_tokens_per_sec", "itl_p50_ms", "itl_p99_ms",
        "max_itl_gap_ms", "interblock_gap_ms_p50", "interblock_gap_ms_p99",
        "interblock_gap_ms_mean", "fetch_blocked_ms_p50", "fetch_blocked_ms_mean")
TENANT_COUNTS = ("requests", "generated_tokens", "ttft_blocks_mean", "ttft_blocks_p99",
                 "rejected", "expired", "deadline_missed")


@pytest.fixture(scope="module")
def lms():
    """The port's and the JAX package's slab and paged lms on one weight
    set."""
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))

    def port(**kw):
        return CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM, **kw)

    def ref(**kw):
        return JaxLM(jcfg, params, jl.LlamaForCausalLM, **LM, **kw).compile()

    return {"port": {"slab": port(), "paged": port(page_size=PAGE),
                     "small": port(page_size=PAGE, page_pool_pages=12)},
            "jax": {"slab": ref(), "paged": ref(page_size=PAGE),
                    "small": ref(page_size=PAGE, page_pool_pages=12)}}


def _engine(lms, side, lm="slab", **kw):
    cls = ServeEngine if side == "port" else JaxEngine
    return cls(lms[side][lm], block_steps=K, **kw)


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def _overload_trace(make):
    """``TRACE`` with the short prompts' TTFT budget a quarter of the long
    ones'."""
    trace = make(16, TINY["vocab_size"], **TRACE)
    for it in trace:
        if it["prompt"].size < TRACE["long_prompt_len"]:
            it["ttft_deadline_ms"] = TRACE["ttft_deadline_ms"] / 4
    return trace


def _comps(eng):
    return {c.request_id: (c.tokens.tolist(), c.finish_reason, c.expired, c.deadline_missed,
                           c.tenant, c.queue_blocks, c.ttft_blocks, c.decode_blocks)
            for c in eng.completed}


def _rejected(eng):
    return [(r.request_id, r.reason, r.retry_after_blocks, r.queue_depth) for r in eng.rejected]


def _events(eng):
    return {rid: [(ev["name"], ev["block"]) for ev in evs]
            for rid, evs in eng.tracer.by_request().items()}


def _report(rep, async_loop=False):
    """The deterministic part of a report. The pipelined loop reserves
    pages for two blocks of overrun, not one (so its page peak is its own),
    and completes a stream with tokens in flight when they come back (so
    its completion order is its own)."""
    out = {k: rep.get(k) for k in DETERMINISTIC if not (async_loop and k == "pages_in_use_peak")}
    out["per_request"] = sorted(({k: v for k, v in r.items() if k != "max_itl_gap_ms"}
                                 for r in rep["per_request"]), key=lambda r: r["request_id"])
    out["per_tenant"] = {t: {k: d[k] for k in TENANT_COUNTS} for t, d in rep["per_tenant"].items()}
    return out


@pytest.fixture(scope="module")
def jax_runs(lms):
    """The JAX engine's synchronous loop over the parity trace, per shed
    policy."""
    out = {}
    for policy in ("tail", "deadline"):
        eng = _engine(lms, "jax", "paged", shed_policy=policy, **ENGINE)
        rep = jax_run_trace(eng, _overload_trace(jax_trace))
        out[policy] = (_comps(eng), _rejected(eng), _events(eng), rep)
    return out


@pytest.mark.parametrize("async_loop", [False, True])
@pytest.mark.parametrize("policy", ["tail", "deadline"])
def test_overload_trace_matches_jax(lms, jax_runs, policy, async_loop):
    eng = _engine(lms, "port", "paged", shed_policy=policy, async_loop=async_loop, **ENGINE)
    rep = run_trace(eng, _overload_trace(synthetic_trace))
    comps, rejected, events, report = jax_runs[policy]
    assert _comps(eng) == comps
    assert _rejected(eng) == rejected
    assert _events(eng) == events
    assert _report(rep, async_loop) == _report(report, async_loop)
    for key in WALL:
        assert isinstance(rep[key], float), key
    assert rep["async_loop"] is async_loop and rep["trace_events_dropped"] == 0
    # the trace exercises every decision: sheds, expiry before and during
    # decode, a stream cut short, streams on time
    got = list(comps.values())
    assert any(r[1] == "queue_full" for r in rejected)
    assert (rep["shed_evictions"] > 0) == (policy == "deadline")
    assert any(c[2] and not c[0] for c in got) and any(c[2] and c[0] for c in got)
    assert any(not c[3] for c in got) and rep["prefill_aborts"] > 0


# --- the JAX package's oracle tests, on both engines ------------------------------


def test_deadline_expires_decoding_request_with_partial_stream(lms):
    """``test_serving_faults.py:99``: past its completion deadline a stream
    retires with a partial ``expired`` completion; the freed slot serves a
    follow-up."""
    got = {}
    for side in ("jax", "port"):
        eng = _engine(lms, side)
        rid = eng.submit(_prompts(1, seed=9)[0], 20, deadline_ms=3)
        eng.run()
        c = {c.request_id: c for c in eng.completed}[rid]
        assert c.expired and c.deadline_missed and c.finish_reason == "expired"
        assert 0 < len(c.tokens) < 20
        r2 = eng.submit(_prompts(1, seed=11)[0], 5)
        eng.run()
        got[side] = (_comps(eng), r2)
    assert got["port"] == got["jax"]
    assert len(got["port"][0][got["port"][1]][0]) == 5


def test_deadline_expires_queued_request_without_burning_prefill(lms):
    """``:122``: a request whose deadline dies in the queue expires with no
    tokens and no insert spent on it."""
    got = {}
    for side in ("jax", "port"):
        eng = _engine(lms, side)
        for p in _prompts(3, seed=13):
            eng.submit(p, 16)
        eng.step_block()
        doomed = eng.submit(_prompts(1, seed=15)[0], 4, deadline_ms=2)
        inserts = eng.inserts if side == "port" else eng.stats["inserts"]
        while not any(c.request_id == doomed for c in eng.completed):
            assert eng.step_block()
        now = eng.inserts if side == "port" else eng.stats["inserts"]
        assert now == inserts
        eng.run()
        got[side] = _comps(eng)
    assert got["port"] == got["jax"]
    assert got["port"][3][:3] == ([], "expired", True)


def test_ttft_deadline_expires_mid_chunked_prefill_pages_roll_back(lms):
    """``:142``: a TTFT deadline dies mid-chunked-prefill: the admission
    rolls back (``_abort_prefill``), the request expires with no tokens,
    the decoding tenant's stream is untouched, and no page leaks."""
    got = {}
    for side in ("jax", "port"):
        eng = _engine(lms, side, "paged", prefill_chunk_tokens=4)
        tenant = eng.submit(_prompts(1, seed=17)[0], 20)
        eng.step_block()
        doomed = eng.submit(_prompts(1, s=16, seed=19)[0], 6, ttft_deadline_ms=2)
        eng.run()
        aborts = eng.prefill_aborts if side == "port" else eng.stats["prefill_aborts"]
        pkv = eng.session.paged
        pkv.prefix.evict(10 ** 6)
        assert pkv.allocator.in_use() == 0
        got[side] = (_comps(eng), aborts)
    assert got["port"] == got["jax"]
    comps, aborts = got["port"]
    assert comps[doomed][:3] == ([], "expired", True) and aborts >= 1
    solo = _engine(lms, "port")
    solo.submit(_prompts(1, seed=17)[0], 20)
    assert comps[tenant][0] == solo.run()[0].tokens.tolist()


def test_edf_admission_prefers_earliest_deadline(lms):
    """``:169``: a later request with a binding deadline is admitted ahead
    of an earlier one without."""
    got = {}
    for side in ("jax", "port"):
        eng = _engine(lms, side)
        p = _prompts(3, seed=21)
        for i, n in enumerate((2, 10, 14)):
            eng.submit(p[i], n)
        late = eng.submit(_prompts(1, seed=23)[0], 4)
        urgent = eng.submit(_prompts(1, seed=25)[0], 4, deadline_ms=60)
        eng.run()
        got[side] = _comps(eng)
    assert got["port"] == got["jax"]
    assert got["port"][urgent][5] < got["port"][late][5]


def test_bounded_queue_sheds_with_retry_after_then_resubmit_succeeds(lms):
    """``:190``: a full queue returns ``Rejected("queue_full")`` with a
    retry-after; resubmitted after that many blocks, the prompt is served."""
    got = {}
    shed_p = _prompts(1, seed=29)[0]
    for side in ("jax", "port"):
        eng = _engine(lms, side, max_queue=1)
        for p in _prompts(3, seed=27):
            eng.submit(p, 8)
        eng.step_block()
        assert isinstance(eng.submit(_prompts(1, seed=31)[0], 4), int)
        rej = eng.submit(shed_p, 4)
        assert isinstance(rej, Rejected if side == "port" else JaxRejected)
        assert rej.reason == "queue_full" and rej.retry_after_blocks >= 1
        assert rej.queue_depth == 1 and len(eng.rejected) == 1
        for _ in range(rej.retry_after_blocks):
            eng.step_block()
        retry = eng.submit(shed_p, 4)
        assert isinstance(retry, int)
        eng.run()
        got[side] = (_comps(eng), _rejected(eng), retry)
    assert got["port"] == got["jax"]


def test_pool_exhausted_shed_reason_and_retry_from_oldest_decoder(lms):
    """``:219``: a shed forced by page-pool exhaustion (free slots, no
    pages) says ``pool_exhausted`` and its retry-after covers the oldest
    decoding stream's remaining budget; the same shed on the slab is
    ``queue_full``."""
    got = {}
    for side in ("jax", "port"):
        eng = _engine(lms, side, "small", max_queue=1)
        p = _prompts(3, seed=61)
        r1 = eng.submit(p[0], 12)
        eng.step_block()
        assert eng.slots.count(None) == 2
        assert isinstance(eng.submit(p[1], 12), int)
        rej = eng.submit(p[2], 12)
        assert rej.reason == "pool_exhausted"
        assert rej.retry_after_blocks >= -(-(12 - len(eng._out[r1])) // K) == 2
        slab = _engine(lms, side, max_queue=0)
        for q in p:
            slab.submit(q, 8)
        slab.step_block()
        rej_slab = slab.submit(_prompts(1, seed=63)[0], 8)
        assert rej_slab.reason == "queue_full"
        eng.run()
        slab.run()
        got[side] = (_comps(eng), _rejected(eng), _rejected(slab))
    assert got["port"] == got["jax"]


def test_deadline_shed_policy_evicts_laxest_deadline(lms):
    """``:256``: under ``shed_policy="deadline"`` a tight newcomer displaces
    the deadline-free queued request."""
    got = {}
    for side in ("jax", "port"):
        eng = _engine(lms, side, max_queue=1, shed_policy="deadline")
        for p in _prompts(3, seed=33):
            eng.submit(p, 12)
        lax = eng.submit(_prompts(1, seed=35)[0], 4)
        urgent = eng.submit(_prompts(1, seed=37)[0], 4, deadline_ms=40)
        assert isinstance(lax, int) and isinstance(urgent, int)
        evictions = eng.shed_evictions if side == "port" else eng.stats["shed_evictions"]
        assert evictions == 1 and [r.request_id for r in eng.rejected] == [lax]
        eng.run()
        got[side] = (_comps(eng), _rejected(eng))
    assert got["port"] == got["jax"]
    assert urgent in got["port"][0] and lax not in got["port"][0]


def test_overload_report_surface_and_goodput(lms):
    """``:275``: ``run_trace`` at about 2x overload with deadlines and a
    bounded queue: sheds or expiries happen, the miss rate is set, goodput
    counts only streams that met their deadlines."""
    knobs = dict(prompt_lens=(8,), max_new_tokens=8, mean_interarrival_blocks=0.2,
                 deadline_ms=6, seed=3)
    reps = {}
    for side, make, run in (("jax", jax_trace, jax_run_trace),
                            ("port", synthetic_trace, run_trace)):
        eng = _engine(lms, side, max_queue=2, shed_policy="deadline")
        reps[side] = run(eng, make(10, 128, **knobs))
    rep = reps["port"]
    assert rep["max_queue"] == 2 and rep["shed_policy"] == "deadline"
    assert rep["rejected"] + rep["expired"] > 0
    assert 0.0 < rep["deadline_miss_rate"] <= 1.0
    assert rep["goodput_tokens_per_sec"] <= rep["tokens_per_sec"]
    keys = [k for k in DETERMINISTIC if k in reps["jax"]]
    assert {k: rep.get(k) for k in keys} == {k: reps["jax"][k] for k in keys}


def test_engine_robustness_knob_validation(lms, tmp_path):
    """``:500``: the overload knobs are validated as in JAX; ``run_trace``
    takes ``snapshot_path`` (removed again on a clean drain)."""
    lm = lms["port"]["slab"]
    with pytest.raises(ValueError, match="shed_policy"):
        ServeEngine(lm, block_steps=K, shed_policy="lifo")
    with pytest.raises(ValueError, match="max_queue"):
        ServeEngine(lm, block_steps=K, max_queue=-1)
    with pytest.raises(ValueError, match="block_time_ms"):
        ServeEngine(lm, block_steps=K, block_time_ms=0.0)
    eng = ServeEngine(lm, block_steps=K)
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.submit(_prompts(1)[0], 4, deadline_ms=-1.0)
    with pytest.raises(ValueError, match="ttft_deadline_ms"):
        eng.submit(_prompts(1)[0], 4, ttft_deadline_ms=0)
    path = tmp_path / "snap.json"
    assert run_trace(eng, [], snapshot_path=str(path))["requests_completed"] == 0
    assert not path.exists()


def test_async_cancel_and_deadline_exact(lms):
    """``test_async_loop.py:177``: cancel and deadline expiry drain the
    pipeline first, so the partials they cut equal the synchronous loop's;
    the greedy streams and every finish reason equal JAX's."""
    p = _prompts(3, seed=9)
    submits = [dict(prompt=p[0], max_new_tokens=20),
               dict(prompt=p[1], max_new_tokens=20, arrival_block=1, deadline_ms=1),
               dict(prompt=p[2], max_new_tokens=6, arrival_block=1)]
    results = {}
    for side in ("jax", "port"):
        for async_loop in (False, True):
            eng = _engine(lms, side, "paged", block_time_ms=100.0, async_loop=async_loop)
            rids = [eng.submit(**kw) for kw in submits]
            eng.run(max_blocks=2)
            cancelled = eng.cancel(rids[0])
            eng.run()
            results[side, async_loop] = ({c.request_id: (c.tokens.tolist(), c.finish_reason)
                                          for c in eng.completed}, cancelled)
    assert results["port", True] == results["port", False] == results["jax", False]
    assert results["jax", True] == results["jax", False]
    assert [fr for _t, fr in results["port", True][0].values()].count("expired") == 1


def test_async_run_trace_reports_gap_surface(lms):
    """``test_async_loop.py:261``: ``run_trace`` reports the pipeline: the
    gap between a block's fetch and the next launch is 0 in the pipelined
    loop and positive in the synchronous one; totals are the same."""
    reports = {}
    for async_loop in (False, True):
        eng = _engine(lms, "port", async_loop=async_loop)
        reports[async_loop] = run_trace(eng, synthetic_trace(
            6, 128, prompt_lens=(8,), max_new_tokens=8, mean_interarrival_blocks=0.5, seed=3))
    assert reports[True]["async_loop"] is True and reports[False]["async_loop"] is False
    assert reports[True]["interblock_gap_ms_mean"] == 0.0
    assert reports[True]["interblock_gap_ms_p99"] == 0.0
    assert reports[False]["interblock_gap_ms_mean"] > 0.0
    assert reports[True]["fetch_blocked_ms_mean"] is not None
    for k in ("requests_completed", "total_generated_tokens", "program_calls"):
        assert reports[True][k] == reports[False][k], k
