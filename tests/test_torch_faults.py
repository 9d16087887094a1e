"""Fault injection and dispatch retry: the port's ``faults.py`` and
``ServeEngine(faults=...)`` against the JAX package's.

- ``FaultPlan`` validation, spec parsing and ``resolve_fault_plan``; every
  seam of ``FaultInjector`` draws the reference's schedule (the same
  per-seam seeds), compared call for call with the JAX injector.
- One seeded chaos trace with a host tier (pool storms, dispatch faults,
  corrupted pages, tier read failures and corruptions), the port's
  synchronous and pipelined loops against the JAX synchronous loop on one
  weight set (fp32, 2 layers, hidden 32, 3 slots, pages of 4, a 13-page
  pool, K = 4, greedy): the same completions (tokens and per-request
  blocks), ``FaultInjector.stats`` equal as dicts, the same replays,
  spills, restores, repairs, retries and decode blocks, and the same
  per-request trace event names and faults-lane event names. Exact: no
  tolerance.
- The JAX oracle tests of ``tests/test_serving_faults.py`` on the port
  (``:394, 437, 472, 487, 500``): chaos streams equal the no-fault run and
  the allocator drains, a plan replayed twice decides the same, a dispatch
  failing past its budget raises ``DispatchFailed``, the knobs are checked.

One intra-op thread (the tests share the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import FaultPlan as JaxPlan
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference import faults as jfaults
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import faults as tfaults
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine, run_trace
from neuronx_distributed_tpu_torch.inference.faults import (
    DispatchFailed,
    FaultInjector,
    FaultPlan,
    resolve_fault_plan,
)
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
K = 4
PAGE = 4
SMALL_POOL = 13
TIER = 32
CHAOS_PLAN = dict(seed=1, pool_exhaust_prob=0.3, pool_storm_len=2, dispatch_fail_prob=0.25,
                  dispatch_max_failures=2, corrupt_page_prob=0.3)
TIER_CHAOS = dict(CHAOS_PLAN, tier_restore_fail_prob=0.15, tier_corrupt_prob=0.1)
CHAOS_ENGINE = dict(block_steps=K, prefill_chunk_tokens=5, dispatch_retries=8,
                    dispatch_backoff_s=0.0)
# 12 greedy requests over three shared 8-token prefixes
CHAOS_TRACE = dict(prompt_lens=(6, 10), max_new_tokens=8, mean_interarrival_blocks=1.0,
                   shared_prefix_len=8, prefix_families=3, seed=3)


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
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))

    def port(**kw):
        return CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM, **kw)

    return {"slab": port(), "paged": port(page_size=PAGE),
            "small": port(page_size=PAGE, page_pool_pages=SMALL_POOL),
            "jax_small": JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=PAGE,
                               page_pool_pages=SMALL_POOL, **LM).compile()}


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def _mixed_submits():
    """Greedy, sampled and a chunk-eligible prompt (``test_serving_faults.py:69``)."""
    p = _prompts(2, seed=5)
    return [dict(prompt=p[0], max_new_tokens=12),
            dict(prompt=_prompts(1, s=16, seed=7)[0], max_new_tokens=8, arrival_block=1,
                 sampler=Sampler(temperature=1.3)),
            dict(prompt=p[1], max_new_tokens=10, arrival_block=1,
                 sampler=Sampler(temperature=0.8))]


def _streams(eng):
    return {c.request_id: c.tokens.tolist() for c in eng.completed}


def _run(lm, submits, **kw):
    eng = ServeEngine(lm, seed=42, **kw)
    for s in submits:
        eng.submit(**s)
    eng.run(max_blocks=300)
    return eng


# --- the plan and the injector ------------------------------------------------------


def test_fault_plan_validation_and_spec_parsing(tmp_path):
    """``test_serving_faults.py:487`` and ``test_kv_tier.py:440``: bad
    probabilities, verdict pairs over 1 and empty storms are refused; a
    JSON object (inline or a file) parses; ``to_dict`` is the JAX plan's."""
    with pytest.raises(ValueError, match="pool_exhaust_prob"):
        FaultPlan(pool_exhaust_prob=1.5)
    with pytest.raises(ValueError, match="storm lengths"):
        FaultPlan(pool_storm_len=0)
    with pytest.raises(ValueError, match="tier_restore_fail_prob"):
        FaultPlan(tier_restore_fail_prob=1.5)
    with pytest.raises(ValueError, match="<= 1"):
        FaultPlan(tier_restore_fail_prob=0.7, tier_corrupt_prob=0.7)
    with pytest.raises(ValueError, match="max_replica_crashes"):
        FaultPlan(max_replica_crashes=-1)
    spec = '{"seed": 7, "dispatch_fail_prob": 0.5, "dispatch_max_failures": 2}'
    plan = FaultPlan.from_spec(spec)
    assert plan.seed == 7 and plan.dispatch_fail_prob == 0.5
    assert plan.to_dict() == jfaults.FaultPlan.from_spec(spec).to_dict()
    with pytest.raises(ValueError, match="JSON object"):
        FaultPlan.from_spec("[1, 2]")
    path = tmp_path / "plan.json"
    path.write_text(spec)
    assert resolve_fault_plan(str(path)) == plan == resolve_fault_plan(spec)
    assert resolve_fault_plan(None) is None and resolve_fault_plan("") is None


def _drive(mod, plan_kw):
    """Every seam of one injector of ``mod`` (``faults`` of either
    package), 60 calls each: the decisions and the final stats."""
    inj = mod.FaultInjector(mod.FaultPlan(**plan_kw))
    out = []
    for i in range(60):
        out.append(("alloc", inj.on_alloc(3)))
        try:
            inj.before_dispatch(("insert", "extend", "decode")[i % 3])
            out.append(("dispatch", None))
        except mod.TransientDispatchError as e:
            out.append(("dispatch", str(e)))
        out.append(("corrupt", inj.pages_to_corrupt(list(range(5, 5 + i % 7)))))
        out.append(("replica", inj.replica_crash([0, 1, 2])))
        for seam in ("on_tier_restore", "on_adapter_acquire", "on_grammar_acquire",
                     "on_migrate", "on_park_write", "on_park_read"):
            out.append((seam, getattr(inj, seam)()))
    return out, inj.stats


@pytest.mark.parametrize("seed", [0, 1, 2023])
def test_injector_draws_equal_jax_per_seam(seed):
    """The per-seam ``RandomState`` seeds are the reference's formula, so
    one plan makes the same schedule at every seam in both packages."""
    plan = dict(seed=seed, pool_exhaust_prob=0.3, pool_storm_len=2, dispatch_fail_prob=0.3,
                dispatch_max_failures=2, corrupt_page_prob=0.4, replica_crash_prob=0.2,
                max_replica_crashes=2, tier_restore_fail_prob=0.2, tier_corrupt_prob=0.2,
                adapter_load_fail_prob=0.1, adapter_corrupt_prob=0.2,
                grammar_load_fail_prob=0.2, grammar_corrupt_prob=0.1, migrate_fail_prob=0.2,
                migrate_corrupt_prob=0.2, park_write_fail_prob=0.3, park_read_fail_prob=0.2,
                park_corrupt_prob=0.2)
    port, port_stats = _drive(tfaults, plan)
    ref, ref_stats = _drive(jfaults, plan)
    assert port == ref
    assert port_stats == ref_stats
    assert all(v > 0 for k, v in port_stats.items() if k != "replica_crashes")


def test_injector_seams_are_independent():
    """Draws at one seam never move another seam's schedule."""
    plan = FaultPlan(seed=4, corrupt_page_prob=0.5, dispatch_fail_prob=0.5)
    a, b = FaultInjector(plan), FaultInjector(plan)
    for _ in range(20):
        try:
            b.before_dispatch("decode")
        except tfaults.TransientDispatchError:
            pass
    assert ([a.pages_to_corrupt([1, 2, 3]) for _ in range(30)]
            == [b.pages_to_corrupt([1, 2, 3]) for _ in range(30)])


# --- the chaos trace against the JAX synchronous loop -------------------------------


def _chaos_run(eng):
    trace = synthetic_trace(12, TINY["vocab_size"], **CHAOS_TRACE)
    for it in trace:
        eng.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"])
    eng.run(max_blocks=400)
    return eng


def _chaos_reading(eng, jax_side):
    """What the parity holds equal: completions, injector stats, the
    recovery counts, request-lane and faults-lane event names."""
    pkv = eng.session.paged
    if jax_side:
        counts = {k: pkv.stats[k] for k in ("tier_spilled_pages", "tier_restored_pages",
                                            "tier_repaired_pages", "tier_hits",
                                            "tier_restore_failures", "evicted_pages")}
        counts.update({k: eng.stats[k] for k in ("corrupt_page_replays", "tier_page_repairs",
                                                 "decode_blocks", "inserts",
                                                 "deferred_admissions", "prefill_aborts")})
        counts["dispatch_retries"] = eng.stats["dispatch_retries"]
    else:
        counts = {k: getattr(pkv, k) for k in ("tier_spilled_pages", "tier_restored_pages",
                                               "tier_repaired_pages", "tier_hits",
                                               "tier_restore_failures", "evicted_pages")}
        counts.update({k: getattr(eng, k) for k in ("corrupt_page_replays",
                                                    "tier_page_repairs", "decode_blocks",
                                                    "inserts", "deferred_admissions",
                                                    "prefill_aborts")})
        counts["dispatch_retries"] = eng.dispatch_retry_count
    return dict(
        comps={c.request_id: (c.tokens.tolist(), c.queue_blocks, c.ttft_blocks,
                              c.decode_blocks, c.finish_reason) for c in eng.completed},
        injector=dict(eng._injector.stats), counts=counts,
        events={rid: [ev["name"] for ev in evs] for rid, evs in eng.tracer.by_request().items()},
        faults=[ev["name"] for ev in eng.tracer.events() if ev["lane"][1] == "faults"])


@pytest.fixture(scope="module")
def jax_chaos(lms):
    eng = JaxEngine(lms["jax_small"], rng=jax.random.key(42), faults=JaxPlan(**TIER_CHAOS),
                    host_tier_pages=TIER, trace=True, **CHAOS_ENGINE)
    return _chaos_reading(_chaos_run(eng), True)


@pytest.mark.parametrize("async_loop", [False, True])
def test_chaos_trace_matches_jax(lms, jax_chaos, async_loop):
    eng = ServeEngine(lms["small"], seed=42, faults=FaultPlan(**TIER_CHAOS),
                      host_tier_pages=TIER, trace=True, async_loop=async_loop, **CHAOS_ENGINE)
    got = _chaos_reading(_chaos_run(eng), False)
    for key in ("comps", "injector", "counts", "events", "faults"):
        assert got[key] == jax_chaos[key], key
    # every seam fired and every recovery path ran
    inj, counts = got["injector"], got["counts"]
    assert inj["alloc_faults"] and inj["dispatch_faults"] and inj["pages_corrupted"]
    assert inj["tier_restore_faults"] + inj["tier_corruptions"] > 0
    assert counts["corrupt_page_replays"] and counts["tier_spilled_pages"]
    assert counts["tier_restored_pages"] and counts["dispatch_retries"] == inj["dispatch_faults"]
    assert len(got["comps"]) == 12
    assert all(len(c[0]) == CHAOS_TRACE["max_new_tokens"] for c in got["comps"].values())
    assert {"fault:dispatch", "fault:corrupt_pages"} <= set(got["faults"])
    assert any("corrupt_replay" in names for names in got["events"].values())


def test_chaos_trace_report_carries_fault_surface(lms):
    """``run_trace`` on the chaos engine: the injector's counts and the
    tier's surface are in the report, and equal the engine's counters."""
    eng = ServeEngine(lms["small"], seed=42, faults=FaultPlan(**TIER_CHAOS),
                      host_tier_pages=TIER, **CHAOS_ENGINE)
    rep = run_trace(eng, synthetic_trace(12, TINY["vocab_size"], **CHAOS_TRACE),
                    max_blocks=400)
    pkv = eng.session.paged
    assert rep["fault_stats"] == eng._injector.stats
    assert rep["dispatch_retries"] == eng.dispatch_retry_count > 0
    assert rep["corrupt_page_replays"] == eng.corrupt_page_replays > 0
    assert rep["tier_spilled_pages"] == pkv.tier_spilled_pages > 0
    assert rep["host_tier_pages"] == TIER and rep["tier_restore_ms_p99"] > 0
    assert rep["tier_d2h_copies"] > 0 and rep["tier_h2d_copies"] > 0
    assert rep["requests_completed"] == 12


# --- the JAX oracle tests of test_serving_faults.py, on the port ----------------------


def test_chaos_storm_streams_exact_and_allocator_drains(lms):
    """``:394``: storms at all three seams on greedy and sampled streams;
    every request completes, the streams equal the no-fault run's, every
    retry is counted, and the pool drains after the prefix cache does."""
    submits = _mixed_submits()
    oracle = _streams(_run(lms["paged"], submits, block_steps=K, prefill_chunk_tokens=5))
    eng = _run(lms["paged"], submits, faults=FaultPlan(**CHAOS_PLAN), **CHAOS_ENGINE)
    assert not eng.queue and not eng._prefilling and not eng._replay_q
    assert _streams(eng) == oracle
    inj = eng._injector.stats
    assert inj["alloc_faults"] > 0 and inj["dispatch_faults"] > 0, inj
    assert eng.dispatch_retry_count == inj["dispatch_faults"]
    pkv = eng.session.paged
    pkv.prefix.evict(10 ** 6)
    assert pkv.allocator.in_use() == 0


def test_fault_plan_replayed_twice_identical(lms):
    """``:437``: the same plan over the same requests decides the same:
    streams, engine counters and injector stats."""
    runs = []
    for _ in range(2):
        eng = _run(lms["paged"], _mixed_submits(), faults=FaultPlan(**CHAOS_PLAN),
                   **CHAOS_ENGINE)
        runs.append((_streams(eng), eng.decode_blocks, eng.inserts, eng.dispatch_retry_count,
                     eng.corrupt_page_replays, eng.deferred_admissions,
                     dict(eng._injector.stats)))
    assert runs[0] == runs[1]


def test_dispatch_failure_past_retry_budget_escalates(lms):
    """``:472``: a launch failing past ``dispatch_retries`` raises
    ``DispatchFailed`` after the first try and two retries."""
    eng = ServeEngine(lms["slab"], block_steps=K, dispatch_retries=2, dispatch_backoff_s=0.0,
                      seed=42, faults=FaultPlan(seed=0, dispatch_fail_prob=1.0,
                                                dispatch_max_failures=50))
    eng.submit(_prompts(1, seed=51)[0], 4)
    with pytest.raises(DispatchFailed):
        eng.run(max_blocks=10)
    assert eng.dispatch_retry_count == 3


def test_dispatch_retry_backs_off_exponentially(lms, monkeypatch):
    """The waits between attempts double from ``dispatch_backoff_s``."""
    import neuronx_distributed_tpu_torch.inference.engine as teng

    class ThreeFailures(FaultInjector):
        """The first three launches fail, then none."""

        def before_dispatch(self, kind):
            self.calls = getattr(self, "calls", 0) + 1
            if self.calls <= 3:
                raise tfaults.TransientDispatchError(f"injected {kind} dispatch failure")

    slept = []
    monkeypatch.setattr(teng.time, "sleep", slept.append)
    eng = ServeEngine(lms["slab"], block_steps=K, dispatch_retries=3, dispatch_backoff_s=0.5,
                      seed=42, faults=ThreeFailures(FaultPlan()))
    eng.submit(_prompts(1, seed=51)[0], 4)
    eng.step_block()
    assert slept == [0.5, 1.0, 2.0] and eng.inserts == 1 and eng.dispatch_retry_count == 3


def test_engine_robustness_knob_validation(lms):
    """``:500`` and ``test_kv_tier.py:440``: the fault and tier knobs are
    checked as in JAX."""
    with pytest.raises(ValueError, match="dispatch_retries"):
        ServeEngine(lms["slab"], block_steps=K, dispatch_retries=-1)
    with pytest.raises(ValueError, match="host_tier_pages"):
        ServeEngine(lms["small"], block_steps=K, host_tier_pages=-1)
    with pytest.raises(ValueError, match="paged CausalLM"):
        ServeEngine(lms["slab"], block_steps=K, host_tier_pages=8)
    eng = ServeEngine(lms["slab"], block_steps=K)
    with pytest.raises(ValueError, match="page corruption"):
        eng.inject_page_corruption([0])
    # an injector is taken as it is (its schedule is the run's)
    inj = FaultInjector(FaultPlan(seed=3))
    assert ServeEngine(lms["paged"], block_steps=K, faults=inj)._injector is inj
