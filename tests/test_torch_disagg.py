"""Prefill/decode disaggregation in the port (``inference/disagg.py`` and the
engine's ``role``/handoff seams), held against the JAX package (the
counterparts of ``tests/test_disagg.py`` and of the ``migration`` phase
case of ``tests/test_attribution.py:219``).

- The exactness matrix: a disaggregated fleet's streams equal one
  engine's over the same submissions, fused and stepwise, greedy and
  sampled, prefix hit and cold, with failed and corrupted handoffs
  degrading to a re-prefill; adoption after retirement reuses pages; a
  drained prefill worker's mid-chunk work migrates; a crashed worker on
  either side fails over exactly. Every allocator drains to 0.
- The fleet decides as JAX's does: handoff counts, degradations and
  greedy streams equal the JAX ``DisaggRouter``'s on the same work.
- Handoffs cross the frameworks: a JAX-sealed handoff verifies in the port
  page for page, a port-sealed one in JAX, each under the same leaf paths
  and page shapes; a port decode worker adopts a JAX handoff and decodes
  the JAX engine's greedy stream.
- The report and lanes, the role guards, the ``tp_degree`` and
  ``page_dtype`` stamps, and the ``migration`` phase's sum rule.

Tiny model: 2 layers, hidden 32, 3 slots, pages of 4, K = 4. One intra-op
thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import DisaggRouter as JaxDisagg
from neuronx_distributed_tpu.inference import FaultPlan as JaxFaultPlan
from neuronx_distributed_tpu.inference import KVHandoff as JaxHandoff
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import (
    CausalLM,
    DisaggRouter,
    FaultPlan,
    KVHandoff,
    Request,
    Router,
    Sampler,
    ServeEngine,
    run_disagg_trace,
    synthetic_trace,
)
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.observability import validate_chrome_trace
from neuronx_distributed_tpu_torch.observability.attribution import (
    attribution_report,
    request_attribution,
)

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
K = 4
PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stack():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return {"tcfg": tcfg, "sd": sd,
            "p": CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", page_size=PAGE, **LM),
            "jax": JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=PAGE, **LM).compile()}


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def _mixed_submits():
    p = _prompts(3, seed=5)
    return [dict(prompt=p[0], max_new_tokens=12),
            dict(prompt=p[1], max_new_tokens=8, arrival_block=1, sampler=Sampler(temperature=1.3)),
            dict(prompt=p[2], max_new_tokens=10, arrival_block=1,
                 sampler=Sampler(temperature=0.8))]


def _streams(obj):
    return {c.request_id: c.tokens.tolist() for c in obj.completed}


def _oracle(lm, submits, **kw):
    eng = ServeEngine(lm, block_steps=K, seed=42, **kw)
    for s in submits:
        eng.submit(**s)
    eng.run()
    eng.close()
    return _streams(eng)


def _run(router, submits, max_blocks=300):
    for s in submits:
        router.submit(**s)
    router.run(max_blocks=max_blocks)
    return router


def _drained_to_zero(router):
    for i, eng in enumerate(router.engines):
        if not router._alive[i]:
            continue
        pkv = eng.session.paged
        if pkv.prefix is not None:
            pkv.prefix.evict(10 ** 6)
        assert pkv.allocator.in_use() == 0, (i, pkv.allocator.in_use())


_HANDOFF_KEYS = ("handoffs_sent", "handoffs_adopted", "handoffs_degraded", "handoffs_deferred",
                 "handoff_pages", "placements", "crashes", "failovers", "failed_over_requests",
                 "drains", "drain_migrated_requests")


def _same_as_jax(router, twin, submits):
    """Handoff and placement counts equal the JAX fleet's; so do the greedy
    streams."""
    assert {k: router.stats[k] for k in _HANDOFF_KEYS} == {k: twin.stats[k] for k in _HANDOFF_KEYS}
    mine, theirs = _streams(router), _streams(twin)
    for rid, s in enumerate(submits):
        if "sampler" not in s:
            assert mine[rid] == theirs[rid], rid


# --- the exactness matrix ---------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_disagg_bit_identical_fused_and_stepwise(stack, fused):
    """``test_disagg.py:95``: one prefill and one decode worker serve a
    greedy and sampled staggered workload as one engine does; every
    request's pages travel as a handoff; the counts and greedy streams
    equal the JAX fleet's."""
    submits = _mixed_submits()
    oracle = _oracle(stack["p"], submits, fused=fused)
    router = _run(DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K,
                               fused=fused), submits)
    assert _streams(router) == oracle
    assert router.stats["handoffs_sent"] == router.stats["handoffs_adopted"] == len(submits)
    assert router.stats["handoffs_degraded"] == 0
    assert router.engines[0].handoffs_sent == router.engines[1].handoffs_adopted == 3
    assert router.engines[1].metrics.histogram("serve_handoff_adopt_ms").count == 3
    _drained_to_zero(router)
    twin = _run(JaxDisagg(stack["jax"], 2, prefill_replicas=1, rng=jax.random.key(42),
                          block_steps=K, fused=fused), submits)
    _same_as_jax(router, twin, submits)


def test_disagg_prefix_hit_and_cold_exact(stack):
    """``:116``: the prefill worker's prefix index stays hot (a later
    admission prefills only the suffix), adopted pages register on the
    decode side, streams exact."""
    prefix = np.random.RandomState(9).randint(1, 127, (8,)).astype(np.int32)

    def with_prefix(seed):
        tail = np.random.RandomState(seed).randint(1, 127, (8,))
        return np.concatenate([prefix, tail]).astype(np.int32)

    submits = [dict(prompt=with_prefix(1), max_new_tokens=8),
               dict(prompt=_prompts(1, seed=31)[0], max_new_tokens=8, arrival_block=2,
                    sampler=Sampler(temperature=1.2)),
               dict(prompt=with_prefix(2), max_new_tokens=6, arrival_block=4)]
    oracle = _oracle(stack["p"], submits)
    router = _run(DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K),
                  submits)
    assert _streams(router) == oracle
    pre, dec = router.engines[0].session.paged, router.engines[1].session.paged
    assert pre.prefix_hits >= 1 and dec.adopted_pages >= 6 and dec.prefix.cached_pages >= 2
    _drained_to_zero(router)


def test_handoff_fault_plan_degrades_exact_and_replays_identical(stack):
    """``:149``: failed and corrupted handoffs degrade to a re-prefill; the
    streams stay exact; the same plan replays the same decisions twice,
    and the JAX fleet's injector makes them too."""
    submits = _mixed_submits()
    oracle = _oracle(stack["p"], submits)
    runs = []
    for _ in range(2):
        router = _run(DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K,
                                   faults=FaultPlan(seed=13, migrate_fail_prob=0.35,
                                                    migrate_corrupt_prob=0.35)), submits)
        assert _streams(router) == oracle
        assert router.stats["handoffs_degraded"] >= 1
        assert router.stats["handoffs_adopted"] + router.stats["handoffs_degraded"] == \
            router.stats["handoffs_sent"]
        inj = router._injector.stats
        assert inj["migrate_faults"] + inj["migrate_corruptions"] == \
            router.stats["handoffs_degraded"]
        _drained_to_zero(router)
        runs.append((_streams(router), dict(router.stats), dict(inj)))
    assert runs[0] == runs[1]
    twin = _run(JaxDisagg(stack["jax"], 2, prefill_replicas=1, rng=jax.random.key(42),
                          block_steps=K, faults=JaxFaultPlan(seed=13, migrate_fail_prob=0.35,
                                                             migrate_corrupt_prob=0.35)), submits)
    _same_as_jax(router, twin, submits)
    assert {k: runs[0][2][k] for k in ("migrate_faults", "migrate_corruptions")} == \
        {k: twin._injector.stats[k] for k in ("migrate_faults", "migrate_corruptions")}


def test_adopt_after_retire_page_reuse(stack):
    """``:179``: more adoptions than one decode pool holds at once: freed
    pages are reused and every stream stays exact."""
    p = _prompts(9, seed=17)
    submits = [dict(prompt=p[i], max_new_tokens=12, arrival_block=i // 3) for i in range(9)]
    oracle = _oracle(stack["p"], submits)
    router = _run(DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K),
                  submits, max_blocks=400)
    assert _streams(router) == oracle
    dec = router.engines[1].session.paged
    assert 9 * -(-(8 + 12 + K) // PAGE) > dec.capacity_pages()
    assert router.stats["handoffs_adopted"] == 9
    _drained_to_zero(router)


# --- drain and failover ---------------------------------------------------------------


def test_drain_prefill_worker_migrates_mid_chunk(stack):
    """``:204``: draining a prefill worker mid-chunked-prefill rolls the
    admission back; it finishes through the other prefill worker; the
    drained worker parks with a snapshot, role intact."""
    p16, p8 = _prompts(1, s=16, seed=23)[0], _prompts(2, seed=25)
    submits = [dict(prompt=p8[0], max_new_tokens=10), dict(prompt=p8[1], max_new_tokens=10),
               dict(prompt=p16, max_new_tokens=6, sampler=Sampler(temperature=1.1))]
    oracle = _oracle(stack["p"], submits, prefill_chunk_tokens=5)
    router = DisaggRouter(stack["p"], 3, prefill_replicas=2, seed=42, block_steps=K,
                          prefill_chunk_tokens=5)
    for s in submits:
        router.submit(**s)
    router.step_block()
    victim = next((i for i in range(2) if router.engines[i]._prefilling), None)
    assert victim is not None, "schedule drifted: no in-flight chunk"
    router.drain(victim)
    router.run(max_blocks=400)
    assert _streams(router) == oracle
    assert router.stats["drains"] == 1 and router.stats["drain_migrated_requests"] >= 1
    states = {s["replica"]: s for s in router.replica_states()}
    assert states[victim]["state"] == "drained" and states[victim]["role"] == "prefill"
    assert victim in router.snapshots
    _drained_to_zero(router)


def test_decode_worker_crash_failover_exact(stack):
    """``:237``: a decode worker dies mid-stream; its adopted streams
    replay on the surviving decode worker, exact; the JAX fleet decides
    alike."""
    p = _prompts(4, seed=11)
    submits = [dict(prompt=p[i], max_new_tokens=24) for i in range(4)]
    oracle = _oracle(stack["p"], submits)
    router = _run(DisaggRouter(stack["p"], 3, prefill_replicas=1, seed=42, block_steps=K,
                               crash_at=[(3, 1)]), submits, max_blocks=400)
    assert router.stats["crashes"] == router.stats["failovers"] == 1
    assert router.stats["failed_over_requests"] >= 1
    assert _streams(router) == oracle
    assert {s["replica"]: s["state"] for s in router.replica_states()}[1] == "dead"
    _drained_to_zero(router)
    twin = _run(JaxDisagg(stack["jax"], 3, prefill_replicas=1, rng=jax.random.key(42),
                          block_steps=K, crash_at=[(3, 1)]), submits, max_blocks=400)
    _same_as_jax(router, twin, submits)


def test_prefill_worker_crash_replays_as_fresh_prefill(stack):
    """``:259``: a prefill worker dies mid-chunk: its requests with no token
    delivered replay as fresh prefill work on the other prefill worker."""
    p16, p8 = _prompts(1, s=16, seed=23)[0], _prompts(2, seed=25)
    submits = [dict(prompt=p16, max_new_tokens=8),
               dict(prompt=p8[0], max_new_tokens=8, arrival_block=1,
                    sampler=Sampler(temperature=0.9))]
    oracle = _oracle(stack["p"], submits, prefill_chunk_tokens=5)
    router = _run(DisaggRouter(stack["p"], 3, prefill_replicas=2, seed=42, block_steps=K,
                               prefill_chunk_tokens=5, crash_at=[(1, 0)]), submits,
                  max_blocks=400)
    assert router.stats["crashes"] == router.stats["failovers"] == 1
    assert _streams(router) == oracle
    _drained_to_zero(router)


# --- handoffs across the frameworks ------------------------------------------------------


def _first_handoff(eng):
    while not eng.outbox:
        assert eng.step_block() or eng.outbox
    return eng.outbox[0]


def test_handoffs_verify_across_the_frameworks(stack):
    """A handoff sealed by the JAX prefill worker verifies in the port page
    for page (same leaf paths, page shapes and crc32s), a port-sealed one
    in JAX; corrupting either is caught by both. A port decode worker
    adopts the JAX handoff and decodes the JAX engine's greedy stream."""
    prompt = _prompts(1, s=13, seed=71)[0]
    jeng = JaxEngine(stack["jax"], block_steps=K, rng=jax.random.key(42), role="prefill")
    jeng.submit(prompt, 10)
    jh = _first_handoff(jeng)
    teng = ServeEngine(stack["p"], block_steps=K, seed=42, role="prefill")
    teng.submit(prompt, 10)
    th = _first_handoff(teng)
    assert th.pages == jh.pages == 4 and th.first_token == jh.first_token
    assert [sorted(p) for p in th.payloads] == [sorted(p) for p in jh.payloads]
    assert all(t[k].shape == j[k].shape and t[k].dtype == j[k].dtype
               for t, j in zip(th.payloads, jh.payloads) for k in t)
    # the port's verify on the JAX seal, JAX's on the port's
    as_port = KVHandoff(req=th.req, first_token=jh.first_token, first_ts=0.0, page_size=PAGE,
                        payloads=[dict(p) for p in jh.payloads], crcs=list(jh.crcs))
    as_jax = JaxHandoff(req=jh.req, first_token=th.first_token, first_ts=0.0, page_size=PAGE,
                        payloads=[dict(p) for p in th.payloads], crcs=list(th.crcs))
    assert as_port.verify() and as_jax.verify()
    assert KVHandoff(req=th.req, first_token=0, first_ts=0.0, page_size=PAGE,
                     payloads=jh.payloads).seal().crcs == list(jh.crcs)
    # the port decode worker adopts the JAX pages and goes on as JAX does
    dec = ServeEngine(stack["p"], block_steps=K, seed=42, role="decode")
    assert dec.adopt_handoff(as_port) == "adopted"
    dec.run()
    want = JaxEngine(stack["jax"], block_steps=K, rng=jax.random.key(42))
    want.submit(prompt, 10)
    want.run()
    assert dec.completed[0].tokens.tolist() == want.completed[0].tokens.tolist()
    for h in (as_port, as_jax):
        h.corrupt()
        assert not h.verify()
    for eng in (teng, dec):
        eng.close()


# --- surface and validation -------------------------------------------------------------


def test_run_disagg_trace_report_and_lanes(stack, tmp_path):
    """``:284``: the report's roles, handoff counters and decode-clock keys;
    the decode worker keeps one replay and one fetch a block; the shared
    tracer carries the migrate lanes and validates."""
    trace = synthetic_trace(6, 128, prompt_lens=(8,), max_new_tokens=6,
                            mean_interarrival_blocks=0.5, seed=7)
    router = DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K, trace=True)
    rep = run_disagg_trace(router, trace)
    assert rep["disagg"] is True and rep["prefill_replicas"] == 1 and rep["decode_replicas"] == 1
    assert rep["requests_completed"] == 6
    assert rep["handoffs_sent"] == rep["handoffs_adopted"] == 6
    assert rep["handoff_pages"] >= 12 and rep["adopted_pages"] == rep["handoff_pages"]
    assert rep["handoff_bytes"] > 0 and len(rep["handoff_seal_ms"]) == 6
    assert router.engines[1].metrics.histogram("serve_handoff_adopt_ms").count == 6
    for key in ("itl_p50_ms_decode_clock", "itl_p99_ms_decode_clock", "decode_stall_excess_ms"):
        assert rep[key] is not None
    assert [s["role"] for s in rep["replica_states"]] == ["prefill", "decode"]
    dec = router.engines[1]
    assert dec.replays == dec.host_fetches == dec.decode_blocks > 0
    assert dec.h2d_copies <= dec.decode_blocks
    summary = validate_chrome_trace(router.tracer.export_chrome(str(tmp_path / "d.json")))
    assert {"migrate_send", "migrate_adopt", "migrate:send", "migrate:recv"} <= summary["names"]


def test_disagg_validation_and_role_guards(stack):
    """``:314``."""
    lm_c = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu", buckets=(8,),
                    max_batch=2)
    lm_p = stack["p"]
    with pytest.raises(ValueError, match="paged"):
        DisaggRouter(lm_c, 2)
    with pytest.raises(ValueError, match="prefill_replicas"):
        DisaggRouter(lm_p, 2, prefill_replicas=2)
    with pytest.raises(ValueError, match="prefill_replicas"):
        DisaggRouter(lm_p, 2, prefill_replicas=0)
    with pytest.raises(ValueError, match="role"):
        DisaggRouter(lm_p, 2, role="decode")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(lm_c, role="prefill")
    with pytest.raises(ValueError, match="role"):
        ServeEngine(lm_p, role="hybrid")
    router = DisaggRouter(lm_p, 2, prefill_replicas=1, block_steps=K)
    with pytest.raises(ValueError, match="multi-LoRA"):
        router.submit(_prompts(1)[0], 4, adapter="a0")
    with pytest.raises(ValueError, match="decode worker"):
        router.engines[1].submit(_prompts(1)[0], 4)
    req = Request(request_id=99, prompt=_prompts(1)[0], max_new_tokens=4)
    with pytest.raises(ValueError, match="prefill worker"):
        router.engines[0].resume(req, [1])
    with pytest.raises(ValueError, match="adopt_handoff"):
        router.engines[0].adopt_handoff(None)
    assert Router(lm_p, 1, block_steps=K).replica_states()[0]["role"] == "both"
    assert router.state_summary()["disagg"] == {"prefill_replicas": 1, "handoffs_in_flight": 0}


def test_kv_handoff_seal_verify_corrupt():
    """``:349``."""
    payload = {"['cached_key']": np.arange(24, dtype=np.float32)}
    req = Request(request_id=0, prompt=np.ones((4,), np.int32), max_new_tokens=4)
    h = KVHandoff(req=req, first_token=3, first_ts=0.0, page_size=4, payloads=[payload]).seal()
    assert h.verify() and h.pages == 1 and h.nbytes() == 96 and h.tp_degree == 1
    h.corrupt()
    assert not h.verify()


@pytest.mark.parametrize("stamp, value", [("tp_degree", 4), ("page_dtype", "int8")])
def test_adopt_rejects_a_foreign_stamp(stack, stamp, value):
    """``:363``: a handoff sealed under another TP degree or page dtype is
    refused before any write and degrades to a re-prefill (its bytes still
    verify): the streams stay exact."""
    submits = _mixed_submits()
    oracle = _oracle(stack["p"], submits)
    router = DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K)
    dec = router.engines[1]
    orig, verdicts = dec.adopt_handoff, []

    def forge(h):
        setattr(h, stamp, value)
        out = orig(h)
        verdicts.append((out, h.verify()))
        return out

    dec.adopt_handoff = forge
    _run(router, submits)
    assert _streams(router) == oracle
    assert router.stats["handoffs_degraded"] == len(submits) and router.stats["handoffs_adopted"] == 0
    assert verdicts and all(v == ("degraded", True) for v in verdicts)
    _drained_to_zero(router)


def test_disagg_migration_phase_invariant(stack):
    """``test_attribution.py:219``: the ``migration`` phase (send to adopt,
    or to the degraded handoff's replay) closes the phases-sum-to-span rule
    on a faulted disaggregated run with deferred adoptions."""
    router = DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K, trace=True,
                          faults=FaultPlan(seed=5, migrate_fail_prob=0.3,
                                           migrate_corrupt_prob=0.2))
    rs = np.random.RandomState(3)
    prefix = rs.randint(1, 127, (8,)).astype(np.int32)
    for i in range(6):
        tail = rs.randint(1, 127, (8,)).astype(np.int32)
        router.submit(np.concatenate([prefix, tail]), 12, arrival_block=i // 2,
                      tenant=f"t{i % 2}",
                      sampler=Sampler(temperature=1.1) if i % 3 == 2 else None)
    router.run(max_blocks=400)
    assert router.stats["handoffs_sent"] == 6 and router.stats["handoffs_degraded"] >= 1
    atts = {rid: request_attribution(router.tracer, rid) for rid in range(6)}
    for a in atts.values():
        assert sum(a["phases_blocks"].values()) == a["e2e_blocks"]
    assert any(a["phases_blocks"].get("migration", 0) > 0 for a in atts.values())
    degraded = [a for a in atts.values() if a["annotations"]["migrate_degrades"] > 0]
    assert degraded and all(a["phases_blocks"].get("migration", 0) > 0 for a in degraded)
    rep = attribution_report(router.tracer)
    assert rep["phases_blocks"]["migration"]["total"] == sum(
        a["phases_blocks"].get("migration", 0) for a in atts.values())
