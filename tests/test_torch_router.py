"""The port's multi-replica front door (``inference/router.py``), held
against the JAX package's ``Router`` (the counterparts of
``tests/test_router.py``'s tier-1 tests, of the router park case of
``tests/test_conversation_tier.py:505`` and of the router cases of
``tests/test_multilora.py:295-345`` and ``tests/test_structured.py:429``).

- The identity oracle: a router over one replica serves a bare engine's
  streams (slab and paged, fused and stepwise, greedy and sampled).
- The failover oracle: a replica crashing mid-decode (scheduled, or from a
  seeded plan) leaves every stream equal to the no-fault engine's, from the
  router's delivery records or from the replica's last snapshot, and the
  survivor's allocator drains to 0.
- Drain under load and mid-chunked-prefill loses no token.
- Fairness: WFQ holds a compliant tenant near its share against a 10:1
  burst, weights skew service, and tenant-aware shedding takes the
  over-budget tenant's tail.
- The port's fleet makes JAX's decisions: on the same trace the router
  stats, each request's replica, the rejections and the router lanes'
  event names equal the JAX router's, on the tiny model (greedy streams
  equal JAX's too) and over both packages' ``SimCausalLM``.
- Observability, knob validation, the capped requeue of an engine's
  rejection, the failover's timeline and attribution, the fleet-global
  park store, adapter affinity and pin migration, grammar pin migration.
- The full chaos matrix stays ``slow``, as the reference's does.

Greedy streams are compared with JAX's; sampled streams within the port
(the port does not reproduce threefry). Tiny model: 2 layers, hidden 32,
3 slots, pages of 4, K = 4. One intra-op thread.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import Router as JaxRouter
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference import FaultPlan as JaxFaultPlan
from neuronx_distributed_tpu.inference.simlm import SimCausalLM as JaxSim
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import (
    CausalLM,
    FaultPlan,
    Rejected,
    Router,
    Sampler,
    ServeEngine,
    run_router_trace,
    synthetic_trace,
)
from neuronx_distributed_tpu_torch.inference.grammar import default_token_table, detokenize
from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM
from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.observability import validate_chrome_trace

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

    def port(**kw):
        return CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM, **kw)

    return {"tcfg": tcfg, "sd": sd, "c": port(), "p": port(page_size=PAGE),
            "jax_c": JaxLM(jcfg, params, jl.LlamaForCausalLM, **LM).compile(),
            "jax_p": JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=PAGE, **LM).compile()}


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


def _run(router, submits, **run_kw):
    for s in submits:
        router.submit(**s)
    router.run(**run_kw)
    return router


def _decisions(router):
    """What the router decided: its stats, the replica each completed
    request retired on, the rejected ids and the replicas' states."""
    where = {c.request_id: i for i, e in enumerate(router.engines) for c in e.completed}
    return (dict(router.stats), where, sorted(r.request_id for r in router.rejected),
            [s["state"] for s in router.replica_states()])


def _jax_twin(stack, pool, n, submits, jax_plan=None, **kw):
    """The JAX router over the same weights and submissions (greedy ones
    only when ``greedy_only``), run to the end."""
    r = JaxRouter(stack["jax_" + pool], n, rng=jax.random.key(42), block_steps=K,
                  faults=jax_plan, **kw)
    return _run(r, submits, max_blocks=300)


def _drain_allocators(router):
    for eng in router.engines:
        pkv = getattr(eng.session, "paged", None)
        if pkv is None:
            continue
        if pkv.prefix is not None:
            pkv.prefix.evict(10 ** 6)
        yield eng, pkv


# --- the identity oracle --------------------------------------------------------------


def test_router_n1_bit_identical_to_bare_engine(stack):
    """``test_router.py:106``: Router(N=1) == a bare engine, fused and
    stepwise, slab and paged, greedy and sampled; the greedy streams equal
    the JAX router's."""
    submits = _mixed_submits()
    for pool in ("c", "p"):
        for fused in (True, False):
            oracle = _oracle(stack[pool], submits, fused=fused)
            router = _run(Router(stack[pool], 1, seed=42, block_steps=K, fused=fused), submits)
            assert _streams(router) == oracle, (pool, fused)
            router.close()
    greedy = [s for s in submits if "sampler" not in s]
    want = _streams(_jax_twin(stack, "p", 1, greedy))
    got = _streams(_run(Router(stack["p"], 1, seed=42, block_steps=K), greedy))
    assert got == want


# --- the failover oracle --------------------------------------------------------------


def test_scheduled_crash_mid_decode_failover_bit_identical(stack):
    """``:125``: replica 0 goes dark mid-decode; its streams fail over from
    the router's records and equal the no-fault engine's; the dead replica
    is out, the survivor's allocator drains to 0; the decisions and greedy
    streams equal the JAX router's."""
    submits = _mixed_submits()
    oracle = _oracle(stack["p"], submits)
    router = _run(Router(stack["p"], 2, seed=42, block_steps=K, crash_at=[(3, 0)]), submits,
                  max_blocks=300)
    assert router.stats["crashes"] == 1 and router.stats["failovers"] == 1
    assert router.stats["failed_over_requests"] >= 1
    assert router.last_failover_ms is not None
    assert _streams(router) == oracle
    states = {s["replica"]: s["state"] for s in router.replica_states()}
    assert states == {0: "dead", 1: "live"}
    assert router.engines[0].session.state is None     # its device state went back
    for eng, pkv in _drain_allocators(router):
        if eng is router.engines[1]:
            assert pkv.allocator.in_use() == 0
    twin = _jax_twin(stack, "p", 2, submits, crash_at=[(3, 0)])
    assert _decisions(router) == _decisions(twin)
    assert _streams(router)[0] == _streams(twin)[0]


def test_failover_from_snapshot_when_router_keeps_no_records(stack):
    """``:152``: with ``record_streams=False`` the replay starts from the
    crashed replica's last snapshot: still the no-fault streams."""
    submits = _mixed_submits()
    oracle = _oracle(stack["p"], submits)
    router = _run(Router(stack["p"], 2, seed=42, block_steps=K, crash_at=[(4, 0)],
                         record_streams=False, snapshot_every_blocks=2), submits, max_blocks=300)
    assert router.stats["failovers"] == 1 and router.stats["snapshots_taken"] >= 2
    assert _streams(router) == oracle


def test_seeded_plan_crash_replayed_twice_identical(stack):
    """``:171``: the replica-crash seam is plan-driven: the same plan over
    the same work crashes the same replica at the same block twice, and
    the JAX router's injector makes the same draw."""
    submits = _mixed_submits()
    oracle = _oracle(stack["p"], submits)
    runs = []
    for _ in range(2):
        router = _run(Router(stack["p"], 2, seed=42, block_steps=K,
                             faults=FaultPlan(seed=11, replica_crash_prob=0.35)), submits,
                      max_blocks=300)
        assert router._injector.stats["replica_crashes"] == 1
        assert _streams(router) == oracle
        runs.append((_streams(router), dict(router.stats), dict(router._injector.stats)))
    assert runs[0] == runs[1]
    twin = _jax_twin(stack, "p", 2, submits,
                     jax_plan=JaxFaultPlan(seed=11, replica_crash_prob=0.35))
    assert runs[0][1] == dict(twin.stats)
    assert runs[0][2]["replica_crashes"] == twin._injector.stats["replica_crashes"]


# --- graceful drain -------------------------------------------------------------------


def test_drain_under_load_loses_zero_tokens(stack):
    """``:196``: drain a replica holding queued and decoding work: the
    queued work migrates, the decoding streams finish in place, the
    replica parks with an empty snapshot and allocator, its session is
    closed; the streams equal the no-drain engine's and the decisions the
    JAX router's."""
    p = _prompts(8, seed=21)
    submits = [dict(prompt=p[i], max_new_tokens=8 + (i % 3)) for i in range(8)]
    oracle = _oracle(stack["p"], submits)

    def drive(router):
        for s in submits:
            router.submit(**s)
        router.step_block()
        router.drain(0)
        router.run(max_blocks=300)
        return router

    router = drive(Router(stack["p"], 2, seed=42, block_steps=K))
    assert _streams(router) == oracle
    assert router.stats["drains"] == 1 and router.last_drain_ms is not None
    assert router.snapshots[0]["requests"] == []
    states = {s["replica"]: s["state"] for s in router.replica_states()}
    assert states[0] == "drained" and router.engines[0].session.state is None
    for _eng, pkv in _drain_allocators(router):
        assert pkv.allocator.in_use() == 0
    assert not router.engines[0].queue and not router.engines[0].has_decode_work()
    twin = drive(JaxRouter(stack["jax_p"], 2, rng=jax.random.key(42), block_steps=K))
    assert _decisions(router) == _decisions(twin)
    assert _streams(router) == _streams(twin)


def test_drain_migrates_mid_chunked_prefill_atomically(stack):
    """``:227``: a drain catches a long prompt mid-chunked-prefill: the
    admission rolls back and finishes on the peer, streams exact, no page
    leaked."""
    p16 = _prompts(1, s=16, seed=23)[0]
    p8 = _prompts(2, seed=25)
    submits = [dict(prompt=p8[0], max_new_tokens=10), dict(prompt=p8[1], max_new_tokens=10),
               dict(prompt=p16, max_new_tokens=6, sampler=Sampler(temperature=1.1))]
    oracle = _oracle(stack["p"], submits, prefill_chunk_tokens=5)
    router = Router(stack["p"], 2, seed=42, block_steps=K, prefill_chunk_tokens=5,
                    placement="round_robin")
    for s in submits:
        router.submit(**s)
    router.step_block()
    victim = next((i for i, eng in enumerate(router.engines) if eng._prefilling), None)
    assert victim is not None, "schedule drifted: no in-flight chunk"
    router.drain(victim)
    router.run(max_blocks=300)
    assert _streams(router) == oracle
    assert router.stats["drain_migrated_requests"] >= 1
    for _eng, pkv in _drain_allocators(router):
        assert pkv.allocator.in_use() == 0


# --- fairness and tenants -------------------------------------------------------------


def test_wfq_share_within_10pct_at_10to1_offered_load(stack):
    """``:257``: two equal-weight tenants offer 10:1 load into a saturated
    fleet: the compliant tenant is served as if alone and, while both are
    backlogged, gets 40-60 % of the tokens."""
    router = Router(stack["c"], 2, seed=42, block_steps=K, trace=True)
    big, small = _prompts(30, seed=27), _prompts(3, seed=29)
    for i in range(30):
        router.submit(big[i], 8, tenant="burst")
    for i in range(3):
        router.submit(small[i], 8, tenant="compliant")
    router.run()
    comps = router.completed
    assert len(comps) == 33
    done_block = {c.request_id: c.ttft_blocks + c.decode_blocks for c in comps}
    by_tenant = {}
    for c in comps:
        by_tenant.setdefault(c.tenant, []).append(c)
    assert max(c.ttft_blocks for c in by_tenant["compliant"]) <= max(
        c.ttft_blocks for c in by_tenant["burst"]) / 3
    cutoff = max(done_block[c.request_id] for c in by_tenant["compliant"])
    tenant_of = {c.request_id: c.tenant for c in comps}
    share = {"burst": 0, "compliant": 0}
    for rid, evs in router.tracer.by_request().items():
        t = tenant_of.get(rid)
        if t is not None:
            share[t] += sum(1 for ev in evs if ev["name"] == "tok" and ev["block"] < cutoff)
    assert 0.4 <= share["compliant"] / (share["burst"] + share["compliant"]) <= 0.6, share


def test_tenant_weights_skew_service_share(stack):
    """``:306``: at 2:1 weights the heavy tenant admits earlier on
    average."""
    router = Router(stack["c"], 2, seed=42, block_steps=K,
                    tenant_weights={"gold": 2.0, "std": 1.0})
    g, s = _prompts(8, seed=31), _prompts(8, seed=33)
    for i in range(8):
        router.submit(g[i], 8, tenant="gold")
        router.submit(s[i], 8, tenant="std")
    router.run()
    by_tenant = {}
    for c in router.completed:
        by_tenant.setdefault(c.tenant, []).append(c.ttft_blocks)
    assert np.mean(by_tenant["gold"]) < np.mean(by_tenant["std"])


def test_tenant_aware_shed_evicts_over_budget_tail(stack):
    """``:324``: ``max_pending`` overflow sheds the newest requests of the
    tenant furthest over its share; the compliant tenant is never shed;
    the shed ids equal the JAX router's."""
    big, small = _prompts(16, seed=35), _prompts(2, seed=37)

    def drive(router):
        rids = [router.submit(big[i], 8, tenant="burst") for i in range(14)]
        ok = [router.submit(small[i], 8, tenant="compliant") for i in range(2)]
        return rids, ok

    router = Router(stack["c"], 2, seed=42, block_steps=K, max_pending=4)
    rids, ok_small = drive(router)
    shed = [r for r in rids if isinstance(r, Rejected)]
    assert all(isinstance(r, int) for r in ok_small) and shed
    assert shed[0].reason == "tenant_over_budget" and shed[0].retry_after_blocks >= 1
    assert all(router._tenant_of[r.request_id] == "burst" for r in router.rejected)
    twin = JaxRouter(stack["jax_c"], 2, rng=jax.random.key(42), block_steps=K, max_pending=4)
    drive(twin)
    assert [(r.request_id, r.retry_after_blocks) for r in router.rejected] == \
        [(r.request_id, r.retry_after_blocks) for r in twin.rejected]
    router.run()
    assert all(r in {c.request_id for c in router.completed} for r in ok_small)


def test_run_router_trace_reports_per_tenant_surface(stack):
    """``:350``: Zipf-skewed tenants ride the trace; the report carries the
    per-tenant table and the router surface."""
    trace = synthetic_trace(10, 128, prompt_lens=(8,), max_new_tokens=6,
                            mean_interarrival_blocks=0.3, tenants=3, tenant_skew=1.5, seed=7)
    counts = {}
    for item in trace:
        counts[item["tenant"]] = counts.get(item["tenant"], 0) + 1
    assert counts["t0"] == max(counts.values()) and len(counts) > 1
    rep = run_router_trace(Router(stack["p"], 2, seed=42, block_steps=K), trace)
    assert rep["replicas"] == 2 and rep["requests_completed"] == 10 and rep["placements"] == 10
    assert len(rep["replica_states"]) == 2
    assert set(rep["per_tenant"]) == set(counts)
    for t, row in rep["per_tenant"].items():
        assert row["requests"] == counts[t] and row["generated_tokens"] == counts[t] * 6
        assert row["goodput_tokens_per_sec"] is not None


# --- placement ------------------------------------------------------------------------


def test_prefix_affinity_routes_to_hot_replica(stack):
    """``:378``: requests sharing a hot prefix follow it to its replica, and
    ``prefix_peek`` is free (no query counted)."""
    prefix = np.random.RandomState(9).randint(1, 127, (8,)).astype(np.int32)

    def with_prefix(seed):
        tail = np.random.RandomState(seed).randint(1, 127, (8,))
        return np.concatenate([prefix, tail]).astype(np.int32)

    router = Router(stack["p"], 2, seed=42, block_steps=K)
    first = router.submit(with_prefix(1), 8)
    router.step_block()
    home = router._records[first].replica
    assert home is not None
    pkv_home = router.engines[home].session.paged
    router.run()
    queries = pkv_home.prefix_queries
    assert pkv_home.prefix_peek(with_prefix(2).tolist()) == 8
    assert pkv_home.prefix_queries == queries
    followers = [router.submit(with_prefix(s), 4) for s in (2, 3)]
    router.run()
    for rid in followers:
        assert [len(c.tokens) for c in router.completed if c.request_id == rid] == [4]
    assert router.stats["affinity_placements"] == 2
    assert router.engines[1 - home].session.paged.prefix_hits == 0


def test_round_robin_spreads_and_identity_holds(stack):
    """``:413``: round_robin alternates replicas, streams exact."""
    submits = _mixed_submits()
    oracle = _oracle(stack["c"], submits)
    router = _run(Router(stack["c"], 2, seed=42, block_steps=K, placement="round_robin"),
                  submits)
    assert _streams(router) == oracle
    assert all(s["inserted_requests"] >= 1 for s in router.replica_states())


# --- decisions against JAX over the sim model ------------------------------------------


def test_sim_fleet_decisions_and_router_lanes_equal_jax():
    """Over both packages' ``SimCausalLM`` (no device work), one trace with
    shared prefixes, two tenants, a scheduled crash and a bounded backlog:
    the port router's stats, each request's replica, its rejections, the
    replicas' states, the streams and the router lanes' event names (with
    their counts) equal the JAX router's, for every placement policy.
    (The reference's sim cannot snapshot, so a drain is held against JAX
    on the tiny model, ``test_drain_under_load_loses_zero_tokens``.)"""
    trace = synthetic_trace(40, 512, prompt_lens=(8, 12), max_new_tokens=10,
                            mean_interarrival_blocks=0.4, shared_prefix_len=8,
                            prefix_families=2, tenants=2, seed=3)

    def drive(router):
        for item in trace:
            router.submit(item["prompt"], item["max_new_tokens"],
                          arrival_block=item["arrival_block"], tenant=item["tenant"])
        router.run(max_blocks=400)
        return router

    def names(router):
        out = {}
        for ev in router.tracer.events():
            if ev["lane"][0] == "router":
                out[(ev["name"], ev["lane"])] = out.get((ev["name"], ev["lane"]), 0) + 1
        return out

    sim = dict(max_batch=3, buckets=(8, 16, 32), max_seq_len=64, vocab_size=512, page_size=4,
               page_pool_pages=24)
    for placement in ("affinity", "least_loaded", "round_robin"):
        kw = dict(block_steps=K, placement=placement, crash_at=[(4, 0)], trace=True,
                  max_pending=12)
        port = drive(Router(SimCausalLM(**sim), 3, seed=42, **kw))
        ref = drive(JaxRouter(JaxSim(**sim), 3, **kw))
        assert _decisions(port) == _decisions(ref), placement
        assert _streams(port) == _streams(ref)
        assert names(port) == names(ref)
        assert port.stats["failovers"] == 1
    assert port.stats["placements"] >= 40 - len(port.rejected)


# --- observability and validation -----------------------------------------------------


def test_router_trace_lanes_validate(stack, tmp_path):
    """``:431``: the shared tracer carries the router's lanes and each
    replica's; the Chrome export validates; tenant-labelled families live
    on the router's registry."""
    router = Router(stack["p"], 2, seed=42, block_steps=K, trace=True, crash_at=[(3, 0)])
    for s in _mixed_submits():
        router.submit(**s)
    router.step_block()
    router.run(max_blocks=300)
    summary = validate_chrome_trace(router.tracer.export_chrome(str(tmp_path / "t.json")))
    assert {"router", "replica0", "replica1", "req"} <= set(summary["processes"])
    assert {"route_submit", "place", "fault:replica_crash", "heartbeat_miss",
            "failover"} <= summary["names"]
    assert ("replica1", "queue") in {ev["lane"] for ev in router.tracer.events()
                                     if ev["name"] == "queue_depth"}
    prom = router.metrics.to_prometheus()
    assert "router_tenant_requests_total" in prom and 'tenant="default"' in prom


def test_router_knob_validation(stack):
    """``:460``."""
    lm = stack["c"]
    with pytest.raises(ValueError, match="num_replicas"):
        Router(lm, 0)
    with pytest.raises(ValueError, match="placement"):
        Router(lm, 1, placement="random")
    with pytest.raises(ValueError, match="heartbeat_miss_blocks"):
        Router(lm, 1, heartbeat_miss_blocks=0)
    with pytest.raises(ValueError, match="max_pending"):
        Router(lm, 1, max_pending=-1)
    with pytest.raises(ValueError, match="unknown replica"):
        Router(lm, 2, crash_at=[(3, 5)])
    with pytest.raises(ValueError, match="replica_crash_prob"):
        FaultPlan(replica_crash_prob=1.5)
    router = Router(lm, 2, block_steps=K)
    with pytest.raises(ValueError, match="unknown replica"):
        router.drain(7)
    with pytest.raises(ValueError, match="weight"):
        router.set_tenant_weight("t", 0.0)
    router.close()


def test_router_honors_engine_rejection_with_capped_requeue(stack):
    """``:486``: a replica's bounded queue bounces placements; the router
    re-queues with the verdict's backoff and every request completes with
    a lone engine's stream."""
    router = Router(stack["c"], 1, seed=42, block_steps=K, max_queue=1, replica_queue_depth=2)
    p = _prompts(6, seed=41)
    rids = [router.submit(p[i], 6) for i in range(6)]
    assert all(isinstance(r, int) for r in rids)
    router.run(max_blocks=300)
    assert router.stats["requeues"] >= 1
    assert {c.request_id for c in router.completed} == set(rids)
    assert _streams(router) == _oracle(stack["c"], [dict(prompt=p[i], max_new_tokens=6)
                                                    for i in range(6)])


@pytest.mark.slow   # full chaos: crashes and engine seams, paged, two seeds
def test_router_chaos_full_matrix_slow(stack):
    """``:511``."""
    submits = _mixed_submits()
    oracle = _oracle(stack["p"], submits, prefill_chunk_tokens=5)
    for seed in (1, 9):
        router = _run(Router(
            stack["p"], 3, seed=42, block_steps=K, prefill_chunk_tokens=5,
            faults=FaultPlan(seed=seed, replica_crash_prob=0.2, pool_exhaust_prob=0.15,
                             pool_storm_len=2, dispatch_fail_prob=0.1,
                             dispatch_max_failures=2),
            dispatch_retries=8, dispatch_backoff_s=0.0), submits, max_blocks=500)
        assert _streams(router) == oracle, seed
        for eng, pkv in _drain_allocators(router):
            if router._alive[router.engines.index(eng)]:
                assert pkv.allocator.in_use() == 0, seed


def test_request_timeline_and_attribution_cover_failover_replay(stack):
    """``:535``: a stream that died with its replica shows its pre-crash
    tokens, a ``replay_admit`` at the tokens delivered, the resumed stream
    and a retire; attribution charges the gap to ``failover_replay`` and
    its phases sum to the span."""
    router = Router(stack["c"], 2, seed=42, block_steps=K, trace=True, crash_at=[(2, 1)])
    p = _prompts(4, seed=11)
    for i in range(4):
        router.submit(p[i], 24)
    router.run(max_blocks=300)
    assert router.stats["crashes"] == 1 and router.stats["failed_over_requests"] > 0
    replayed = [rid for rid, evs in router.tracer.by_request().items()
                if any(e["name"] == "replay_admit" for e in evs)]
    assert replayed
    tl_ = router.engines[0].request_timeline(replayed[0])
    names = [e["name"] for e in tl_]
    i = names.index("replay_admit")
    resumed_at = tl_[i]["args"]["resumed_at"]
    assert resumed_at > 0 and names[:i].count("tok") == resumed_at
    assert "tok" in names[i:] and names[-1] == "retire"
    att = router.request_attribution(replayed[0])
    assert att["phases_blocks"].get("failover_replay", 0) > 0
    assert sum(att["phases_blocks"].values()) == att["e2e_blocks"]
    assert router.attribution_report()["phases_blocks"]["failover_replay"]["total"] > 0
    assert router.explain_deadline_miss(replayed[0])["missed"] is False


# --- tenants across the fleet ----------------------------------------------------------


@pytest.fixture(scope="module")
def tenant_lm(stack):
    lm = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu",
                  page_size=PAGE, lora_rank=2, lora_slots=3, grammar_slots=3,
                  grammar_states=16, **LM)
    cfg = LoraConfig(r=2, lora_alpha=4.0)
    ad = init_lora(stack["sd"], cfg, torch.Generator().manual_seed(3))
    for v in ad.values():
        v["lora_b"].normal_(generator=torch.Generator().manual_seed(4))
    return lm, ad, cfg


def test_router_parked_conversation_survives_drained_replica(tenant_lm, tmp_path):
    """``test_conversation_tier.py:505``: the park store is fleet-global: a
    conversation parked by a replica that is then drained resumes on the
    survivor with the never-parked fleet's stream."""
    lm, ad, acfg = tenant_lm
    p = _prompts(2, seed=51)
    submits = [dict(prompt=p[0], max_new_tokens=12), dict(prompt=p[1], max_new_tokens=12)]
    solo = Router(lm, 2, seed=42, block_steps=K, park_dir=str(tmp_path / "solo"))
    solo.register_adapter("a0", ad, acfg)
    oracle = _streams(_run(solo, submits))
    solo.close()
    r = Router(lm, 2, seed=42, block_steps=K, park_dir=str(tmp_path / "park"))
    r.register_adapter("a0", ad, acfg)
    rids = [r.submit(**s) for s in submits]
    r.step_block()
    r.step_block()
    parked = next(rid for rid in rids if r._records[rid].replica == 1)
    r.engines[1].park(parked)
    assert parked in r.parked_ids()
    r.drain(1)
    while r.step_block():
        pass
    assert r.resume_parked(parked) == parked
    r.run()
    assert _streams(r) == oracle


def test_router_adapter_affinity_and_replica_states(tenant_lm):
    """``test_multilora.py:295``: placement follows the replica whose pool
    holds the request's adapter; replica_states shows the residency."""
    lm, ad, acfg = tenant_lm
    router = Router(lm, 2, placement="least_loaded", block_steps=K, seed=42)
    router.register_adapter("a0", ad, acfg)
    r0 = router.submit(_prompts(1, seed=61)[0], 4, adapter="a0")
    router.run(max_blocks=4)
    states = router.replica_states()
    homes = [s["replica"] for s in states if s["adapters_resident"]]
    assert len(homes) == 1 and states[homes[0]]["adapters_resident"] == ["a0"]
    r1 = router.submit(_prompts(1, seed=62)[0], 4, adapter="a0", arrival_block=router.blocks)
    router.run()
    placed = {c.request_id: i for i, eng in enumerate(router.engines) for c in eng.completed}
    assert placed[r0] == placed[r1] == homes[0]
    assert router.engines[homes[0]].session.adapters.loads == 1


def test_router_drain_migrates_adapter_pins(tenant_lm):
    """``test_multilora.py:320``: drained queued adapter work migrates with
    its pin; the destination loads the adapter; the stream equals a lone
    engine's under the same request id."""
    lm, ad, acfg = tenant_lm
    p = _prompts(2, seed=63)
    router = Router(lm, 2, placement="least_loaded", block_steps=K, seed=1)
    router.register_adapter("a0", ad, acfg)
    rA = router.submit(p[0], 12, adapter="a0")
    router.step_block()
    src = next(i for i, eng in enumerate(router.engines) if any(r is not None for r in eng.slots))
    rB = router.submit(p[1], 6, adapter="a0", arrival_block=router.blocks + 1)
    router.drain(src)
    comps = {c.request_id: c for c in router.run()}
    assert len(comps[rA].tokens) == 12 and len(comps[rB].tokens) == 6
    assert router.engines[1 - src].session.adapters.is_resident("a0")
    assert router.engines[src].session.adapters.pinned("a0") == 0
    assert src in router.snapshots
    eng = ServeEngine(lm, block_steps=K, seed=1)
    eng.register_adapter("a0", ad, acfg)
    eng.submit(p[1], 6, adapter="a0", request_id=rB)
    assert comps[rB].tokens.tolist() == eng.run()[0].tokens.tolist()


AB_RE, NUM_RE = "a[ab]*b", "[0-9]+"
TABLE = default_token_table(128)


def test_router_fleet_registration_and_drain_migrates_grammar_pins(tenant_lm):
    """``test_structured.py:429``: register_grammar is fleet-wide; drained
    constrained work migrates with its pin; every stream parses, and the
    migrated one equals its lone run."""
    lm, _ad, _acfg = tenant_lm
    p = _prompts(2, seed=65)
    router = Router(lm, 2, placement="least_loaded", block_steps=K, seed=1)
    router.register_grammar("gab", regex=AB_RE)
    router.register_grammar("gnum", regex=NUM_RE)
    rA = router.submit(p[0], 12, grammar="gab", sampler=Sampler(temperature=1.2))
    router.step_block()
    src = next(i for i, eng in enumerate(router.engines) if any(r is not None for r in eng.slots))
    rB = router.submit(p[1], 6, grammar="gnum", arrival_block=router.blocks + 1)
    router.drain(src)
    comps = {c.request_id: c for c in router.run()}
    assert re.fullmatch(AB_RE, detokenize(comps[rA].tokens, TABLE))
    assert re.fullmatch(NUM_RE, detokenize(comps[rB].tokens, TABLE))
    assert router.engines[1 - src].session.grammars.is_resident("gnum")
    assert router.engines[src].session.grammars.pinned("gab") == 0
    eng = ServeEngine(lm, block_steps=K, seed=1)
    eng.register_grammar("gnum", regex=NUM_RE)
    eng.submit(p[1], 6, grammar="gnum", request_id=rB)
    assert comps[rB].tokens.tolist() == eng.run()[0].tokens.tolist()
