"""Autoscaling in the port (``inference/autoscale.py`` over the router),
held against the JAX package (the counterparts of
``tests/test_autoscale.py``).

- The elasticity oracle: an autoscaled fleet (min 1) serves the streams of
  a fixed fleet and of a bare engine, greedy and sampled, fused paged and
  stepwise slab; a spawned replica is a new session of the shared
  ``CausalLM`` whose programs are built while the others serve.
- The scale events equal the JAX autoscaler's on the same traces (the
  tiny model, and both packages' ``SimCausalLM``), replay twice alike, and
  land on the same blocks in the pipelined loop as in the synchronous one.
- A scale-down drains and parks a snapshot; a later scale-up restores warm
  from it (taking over the closed session's state); a crash inside a
  scale-up window stays exact; a drain carrying adapter and tiered work
  migrates it; disaggregated pools scale apart; the policy's bounds,
  cooldown and validation; the shared ``ReplicaLoad`` card; the scale
  lanes, metrics and incident bundle.

Tiny model: 2 layers, hidden 32, 3 slots, pages of 4, K = 4. One intra-op
thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import AutoscalePolicy as JaxPolicy
from neuronx_distributed_tpu.inference import Autoscaler as JaxAutoscaler
from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import Router as JaxRouter
from neuronx_distributed_tpu.inference.simlm import SimCausalLM as JaxSim
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import (
    AutoscalePolicy,
    Autoscaler,
    CausalLM,
    DisaggRouter,
    FaultPlan,
    Router,
    Sampler,
    ServeEngine,
    run_router_trace,
    synthetic_trace,
    synthetic_trace_stream,
)
from neuronx_distributed_tpu_torch.inference.engine import ReplicaLoad
from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM
from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.observability import (
    default_slos,
    validate_chrome_trace,
    validate_incident_bundle,
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

    def port(**kw):
        return CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM, **kw)

    return {"tcfg": tcfg, "sd": sd, "c": port(), "p": port(page_size=PAGE),
            "jax_p": JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=PAGE, **LM).compile()}


def _streams(obj):
    return {c.request_id: c.tokens.tolist() for c in obj.completed}


def _two_burst(seed_a=1, seed_b=2, gap=40, n=6, max_new=8):
    """A burst at block 0, an idle valley, a burst at ``gap``."""
    tr = synthetic_trace(n, 128, prompt_lens=(8,), max_new_tokens=max_new,
                         mean_interarrival_blocks=0.2, seed=seed_a)
    late = synthetic_trace(n, 128, prompt_lens=(8,), max_new_tokens=max_new,
                           mean_interarrival_blocks=0.2, seed=seed_b)
    for item in late:
        item["arrival_block"] += gap
    return tr + late


_POLICY = dict(min_replicas=1, max_replicas=3, backlog_high_blocks=0.5, up_patience_blocks=1,
               down_utilization=0.5, down_patience_blocks=4, cooldown_blocks=2)


def _policy(cls=AutoscalePolicy, **kw):
    return cls(**{**_POLICY, **kw})


def _submit_all(router, trace):
    for item in trace:
        router.submit(item["prompt"], item["max_new_tokens"],
                      arrival_block=item.get("arrival_block", 0), sampler=item.get("sampler"))


def test_autoscaled_streams_bit_identical_to_fixed_fleet(stack):
    """``test_autoscale.py:132``: streams of an elastic 1 -> 3 fleet equal
    the fixed 3-replica fleet's and the bare engine's; the burst forces a
    scale-up, and each spawned replica holds a session of its own."""
    trace = synthetic_trace(8, 128, prompt_lens=(8,), max_new_tokens=8,
                            mean_interarrival_blocks=0.2, seed=1)
    trace[3]["sampler"] = Sampler(temperature=1.1)
    for lm, fused in ((stack["p"], True), (stack["c"], False)):
        eng = ServeEngine(lm, block_steps=K, seed=42, fused=fused)
        _submit_all(eng, trace)
        eng.run()
        oracle = _streams(eng)
        eng.close()
        fixed = Router(lm, 3, seed=42, block_steps=K, fused=fused)
        _submit_all(fixed, trace)
        fixed.run()
        assert _streams(fixed) == oracle
        fixed.close()
        auto = Router(lm, 1, seed=42, block_steps=K, fused=fused, autoscaler=Autoscaler(_policy()))
        _submit_all(auto, trace)
        auto.run()
        assert _streams(auto) == oracle, (lm.paged, fused)
        assert [e for e in auto.autoscaler.scale_events if e["action"] == "up"]
        states = {id(e.session.state) for e in auto.engines if e.session.state is not None}
        assert len(auto.engines) > 1 and len(states) == len(auto.engines)
        assert auto.last_spawn["spawn_ms"] >= 0
        auto.close()


def test_scale_events_replay_twice_identical_and_equal_jax(stack):
    """``:168``: one (trace, policy, seed) replays to the same events and
    streams; the JAX autoscaler makes the same events on the same trace."""

    def run_once():
        r = Router(stack["p"], 1, seed=42, block_steps=K, autoscaler=Autoscaler(_policy()))
        _submit_all(r, _two_burst())
        r.run()
        r.close()
        return r

    a, b = run_once(), run_once()
    assert a.autoscaler.scale_events == b.autoscaler.scale_events and a.autoscaler.scale_events
    assert _streams(a) == _streams(b)
    twin = JaxRouter(stack["jax_p"], 1, rng=jax.random.key(42), block_steps=K,
                     autoscaler=JaxAutoscaler(_policy(JaxPolicy)))
    _submit_all(twin, _two_burst())
    twin.run()
    assert a.autoscaler.scale_events == twin.autoscaler.scale_events
    assert a.autoscaler.time_to_ready_blocks(a) == twin.autoscaler.time_to_ready_blocks(twin)
    assert _streams(a) == _streams(twin)


def test_async_fleet_scales_on_same_block_as_sync(stack):
    """``:187``: the pipelined fleet's scale events land on the same blocks
    as the synchronous fleet's (the staleness credit), streams alike."""

    def run_once(async_loop):
        r = Router(stack["p"], 1, seed=42, block_steps=K, async_loop=async_loop,
                   autoscaler=Autoscaler(_policy(up_patience_blocks=2)))
        _submit_all(r, _two_burst())
        r.run()
        r.close()
        return r

    sync, pipe = run_once(False), run_once(True)
    assert sync.autoscaler.scale_events and \
        pipe.autoscaler.scale_events == sync.autoscaler.scale_events
    assert _streams(pipe) == _streams(sync)


def test_sim_fleet_scale_events_equal_jax():
    """Over both packages' ``SimCausalLM``: a bursty trace on a classic
    fleet gives the JAX autoscaler's events, time to ready and streams (the
    scale-down parks rely on the port sim's snapshot; the reference's sim
    cannot snapshot, so its fleet here never drains: both run with
    ``down_patience_blocks`` past the trace)."""
    trace = synthetic_trace(60, 512, prompt_lens=(8, 16), max_new_tokens=12,
                            mean_interarrival_blocks=0.2, burst_every=24, seed=5)
    sim = dict(max_batch=3, buckets=(8, 16), max_seq_len=64, vocab_size=512, page_size=4,
               page_pool_pages=24)
    runs = []
    for router_cls, sim_cls, pol_cls, scaler_cls, kw in (
            (Router, SimCausalLM, AutoscalePolicy, Autoscaler, dict(seed=42)),
            (JaxRouter, JaxSim, JaxPolicy, JaxAutoscaler, {})):
        r = router_cls(sim_cls(**sim), 1, block_steps=K, **kw,
                       autoscaler=scaler_cls(_policy(pol_cls, max_replicas=4,
                                                     down_patience_blocks=10 ** 6)))
        _submit_all(r, trace)
        r.run(max_blocks=600)
        runs.append((r.autoscaler.scale_events, r.autoscaler.time_to_ready_blocks(r),
                     _streams(r), dict(r.stats)))
    assert runs[0] == runs[1]
    assert sum(e["action"] == "up" for e in runs[0][0]) >= 2


def test_park_unpark_snapshot_roundtrip_bit_identity(stack):
    """``:215``: the scale-down parks a snapshot and closes the replica's
    session; the second burst's scale-up restores warm from the snapshot
    (a new engine object, the parked state taken over); the round trip
    serves the fixed fleet's streams."""
    trace = _two_burst()
    fixed = Router(stack["p"], 3, seed=42, block_steps=K)
    _submit_all(fixed, trace)
    fixed.run()
    fixed.close()
    auto = Router(stack["p"], 1, seed=42, block_steps=K, autoscaler=Autoscaler(_policy()))
    _submit_all(auto, trace)
    first_spawn = None
    while auto.step_block():
        if first_spawn is None and len(auto.engines) > 1:
            first_spawn = auto.engines[1]
    assert _streams(auto) == _streams(fixed)
    evs = auto.autoscaler.scale_events
    acts = [e["action"] for e in evs]
    assert "down" in acts and "parked" in acts, acts
    warm = [e for e in evs if e["action"] == "up" and e["warm"]]
    assert warm and auto.stats["warm_spawns"] >= 1
    i = warm[0]["replica"]
    assert i in auto.snapshots and auto.engines[i] is not first_spawn
    assert sum(len(c.tokens) for c in auto.completed) == \
        sum(len(c.tokens) for c in fixed.completed)


def test_replica_crash_during_scaleup_chaos(stack):
    """``:253``: a seeded crash can fire only with two live replicas, so
    inside a scale-up window; streams equal the bare engine's, live
    allocators drain to 0, and the run replays alike."""
    trace = _two_burst()
    eng = ServeEngine(stack["p"], block_steps=K, seed=42)
    _submit_all(eng, trace)
    eng.run()
    oracle = _streams(eng)
    eng.close()

    def run_once():
        r = Router(stack["p"], 1, seed=42, block_steps=K, autoscaler=Autoscaler(_policy()),
                   faults=FaultPlan(replica_crash_prob=0.4, max_replica_crashes=1, seed=9))
        _submit_all(r, trace)
        r.run()
        return r

    a = run_once()
    assert a.stats["crashes"] == 1 and _streams(a) == oracle
    assert [e for e in a.autoscaler.scale_events if e["action"] == "up"]
    for i, e in enumerate(a.engines):
        if not a._alive[i]:
            continue
        if e.session.paged.prefix is not None:
            e.session.paged.prefix.drop_tiered()
            e.session.paged.prefix.evict(10 ** 6)
        assert e.session.paged.allocator.in_use() == 0, i
    a.close()
    b = run_once()
    assert b.autoscaler.scale_events == a.autoscaler.scale_events and _streams(b) == oracle
    b.close()


def test_scale_down_drain_migrates_pinned_adapters_and_tiered_prefixes(stack):
    """``:296``: an autoscaler's drain on a tiered multi-LoRA fleet catches
    a chunked admission of an adapter request, rolls it back and re-places
    it (the pin released at the source); a late request on a family the
    victim's radix held streams exactly as the bare engine serves it."""
    lm = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu",
                  page_size=PAGE, lora_rank=4, lora_slots=3, **LM)
    acfg = LoraConfig(r=4)
    adapters = {}
    for i in range(2):
        ad = init_lora(stack["sd"], acfg, torch.Generator().manual_seed(100 + i))
        for j, v in enumerate(ad[k] for k in sorted(ad)):
            v["lora_b"].copy_(0.05 * torch.randn(v["lora_b"].shape,
                                                 generator=torch.Generator().manual_seed(200 + j)))
        adapters[f"a{i}"] = ad
    rs = np.random.RandomState(3)
    fam = [rs.randint(1, 127, (8,)).astype(np.int32) for _ in range(2)]

    def submits():
        rs2 = np.random.RandomState(5)
        out = [dict(prompt=np.concatenate([fam[i % 2], rs2.randint(1, 127, (4,))
                                           .astype(np.int32)]), max_new_tokens=8)
               for i in range(9)]
        out += [dict(prompt=rs2.randint(1, 127, (24,)).astype(np.int32), max_new_tokens=8,
                     adapter=f"a{i % 2}", arrival_block=12) for i in range(3)]
        out.append(dict(prompt=np.concatenate([fam[0], rs2.randint(1, 127, (4,))
                                               .astype(np.int32)]),
                        max_new_tokens=8, adapter="a0", arrival_block=40))
        return out

    def fill(target):
        for n, ad in adapters.items():
            target.register_adapter(n, ad, acfg)
        for kw in submits():
            target.submit(**kw)

    eng = ServeEngine(lm, block_steps=K, seed=42, host_tier_pages=8, prefill_chunk_tokens=4)
    fill(eng)
    eng.run()
    oracle = _streams(eng)
    eng.close()
    auto = Router(lm, 1, seed=42, block_steps=K, host_tier_pages=8, prefill_chunk_tokens=4,
                  autoscaler=Autoscaler(_policy(down_patience_blocks=3, down_utilization=0.6)))
    fill(auto)
    auto.run()
    assert _streams(auto) == oracle
    assert any(e["action"] == "down" for e in auto.autoscaler.scale_events)
    assert auto.stats["drain_migrated_requests"] >= 1
    assert sum(int(e.prefill_aborts) for e in auto.engines) >= 1
    for i in auto._drained:
        pool = auto.engines[i].session.adapters
        assert not any(pool.pinned(n) for n in pool.resident)
    assert sum(e.session.adapters.loads for e in auto.engines) > 0


def test_disagg_pools_scale_independently(stack):
    """``:374``: each role pool runs its own policy; both grow; the role
    table extends with the engines; streams exact."""
    trace = _two_burst()
    eng = ServeEngine(stack["p"], block_steps=K, seed=42)
    _submit_all(eng, trace)
    eng.run()
    oracle = _streams(eng)
    eng.close()
    pols = {r: _policy(max_replicas=2, backlog_high_blocks=0.3, down_patience_blocks=4)
            for r in ("prefill", "decode")}
    rd = DisaggRouter(stack["p"], 2, prefill_replicas=1, seed=42, block_steps=K,
                      autoscaler=Autoscaler(per_role=pols))
    _submit_all(rd, trace)
    rd.run()
    assert _streams(rd) == oracle
    assert {e["role"] for e in rd.autoscaler.scale_events if e["action"] == "up"} == \
        {"prefill", "decode"}
    assert len(rd.roles) == len(rd.engines) > 2
    assert all(rd.engines[i].role == role for i, role in enumerate(rd.roles))
    rd.close()


def test_policy_bounds_cooldown_and_validation(stack):
    """``:405``."""
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(backlog_high_blocks=0), dict(down_utilization=1.0)):
        with pytest.raises(ValueError):
            AutoscalePolicy(**bad)
    pol = _policy(max_replicas=2, cooldown_blocks=4)
    r = Router(stack["p"], 1, seed=42, block_steps=K, autoscaler=Autoscaler(pol))
    _submit_all(r, synthetic_trace(10, 128, prompt_lens=(8,), max_new_tokens=8,
                                   mean_interarrival_blocks=0.1, seed=4))
    r.run()
    assert len(r.engines) <= 2
    blocks = [e["block"] for e in r.autoscaler.scale_events
              if e["action"] in ("up", "down") and e["reason"] != "min_replicas"]
    assert all(b2 - b1 >= pol.cooldown_blocks for b1, b2 in zip(blocks, blocks[1:]))
    assert len(r._live_replicas()) >= pol.min_replicas
    r.close()


def test_replica_load_struct_is_shared_surface(stack):
    """``:437``: one ``ReplicaLoad`` feeds placement, the policy, the
    replica cards and the incident state card."""
    eng = ServeEngine(stack["p"], block_steps=K, seed=0, host_tier_pages=4,
                      slos=default_slos(target=0.9))
    load = eng.load_summary()
    assert isinstance(load, ReplicaLoad)
    assert load.role == "both" and load.free_slots == 3 and load.backlog == 0
    assert load.est_ttft_blocks == 0 and load.pages_in_use == 0 and load.pages_free is not None
    assert load.tier_pages == 0 and load.adapters_resident is None and load.slo_alerting is False
    eng.submit(np.arange(1, 9, dtype=np.int32), 12)
    eng.step_block()
    busy = eng.load_summary()
    assert busy.active_slots == 1 and busy.pages_in_use > 0
    assert eng.state_summary()["load"] == busy.to_dict()
    eng.close()
    r = Router(stack["p"], 2, seed=0, block_steps=K)
    states = r.replica_states()
    assert [s["replica"] for s in states] == [0, 1]
    for s in states:
        assert s["state"] == "live"
        for key in ("role", "est_ttft_blocks", "free_slots", "backlog", "pages_free",
                    "tier_pages", "adapters_resident", "slo_alerting"):
            assert key in s, key
    r.close()


def test_scale_observability_lanes_metrics_and_incident(stack, tmp_path):
    """``:473``: scale decisions on the ``("router", "scale")`` lane, the
    ``serve_replicas_active`` gauge and a valid ``scale`` incident bundle;
    the report's autoscale section on a streamed trace."""
    r = Router(stack["p"], 1, seed=42, block_steps=K, trace=True, incident_dir=str(tmp_path),
               autoscaler=Autoscaler(_policy()))
    _submit_all(r, _two_burst())
    r.run()
    names = {ev["name"] for ev in r.tracer.events() if ev["lane"] == ("router", "scale")}
    assert {"scale_up", "replicas_active", "scale_down", "scale_parked"} <= names, names
    validate_chrome_trace(r.tracer.export_chrome(str(tmp_path / "trace.json")))
    assert dict(r.metrics.snapshot())["serve_replicas_active"]["samples"][0]["value"] >= 1
    bundles = [p for p in r.incident.bundles if "_scale_" in p]
    assert bundles and validate_incident_bundle(bundles[0])["kind"] == "scale"
    r.close()
    r2 = Router(stack["p"], 1, seed=42, block_steps=K, autoscaler=Autoscaler(_policy()))
    rep = run_router_trace(r2, synthetic_trace_stream(6, 128, prompt_lens=(8,), max_new_tokens=6,
                                                      mean_interarrival_blocks=0.2, seed=1))
    assert rep["autoscale"]["scale_ups"] >= 1
    assert rep["autoscale"]["time_to_ready_blocks_mean"] is not None and rep["replica_blocks"] > 0
    r2.close()
