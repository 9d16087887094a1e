"""The host-memory KV tier: the port's ``HostPageTier``, the tier half of
``RadixPrefixIndex``/``PagedKVCache`` and ``ServeEngine(host_tier_pages=)``.

The JAX oracle tests of ``tests/test_kv_tier.py`` on the port (``:118,
136, 165, 193, 210, 223, 240, 268, 299, 322, 354, 386, 440, 458, 484``;
the router case at ``:417`` waits for the router): streams served through
spill and restore, restore failures and corrupt tier copies (re-prefill),
a snapshot of a tiered engine, and in-place repair of a corrupted device
page from its tier copy are bit-identical to an untiered engine on a pool
large enough never to evict (fp32, fused and stepwise, greedy and
sampled); chaos drains the pool and the tier to zero. Streams are
compared exactly. One test holds the tier's decisions on the pressure
workload (greedy) against the JAX engine's: the same spills, restores,
hits and streams.

Tiny model: 2 layers, hidden 32, 3 slots, pages of 4, a 13-page pool (3
scratch + 10), a 32-page tier, K = 4. One intra-op thread.
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
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import Request, ServeEngine
from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
from neuronx_distributed_tpu_torch.inference.paged_cache import HostPageTier, TierCorruption
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3, page_size=4)
K = 4
PAGE = 4
SMALL_POOL = 13
TIER = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stack():
    """The port's big-pool lm (the untiered oracle), its small-pool lm, and
    the JAX small-pool lm, on one weight set."""
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    big = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM)
    small = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", page_pool_pages=SMALL_POOL,
                     **LM)
    return {"big": big, "small": small, "jcfg": jcfg, "params": params}


def _family(seed, n_tails, tail=8):
    """Prompts over one shared 8-token prefix (two full pages)."""
    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, 127, (8,)).astype(np.int32)
    return [np.concatenate([prefix, rs.randint(1, 127, (tail,)).astype(np.int32)])
            for _ in range(n_tails)]


def _pressure_submits(greedy_only=False):
    """An A-family request, a B-family burst that spills A's prefix out of
    the small pool, then A again (a restore on the hit)."""
    a, b = _family(1, 2), _family(2, 3)
    hot = None if greedy_only else Sampler(temperature=1.1)
    back = None if greedy_only else Sampler(temperature=0.8)
    return ([dict(prompt=a[0], max_new_tokens=8)]
            + [dict(prompt=p, max_new_tokens=8, arrival_block=4, sampler=hot if i == 1 else None)
               for i, p in enumerate(b)]
            + [dict(prompt=a[1], max_new_tokens=8, arrival_block=12, sampler=back)])


def _streams(eng):
    return {c.request_id: c.tokens.tolist() for c in eng.completed}


def _run(lm, submits, **kw):
    eng = ServeEngine(lm, block_steps=K, seed=42, **kw)
    for s in submits:
        eng.submit(**s)
    eng.run(max_blocks=300)
    return eng


def _drain_all(pkv):
    pkv.prefix.drop_tiered()
    pkv.prefix.evict(10 ** 6)


@pytest.fixture(scope="module")
def oracle(stack):
    return _streams(_run(stack["big"], _pressure_submits()))


# --- exactness ---------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_tiered_streams_bit_identical_across_modes(stack, oracle, fused):
    """``:118``: spills, restores and tier hits happen, and every stream
    equals the untiered big-pool run's; pool and tier drain to zero."""
    eng = _run(stack["small"], _pressure_submits(), fused=fused, host_tier_pages=TIER)
    pkv = eng.session.paged
    assert pkv.tier_spilled_pages > 0 and pkv.tier_restored_pages > 0 and pkv.tier_hits > 0
    assert _streams(eng) == oracle
    _drain_all(pkv)
    assert pkv.allocator.in_use() == 0 and pkv.tier_pages() == 0


def test_tier_decisions_match_jax(stack):
    """The pressure workload, greedy, against the JAX engine: the same
    streams, spills, restores, hits and drops."""
    jlm = JaxLM(stack["jcfg"], stack["params"], jl.LlamaForCausalLM, buckets=(8, 16),
                max_batch=3, page_size=PAGE, page_pool_pages=SMALL_POOL).compile()
    subs = _pressure_submits(greedy_only=True)
    ref = JaxEngine(jlm, block_steps=K, rng=jax.random.key(42), host_tier_pages=TIER)
    for s in subs:
        ref.submit(**s)
    ref.run(max_blocks=300)
    eng = _run(stack["small"], subs, host_tier_pages=TIER)
    keys = ("tier_spilled_pages", "tier_restored_pages", "tier_hits", "evicted_pages",
            "prefix_hits", "prefix_hit_tokens", "pages_in_use_peak")
    assert {k: getattr(eng.session.paged, k) for k in keys} == {
        k: ref.session.paged.stats[k] for k in keys}
    assert _streams(eng) == _streams(ref)
    assert eng.session.paged.tier_pages() == ref.session.paged.tier_pages() > 0


def test_restore_mid_chunked_prefill_exact(stack):
    """``:136``: a chunked admission whose shared prefix sits in the tier:
    ``begin_chunked`` restores it, the chunks prefill the rest, and the
    stream equals the untiered run's."""
    a = _family(5, 2, tail=8)
    long_tail = _family(5, 1, tail=8)[0]
    submits = [dict(prompt=a[0], max_new_tokens=6),
               dict(prompt=a[1], max_new_tokens=6, arrival_block=3),
               dict(prompt=long_tail, max_new_tokens=6, arrival_block=8,
                    sampler=Sampler(temperature=1.2))]
    oracle = _streams(_run(stack["big"], submits, prefill_chunk_tokens=5))
    eng = ServeEngine(stack["small"], block_steps=K, prefill_chunk_tokens=5, seed=42,
                      host_tier_pages=TIER)
    for s in submits[:2]:
        eng.submit(**s)
    eng.run()
    pkv = eng.session.paged
    assert pkv.prefix.spill(10 ** 6) > 0 and pkv.allocator.in_use() == 0
    eng.submit(**submits[2])
    eng.run()
    assert pkv.tier_restored_pages > 0 and eng.chunk_program_calls > 0
    assert _streams(eng) == oracle


def test_snapshot_of_tiered_engine_restores_bit_identical(stack, oracle):
    """``:165``: the snapshot keeps the tier knob and none of its content;
    the restored engine starts with an empty tier and its streams, with
    those delivered before the snapshot, equal the untiered run's."""
    eng = ServeEngine(stack["small"], block_steps=K, seed=42, host_tier_pages=TIER)
    for s in _pressure_submits():
        eng.submit(**s)
    for _ in range(6):
        eng.step_block()
    snap = json.loads(json.dumps(eng.snapshot()))
    assert snap["config"]["host_tier_pages"] == TIER
    assert "tier" not in json.dumps(snap["requests"])
    pre = _streams(eng)
    restored = ServeEngine.from_snapshot(stack["small"], snap)
    assert restored.host_tier_pages == TIER and restored.session.paged.tier_pages() == 0
    restored.run()
    assert {**pre, **_streams(restored)} == oracle


# --- the tier seam and the ladder ----------------------------------------------------


def test_restore_failure_degrades_to_reprefill_exact(stack, oracle):
    """``:193``: every restore fails; admission re-prefills the suffix,
    nothing is shed, the streams equal the oracle's."""
    eng = _run(stack["small"], _pressure_submits(), host_tier_pages=TIER,
               faults=FaultPlan(seed=3, tier_restore_fail_prob=1.0))
    pkv = eng.session.paged
    assert eng._injector.stats["tier_restore_faults"] > 0
    assert pkv.tier_restore_failures > 0 and pkv.tier_restored_pages == 0
    assert not eng.rejected
    assert _streams(eng) == oracle


def test_corrupted_tier_bytes_caught_by_checksum_exact(stack, oracle):
    """``:210``: garbled tier bytes fail their crc32, the copy is dropped
    and the admission re-prefills."""
    eng = _run(stack["small"], _pressure_submits(), host_tier_pages=TIER,
               faults=FaultPlan(seed=7, tier_corrupt_prob=1.0))
    assert eng._injector.stats["tier_corruptions"] > 0
    assert eng.session.paged.tier.checksum_failures > 0
    assert _streams(eng) == oracle


def test_tier_fault_plan_replayed_twice_identical(stack):
    """``:223``: the same tier plan decides the same twice: streams, engine,
    injector and tier counters."""
    runs = []
    for _ in range(2):
        eng = _run(stack["small"], _pressure_submits(), host_tier_pages=TIER,
                   faults=FaultPlan(seed=11, tier_restore_fail_prob=0.4, tier_corrupt_prob=0.3))
        pkv = eng.session.paged
        runs.append((_streams(eng), eng.decode_blocks, eng.inserts, eng.deferred_admissions,
                     dict(eng._injector.stats),
                     [getattr(pkv, k) for k in ("tier_spilled_pages", "tier_restored_pages",
                                                "tier_hits", "tier_restore_failures",
                                                "evicted_pages")]))
    assert runs[0] == runs[1]


def test_corrupt_device_page_repaired_from_inclusive_tier_copy(stack):
    """``:240``: a corrupted device page whose entry keeps a host copy is
    rewritten in place: no replay, and the live stream reading through it
    stays bit-identical."""
    a = _family(9, 2)
    golden = _streams(_run(stack["big"], [dict(prompt=a[0], max_new_tokens=6),
                                          dict(prompt=a[1], max_new_tokens=12)]))
    eng = ServeEngine(stack["small"], block_steps=K, seed=42, host_tier_pages=TIER)
    r0 = eng.submit(a[0], 6)
    eng.run()
    pkv = eng.session.paged
    pkv.prefix.spill(10 ** 6)
    r1 = eng.submit(a[1], 12)
    eng.step_block()
    assert pkv.tier_restored_pages > 0
    victims = [n.page for n in pkv.prefix._iter_nodes() if n.page >= 0 and n.tier_id is not None]
    assert victims
    eng.inject_page_corruption(victims[:1])
    assert eng.tier_page_repairs == 1 and eng.corrupt_page_replays == 0
    assert eng.injected_corruptions == 1
    eng.run()
    assert _streams(eng) == {r0: golden[0], r1: golden[1]}


def test_chaos_storm_tiered_allocator_and_tier_drain_to_zero(stack):
    """``:268``: every engine seam armed on a tiered small pool: the streams
    equal the no-fault big-pool run's, and the allocator and the tier both
    drain to zero."""
    submits = _pressure_submits()
    oracle = _streams(_run(stack["big"], submits, prefill_chunk_tokens=5))
    eng = _run(stack["small"], submits, prefill_chunk_tokens=5, host_tier_pages=TIER,
               dispatch_retries=8, dispatch_backoff_s=0.0,
               faults=FaultPlan(seed=1, pool_exhaust_prob=0.3, pool_storm_len=2,
                                dispatch_fail_prob=0.25, dispatch_max_failures=2,
                                corrupt_page_prob=0.3, tier_restore_fail_prob=0.15,
                                tier_corrupt_prob=0.1))
    assert not eng.queue and not eng._prefilling and not eng._replay_q
    inj = eng._injector.stats
    assert inj["alloc_faults"] > 0 and inj["pages_corrupted"] > 0
    assert _streams(eng) == oracle
    pkv = eng.session.paged
    _drain_all(pkv)
    assert pkv.allocator.in_use() == 0 and pkv.tier_pages() == 0 and pkv.tier_bytes() == 0


# --- index and scheduler units -------------------------------------------------------


def test_peek_reports_tiered_hit_without_restore_or_lru_touch(stack):
    """``:299``: ``peek``/``prefix_peek`` see tiered entries (page -1)
    without touching the LRU clock, taking holds or restoring."""
    a = _family(13, 1, tail=8)
    eng = ServeEngine(stack["small"], block_steps=K, seed=42, host_tier_pages=TIER)
    eng.submit(a[0], 4)
    eng.run()
    pkv = eng.session.paged
    pkv.prefix.spill(10 ** 6)
    stamps = {id(n): n.last_used for n in pkv.prefix._iter_nodes()}
    pages = pkv.prefix.peek(a[0].tolist())
    assert len(pages) >= 2 and all(p == -1 for p in pages[:2])
    assert pkv.prefix_peek(a[0].tolist()) >= 2 * PAGE
    assert pkv.tier_restored_pages == 0
    assert {id(n): n.last_used for n in pkv.prefix._iter_nodes()} == stamps
    assert pkv.allocator.in_use() == 0


def test_evictable_spillable_reclaimable_counts(stack):
    """``:322``: evictable counts device pages (tiered entries pin no
    ancestor), spillable every cache-only device page, reclaimable the
    ladder's reach (spillable with a tier, evictable without)."""
    a = _family(15, 1, tail=8)
    eng = ServeEngine(stack["small"], block_steps=K, seed=42, host_tier_pages=TIER)
    eng.submit(a[0], 4)
    eng.run()
    pkv = eng.session.paged
    dev = sum(1 for n in pkv.prefix._iter_nodes() if n.page >= 0)
    assert dev >= 4
    assert (pkv.prefix.evictable_pages() == pkv.prefix.spillable_pages()
            == pkv.prefix.reclaimable_pages() == dev)
    pkv.prefix.spill(2)
    assert pkv.prefix.evictable_pages() == pkv.prefix.spillable_pages() == dev - 2
    untiered = ServeEngine(stack["small"], block_steps=K, seed=42)
    untiered.submit(a[0], 4)
    untiered.run()
    pu = untiered.session.paged
    assert pu.prefix.spillable_pages() == 0
    assert pu.prefix.reclaimable_pages() == pu.prefix.evictable_pages() > 0


def test_pool_retry_after_spill_vs_oldest_stream_branches(stack):
    """``:354``: a shed whose shortfall one spill covers retries after 1
    block; with the pool pinned by a live stream the estimate is the
    oldest stream's remaining budget."""
    a = _family(17, 2, tail=8)
    eng = ServeEngine(stack["small"], block_steps=K, seed=42, host_tier_pages=TIER)
    r1 = eng.submit(a[0], 20)
    eng.step_block()
    probe = Request(request_id=999, prompt=a[1], max_new_tokens=8)
    assert eng.session.paged.prefix.spillable_pages() == 0
    expect = -(-(20 - len(eng._out[r1])) // K)
    assert eng._pool_retry_after(probe) == max(1, expect) > 1
    eng.run()
    assert eng.session.paged.prefix.spillable_pages() > 0
    assert eng._pool_retry_after(probe) == 1
    untiered = ServeEngine(stack["small"], block_steps=K, seed=42)
    untiered.submit(a[0], 20)
    untiered.step_block()
    assert untiered._pool_retry_after(probe) == max(1, -(-(20 - len(untiered._out[0])) // K))


def test_register_readopts_tiered_entry(stack):
    """``:386``: an admission whose restore failed re-prefills, and the
    fresh pages are adopted back into the tiered entries: the prefix is
    device-resident again."""
    eng = ServeEngine(stack["small"], block_steps=K, seed=42, host_tier_pages=TIER,
                      faults=FaultPlan(seed=19))
    a = _family(21, 2)
    eng.submit(a[0], 4)
    eng.run()
    pkv = eng.session.paged
    pkv.prefix.spill(10 ** 6)
    calls = {"n": 0}

    def fail_once():
        calls["n"] += 1
        return "fail" if calls["n"] == 1 else None

    pkv.tier.fault_hook = fail_once
    eng.submit(a[1], 4)
    eng.run()
    assert pkv.tier_restore_failures >= 1
    assert pkv.prefix_peek(a[1].tolist()) >= 2 * PAGE
    assert all(p >= 0 for p in pkv.prefix.peek(a[1].tolist())[:2])


def test_tier_knob_validation(stack):
    """``:440``: the tier's knobs and the plan's tier pair are checked."""
    with pytest.raises(ValueError, match="host_tier_pages"):
        ServeEngine(stack["small"], block_steps=K, host_tier_pages=-1)
    with pytest.raises(ValueError, match="prefix_cache"):
        lm = CausalLM(stack["small"].config, {k: v for k, v in
                                              stack["small"].model.state_dict().items()},
                      tl.LlamaForCausalLM, buckets=(8, 16), max_batch=3, page_size=PAGE,
                      prefix_cache=False, device="cpu")
        ServeEngine(lm, block_steps=K, host_tier_pages=8)
    with pytest.raises(ValueError, match="<= 1"):
        FaultPlan(tier_restore_fail_prob=0.7, tier_corrupt_prob=0.7)
    with pytest.raises(ValueError, match=">= 1 page"):
        HostPageTier(0)


def test_host_page_tier_store_checksum_and_lru():
    """``:458``: bytes round-trip; a garbled entry raises
    ``TierCorruption`` and leaves; past capacity the coldest entry is
    dropped and reported; a "corrupt" verdict garbles a copy, so an array
    handed out earlier (a copy in flight) keeps its bytes."""
    tier = HostPageTier(2)
    d1 = {"k": np.arange(8, dtype=np.float32)}
    t1, ev = tier.put(d1)
    assert ev == [] and len(tier) == 1
    got = tier.get(t1)
    assert np.array_equal(got["k"], d1["k"])
    tier._entries[t1]["data"]["k"].view(np.uint8)[0] ^= 0xFF
    with pytest.raises(TierCorruption):
        tier.get(t1)
    assert len(tier) == 0 and tier.checksum_failures == 1
    ta, _ = tier.put(d1)
    tb, _ = tier.put(d1)
    tier.get(ta)
    tc, dropped = tier.put(d1)
    assert dropped == [tb] and len(tier) == 2 and tier.lru_drops == 1
    assert tier.bytes_used() == 2 * d1["k"].nbytes
    handed = tier.get(tc)["k"]
    before = handed.copy()
    tier.fault_hook = lambda: "corrupt"
    with pytest.raises(TierCorruption):
        tier.get(tc)
    assert np.array_equal(handed, before)


def test_request_timeline_covers_tier_restore_lane(stack):
    """``:484``: the admission that restored spilled pages carries a
    ``tier_restore`` mark with its page count on the request's own
    timeline, between ``submit`` and ``retire``. (The cache-lane events and
    the attribution layer are not ported.)"""
    submits = _pressure_submits()
    eng = ServeEngine(stack["small"], block_steps=K, seed=42, host_tier_pages=TIER, trace=True)
    for s in submits:
        eng.submit(**s)
    eng.run(max_blocks=300)
    pkv = eng.session.paged
    assert pkv.tier_restored_pages > 0
    tl_ = eng.request_timeline(len(submits) - 1)
    names = [e["name"] for e in tl_]
    assert names[0] == "submit" and names[-1] == "retire" and "tier_restore" in names
    ev = next(e for e in tl_ if e["name"] == "tier_restore")
    assert ev["args"]["pages"] > 0 and ev["block"] is not None
    assert any(e["name"] == "tier_pages" for e in eng.tracer.events())
    _drain_all(pkv)
    assert pkv.allocator.in_use() == 0
