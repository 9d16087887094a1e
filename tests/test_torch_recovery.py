"""Recovery: snapshot/restore, corrupted-page replay and the pipelined
loop's drain before them, in the port's ``ServeEngine``.

- The JAX oracle tests of ``tests/test_serving_faults.py`` on the port
  (``:296, 322, 359, 418, 453``): a snapshot taken mid-run (through JSON)
  and restored into a fresh engine finishes every stream as the
  uninterrupted run does, for the slab and paged pools, fused and
  stepwise, greedy and sampled; a snapshot mid-chunked-prefill restarts
  the admission; ``run(snapshot_path=)`` writes the file and removes it on
  a clean drain; corrupted pages (from the plan, or injected, their bytes
  really garbled) are replayed to the same streams. All bit-identical in
  fp32 (exact comparison).
- Snapshots cross the frameworks: a JAX snapshot restored by the port, and
  a port snapshot restored by the JAX engine, each finish with the other's
  greedy completions (the seed travels as JAX key data ``[0, seed]``).
- The pipelined loop drains and retires before a snapshot and before a
  corrupted-page recovery: at every round boundary of a run whose streams
  end on EOS, both give the synchronous loop's streams and never a token
  past the EOS.
- A garbled page holds 104729.0 in fp leaves (104960 in bf16) and 127 in
  int8 ones, the values the JAX engine's garble leaves there.

Tiny model: 2 layers, hidden 32, 3 slots, pages of 4, K = 4. One intra-op
thread.
"""

import json
import os

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
from neuronx_distributed_tpu_torch.inference.engine import GARBLE_INT8, ServeEngine, run_trace
from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM
from neuronx_distributed_tpu_torch.models import llama as tl

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

    return {"slab": port(), "paged": port(page_size=PAGE),
            "int8": port(page_size=PAGE, page_dtype="int8"),
            "jax_paged": JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=PAGE,
                               **LM).compile()}


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def _mixed_submits():
    p = _prompts(2, seed=5)
    return [dict(prompt=p[0], max_new_tokens=12),
            dict(prompt=_prompts(1, s=16, seed=7)[0], max_new_tokens=8, arrival_block=1,
                 sampler=Sampler(temperature=1.3)),
            dict(prompt=p[1], max_new_tokens=10, arrival_block=1,
                 sampler=Sampler(temperature=0.8))]


def _greedy_submits():
    p = _prompts(3, seed=61)
    return [dict(prompt=p[0], max_new_tokens=12),
            dict(prompt=_prompts(1, s=16, seed=63)[0], max_new_tokens=9, arrival_block=1),
            dict(prompt=p[1], max_new_tokens=10, arrival_block=1),
            dict(prompt=p[2], max_new_tokens=7, arrival_block=3)]


def _streams(eng):
    return {c.request_id: c.tokens.tolist() for c in eng.completed}


def _engine(lm, **kw):
    return ServeEngine(lm, block_steps=K, seed=42, **kw)


def _oracle(lm, submits, **kw):
    eng = _engine(lm, **kw)
    for s in submits:
        eng.submit(**s)
    eng.run()
    return _streams(eng)


# --- the JAX oracle tests of test_serving_faults.py --------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pool", ["slab", "paged"])
def test_snapshot_restore_bit_identical_matrix(stack, pool, fused):
    """``:296``: two rounds, a snapshot through JSON, a restore into a fresh
    engine (stepwise or fused): the streams before and after equal the
    uninterrupted slab run's, greedy and sampled."""
    submits = _mixed_submits()
    oracle = _oracle(stack["slab"], submits)
    lm = stack[pool]
    eng = _engine(lm)
    for s in submits:
        eng.submit(**s)
    for _ in range(2):
        eng.step_block()
    snap = json.loads(json.dumps(eng.snapshot()))
    pre = _streams(eng)
    restored = ServeEngine.from_snapshot(lm, snap, fused=fused)
    assert restored.restored_requests >= 1 and restored.fused is fused
    restored.run()
    assert {**pre, **_streams(restored)} == oracle


def test_snapshot_mid_chunked_prefill_and_queued(stack):
    """``:322``: a snapshot with one stream decoding, one mid-chunked-prefill
    and one queued; the restore replays, restarts the chunked admission and
    keeps the queue; the streams equal the uninterrupted run's and the pool
    drains."""
    submits = [dict(prompt=_prompts(1, seed=41)[0], max_new_tokens=9),
               dict(prompt=_prompts(1, s=16, seed=43)[0], max_new_tokens=6, arrival_block=1,
                    sampler=Sampler(temperature=1.1)),
               dict(prompt=_prompts(1, seed=45)[0], max_new_tokens=5, arrival_block=4)]
    oracle = _oracle(stack["paged"], submits, prefill_chunk_tokens=5)
    eng = _engine(stack["paged"], prefill_chunk_tokens=5)
    for s in submits:
        eng.submit(**s)
    eng.step_block()
    eng.step_block()
    assert eng._prefilling
    snap = json.loads(json.dumps(eng.snapshot()))
    assert {r["state"] for r in snap["requests"]} == {"decoding", "prefill", "queued"}
    pre = _streams(eng)
    restored = ServeEngine.from_snapshot(stack["paged"], snap)
    restored.run()
    assert {**pre, **_streams(restored)} == oracle
    pkv = restored.session.paged
    pkv.prefix.evict(10 ** 6)
    assert pkv.allocator.in_use() == 0


def test_snapshot_file_roundtrip_and_clean_drain_removes_it(stack, tmp_path):
    """``:359``: ``run(snapshot_path=)`` leaves the file when cut short;
    the restore from it finishes the streams and its clean drain removes
    the file. ``run_trace(snapshot_path=)`` arms the same."""
    path = str(tmp_path / "serve.snap")
    submits = _mixed_submits()
    oracle = _oracle(stack["slab"], submits)
    eng = _engine(stack["slab"])
    for s in submits:
        eng.submit(**s)
    eng.run(max_blocks=2, snapshot_path=path, snapshot_every_blocks=2)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    pre = _streams(eng)
    restored = ServeEngine.from_snapshot(stack["slab"], path)
    restored.run(snapshot_path=path)
    assert not os.path.exists(path)
    assert {**pre, **_streams(restored)} == oracle
    traced = _engine(stack["slab"])
    rep = run_trace(traced, [dict(prompt=s["prompt"], max_new_tokens=s["max_new_tokens"])
                             for s in submits[:1]], snapshot_path=path)
    assert rep["requests_completed"] == 1 and not os.path.exists(path)


def test_chaos_corruption_fires_and_replays_exactly(stack):
    """``:418``: the plan's corruption seam fires; the requests reading
    through a bad page re-prefill and finish as the no-fault run does."""
    p = _prompts(2, seed=47)
    submits = [dict(prompt=p[0], max_new_tokens=20),
               dict(prompt=p[1], max_new_tokens=16, arrival_block=1)]
    oracle = _oracle(stack["paged"], submits)
    eng = _engine(stack["paged"], faults=FaultPlan(seed=5, corrupt_page_prob=0.6))
    for s in submits:
        eng.submit(**s)
    eng.run(max_blocks=300)
    assert eng._injector.stats["pages_corrupted"] > 0 and eng.corrupt_page_replays > 0
    assert _streams(eng) == oracle


def test_injected_page_corruption_physically_garbled_then_replayed(stack):
    """``:453``: the injected page is really garbled (its bytes read the
    garble value, so the replay must rewrite K/V), its index entries go,
    and the stream equals ``generate``'s."""
    p = _prompts(1, seed=49)
    golden = stack["slab"].generate(p, max_new_tokens=12).tokens[0].tolist()
    eng = _engine(stack["paged"])
    rid = eng.submit(p[0], 12)
    eng.step_block()
    slot = next(i for i, r in enumerate(eng.slots) if r is not None)
    victim = eng.session.paged.slot_pages(slot)[0]
    seen = []
    corrupt = eng._corrupt_page_bytes

    def spy(pages):
        corrupt(pages)
        seen.append(float(eng.session.cache.keys[0][pages[0]].min()))

    eng._corrupt_page_bytes = spy
    eng.inject_page_corruption([victim])
    assert seen == [104729.0]
    assert eng.corrupt_page_replays == 1 and eng.injected_corruptions == 1
    assert victim not in eng.session.paged.prefix.peek(p[0].tolist())
    assert {c.request_id: c for c in eng.run()}[rid].tokens.tolist() == golden


def test_garble_values_equal_jax_casts(stack):
    """104729.0 cast to each leaf dtype as JAX casts it: bf16 104960, int8
    127 (JAX saturates; PyTorch's own cast of an out-of-range float to
    int8 is undefined, so the port fills the integer). The int8 pool's
    scales take the fp value."""
    assert float(jnp.asarray(104729.0).astype(jnp.bfloat16)) == 104960.0
    assert int(jnp.asarray(104729.0).astype(jnp.int8)) == GARBLE_INT8 == 127
    eng = _engine(stack["int8"])
    eng._corrupt_page_bytes([5, 6])
    cache = eng.session.cache
    assert bool((cache.keys[1][5:7] == 127).all()) and bool((cache.values[0][6] == 127).all())
    assert bool((cache.k_scales[0][5:7] == 104729.0).all())
    assert int(cache.keys[0][4].abs().max()) == 0     # a neighbour untouched
    pool = torch.zeros((3, 2), dtype=torch.bfloat16)
    pool.index_fill_(0, torch.tensor([1]), 104729.0)
    assert float(pool[1, 0]) == 104960.0


def test_int8_pool_replay_finishes_every_stream(stack):
    """Corruption on an int8 pool: the garbled page (127s and a huge scale)
    is invalidated and its readers replay; every stream finishes with its
    budget (int8 pages are bounded-divergence, not bit-exact, so the
    tokens are not compared)."""
    eng = _engine(stack["int8"], faults=FaultPlan(seed=5, corrupt_page_prob=0.6))
    p = _prompts(2, seed=47)
    eng.submit(p[0], 20)
    eng.submit(p[1], 16, arrival_block=1)
    eng.run(max_blocks=300)
    assert eng.corrupt_page_replays > 0 and eng.nonfinite_logits == 0
    assert sorted(len(t) for t in _streams(eng).values()) == [16, 20]


# --- across the frameworks ------------------------------------------------------------


def test_jax_snapshot_restores_in_the_port(stack):
    """A snapshot of the JAX engine (``rng=key(42)``), taken mid-run, is
    restored by the port: the greedy streams equal the JAX engine's
    uninterrupted run."""
    submits = _greedy_submits()
    ref = JaxEngine(stack["jax_paged"], block_steps=K, rng=jax.random.key(42))
    for s in submits:
        ref.submit(**s)
    ref.run()
    oracle = _streams(ref)
    src = JaxEngine(stack["jax_paged"], block_steps=K, rng=jax.random.key(42))
    for s in submits:
        src.submit(**s)
    for _ in range(3):
        src.step_block()
    snap = json.loads(json.dumps(src.snapshot()))
    assert snap["rng"] == [0, 42]
    restored = ServeEngine.from_snapshot(stack["paged"], snap)
    assert restored.seed == 42 and restored.restored_requests == len(snap["requests"]) > 0
    restored.run()
    assert {**_streams(src), **_streams(restored)} == oracle


def test_port_snapshot_restores_in_jax(stack):
    """A port snapshot (its format the JAX engine's version 1, key for key)
    is restored by the JAX engine, which finishes the port's greedy
    streams."""
    submits = _greedy_submits()
    oracle = _oracle(stack["paged"], submits)
    src = _engine(stack["paged"])
    for s in submits:
        src.submit(**s)
    for _ in range(3):
        src.step_block()
    snap = json.loads(json.dumps(src.snapshot()))
    jsnap = JaxEngine(stack["jax_paged"], block_steps=K, rng=jax.random.key(42)).snapshot()
    assert set(snap) == set(jsnap) and set(snap["config"]) == set(jsnap["config"])
    restored = JaxEngine.from_snapshot(stack["jax_paged"], snap)
    restored.run()
    assert {**_streams(src), **_streams(restored)} == oracle


def test_snapshot_refuses_what_is_not_ported(stack):
    """A snapshot whose request, live or parked, names an adapter the
    restoring ``CausalLM`` has no pool for is refused, and so is an unknown
    version; a sim engine has nothing to snapshot. (Parked conversations
    are ported: ``tests/test_torch_park.py`` restores them.)"""
    src = _engine(stack["paged"])
    src.submit(_prompts(1)[0], 4)
    snap = src.snapshot()
    bad = json.loads(json.dumps(snap))
    bad["requests"][0]["adapter"] = "a"
    with pytest.raises(ValueError, match="adapter"):
        ServeEngine.from_snapshot(stack["paged"], bad)
    parked = json.loads(json.dumps(snap))
    parked["parked"] = [dict(parked["requests"].pop(), state="parked", adapter="a")]
    with pytest.raises(ValueError, match="adapter"):
        ServeEngine.from_snapshot(stack["paged"], parked)
    with pytest.raises(ValueError, match="version"):
        ServeEngine.from_snapshot(stack["paged"], {**snap, "version": 2})
    sim = ServeEngine(SimCausalLM(max_batch=2, buckets=(8,), page_size=4, page_pool_pages=16),
                      block_steps=K)
    with pytest.raises(ValueError, match="sim engines"):
        sim.snapshot()


# --- the pipelined loop drains, then retires ---------------------------------------


def _eos_submits(stack):
    """Greedy requests whose EOS id is a token each one's stream emits
    early (the stream ends on it), mixed with ones ending on budget."""
    p = _prompts(3, seed=71)
    base = [dict(prompt=p[i], max_new_tokens=n) for i, n in enumerate((14, 12, 10))]
    plain = _oracle(stack["paged"], base)
    out = []
    for i, s in enumerate(base):
        toks = plain[i]
        eos = next((t for j, t in enumerate(toks[2:], 2) if t not in toks[:j]), None)
        out.append(dict(s, eos_token_id=eos) if i < 2 and eos is not None else s)
    assert any("eos_token_id" in s for s in out)
    return out


@pytest.mark.parametrize("at", range(1, 6))
def test_async_snapshot_drains_then_retires(stack, at):
    """A snapshot of the pipelined loop at round ``at``: the restored run
    finishes the synchronous loop's streams, each ending at its EOS (a
    stream the drain finished is retired, not replayed past its end)."""
    submits = _eos_submits(stack)
    oracle = _oracle(stack["paged"], submits)
    eng = _engine(stack["paged"], async_loop=True)
    for s in submits:
        eng.submit(**s)
    for _ in range(at):
        eng.step_block()
    snap = json.loads(json.dumps(eng.snapshot()))
    assert not eng._inflight and not eng._first_pending
    pre = _streams(eng)
    assert not set(pre) & {r["request_id"] for r in snap["requests"]}
    restored = ServeEngine.from_snapshot(stack["paged"], snap)
    assert restored.async_loop
    restored.run()
    assert {**pre, **_streams(restored)} == oracle


@pytest.mark.parametrize("at", range(1, 6))
def test_async_corruption_drains_then_retires(stack, at):
    """Every live page corrupted at round ``at`` of the pipelined loop: the
    drain comes first and the streams it finished retire; the rest replay
    to the synchronous loop's streams."""
    submits = _eos_submits(stack)
    oracle = _oracle(stack["paged"], submits)
    eng = _engine(stack["paged"], async_loop=True, trace=True)
    for s in submits:
        eng.submit(**s)
    for _ in range(at):
        eng.step_block()
    live = eng.session.paged.live_pages()
    if live:
        eng.inject_page_corruption(live)
    eng.run()
    got = _streams(eng)
    assert got == oracle
    # only unfinished streams replayed: each resumed short of its end
    replays = [(ev["lane"][1], ev["args"]["delivered"]) for ev in eng.tracer.events()
               if ev["name"] == "corrupt_replay"]
    assert len(replays) == eng.corrupt_page_replays
    assert all(delivered < len(got[rid]) for rid, delivered in replays)
    assert eng.host_fetches == eng.replays
