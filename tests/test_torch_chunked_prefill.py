"""Chunked prefill, ``cancel`` and the synthetic trace of the port's
``ServeEngine``, against the port's own one-shot admission and against the
JAX package (mirrors ``tests/test_chunked_prefill.py``).

One seeded flax init is carried over with ``llama_params_from_jax``; fp32
on both sides, 2 layers, hidden 64, pages of 4 tokens, buckets (8, 16),
3 slots, K = 4. Within the port, chunked and one-shot admission must give
bit-identical streams on the slab, on fp32 pages and on int8 pages, with
chunks narrower than a page among them. Against the JAX engine, the same
synthetic trace must give the same greedy completions and the same
admission and first-token blocks for every request, one-shot and chunked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference import paged_cache as jpc
from neuronx_distributed_tpu.inference.engine import synthetic_trace as jax_trace
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import paged_cache as tpc
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
PAGE = 4
K = 4
CHUNK = 5   # misaligned with both the pages and the buckets
TRACE = dict(prompt_lens=(5, 8, 11), max_new_tokens=6, mean_interarrival_blocks=0.5,
             long_prompt_frac=0.25, long_prompt_len=16, seed=3)


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, sd


@pytest.fixture(scope="module")
def lms(weights):
    """The port's slab, fp32-page and int8-page lms on one weight set."""
    _, tcfg, _, sd = weights
    mk = lambda **kw: CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM, **kw)  # noqa: E731
    return {"slab": mk(), "paged": mk(page_size=PAGE, paged_attn_kernel=True),
            "int8": mk(page_size=PAGE, page_dtype="int8")}


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX engine (fp32 pages, its Pallas decode kernel in interpret
    mode) over ``TRACE``, one-shot and chunked: per request, its tokens and
    its queue, first-token and decode blocks."""
    jcfg, _, params, _ = weights
    jlm = JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=PAGE, paged_attn_kernel=True,
                **LM).compile()
    trace = jax_trace(10, TINY["vocab_size"], **TRACE)
    return {chunk: _run(JaxEngine(jlm, block_steps=K, prefill_chunk_tokens=chunk), trace)
            for chunk in (0, CHUNK)}


def _prompts(n, s, seed):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def _run(engine, trace):
    """Submit ``trace``, run to the end; per request id: (tokens, queue
    blocks, first-token blocks, decode blocks, finish reason)."""
    for it in trace:
        engine.submit(it["prompt"], it["max_new_tokens"], sampler=it.get("sampler"),
                      eos_token_id=it.get("eos_token_id"), arrival_block=it["arrival_block"])
    done = engine.run()
    return {c.request_id: (c.tokens.tolist(), c.queue_blocks, c.ttft_blocks, c.decode_blocks,
                           c.finish_reason) for c in done}


def _mixed():
    """Short prompts decoding while two long ones (12 and 16 tokens, both
    past CHUNK) arrive, greedy and sampled."""
    short = _prompts(2, 8, 5)
    return [dict(prompt=short[0], max_new_tokens=10, arrival_block=0),
            dict(prompt=_prompts(1, 12, 6)[0], max_new_tokens=6, arrival_block=1),
            dict(prompt=short[1], max_new_tokens=7, arrival_block=1,
                 sampler=Sampler(temperature=0.8)),
            dict(prompt=_prompts(1, 16, 7)[0], max_new_tokens=5, arrival_block=2,
                 sampler=Sampler(temperature=1.3))]


def _tokens(res):
    return {r: v[0] for r, v in res.items()}


@pytest.mark.parametrize("mode", ["slab", "paged", "int8"])
def test_chunked_streams_equal_oneshot_within_the_port(lms, mode):
    """Chunks of 5 (misaligned with pages and buckets) and of 3 (narrower
    than a page: later chunks keep writing into an owned page, int8 pages
    requantize its window) give the one-shot streams, greedy and sampled."""
    lm = lms[mode]
    oneshot = _run(ServeEngine(lm, block_steps=K), _mixed())
    for chunk in (CHUNK, 3):
        eng = ServeEngine(lm, block_steps=K, prefill_chunk_tokens=chunk)
        assert _tokens(_run(eng, _mixed())) == _tokens(oneshot), chunk
        assert eng.chunk_program_calls >= 2 * (16 // chunk)
        assert eng.prefill_chunk_tokens_done == 8 + 12 + 8 + 16


@pytest.mark.parametrize("async_loop", [False, True])
@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_trace_completions_and_schedule_match_jax(lms, jax_runs, chunk, async_loop):
    """The same synthetic trace (every 4th request a 16-token prompt) through
    the JAX engine's synchronous loop and the port's, synchronous and
    pipelined: the same greedy tokens, and for every request the same
    queue, first-token and decode blocks (the port's pipelined loop retires
    a budget-finished stream at the block the synchronous loop does)."""
    trace = synthetic_trace(10, TINY["vocab_size"], **TRACE)
    eng = ServeEngine(lms["paged"], block_steps=K, prefill_chunk_tokens=chunk,
                      async_loop=async_loop)
    assert _run(eng, trace) == jax_runs[chunk]
    assert (eng.chunk_program_calls > 0) == bool(chunk)


def test_decode_advances_during_chunked_prefill(lms):
    """While a long prompt prefills 4 tokens a round, the live slot keeps
    emitting K tokens a round (no stall)."""
    eng = ServeEngine(lms["slab"], block_steps=K, prefill_chunk_tokens=4)
    short = eng.submit(_prompts(1, 4, 9)[0], 24)
    assert eng.step_block()
    long_r = eng.submit(_prompts(1, 16, 11)[0], 4)
    rounds = 0
    while long_r not in eng._out and not any(c.request_id == long_r for c in eng.completed):
        before = len(eng._out[short])
        assert eng.step_block()
        assert len(eng._out[short]) >= before + K
        rounds += 1
    assert rounds >= 16 // 4
    eng.run()


def test_pool_exhaustion_mid_chunk_rolls_back_atomically(weights, lms):
    """12 pages (3 scratch): the short tenant holds 7 while it lives, so the
    long prompt's chunked prefill runs out of pages mid-prompt, aborts,
    requeues and completes later; the same happens in the JAX engine, the
    streams equal the slab's, and no page leaks."""
    jcfg, tcfg, params, sd = weights
    kw = dict(page_size=PAGE, page_pool_pages=12, prefix_cache=False, **LM)
    subs = [dict(prompt=_prompts(1, 8, 23)[0], max_new_tokens=16, arrival_block=0),
            dict(prompt=_prompts(1, 16, 25)[0], max_new_tokens=6, arrival_block=1)]
    eng = ServeEngine(CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **kw),
                      block_steps=K, prefill_chunk_tokens=4)
    got = _run(eng, subs)
    jeng = JaxEngine(JaxLM(jcfg, params, jl.LlamaForCausalLM, **kw).compile(), block_steps=K,
                     prefill_chunk_tokens=4)
    assert got == _run(jeng, subs)
    assert eng.prefill_aborts == jeng.stats["prefill_aborts"] >= 1
    assert eng.deferred_admissions >= 1
    assert _tokens(got) == _tokens(_run(ServeEngine(lms["slab"], block_steps=K), subs))
    assert eng.session.paged.allocator.in_use() == 0


def test_chunked_prefix_hit_skips_shared_pages(lms):
    """A sharer's chunked prefill starts after the reused pages (page
    aligned, below its last token), and its stream equals the slab's."""
    p = _prompts(1, 16, 35)[0]
    sharer = p.copy()
    sharer[13:] = (sharer[13:] + 11) % 126 + 1
    eng = ServeEngine(lms["paged"], block_steps=K, prefill_chunk_tokens=CHUNK)
    eng.submit(p, 4)
    eng.run()
    hits, done = eng.session.paged.prefix_hit_tokens, eng.prefill_chunk_tokens_done
    rid = eng.submit(sharer, 6)
    got = {c.request_id: c.tokens.tolist() for c in eng.run()}
    assert eng.session.paged.prefix_hit_tokens - hits == 12
    assert eng.prefill_chunk_tokens_done - done == 16 - 12
    slab = ServeEngine(lms["slab"], block_steps=K)
    want = _run(slab, [dict(prompt=sharer, max_new_tokens=6, arrival_block=0)])
    assert got[rid] == want[0][0]


def test_prompt_beyond_largest_bucket_is_served_chunked(weights, lms):
    """A 20-token prompt (largest bucket 16) is refused one-shot and served
    chunked, the same on the slab and on pages, and as in the JAX engine."""
    jcfg, _, params, _ = weights
    p20 = _prompts(1, 20, 21)[0]
    with pytest.raises(ValueError, match="largest bucket"):
        ServeEngine(lms["slab"], block_steps=K).submit(p20, 4)
    sub = [dict(prompt=p20, max_new_tokens=4, arrival_block=0)]
    results = {m: _run(ServeEngine(lms[m], block_steps=K, prefill_chunk_tokens=8), sub)
               for m in ("slab", "paged")}
    assert len(results["slab"][0][0]) == 4
    assert results["paged"] == results["slab"]
    jlm = JaxLM(jcfg, params, jl.LlamaForCausalLM, **LM).compile()
    assert results["slab"] == _run(JaxEngine(jlm, block_steps=K, prefill_chunk_tokens=8), sub)


@pytest.mark.parametrize("async_loop", [False, True])
def test_cancel_in_every_state(lms, async_loop):
    """cancel() drops a queued request, unwinds one mid-chunked-prefill (slot
    freed, pages back, no completion) and cuts a decoding one short (a
    partial completion); the freed slots then serve a fresh request with
    the stream it has alone."""
    eng = ServeEngine(lms["paged"], block_steps=K, prefill_chunk_tokens=4, async_loop=async_loop)
    pkv = eng.session.paged
    r_dec = eng.submit(_prompts(1, 8, 27)[0], 20)
    r_pre = eng.submit(_prompts(1, 16, 29)[0], 6)
    r_q = eng.submit(_prompts(1, 8, 31)[0], 4, arrival_block=50)
    eng.step_block()
    assert any(st.req.request_id == r_pre for st in eng._prefilling.values())
    assert eng.cancel(r_q)
    assert eng.cancel(r_pre)
    assert not any(st.req.request_id == r_pre for st in eng._prefilling.values())
    eng.step_block()
    assert eng.cancel(r_dec)
    assert not eng.cancel(r_dec)
    assert not eng.cancel(12345)
    (partial,) = eng.completed
    assert partial.request_id == r_dec and partial.finish_reason == "cancelled"
    assert 0 < len(partial.tokens) < 20
    p_new = _prompts(1, 8, 33)[0]
    r_new = eng.submit(p_new, 6)
    got = {c.request_id: c.tokens.tolist() for c in eng.run()}
    want = _run(ServeEngine(lms["slab"], block_steps=K),
                [dict(prompt=p_new, max_new_tokens=6, arrival_block=0)])
    assert got[r_new] == want[0][0]
    assert eng.cancelled == 3
    assert {c.request_id for c in eng.completed} == {r_dec, r_new}
    assert pkv.allocator.in_use() == pkv.prefix.cached_pages


def test_extend_needs_decode_room_and_tables(lms):
    """``extend`` refuses a chunk that would leave no decode room, and a
    paged extend without its block tables."""
    for mode in ("slab", "paged"):
        lm = lms[mode]
        session = lm.start_session()
        with pytest.raises(ValueError, match="no decode room"):
            lm.extend(session, [0], _prompts(1, 8, 1), [8], [56])
    with pytest.raises(ValueError, match="block tables"):
        lms["paged"].extend(lms["paged"].start_session(), [0], _prompts(1, 4, 1), [4], [0])


def test_engine_chunk_and_async_validation(lms):
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        ServeEngine(lms["slab"], block_steps=K, prefill_chunk_tokens=-1)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        ServeEngine(lms["slab"], block_steps=K, prefill_chunk_tokens=32)
    eng = ServeEngine(lms["slab"], block_steps=K, prefill_chunk_tokens=8)
    with pytest.raises(ValueError, match="cache room"):
        eng.submit(_prompts(1, 40, 1)[0], 40)


def test_chunked_page_lifecycle_matches_jax():
    """begin/extend/finish/abort on the port's PagedKVCache and the JAX one,
    step by step: the same owned pages, tables and reuse, a failed extend
    leaving the state untouched, an abort releasing every hold."""
    caches = [m.PagedKVCache(page_size=4, num_pages=12, max_batch=2, max_seq_len=64)
              for m in (jpc, tpc)]
    toks = list(range(1, 15))

    def both(fn):
        return [fn(c) for c in caches]

    st = both(lambda c: c.begin_chunked(toks, reserve_total=20))
    for cov, final, owned in ((3, False, 1), (4, False, 1), (9, False, 3), (14, True, 5)):
        for c, s in zip(caches, st):
            c.extend_chunked(s, cov, final=final)
        assert [len(s.owned) for s in st] == [owned, owned]
    assert st[0].owned == st[1].owned
    assert np.array_equal(caches[0].chunk_table(0, st[0]), caches[1].chunk_table(0, st[1]))
    for c, s in zip(caches, st):
        c.finish_chunked(0, s)
    assert np.array_equal(caches[0].tables, caches[1].tables)
    st2 = both(lambda c: c.begin_chunked(toks[:12] + [99, 98], reserve_total=16))
    assert [s.start for s in st2] == [12, 12] and st2[0].shared == st2[1].shared == st[1].owned[:3]
    for c, s in zip(caches, st2):
        c.abort_chunked(1, s)
        assert s.shared == [] and (c.tables[1] == c.scratch[1]).all()
    st3 = both(lambda c: c.begin_chunked([7] * 9, reserve_total=60))
    for c, s in zip(caches, st3):
        with pytest.raises(Exception, match="chunked prefill needs"):
            c.extend_chunked(s, 9, final=True)
        assert s.owned == []
        c.abort_chunked(1, s)
    assert caches[0].allocator.in_use() == caches[1].allocator.in_use()


@pytest.mark.parametrize("knobs", [
    TRACE,
    dict(prompt_lens=(4, 7), max_new_tokens=5, shared_prefix_len=6, prefix_families=2, seed=1),
    dict(prompt_lens=(9,), tenants=3, tenant_skew=1.5, eos_token_id=2, seed=4),
    dict(prompt_lens=(3, 5), diurnal=0.6, diurnal_period_blocks=8, burst_every=6,
         burst_mult=3.0, mean_interarrival_blocks=1.5, seed=7),
    # the deadline knobs, once refused here, are copied onto every item
    dict(prompt_lens=(5, 8), ttft_deadline_ms=5.0, tenants=2, seed=2),
    dict(prompt_lens=(6,), deadline_ms=9.0, ttft_deadline_ms=2.5, seed=8),
])
def test_synthetic_trace_draws_as_jax(knobs):
    """Every kept knob draws the same prompts, arrivals and tenant labels as
    the JAX trace and copies the same deadlines; the JAX trace's adapter
    labels come from a stream of their own, so asking for them there
    shifts nothing here."""
    mine = synthetic_trace(12, 128, **knobs)
    for ref in (jax_trace(12, 128, **knobs), jax_trace(12, 128, adapters=3, **knobs)):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert np.array_equal(a["prompt"], b["prompt"])
            for key in ("max_new_tokens", "eos_token_id", "arrival_block", "ttft_deadline_ms",
                        "deadline_ms"):
                assert a[key] == b[key]
            assert a.get("tenant") == b.get("tenant")


@pytest.mark.parametrize("knob", [dict(adapters=-1), dict(grammar_frac=0.5)])
def test_synthetic_trace_refuses_knobs_of_features_not_ported(knob):
    """The adapter and grammar knobs are ported now: bad values of them are
    refused as the JAX trace refuses them, and a knob no trace has is a
    TypeError."""
    with pytest.raises(ValueError):
        synthetic_trace(4, 128, **knob)
    with pytest.raises(ValueError):
        jax_trace(4, 128, **knob)
    with pytest.raises(TypeError):
        synthetic_trace(4, 128, no_such_knob=1)
