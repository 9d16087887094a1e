"""The fused decode block (one CUDA-graph replay a block on the card) on the
CPU, where the same body runs eagerly through the same runner, against
the port's stepwise route and the JAX package.

Tiny fp32 models; one seeded flax init carried over with
``llama_params_from_jax`` where JAX is the reference. What is held:

- fused and stepwise ``ServeEngine`` streams are identical, greedy and
  sampled, on the slab, fp pages and int8 pages;
- a sampled request's stream does not depend on when it is admitted;
- a steady-state block makes one replay and one fetch, a block after an
  admission or a retirement at most one copy more;
- writes past ``max_seq_len`` are dropped as JAX's ``mode="drop"`` drops
  them (pools and tokens against JAX's fused session program);
- ``generate(fused_chunk=K)`` with a tail equals the stepwise port and
  JAX's ``generate(fused_chunk=K)`` on greedy streams;
- the counter-based noise is a pure function of (key, count) with a
  Gumbel's mean and spread, and finite for every hash value.

Tolerances: K/V pools against JAX's atol 1e-5 (fp32 sums in another order
on each side); int8 pools within one int8 step, their scales rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import sampling as js
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.sampling import (
    Sampler,
    SlotSampler,
    counter_gumbel,
    gumbel_from_bits,
    request_seed,
    split_key,
)
from neuronx_distributed_tpu_torch.models import llama as tl


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
MODES = {"slab": {}, "paged": dict(page_size=4, paged_attn_kernel=True),
         "int8": dict(page_size=4, paged_attn_kernel=True, page_dtype="int8")}
POOL_ATOL = 1e-5
SCALE_RTOL = 1e-5


def _jax_params(cfg):
    return meta.unbox(jl.LlamaForCausalLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]


@pytest.fixture(scope="module")
def tiny():
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    return tcfg, tl.init_params(tcfg, torch.Generator().manual_seed(0))


def _lm(tiny, mode, **kw):
    cfg, params = tiny
    return CausalLM(cfg, params, tl.LlamaForCausalLM, buckets=(8, 16), max_batch=4,
                    device="cpu", **{**MODES[mode], **kw})


def _serve(engine, sampled=(), arrivals=(0, 0, 0, 1, 1, 2)):
    rng = np.random.default_rng(11)
    lens, budgets = (12, 7, 14, 10, 5, 9), (6, 9, 5, 7, 8, 4)
    top_k = engine.slot_sampler.top_k
    for i, (n, m, a) in enumerate(zip(lens, budgets, arrivals)):
        engine.submit(rng.integers(1, 127, n), m, arrival_block=a,
                      sampler=Sampler(temperature=0.9, top_k=top_k, greedy=i not in sampled))
    return {c.request_id: c.tokens.tolist() for c in engine.run()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_block_equals_stepwise_bit_for_bit(tiny, mode):
    """Greedy and sampled rows mixed: the fused runner and the per-token
    route give the same streams; sampled rows really sample."""
    lm = _lm(tiny, mode)
    engine = ServeEngine(lm, block_steps=4, top_k=20, seed=3)
    fused = _serve(engine, sampled=(1, 3, 4))
    step = _serve(ServeEngine(lm, block_steps=4, top_k=20, seed=3, fused=False),
                  sampled=(1, 3, 4))
    greedy = _serve(ServeEngine(lm, block_steps=4, top_k=20, seed=3))
    assert fused == step
    assert all(fused[i] == greedy[i] for i in (0, 2, 5))
    assert any(fused[i] != greedy[i] for i in (1, 3, 4))
    assert engine.replays == engine.decode_blocks and engine.nonfinite_logits == 0


def test_sampled_stream_does_not_depend_on_admission_block(tiny):
    """One sampled request (id 7) admitted at block 0 into an empty pool,
    and at block 2 behind greedy work in other slots: the same tokens."""
    lm = _lm(tiny, "paged")
    prompt = np.random.default_rng(5).integers(1, 127, 9)
    alone = ServeEngine(lm, block_steps=4, seed=9)
    alone.submit(prompt, 10, sampler=Sampler(temperature=1.0), request_id=7)
    want = {c.request_id: c.tokens.tolist() for c in alone.run()}[7]
    busy = ServeEngine(lm, block_steps=4, seed=9)
    rng = np.random.default_rng(6)
    for rid in (0, 1):
        busy.submit(rng.integers(1, 127, 12), 16, request_id=rid)
    busy.submit(prompt, 10, sampler=Sampler(temperature=1.0), request_id=7, arrival_block=2)
    got = {c.request_id: c.tokens.tolist() for c in busy.run()}[7]
    assert got == want
    assert want != {c.request_id: c.tokens.tolist()
                    for c in _greedy_alone(lm, prompt)}[7]


def _greedy_alone(lm, prompt):
    e = ServeEngine(lm, block_steps=4, seed=9)
    e.submit(prompt, 10, request_id=7)
    return e.run()


def test_steady_block_is_one_replay_and_one_fetch(tiny):
    """Per decode block: a block that follows no admission or retirement
    makes exactly one replay and one fetch; any other adds at most one
    copy of the slot state."""
    lm = _lm(tiny, "paged")
    engine = ServeEngine(lm, block_steps=4)
    rng = np.random.default_rng(2)
    for n, budget, arrival in ((9, 44, 0), (6, 40, 0), (11, 5, 2), (7, 6, 4)):
        engine.submit(rng.integers(1, 127, n), budget, arrival_block=arrival)
    ops = []
    while True:
        before = (engine.replays, engine.host_fetches, engine.h2d_copies, engine.decode_blocks)
        if not engine.step_block():
            break
        if engine.decode_blocks > before[3]:
            ops.append(tuple(a - b for a, b in zip(
                (engine.replays, engine.host_fetches, engine.h2d_copies), before)))
    steady = [o for o in ops if o[2] == 0]
    assert len(steady) >= 3 and all(o == (1, 1, 0) for o in steady)
    assert all(o[:2] == (1, 1) and o[2] <= 1 for o in ops)
    assert ops[0] == (1, 1, 1)      # the first block follows the admissions


def test_a_later_session_ends_the_earlier_one(tiny):
    """Sessions of one CausalLM are independent (each holds its own device
    state, its graphs bound to its buffers): a later session ends an
    earlier one only once that one is closed, taking over its state, and
    the closed session then raises."""
    lm = _lm(tiny, "paged")
    first = lm.start_session()
    second = lm.start_session()
    assert second.state is not first.state
    lm.step(first, np.zeros(4, np.int32))     # still live beside the second
    state = first.state
    first.close()
    assert lm.start_session().state is state
    with pytest.raises(RuntimeError, match="closed"):
        lm.step(first, np.zeros(4, np.int32))


# --- the cache edge against JAX ----------------------------------------------------


def _jax_pools(cache):
    att = cache["model"]["layers"]["block"]["attention"]
    return {k: np.asarray(v) for k, v in att.items()
            if k.startswith("cached_")}


def _port_pools(lm, mode):
    c = lm._cache
    n = lm.config.page_pool_pages if mode != "slab" else None   # the sink page is the port's own
    out = {"cached_key": np.stack([t[:n].numpy() for t in c.keys]),
           "cached_value": np.stack([t[:n].numpy() for t in c.values])}
    if c.k_scales is not None:
        out["cached_key_scale"] = np.stack([t[:n].numpy() for t in c.k_scales])
        out["cached_value_scale"] = np.stack([t[:n].numpy() for t in c.v_scales])
    return out


def _assert_pools_match(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if g.dtype == np.int8:     # rounding of values a few fp32 places apart
            assert int(np.abs(g.astype(np.int32) - w.astype(np.int32)).max()) <= 1, name
        elif name.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=POOL_ATOL, err_msg=name)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_writes_past_the_cache_edge_drop_as_in_jax(mode):
    """Row 1 starts 3 tokens below ``max_seq_len`` (its table covers every
    logical page, so a clamped write would land on its own live last
    page): a 6-step fused block writes 3 positions, latches done and drops
    the rest, on both sides. Pools and emitted tokens equal JAX's."""
    cfg = dict(TINY, max_seq_len=32)
    jcfg = jl.LlamaConfig(**cfg, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**cfg, dtype=torch.float32)
    params = _jax_params(jcfg)
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    kw = dict(buckets=(8, 32), max_batch=3, **MODES[mode])
    jlm = JaxLM(jcfg, params, jl.LlamaForCausalLM, **kw).compile()
    tlm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **kw)
    steps = 6
    runner = tlm.compile_session_decode_fused(steps)
    jses, tses = jlm.start_session(), tlm.start_session()
    prompts = np.zeros((2, 29), np.int32)
    rng = np.random.default_rng(8)
    prompts[0, :5] = rng.integers(1, 127, 5)
    prompts[1] = rng.integers(1, 127, 29)
    lengths = np.array([5, 29], np.int32)
    slots = np.array([0, 1])
    first = np.asarray(jlm.insert(jses, slots, prompts, lengths=lengths)).argmax(-1)
    tlm.insert(tses, slots, prompts, lengths=lengths)
    tok = np.zeros((3,), np.int32)
    tok[slots] = first
    active = np.array([True, True, False])
    fused = jlm.compile_session_decode_fused(steps, js.SlotSampler(), 0)
    want, jcache, *_ = fused(
        jlm.params, jses.cache, jnp.asarray(tok[:, None]),
        jax.random.split(jax.random.key(0), 3), jnp.zeros((3,), jnp.int32),
        jnp.asarray(jses.lengths.astype(np.int32)), jnp.asarray(active),
        jnp.zeros((3,), bool), jnp.full((3,), -1, jnp.int32), jnp.ones((3,), jnp.float32),
        jnp.ones((3,), bool))
    st = tses.slots
    st.host_field("tok")[:] = tok
    st.host_field("active")[:] = active
    st.host_field("greedy")[:] = 1
    st.dirty = True
    got = runner(tses).numpy()
    np.testing.assert_array_equal(got[:steps], np.asarray(want))
    assert (got[:steps, 1][3:] == 0).all() and (got[:steps, 1][:3] != 0).any()
    np.testing.assert_array_equal(tses.lengths, np.asarray(jses.lengths) + steps)
    _assert_pools_match(_port_pools(tlm, mode), _jax_pools(jcache))


# --- generate(fused_chunk=K) -------------------------------------------------------


def test_generate_fused_chunk_with_tail_matches_stepwise_and_jax():
    """11 new tokens in chunks of 4: 1 + 4 + 4 + a 2-token tail program,
    greedy, with an EOS that cuts one row; against the port's stepwise
    generate and JAX's ``generate(fused_chunk=4)``. Sampled rows: fused
    equals stepwise."""
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = _jax_params(jcfg)
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    prompts = np.random.default_rng(3).integers(1, 127, (3, 8)).astype(np.int32)
    jlm = JaxLM(jcfg, params, jl.LlamaForCausalLM, buckets=(8,), max_batch=4).compile()
    tlm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, buckets=(8,), max_batch=4, device="cpu")
    plain = tlm.generate(prompts, 11)
    eos = int(plain.tokens[1, 4])
    for kw in ({}, dict(eos_token_id=eos)):
        want = jlm.generate(prompts, 11, fused_chunk=4, **kw)
        step = tlm.generate(prompts, 11, **kw)
        got = tlm.generate(prompts, 11, fused_chunk=4, **kw)
        for r in (step, got):
            np.testing.assert_array_equal(r.tokens, want.tokens)
            np.testing.assert_array_equal(r.lengths, want.lengths)
    assert got.lengths[1] <= 5 and (got.tokens[1, got.lengths[1]:] == 0).all()
    assert {"session_fused_k4", "session_fused_k2"} <= set(
        f"session_fused_k{k[0]}" for k in tlm._fused)
    sampler = Sampler(temperature=1.0, top_p=0.9)
    a = tlm.generate(prompts, 11, sampler=sampler, seed=4)
    b = tlm.generate(prompts, 11, sampler=sampler, seed=4, fused_chunk=4)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.tokens != plain.tokens).any()


# --- counter-based noise -----------------------------------------------------------


def _keys(n, seed=0):
    k = np.asarray([split_key(request_seed(seed, r)) for r in range(n)], np.int32)
    return torch.from_numpy(k[:, 0].copy()), torch.from_numpy(k[:, 1].copy())


def test_counter_gumbel_is_a_pure_function_of_key_and_count():
    lo, hi = _keys(8)
    counts = torch.arange(8, dtype=torch.int32)
    a = counter_gumbel(lo, hi, counts, 4096)
    assert torch.equal(a, counter_gumbel(lo, hi, counts, 4096))
    # row r at count c is the same draw wherever it sits in a batch
    perm = torch.tensor([3, 1, 7, 0, 6, 2, 5, 4])
    assert torch.equal(counter_gumbel(lo[perm], hi[perm], counts[perm], 4096), a[perm])
    b = counter_gumbel(lo, hi, counts + 1, 4096)
    assert float((a == b).float().mean()) < 0.01
    c = counter_gumbel(*_keys(8, seed=1), counts, 4096)
    assert float((a == c).float().mean()) < 0.01


def test_counter_gumbel_has_a_gumbel_mean_and_spread():
    """32768 draws: mean within 0.03 of Euler's gamma (about 4 standard
    errors), standard deviation within 0.03 of pi/sqrt(6); draws of
    neighbouring counts uncorrelated (|r| < 0.03)."""
    lo, hi = _keys(8)
    g = counter_gumbel(lo, hi, torch.zeros(8, dtype=torch.int32), 4096).double()
    assert abs(float(g.mean()) - 0.5772156649) < 0.03
    assert abs(float(g.std()) - np.pi / np.sqrt(6)) < 0.03
    g1 = counter_gumbel(lo, hi, torch.ones(8, dtype=torch.int32), 4096).double()
    assert abs(float(np.corrcoef(g.flatten(), g1.flatten())[0, 1])) < 0.03
    # the argmax of logits + noise follows the softmax
    logits = torch.tensor([0.0, 1.0, 2.0, -1.0])
    lo, hi = _keys(20000)
    draws = SlotSampler()(logits.expand(20000, 4), torch.ones(20000),
                          torch.zeros(20000, dtype=torch.bool),
                          counter_gumbel(lo, hi, torch.zeros(20000, dtype=torch.int32), 4))
    freq = torch.bincount(draws.long(), minlength=4).double() / 20000
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits, -1).numpy(), atol=0.015)


def test_gumbel_from_bits_is_finite_at_the_extreme_hash_values():
    """The smallest and largest 32-bit hashes (and those around the top
    bit) map to u in [2**-24, 1 - 2**-24] and finite noise; the largest is
    the one a uniform from the top 24 bits plus 1/2 rounds up to u = 1."""
    bits = torch.tensor([0, 1, 511, 512, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 512,
                         2 ** 32 - 2, 2 ** 32 - 1], dtype=torch.int64)
    g = gumbel_from_bits(bits)
    assert bool(torch.isfinite(g).all()), g
    assert torch.equal(g[:3], g[:1].expand(3)) and torch.equal(g[-3:], g[-1:].expand(3))
    # the ends of the range: u = 2**-24 and u = 1 - 2**-24, in float64
    for v, u in ((0, 2.0 ** -24), (2 ** 32 - 1, 1 - 2.0 ** -24)):
        want = -np.log(-np.log(u))
        assert abs(float(gumbel_from_bits(torch.tensor([v]))) - want) < 1e-5 * abs(want)


def test_counter_gumbel_is_finite_over_a_full_vocab():
    """Llama-3's 128256-token vocabulary, 16 rows at 4 counters each (8.2M
    draws): every value finite, so no sampled token ignores its logits."""
    lo, hi = _keys(16, seed=3)
    for c in range(4):
        g = counter_gumbel(lo, hi, torch.full((16,), c, dtype=torch.int32), 128256)
        assert bool(torch.isfinite(g).all())


def test_page_dtype_accepts_only_compute_dtype_or_int8(tiny):
    cfg, params = tiny
    for bad in ("float32", "bfloat16"):
        with pytest.raises(ValueError, match="page_dtype"):
            CausalLM(cfg, params, tl.LlamaForCausalLM, buckets=(16,), max_batch=2,
                     page_size=4, page_dtype=bad, device="cpu")


def test_slab_writes_at_the_edge_keep_the_last_column(tiny):
    """The model's slab write drops by rewriting column ``idx - 1`` with its
    own value: a 3-token write at positions 62..64 of a 64-slot slab keeps
    62 and 63 and changes no other column."""
    cfg, params = tiny
    dcfg = dataclasses.replace(cfg, decode=True)
    with torch.device("meta"):
        model = tl.LlamaForCausalLM(dcfg)
    model.load_state_dict(params, assign=True)
    cache = model.new_cache(2)
    for t in cache.keys + cache.values:
        t.normal_(generator=torch.Generator().manual_seed(1))
    before = [t.clone() for t in cache.keys]
    cache.cache_index.copy_(torch.tensor([62, 10], dtype=torch.int32))
    with torch.no_grad():
        model(torch.tensor([[5, 6, 7], [8, 9, 10]], dtype=torch.int32), cache)
    for b_, a in zip(before, cache.keys):
        changed = (b_ != a).any(-1).any(-1)             # (b, max_seq_len)
        assert changed[0].nonzero().flatten().tolist() == [62, 63]
        assert changed[1].nonzero().flatten().tolist() == [10, 11, 12]
    assert cache.cache_index.tolist() == [65, 13]
