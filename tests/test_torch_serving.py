"""The port's ServeEngine against the JAX package's, end to end.

One seeded flax init is carried over with ``llama_params_from_jax``. The
same greedy requests (staggered arrivals, a shared prompt prefix, more
requests than slots) go through the JAX ``ServeEngine`` and the port's,
both paged with ``paged_attn_kernel=True`` at ``max_batch=4`` (the Pallas
kernel in interpret mode on the JAX side, its plain twin here). fp32 on
both sides: the token streams must be identical, and inside the port the
fused K-step block and the per-token loop must agree. The port's own
``PagedKVCache`` must make the same page decisions as the JAX one for the
same plan/commit/release script.
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
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import paged_cache as tpc
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
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
PAGED = dict(buckets=(8, 16), max_batch=4, page_size=4, paged_attn_kernel=True)
K = 4


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, sd


def _pair(weights, **kw):
    jcfg, tcfg, params, sd = weights
    return (JaxLM(jcfg, params, jl.LlamaForCausalLM, **kw).compile(),
            CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **kw))


@pytest.fixture(scope="module")
def pair(weights):
    return _pair(weights, **PAGED)


def _submits(eos=None, sampled=()):
    rng = np.random.default_rng(11)
    lens = (12, 7, 14, 10, 5, 9)
    prompts = [rng.integers(1, 127, n).astype(np.int32) for n in lens]
    prompts[3][:8] = prompts[0][:8]          # two full pages shared with request 0
    arrivals = (0, 0, 0, 1, 1, 2)
    budgets = (6, 9, 5, 7, 8, 4)
    return [dict(prompt=p, max_new_tokens=m, arrival_block=a, eos_token_id=eos,
                 sampler=Sampler(temperature=0.8) if i in sampled else None)
            for i, (p, m, a) in enumerate(zip(prompts, budgets, arrivals))]


def _serve(engine, **kw):
    ids = [engine.submit(**sub) for sub in _submits(**kw)]
    done = engine.run()
    return {c.request_id: c.tokens.tolist() for c in done}, [c.request_id for c in done], ids


def _held_against_jax(jlm, tlm, **kw):
    want, want_order, _ = _serve(JaxEngine(jlm, block_steps=K), **kw)
    got, got_order, ids = _serve(ServeEngine(tlm, block_steps=K), **kw)
    assert sorted(got) == sorted(ids)
    assert got == want
    assert got_order == want_order
    step, _, _ = _serve(ServeEngine(tlm, block_steps=K, fused=False), **kw)
    assert step == got
    return got, ids


def test_serve_engine_streams_match_jax(pair):
    """Paged pools through the paged kernel's twin: identical streams,
    then again with an EOS id that cuts some streams short."""
    got, ids = _held_against_jax(*pair)
    assert all(len(got[i]) == sub["max_new_tokens"] for i, sub in zip(ids, _submits()))
    eos = got[ids[1]][2]                     # request 1's third greedy token
    cut, _ = _held_against_jax(*pair, eos=eos)
    assert cut[ids[1]] == got[ids[1]][:3]
    assert all(t[-1] == eos or len(t) == sub["max_new_tokens"] and eos not in t
               for t, sub in zip((cut[i] for i in ids), _submits()))


def test_serve_engine_slab_streams_match_jax(weights):
    """The contiguous slab (no pages) under the same schedule."""
    _held_against_jax(*_pair(weights, buckets=(8, 16), max_batch=4))


def test_sampled_rows_fused_equals_stepwise_and_leave_greedy_rows_alone(pair):
    """Sampled streams draw from per-(request, token) generators: the fused
    block and the per-token loop give the same streams, and the greedy
    requests in the mixed pool keep their greedy-only streams."""
    _, tlm = pair
    greedy, _, ids = _serve(ServeEngine(tlm, block_steps=K))
    mixed = {f: _serve(ServeEngine(tlm, block_steps=K, fused=f, seed=7), sampled=(1, 4))[0]
             for f in (True, False)}
    assert mixed[True] == mixed[False]
    assert all(mixed[True][ids[i]] == greedy[ids[i]] for i in (0, 2, 3, 5))
    assert any(mixed[True][ids[i]] != greedy[ids[i]] for i in (1, 4))


def test_serve_engine_prefix_reuse_and_pages_return(pair):
    _, tlm = pair
    engine = ServeEngine(tlm, block_steps=K)
    _serve(engine)
    pkv = engine.session.paged
    assert pkv.prefix_hits >= 1 and pkv.prefix_hit_tokens >= 8
    assert pkv.live_pages() == []            # every slot retired
    # what stays held is only the radix cache's one hold per cached page
    assert pkv.allocator.in_use() == pkv.prefix.cached_pages


def _pkv_script():
    """(op, args) steps: admissions with prefix hits, releases, LRU
    eviction under pressure and an admission the pool cannot cover."""
    rng = np.random.default_rng(3)
    a = rng.integers(1, 100, 13).tolist()
    b = a[:8] + rng.integers(1, 100, 5).tolist()     # shares two pages with a
    c = rng.integers(1, 100, 9).tolist()
    return [("admit", 0, a, 16), ("admit", 1, b, 14), ("release", 0), ("admit", 2, c, 12),
            ("admit", 0, a, 32), ("release", 1), ("admit", 1, c[:6], 28),
            ("admit", 2, b, 20), ("release", 2), ("release", 0), ("admit", 0, b, 13)]


def _apply(pkv, exhausted, op):
    if op[0] == "release":
        pkv.release(op[1])
        return "released"
    _, slot, tokens, reserve = op
    try:
        plan = pkv.plan(tokens, reserve)
    except exhausted:
        return "exhausted"
    pkv.commit(slot, plan, tokens)
    return (plan.start, list(plan.shared), list(plan.owned))


def test_paged_kv_cache_decisions_match_jax():
    kw = dict(page_size=4, num_pages=14, max_batch=3, max_seq_len=32)
    jp, tp = jpc.PagedKVCache(**kw), tpc.PagedKVCache(**kw)
    outcomes = set()
    for op in _pkv_script():
        want = _apply(jp, jpc.PagePoolExhausted, op)
        got = _apply(tp, tpc.PagePoolExhausted, op)
        assert got == want, op
        np.testing.assert_array_equal(tp.tables, jp.tables)
        np.testing.assert_array_equal(tp.allocator.refcount, jp.allocator.refcount)
        assert tp.allocator.available() == jp.allocator.available()
        assert tp.live_pages() == jp.live_pages()
        outcomes.add(want if isinstance(want, str) else ("hit" if want[0] else "miss"))
    assert {"exhausted", "hit", "miss", "released"} <= outcomes
    assert tp.evicted_pages > 0
    for _, _, tokens, _ in (op for op in _pkv_script() if op[0] == "admit"):
        assert tp.prefix.peek(tokens) == jp.prefix.peek(tokens)
        assert tp.prefix.lookup(tokens) == jp.prefix.lookup(tokens)
    for n, new in ((5, 3), (30, 9)):
        assert tp.pages_needed(n, new) == jp.pages_needed(n, new)
