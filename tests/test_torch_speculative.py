"""Speculative decoding in the port against the JAX package's.

Weights: seeded flax inits carried over with ``llama_params_from_jax``, fp32
on both sides, the tiny widths of ``tests/test_inference.py``. Tolerance:
greedy token streams identical (the port's speculative tokens, its greedy
``generate`` and JAX's ``speculative_generate``); the fused block's tokens
and counts identical to the host loop's; the acceptance core fed JAX's noise
makes JAX's decisions exactly (accepted count and next token).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import speculative as jspec
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import speculative as spec
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
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


def _init(seed):
    cfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    return meta.unbox(jl.LlamaForCausalLM(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))["params"]


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    out = {}
    for name, seed in (("t", 0), ("d", 99)):
        params = _init(seed)
        sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
        out[name] = (JaxLM(jcfg, params, jl.LlamaForCausalLM, buckets=(16,),
                           max_batch=1).compile(),
                     CausalLM(tcfg, sd, tl.LlamaForCausalLM, buckets=(16,), max_batch=1,
                              device="cpu"), sd)
    # the self-draft: a second CausalLM on the target's weight tensors
    out["self"] = CausalLM(tcfg, out["t"][2], tl.LlamaForCausalLM, buckets=(16,),
                           max_batch=1, device="cpu")
    ids = np.array(jax.random.randint(jax.random.PRNGKey(6), (1, 8), 1, 127))
    return out, ids


def test_self_draft_matches_greedy_and_jax(models):
    m, ids = models
    (jt, t, _), sd = m["t"], m["self"]
    golden = t.generate(ids, max_new_tokens=6)
    res = spec.speculative_generate(t, sd, ids, max_new_tokens=6, num_draft=3,
                                    collect_stats=True)
    jres = jspec.speculative_generate(jt, jt, ids, max_new_tokens=6, num_draft=3)
    np.testing.assert_array_equal(res.tokens, golden.tokens)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    assert res.stats["acceptance_rate"] == 1.0 == jres.stats["acceptance_rate"]
    assert res.stats["accepted"] == res.stats["proposed"] > 0
    for k in ("round_ms_p50", "draft_ms_p50", "verify_ms_p50",
              "round_ms_p90", "draft_ms_p90", "verify_ms_p90"):
        assert res.stats[k] is not None and res.stats[k] >= 0
    assert set(res.stats) == set(jres.stats)
    with pytest.raises(ValueError, match="its own CausalLM"):
        spec.speculative_generate(t, t, ids, max_new_tokens=4)


def test_different_draft_still_exact(models):
    m, ids = models
    (jt, t, _), (jd, d, _) = m["t"], m["d"]
    golden = t.generate(ids, max_new_tokens=12)
    res = spec.speculative_generate(t, d, ids, max_new_tokens=12, num_draft=2)
    jres = jspec.speculative_generate(jt, jd, ids, max_new_tokens=12, num_draft=2)
    np.testing.assert_array_equal(res.tokens, golden.tokens)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    assert (res.stats["rounds"], res.stats["accepted"]) == (jres.stats["rounds"],
                                                            jres.stats["accepted"])
    assert res.stats["accepted"] < res.stats["proposed"]   # the rejection path ran


@pytest.mark.parametrize("rounds_per_block", [1, 3, 16])
def test_fused_matches_host_loop_greedy(models, rounds_per_block):
    m, ids = models
    t, d = m["t"][1], m["d"][1]
    host = spec.speculative_generate(t, d, ids, max_new_tokens=12, num_draft=3)
    fused = spec.speculative_decode_fused(t, d, ids, max_new_tokens=12, num_draft=3,
                                          rounds_per_block=rounds_per_block)
    np.testing.assert_array_equal(fused.tokens, host.tokens)
    for k in ("rounds", "accepted", "acceptance_rate", "tokens_per_round"):
        assert fused.stats[k] == host.stats[k], k
    assert fused.stats["host_dispatches_per_block"] == 2


def test_fused_eos_and_dispatch_count(models):
    m, ids = models
    t, d = m["t"][1], m["d"][1]
    host = spec.speculative_generate(t, d, ids, max_new_tokens=12, num_draft=3)
    eos = int(host.tokens[0, 5])
    calls = {"n": 0}
    orig = spec._compile_block

    def counting_compile(*a, **kw):
        compiled = orig(*a, **kw)

        def wrapped(*ca, **ckw):
            calls["n"] += 1
            return compiled(*ca, **ckw)

        return wrapped

    spec._compile_block = counting_compile
    try:
        he = spec.speculative_generate(t, d, ids, max_new_tokens=12, num_draft=3,
                                       eos_token_id=eos)
        fe = spec.speculative_decode_fused(t, d, ids, max_new_tokens=12, num_draft=3,
                                           eos_token_id=eos, rounds_per_block=4)
    finally:
        spec._compile_block = orig
    np.testing.assert_array_equal(fe.tokens, he.tokens)
    np.testing.assert_array_equal(fe.lengths, he.lengths)
    n = int(fe.lengths[0])
    assert n < 12 and fe.tokens[0, n - 1] == eos and (fe.tokens[0, n:] == 0).all()
    assert calls["n"] == fe.stats["fused_block_calls"] >= 1
    assert fe.stats["host_dispatches_per_block"] == 2


@pytest.mark.parametrize("seed", range(4))
def test_accept_core_makes_jax_decisions(seed):
    """Sampled acceptance: JAX's ``_accept`` on its rng, and the port's core
    on the uniforms and Gumbel noise that rng gives (``jax.random``'s own
    draws: ``uniform`` of the first split, ``categorical`` = argmax of
    logits plus ``gumbel`` of the second)."""
    rng = np.random.default_rng(seed)
    gamma, vocab, temp = 4, 64, 0.9
    t_logits = (rng.standard_normal((gamma + 1, vocab)) * 2).astype(np.float32)
    d_logits = t_logits[:gamma] + rng.standard_normal((gamma, vocab)).astype(np.float32)
    draft_probs = np.array(jax.nn.softmax(jnp.asarray(d_logits) / temp, axis=-1))
    proposals = np.asarray([int(np.argmax(d_logits[i] + rng.gumbel(size=vocab)))
                            for i in range(gamma)], np.int32)
    key = jax.random.key(seed)
    acc_j, nxt_j = jspec._accept(jnp.asarray(t_logits), jnp.asarray(proposals),
                                 jnp.asarray(draft_probs), key, False, temp)
    k_u, k_r = jax.random.split(key)
    u = np.array(jax.random.uniform(k_u, (gamma,)))
    g = np.array(jax.random.gumbel(k_r, (vocab,)))
    acc, nxt = spec._accept_core(torch.from_numpy(t_logits), torch.from_numpy(proposals),
                                 torch.from_numpy(draft_probs), torch.from_numpy(u),
                                 torch.from_numpy(g), False, temp)
    assert (int(acc), int(nxt)) == (int(acc_j), int(nxt_j))
    # greedy: the longest prefix equal to the target's argmax, then its choice
    acc_g, nxt_g = spec._accept_core(torch.from_numpy(t_logits), torch.from_numpy(proposals),
                                     torch.from_numpy(draft_probs), None, None, True, temp)
    acc_jg, nxt_jg = jspec._accept(jnp.asarray(t_logits), jnp.asarray(proposals),
                                   jnp.asarray(draft_probs), key, True, temp)
    assert (int(acc_g), int(nxt_g)) == (int(acc_jg), int(nxt_jg))


def test_sampled_fused_matches_host_and_self_draft_accepts_all(models):
    m, ids = models
    t, d, sd = m["t"][1], m["d"][1], m["self"]
    host = spec.speculative_generate(t, d, ids, max_new_tokens=12, num_draft=3, greedy=False,
                                     temperature=0.8, seed=3)
    fused = spec.speculative_decode_fused(t, d, ids, max_new_tokens=12, num_draft=3,
                                          greedy=False, temperature=0.8, rounds_per_block=4,
                                          seed=3)
    np.testing.assert_array_equal(fused.tokens, host.tokens)
    assert fused.stats["accepted"] == host.stats["accepted"]
    for fn in (spec.speculative_generate, spec.speculative_decode_fused):
        res = fn(t, sd, ids, max_new_tokens=10, num_draft=3, greedy=False, temperature=0.8,
                 seed=5)
        assert int(res.lengths[0]) == 10
        assert res.stats["acceptance_rate"] == 1.0
        assert ((res.tokens[0] >= 0) & (res.tokens[0] < TINY["vocab_size"])).all()
