"""The serving runtime's programs, named and built as the JAX package's.

One seeded flax init carried over with ``llama_params_from_jax`` (fp32, tiny
widths). The same synthetic trace goes through the JAX ``ServeEngine`` and
the port's, one-shot and chunked, paged and slab: the port's
``capture_ms`` keys (its programs, built at their first call: captured
graphs on the card, eager bodies here) equal the JAX ``CausalLM``'s
``compile_ms`` keys, and the streams are identical (greedy, fp32). The
programs go with the ``CausalLM``'s device buffers: a later session reuses
them, with a fresh ``CausalLM``'s results, and a replaced session is
refused before any program runs. Tolerance: keys, streams and logits exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference.engine import synthetic_trace as jax_trace
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
K = 4
TRACE = dict(prompt_lens=(5, 8, 11), max_new_tokens=5, mean_interarrival_blocks=0.5,
             long_prompt_frac=0.25, long_prompt_len=16, seed=3)


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, sd


def _run(engine, trace):
    for it in trace:
        engine.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"])
    return {c.request_id: c.tokens.tolist() for c in engine.run()}


@pytest.mark.parametrize("paged", [True, False])
def test_program_signatures_equal_jax_compile_keys(weights, paged):
    """One-shot then chunked (chunk 5) on one ``CausalLM`` each side."""
    jcfg, tcfg, params, sd = weights
    kw = dict(LM, page_size=4, paged_attn_kernel=True) if paged else LM
    jlm = JaxLM(jcfg, params, jl.LlamaForCausalLM, **kw)
    lm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **kw)
    for chunk in (0, 5):
        want = _run(JaxEngine(jlm, block_steps=K, prefill_chunk_tokens=chunk),
                    jax_trace(8, TINY["vocab_size"], **TRACE))
        eng = ServeEngine(lm, block_steps=K, prefill_chunk_tokens=chunk, trace=True)
        got = _run(eng, synthetic_trace(8, TINY["vocab_size"], **TRACE))
        assert got == want
    assert set(lm.capture_ms) == set(jlm.compile_ms)
    assert any(k.startswith("paged_insert_r" if paged else "chunk_extend_r")
               for k in lm.capture_ms)
    assert all(ms >= 0 for ms in lm.capture_ms.values())
    # the compile lane holds a span for each program first built under it
    spans = {ev["name"] for ev in eng.tracer.events() if tuple(ev["lane"]) == ("engine",
                                                                                 "compile")}
    assert spans <= {"compile:" + k for k in lm.capture_ms}


def test_programs_follow_the_device_state_across_sessions(weights):
    """Programs built in one session serve the next (the device buffers are
    reset in place, not reallocated): the results equal a fresh
    ``CausalLM``'s and nothing is built again; a replaced session raises
    before any program runs."""
    _, tcfg, _, sd = weights
    kw = dict(LM, page_size=4, paged_attn_kernel=True)
    lm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **kw)
    rng = np.random.default_rng(2)
    p1, p2 = (rng.integers(1, 127, (2, 11)).astype(np.int32) for _ in range(2))
    s1 = lm.start_session()
    lm.insert(s1, [0, 2], p1)
    lm.step(s1, np.array([5, 0, 6], np.int32))
    progs = dict(lm._programs)
    keys = dict(lm.capture_ms)
    cache_keys = [t.data_ptr() for t in lm._cache.keys]
    s2 = lm.start_session()
    with pytest.raises(RuntimeError, match="replaced"):
        lm.insert(s1, [1], p1[:1])
    with pytest.raises(RuntimeError, match="replaced"):
        lm.extend(s1, [0], p1[:1, :4], np.array([4]), np.array([0]),
                  tables=np.zeros((1, 16), np.int32))
    got = lm.insert(s2, [1, 0], p2)
    steps = [lm.step(s2, np.array([3, 4, 0], np.int32)) for _ in range(3)]
    assert lm.capture_ms == keys and all(lm._programs[k] is v for k, v in progs.items())
    assert [t.data_ptr() for t in lm._cache.keys] == cache_keys
    fresh = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **kw)
    fs = fresh.start_session()
    want = fresh.insert(fs, [1, 0], p2)
    assert torch.equal(got, want)
    for s in steps:
        assert torch.equal(s, fresh.step(fs, np.array([3, 4, 0], np.int32)))


def test_compile_refuses_live_slots_and_builds_the_ladder(weights):
    _, tcfg, _, sd = weights
    lm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM)
    sess = lm.start_session()
    lm.compile()
    assert set(lm.capture_ms) == {"decode", "prefill_b8", "prefill_b16"}
    assert lm.compiled and not sess.active.any()
    assert (sess.slots.dev_field("length") == 0).all()   # the warm-ups left no length
    lm.insert(sess, [0], np.arange(1, 7, dtype=np.int32)[None])
    with pytest.raises(RuntimeError, match="before inserting"):
        lm.compile()
    # max_batch rows take the ladder's program; fewer their own
    lm.insert(sess, [0, 1, 2], np.ones((3, 5), np.int32))
    assert "insert_prefill_r1_b8" in lm.capture_ms and len(lm.capture_ms) == 4


def test_insert_logits_equal_the_full_head(weights):
    """An insert computes the head at each row's last token only: the
    logits equal the model's full-width forward at those positions."""
    _, tcfg, _, sd = weights
    lm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM)
    sess = lm.start_session()
    prompts = np.random.default_rng(4).integers(1, 127, (2, 13)).astype(np.int32)
    lengths = np.array([13, 9], np.int32)
    got = lm.insert(sess, [2, 0], prompts, lengths=lengths)
    ids = np.zeros((2, 16), np.int32)
    ids[:, :13] = prompts
    cache = lm.model.new_cache(2)
    with torch.no_grad():
        full = lm.model(torch.from_numpy(ids), cache)
    want = full[torch.arange(2), torch.from_numpy(lengths - 1).long()]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
