"""The port's Llama serving forward against the JAX package.

A seeded flax init is carried over with ``llama_params_from_jax``; the same
prompts then go through JAX ``CausalLM`` (``LlamaForCausalLM`` with
``decode=True``) and the port's, on the contiguous slab and on paged pools
with the paged kernel flag, comparing the insert (prefill) logits and four
decode steps. fp32 on both sides: atol 1e-4. One case prefills at bucket
128, so the flash gate is taken on both sides (the Pallas kernel in
interpret mode on the JAX side, the twin here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa
from neuronx_distributed_tpu_torch.models import llama as tl


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-4
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64)


def configs(**over):
    kw = {**TINY, **over}
    return (jl.LlamaConfig(**kw, dtype=jnp.float32, remat_policy=None),
            tl.LlamaConfig(**kw, dtype=torch.float32))


def jax_params(cfg, tie=False):
    cfg = dataclasses.replace(cfg, tie_word_embeddings=tie)
    return meta.unbox(jl.LlamaForCausalLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]


def _run_pair(jcfg, tcfg, params, buckets, prompts, lengths, **kw):
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               tie_word_embeddings=tcfg.tie_word_embeddings)
    jlm = JaxLM(jcfg, params, jl.LlamaForCausalLM, buckets=buckets, max_batch=3,
                **kw).compile()
    tlm = CausalLM(tcfg, sd, tl.LlamaForCausalLM, buckets=buckets, max_batch=3,
                   device="cpu", **kw)
    js, ts = jlm.start_session(), tlm.start_session()
    slots = np.array([0, 2])
    a = np.asarray(jlm.insert(js, slots, prompts, lengths=lengths))
    b = tlm.insert(ts, slots, prompts, lengths=lengths).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)
    tok = np.zeros(3, np.int32)
    tok[slots] = a.argmax(-1)
    for _ in range(4):
        a = np.asarray(jlm.step(js, tok))
        b = tlm.step(ts, tok).numpy()
        np.testing.assert_allclose(b, a, atol=ATOL)
        tok = a.argmax(-1).astype(np.int32)
    return tlm


@pytest.mark.parametrize("mode", ["slab", "paged_kernel"])
def test_insert_and_decode_logits_match_jax(mode):
    jcfg, tcfg = configs(use_flash_attention=False)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 127, (2, 12)).astype(np.int32)
    kw = dict(page_size=4, paged_attn_kernel=True) if mode == "paged_kernel" else {}
    _run_pair(jcfg, tcfg, jax_params(jcfg), (8, 16), prompts, np.array([12, 7]), **kw)


def test_bucket_128_takes_the_flash_gate_on_both_sides(monkeypatch):
    jcfg, tcfg = configs(max_seq_len=256, use_flash_attention=True)
    calls = []
    real = tfa.flash_block_forward_plain
    monkeypatch.setattr(tfa, "flash_block_forward_plain",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, 127, (2, 100)).astype(np.int32)
    _run_pair(jcfg, tcfg, jax_params(jcfg), (128,), prompts, np.array([100, 90]),
              page_size=16, paged_attn_kernel=True)
    # one flash call per layer at the insert (rows*heads, bucket, head_dim)
    assert calls == [(2 * 4, 128, 8)] * TINY["num_layers"]


@pytest.mark.parametrize("flash", [False, True])
def test_full_sequence_forward_matches_jax(flash):
    """``LlamaForCausalLM`` outside decode mode (the training-side
    ``__call__``) over a 128-token batch: the flash kernel's twin against
    the Pallas kernel in interpret mode, or the dense reference on both."""
    jcfg, tcfg = configs(max_seq_len=128, use_flash_attention=flash)
    params = jax_params(jcfg)
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ids = np.random.default_rng(4).integers(1, 127, (2, 128)).astype(np.int32)
    want = np.asarray(jl.LlamaForCausalLM(jcfg).apply({"params": params}, jnp.asarray(ids)))
    with torch.device("meta"):
        model = tl.LlamaForCausalLM(tcfg)
    model.load_state_dict(sd, strict=True, assign=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tied_embeddings_and_converter_names():
    jcfg, tcfg = configs(use_flash_attention=False, tie_word_embeddings=True)
    params = jax_params(jcfg, tie=True)
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               tie_word_embeddings=True)
    with torch.device("meta"):
        names = set(tl.LlamaForCausalLM(tcfg).state_dict())
    assert set(sd) == names and "lm_head.kernel" not in sd
    prompts = np.random.default_rng(2).integers(1, 127, (2, 10)).astype(np.int32)
    _run_pair(jcfg, tcfg, params, (16,), prompts, np.array([10, 4]))


def test_generate_greedy_matches_jax():
    jcfg, tcfg = configs(use_flash_attention=False)
    params = jax_params(jcfg)
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    prompts = np.random.default_rng(3).integers(1, 127, (2, 8)).astype(np.int32)
    want = JaxLM(jcfg, params, jl.LlamaForCausalLM, buckets=(8,), max_batch=2).compile() \
        .generate(prompts, 6)
    got = CausalLM(tcfg, sd, tl.LlamaForCausalLM, buckets=(8,), max_batch=2,
                   device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_config_presets_and_blocks_match_jax():
    for name in ("llama2_7b", "llama3_8b", "llama31_8b", "llama3_70b"):
        j, t = getattr(jl, name)(), getattr(tl, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "num_kv_heads", "max_seq_len", "rope_theta", "head_dim_"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        for sq, sk in ((128, 4096), (512, 4096), (1280, None)):
            assert dataclasses.replace(j, decode=True).blocks_for(sq, sk) == \
                dataclasses.replace(t, decode=True).blocks_for(sq, sk)
    pos = np.arange(40, dtype=np.int32)[None]
    for scaling in (None, jl.RopeScaling()):
        tsc = None if scaling is None else tl.RopeScaling()
        jc, js = jl.rotary_embedding(jnp.asarray(pos), 64, 500000.0, scaling=scaling)
        tc, ts = tl.rotary_embedding(torch.from_numpy(pos), 64, 500000.0, scaling=tsc)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
