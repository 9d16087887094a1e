"""Medusa tree decoding in the port against the JAX package's.

Weights: a seeded flax ``MedusaLlamaForCausalLM`` init (random heads)
carried over with ``medusa_params_from_jax``, fp32 on both sides, the tiny
widths of ``tests/test_inference.py``. Tolerance: the tree buffers, the
candidates and the posterior equal JAX's exactly; greedy token streams
identical (Medusa, the port's greedy ``generate`` and JAX's
``medusa_generate``); ``chunk_ctx`` logits within 1e-5 absolute of JAX's
(fp32, sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import medusa as jmed
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    medusa_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference import medusa as tmed
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


SMALL = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
             num_heads=4, num_kv_heads=4, max_seq_len=128, use_flash_attention=False)
TREE = [(0,), (1,), (0, 0), (0, 1), (1, 0)]
TOL_LOGITS = 1e-5


def _setup(tied: bool):
    jcfg = jl.LlamaConfig(**SMALL, dtype=jnp.float32, remat_policy=None,
                          tie_word_embeddings=tied)
    tcfg = tl.LlamaConfig(**SMALL, dtype=torch.float32, tie_word_embeddings=tied)
    ids = np.array(jax.random.randint(jax.random.PRNGKey(0), (1, 8), 1, 127), np.int32)
    mm = jmed.MedusaLlamaForCausalLM(dataclasses.replace(jcfg, decode=True),
                                     num_medusa_heads=2)
    mparams = meta.unbox(mm.init(jax.random.PRNGKey(0), jnp.asarray(ids)))["params"]
    # random ResBlocks (the JAX init zeroes W): the heads differ from the base head
    rng = np.random.default_rng(1)
    mparams = jax.tree_util.tree_map(np.asarray, mparams)
    for i in range(2):
        mparams[f"medusa_res_{i}"]["kernel"] = rng.standard_normal(
            (32, 32)).astype(np.float32) * 0.2
    sd = medusa_params_from_jax(mparams, tie_word_embeddings=tied)
    base = llama_params_from_jax({k: v for k, v in mparams.items()
                                  if not k.startswith("medusa")}, tie_word_embeddings=tied)
    return jcfg, tcfg, ids, mparams, sd, base


@pytest.fixture(scope="module")
def untied():
    return _setup(False)


@pytest.mark.parametrize("choices", [TREE, tmed.DEFAULT_CHOICES,
                                     [(0,), (1,), (2,), (3,), (0, 0), (0, 1), (0, 0, 0)],
                                     [(9,), (0,), (0, 9)]])
def test_buffers_equal_jax(choices):
    got, want = tmed.generate_medusa_buffers(choices), jmed.generate_medusa_buffers(choices)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="no parent"):
        tmed.generate_medusa_buffers([(0, 0)])
    assert tmed.TOPK == jmed.TOPK and tmed.DEFAULT_CHOICES == jmed.DEFAULT_CHOICES


@pytest.mark.parametrize("seed", range(3))
def test_candidates_and_posterior_equal_jax(seed):
    rng = np.random.default_rng(seed)
    buffers = tmed.generate_medusa_buffers(tmed.DEFAULT_CHOICES)
    base = rng.standard_normal(128).astype(np.float32)
    med = rng.standard_normal((2, 128)).astype(np.float32)
    tree, cand = tmed.generate_candidates(base, med, buffers)
    jtree, jcand = jmed.generate_candidates(base, med, jmed.generate_medusa_buffers(
        tmed.DEFAULT_CHOICES))
    np.testing.assert_array_equal(tree, jtree)
    np.testing.assert_array_equal(cand, jcand)
    for _ in range(4):   # argmax chains that follow a path part of the way
        path_argmax = np.where(rng.random(cand.shape) < 0.6, np.roll(cand, -1, axis=1),
                               rng.integers(0, 128, cand.shape))
        assert tmed.evaluate_posterior_greedy(path_argmax, cand) == \
            jmed.evaluate_posterior_greedy(path_argmax, cand)


@pytest.mark.parametrize("tied", [False, True])
def test_medusa_equals_greedy_and_jax(untied, tied):
    jcfg, tcfg, ids, mparams, sd, base = untied if not tied else _setup(True)
    if tied:
        assert "lm_head.kernel" not in sd
    n = 12 if not tied else 8
    golden = CausalLM(tcfg, base, tl.LlamaForCausalLM, buckets=(8,), max_batch=1,
                      device="cpu").generate(ids, max_new_tokens=n)
    res = tmed.medusa_generate(tcfg, sd, ids, max_new_tokens=n, num_medusa_heads=2,
                               medusa_choices=TREE, device="cpu")
    jres = jmed.medusa_generate(jcfg, mparams, ids, max_new_tokens=n, num_medusa_heads=2,
                                medusa_choices=TREE)
    assert res.tokens[0].tolist() == golden.tokens[0].tolist() == jres.tokens[0].tolist()
    assert set(res.stats) == set(jres.stats)
    for k in ("rounds", "accepted", "proposed", "tokens_per_round"):
        assert res.stats[k] == jres.stats[k], k
    # a built model keeps its programs: a second run replays them
    model = tmed.medusa_model(tcfg, sd, 2, device="cpu")
    first = tmed.medusa_generate(tcfg, model, ids, max_new_tokens=n, medusa_choices=TREE)
    again = tmed.medusa_generate(tcfg, model, ids, max_new_tokens=n, medusa_choices=TREE)
    np.testing.assert_array_equal(first.tokens, res.tokens)
    np.testing.assert_array_equal(again.tokens, res.tokens)
    assert len(model._medusa_runs) == 1


def test_medusa_eos_stops(untied):
    jcfg, tcfg, ids, mparams, sd, base = untied
    golden = CausalLM(tcfg, base, tl.LlamaForCausalLM, buckets=(8,), max_batch=1,
                      device="cpu").generate(ids, max_new_tokens=12)
    eos = int(golden.tokens[0, 4])
    res = tmed.medusa_generate(tcfg, sd, ids, max_new_tokens=12, eos_token_id=eos,
                               device="cpu")
    jres = jmed.medusa_generate(jcfg, mparams, ids, max_new_tokens=12, eos_token_id=eos)
    n = int(res.lengths[0])
    assert res.tokens[0, n - 1] == eos and (res.tokens[0, n:] == 0).all()
    np.testing.assert_array_equal(res.tokens, jres.tokens)


def test_chunk_ctx_logits_equal_jax(untied):
    """A prefix prefill, then one tree chunk under ``chunk_ctx`` (tree mask,
    depth positions), slab and paged, against the JAX model's base logits
    under the same chunk_ctx (JAX's ``LlamaForCausalLM`` takes none: its
    ``MedusaLlamaForCausalLM`` with ``heads=False`` runs ``LlamaModel``
    with it, then the base head)."""
    jcfg, tcfg, ids, mparams, sd, base = untied
    buffers = tmed.generate_medusa_buffers(tmed.DEFAULT_CHOICES)
    mask, pos = buffers["attn_mask"], buffers["position_ids"]
    rng = np.random.default_rng(3)
    tree = rng.integers(1, 127, (1, buffers["num_nodes"])).astype(np.int32)
    jm = jmed.MedusaLlamaForCausalLM(dataclasses.replace(jcfg, decode=True), num_medusa_heads=2)
    _, mut = jm.apply({"params": mparams}, jnp.asarray(ids), mutable=["cache"])
    (want, _), _ = jm.apply({"params": mparams, "cache": mut["cache"]}, jnp.asarray(tree),
                            (jnp.asarray(mask), jnp.asarray(pos)), heads=False,
                            mutable=["cache"])
    for paged in (False, True):
        cfg = dataclasses.replace(tcfg, decode=True)
        if paged:
            cfg = dataclasses.replace(cfg, page_size=8, page_pool_pages=20)
        with torch.device("meta"):
            model = tl.LlamaForCausalLM(cfg)
        model.load_state_dict(base, assign=True)
        cache = model.new_cache(1)
        if paged:   # a non-identity table: pages 3, 7, 1, ...
            cache.block_table.copy_(torch.tensor([[3, 7, 1, 5] + list(range(8, 20))[:12]],
                                                 dtype=torch.int32))
        with torch.no_grad():
            model(torch.from_numpy(ids), cache)
            got = model(torch.from_numpy(tree), cache,
                        (torch.from_numpy(mask), torch.from_numpy(pos)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LOGITS, rtol=0)
        # the plain chunk (no ctx) differs: the mask and positions are in effect
        with torch.no_grad():
            cache.cache_index.fill_(ids.shape[1])
            plain = model(torch.from_numpy(tree), cache)
        assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-3
