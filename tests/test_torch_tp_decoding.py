"""Speculation, Medusa and multi-LoRA serving over ``kv_size_multiplier >
1`` under a tensor-parallel group, held against the JAX package at TP=2
on its CPU mesh and against the port at TP=1.

The JAX oracle runs once per module inside its own TP=2 world (weights
from its trainer's init or its Medusa init under the mesh; speculative
decoding, Medusa and the serving engine there). The port's two ranks are
threads over one gloo group; each carries the JAX trees across with the
converters at ``tp_rank``/``tp_size``.

- speculation: greedy tokens and the accepted counts equal JAX's at TP=2
  (host loop and fused block); the self-draft holds the target's own rank
  shards (``data_ptr`` equal); a sampled run gives the same stream on both
  ranks;
- Medusa: the heads cut over the vocabulary; the tokens and counts equal
  JAX's at TP=2 and the base greedy stream (the invariant);
- multi-LoRA with ``num_kv_heads=2, kv_size_multiplier=2``: the K/V
  deltas compact, repeated, then cut; streams equal the port at TP=1 and
  JAX at TP=2 on the same adapters.

Tiny models, fp32, one intra-op thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference import medusa as jmed
from neuronx_distributed_tpu.inference import speculative as jspec
from neuronx_distributed_tpu.lora import LoraConfig as JaxLoraConfig
from neuronx_distributed_tpu.lora import init_lora
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as psm
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_model,
    neuronx_distributed_config,
)
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    lora_params_from_jax,
    medusa_params_from_jax,
)
from neuronx_distributed_tpu_torch.examples.runner import _draft_params
from neuronx_distributed_tpu_torch.inference import medusa as tmed
from neuronx_distributed_tpu_torch.inference import speculative as spec
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.lora import LoraConfig
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel import mesh

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
KVM = dict(TINY, kv_size_multiplier=2)
TREE = [(0,), (1,), (0, 0), (0, 1), (1, 0)]
NEW = 10
PROMPT = np.random.default_rng(8).integers(1, 127, (1, 8)).astype(np.int32)
JCFG = JaxLoraConfig(r=4, lora_alpha=8.0)
TCFG = LoraConfig(r=4, lora_alpha=8.0)
LORA_LM = dict(buckets=(8, 16), max_batch=4, lora_rank=4, lora_slots=3)


def _prompts(n, s=8, seed=5):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


P = _prompts(4)
SUBMITS = [dict(prompt=P[0], max_new_tokens=8),
           dict(prompt=P[1], max_new_tokens=6, adapter="a0", arrival_block=1),
           dict(prompt=P[2], max_new_tokens=7, adapter="a1"),
           dict(prompt=P[3], max_new_tokens=5, adapter="a0", arrival_block=2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_adapter(params, i):
    ad = init_lora(params, JCFG, jax.random.key(10 + i))
    return {k: {"lora_a": np.asarray(v["lora_a"]),
                "lora_b": np.asarray(0.05 * jax.random.normal(
                    jax.random.fold_in(jax.random.key(20 + i), j), v["lora_b"].shape))}
            for j, (k, v) in enumerate(sorted(ad.items()))}


@pytest.fixture(scope="module")
def oracle():
    """The JAX package at TP=2: speculative decoding (host loop and fused
    block) with a one-layer self-draft, Medusa with its runner's init and
    random ResBlocks, and the serving engine with two adapters over a
    ``kv_size_multiplier=2`` model."""
    psm.destroy_model_parallel()
    psm.initialize_model_parallel(tensor_model_parallel_size=2)
    try:
        nxd = neuronx_distributed_config(tensor_parallel_size=2)
        ids = jnp.zeros((1, 8), jnp.int32)
        jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
        model = initialize_parallel_model(nxd, lambda: jl.LlamaForCausalLM(jcfg), ids)
        target = JaxLM(jcfg, model.params, jl.LlamaForCausalLM, buckets=(8, 16), max_batch=1)
        dcfg = dataclasses.replace(jcfg, num_layers=1)
        dparams = jax.tree.map(lambda p: p[:1] if p.ndim and p.shape[0] == 2 else p,
                               model.params)
        draft = JaxLM(dcfg, dparams, jl.LlamaForCausalLM, buckets=(8, 16), max_batch=1)
        out = {"params": _np(model.params)}
        for name, fn in (("host", jspec.speculative_generate),
                         ("fused", jspec.speculative_decode_fused)):
            kw = {"rounds_per_block": 2} if name == "fused" else {}
            res = fn(target, draft, PROMPT, max_new_tokens=NEW, num_draft=3,
                     rng=jax.random.key(0), **kw)
            out[name] = (np.asarray(res.tokens), dict(res.stats))
        mm = jmed.MedusaLlamaForCausalLM(dataclasses.replace(jcfg, decode=True),
                                         num_medusa_heads=2)
        mtree = meta.unbox(jax.jit(lambda: mm.init(jax.random.key(0), ids))())["params"]
        rng = np.random.default_rng(1)
        for i in range(2):   # random ResBlocks: the heads differ from the base head
            w = rng.standard_normal((32, 32)).astype(np.float32) * 0.2
            mtree[f"medusa_res_{i}"]["kernel"] = jnp.asarray(w)
        mres = jmed.medusa_generate(jcfg, mtree, PROMPT, max_new_tokens=NEW,
                                    num_medusa_heads=2, medusa_choices=TREE)
        out["medusa_tree"] = _np(mtree)
        out["medusa"] = (np.asarray(mres.tokens), dict(mres.stats))
        kcfg = jl.LlamaConfig(**KVM, dtype=jnp.float32, remat_policy=None)
        kmodel = initialize_parallel_model(nxd, lambda: jl.LlamaForCausalLM(kcfg), ids)
        kparams = _np(kmodel.params)
        ads = {f"a{i}": _jax_adapter(kparams, i) for i in range(2)}
        jlm = JaxLM(kcfg, kmodel.params, jl.LlamaForCausalLM, **LORA_LM).compile()
        eng = JaxEngine(jlm, block_steps=4, rng=jax.random.key(42))
        for name, ad in ads.items():
            eng.register_adapter(name, ad, JCFG)
        for kw in SUBMITS:
            eng.submit(**kw)
        eng.run()
        out["kvm"] = dict(params=kparams, ads=ads,
                          streams={c.request_id: c.tokens.tolist() for c in eng.completed})
        return out
    finally:
        psm.destroy_model_parallel()


def _tp2(fn):
    return mesh.run_in_threads(2, fn)


def _cfg(**over):
    return tl.LlamaConfig(**{**TINY, **over}, dtype=torch.float32)


# ------------------------------------------------------------ speculation

def _pair(sd):
    target = CausalLM(_cfg(), sd, tl.LlamaForCausalLM, buckets=(8, 16), max_batch=1,
                      device="cpu")
    draft = CausalLM(_cfg(num_layers=1), _draft_params(target, 1), tl.LlamaForCausalLM,
                     buckets=(8, 16), max_batch=1, device="cpu")
    return target, draft


@pytest.mark.parametrize("fused", [False, True])
def test_speculation_tp2_equals_jax(oracle, fused):
    want, wstats = oracle["fused" if fused else "host"]

    def rank(r):
        target, draft = _pair(llama_params_from_jax(oracle["params"], tp_rank=r, tp_size=2))
        assert target.tp == draft.tp == 2 and draft.tp_group is target.tp_group
        for name, t in draft.model.state_dict().items():
            assert t.data_ptr() == target.model.state_dict()[name].data_ptr(), name
        if fused:
            res = spec.speculative_decode_fused(target, draft, PROMPT, max_new_tokens=NEW,
                                                num_draft=3, rounds_per_block=2, seed=0)
        else:
            res = spec.speculative_generate(target, draft, PROMPT, max_new_tokens=NEW,
                                            num_draft=3, seed=0)
        return res

    for res in _tp2(rank):
        np.testing.assert_array_equal(res.tokens, want)
        for key in ("rounds", "accepted", "proposed", "tokens_per_round"):
            assert res.stats[key] == wstats[key], key


def test_speculation_tp2_sampled_same_on_both_ranks(oracle):
    """Sampled acceptance on the gathered logits under the full-vocabulary
    counter noise: both ranks emit one stream (their KV lengths agree)."""
    def rank(r):
        target, draft = _pair(llama_params_from_jax(oracle["params"], tp_rank=r, tp_size=2))
        res = spec.speculative_generate(target, draft, PROMPT, max_new_tokens=NEW,
                                        num_draft=3, greedy=False, temperature=0.9, seed=4)
        return res.tokens.tolist(), res.stats["accepted"], res.stats["rounds"]

    a, b = _tp2(rank)
    assert a == b


def test_speculation_refuses_a_foreign_group(oracle):
    def rank(r):
        sd = llama_params_from_jax(oracle["params"], tp_rank=r, tp_size=2)
        target = CausalLM(_cfg(), sd, tl.LlamaForCausalLM, buckets=(8, 16), max_batch=1,
                          device="cpu")
        return target

    target = _tp2(rank)[0]
    draft = CausalLM(_cfg(), llama_params_from_jax(oracle["params"]), tl.LlamaForCausalLM,
                     buckets=(8, 16), max_batch=1, device="cpu")
    with pytest.raises(ValueError, match="share one tensor-parallel group"):
        spec.speculative_generate(target, draft, PROMPT, max_new_tokens=4)


# ------------------------------------------------------------------ Medusa

def test_medusa_tp2_equals_jax_and_base_greedy(oracle):
    want, wstats = oracle["medusa"]
    tree = oracle["medusa_tree"]
    base_tree = {k: v for k, v in tree.items() if not k.startswith("medusa")}

    def rank(r):
        sd = medusa_params_from_jax(tree, tp_rank=r, tp_size=2)
        whole = medusa_params_from_jax(tree)
        assert sd["medusa_head_0.kernel"].shape == (32, 64)          # the vocabulary cut
        assert torch.equal(sd["medusa_res_0.kernel"], whole["medusa_res_0.kernel"])
        model = tmed.medusa_model(_cfg(), sd, 2, device="cpu")
        assert model.group is not None
        res = tmed.medusa_generate(_cfg(), model, PROMPT, max_new_tokens=NEW,
                                   medusa_choices=TREE)
        base = CausalLM(_cfg(), llama_params_from_jax(base_tree, tp_rank=r, tp_size=2),
                        tl.LlamaForCausalLM, buckets=(8,), max_batch=1, device="cpu")
        return res, base.generate(PROMPT, max_new_tokens=NEW).tokens

    for res, golden in _tp2(rank):
        np.testing.assert_array_equal(res.tokens, want)
        np.testing.assert_array_equal(res.tokens, golden)
        for key in ("rounds", "accepted", "proposed", "tokens_per_round"):
            assert res.stats[key] == wstats[key], key


# ------------------------------------------------ multi-LoRA at kvm 2

def _serve_lora(o, rank=0, tp=1):
    sd = llama_params_from_jax(o["params"], tp_rank=rank, tp_size=tp, kv_size_multiplier=2)
    lm = CausalLM(_cfg(kv_size_multiplier=2), sd, tl.LlamaForCausalLM, device="cpu",
                  **LORA_LM)
    assert lm.model.model.lora_layout.kv_compact
    eng = ServeEngine(lm, block_steps=4, seed=42)
    for name, ad in o["ads"].items():
        eng.register_adapter(name, lora_params_from_jax(
            ad, TCFG, tp_rank=rank, tp_size=tp, kv_size_multiplier=2), TCFG)
    for kw in SUBMITS:
        eng.submit(**kw)
    eng.run()
    return {c.request_id: c.tokens.tolist() for c in eng.completed}


def test_multilora_kv_multiplier_tp2_equals_tp1_and_jax(oracle):
    o = oracle["kvm"]
    tp1 = _serve_lora(o)
    for got in _tp2(lambda r: _serve_lora(o, r, 2)):
        assert got == tp1 == o["streams"]


def test_lora_kv_b_stays_whole_and_compact(oracle):
    """Under ``kv_size_multiplier > 1`` each rank keeps the compact K/V
    ``B`` whole (its delta is repeated, then cut to the rank's heads in
    the forward), and the Q ``B`` over its fan-out."""
    ad = oracle["kvm"]["ads"]["a0"]
    whole = lora_params_from_jax(ad, TCFG, kv_size_multiplier=2)
    k, q = "model.layers.0.attention.qkv.k_kernel", "model.layers.0.attention.qkv.q_kernel"
    for r in range(2):
        mine = lora_params_from_jax(ad, TCFG, tp_rank=r, tp_size=2, kv_size_multiplier=2)
        assert torch.equal(mine[k]["lora_b"], whole[k]["lora_b"])
        assert torch.equal(mine[q]["lora_b"], whole[q]["lora_b"][:, 16 * r:16 * (r + 1)])
