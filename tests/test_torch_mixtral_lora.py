"""Multi-LoRA serving and grammar tenancy on Mixtral, the port against the
JAX package, on the CPU.

A tiny fp32 Mixtral (2 layers, 4 experts, top 2) on a seeded JAX tree
(``mixtral_params_from_jax``), rank-4 adapters from JAX's ``init_lora``
(which adapts the four attention leaves of a Mixtral tree: the expert
weights are not ``*_proj`` leaves), each ``B`` drawn nonzero:

- greedy engine streams under two adapters and on slot 0 equal the JAX
  engine's over JAX's Mixtral pool, in both MoE decode modes (all_experts at
  the default threshold, selective at a raised one);
- an adapter's stream equals the solo ``generate`` of a model whose weights
  carry the adapter merged, and the slot-0 stream beside it equals a
  ``CausalLM`` built without a pool, bit for bit;
- ``runner.py serve --model mixtral --adapters 2 --paged`` reports JAX's
  keys and schedule; ``--adapters`` with ``--quantize`` is
  refused with JAX's message;
- a Mixtral ``CausalLM`` with ``grammar_slots`` constrains exactly as JAX's
  (the same tokens, every stream parsing);
- at TP 2 over ``kv_size_multiplier`` 2 (thread ranks over gloo) the pooled
  streams equal TP 1's;
- trap 6: Mixtral's pool holds the attention targets only, and an adapter
  tree with an MLP or expert leaf is refused by name, as JAX's pool refuses
  it; a planted pool with the MLP targets takes such a tree silently.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.lora import core as jlora
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu_torch.converters.jax_params import (
    lora_params_from_jax,
    mixtral_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference.adapters import target_leaf_name
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.grammar import default_token_table, detokenize
from neuronx_distributed_tpu_torch.lora import LoraConfig, merge_lora
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.parallel import mesh
from tests.test_torch_runner import jax_params, run_jax, run_port

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False, num_experts=4, top_k=2)
LM = dict(buckets=(8, 16), max_batch=3)
POOL = dict(lora_rank=4, lora_slots=3)
K = 4
JCFG = jlora.LoraConfig(r=4, lora_alpha=8.0)
TCFG = LoraConfig(r=4, lora_alpha=8.0)
ATTENTION = {"q", "k", "v", "o_proj"}
PROMPTS = np.random.default_rng(5).integers(1, 127, (3, 8)).astype(np.int32)
SUBMITS = [dict(prompt=PROMPTS[0], max_new_tokens=6, adapter="a0"),
           dict(prompt=PROMPTS[1], max_new_tokens=5, adapter="a1", arrival_block=1),
           dict(prompt=PROMPTS[2], max_new_tokens=6)]
# selective decode needs T * top_k / E below the threshold: 3 * 2 / 4
THRESHOLDS = {"all_experts": 0.5, "selective": 2.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_adapter(params, i):
    ad = jlora.init_lora(params, JCFG, jax.random.key(10 + i))
    return {k: {"lora_a": np.asarray(v["lora_a"]),
                "lora_b": np.asarray(0.05 * jax.random.normal(
                    jax.random.fold_in(jax.random.key(20 + i), j), v["lora_b"].shape))}
            for j, (k, v) in enumerate(sorted(ad.items()))}


@pytest.fixture(scope="module")
def tree():
    jcfg = jm.MixtralConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(jm.MixtralForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"])
    jad = {f"a{i}": _jax_adapter(params, i) for i in range(2)}
    return params, jad


def _cfg(threshold=0.5, **over):
    return tm.MixtralConfig(**{**TINY, **over}, dtype=torch.float32,
                            selective_loading_threshold=threshold)


def _streams(eng, submits=SUBMITS, adapters=None, cfg=TCFG):
    for name, ad in (adapters or {}).items():
        eng.register_adapter(name, ad, cfg)
    rids = [eng.submit(**s) for s in submits]
    done = {c.request_id: c.tokens.tolist() for c in eng.run()}
    return [done[r] for r in rids]


@pytest.mark.parametrize("mode", sorted(THRESHOLDS))
def test_pooled_streams_equal_jax(tree, mode):
    """Two adapters and slot 0 in one block: the JAX engine's greedy
    tokens, in both decode modes; the adapters adapt attention only."""
    params, jad = tree
    assert {target_leaf_name(n) for ad in jad.values()
            for n in lora_params_from_jax(ad, TCFG)} == ATTENTION
    jcfg = jm.MixtralConfig(**TINY, dtype=jnp.float32, remat_policy=None,
                            selective_loading_threshold=THRESHOLDS[mode])
    jlm = JaxLM(jcfg, params, jm.MixtralForCausalLM, **LM, **POOL).compile()
    want = _streams(JaxEngine(jlm, block_steps=K, rng=jax.random.key(42)), adapters=jad,
                    cfg=JCFG)
    lm = CausalLM(_cfg(THRESHOLDS[mode]), mixtral_params_from_jax(params), tm.MixtralForCausalLM,
                  device="cpu", **LM, **POOL)
    assert set(lm.model.model.lora_layout.groups) == {"qkv", "o_proj"}
    got = _streams(ServeEngine(lm, block_steps=K, seed=42),
                   adapters={n: lora_params_from_jax(a, TCFG) for n, a in jad.items()})
    assert got == want
    assert got[0] != got[2] or got[1] != got[2]   # the adapters move the tokens


def test_adapter_streams_equal_merged_and_slot0_the_plain_lm(tree):
    params, jad = tree
    sd = mixtral_params_from_jax(params)
    tad = {n: lora_params_from_jax(a, TCFG) for n, a in jad.items()}
    lm = CausalLM(_cfg(), sd, tm.MixtralForCausalLM, device="cpu", **LM, **POOL)
    got = _streams(ServeEngine(lm, block_steps=K, seed=42), adapters=tad)
    for i, name in ((0, "a0"), (1, "a1")):
        merged = CausalLM(_cfg(), merge_lora(sd, tad[name], TCFG), tm.MixtralForCausalLM,
                          device="cpu", **LM)
        g = merged.generate(PROMPTS[i:i + 1], max_new_tokens=SUBMITS[i]["max_new_tokens"])
        assert got[i] == g.tokens[0].tolist(), name
    plain = CausalLM(_cfg(), sd, tm.MixtralForCausalLM, device="cpu", **LM)
    assert _streams(ServeEngine(plain, block_steps=K, seed=42), SUBMITS[2:]) == got[2:]


def test_runner_serve_mixtral_adapters_reports_jax_keys():
    """``serve --model mixtral --adapters 2 --paged``: JAX's report keys
    (the port adds only its own counters) and the same schedule; the demo
    adapters are each runner's own seeded draw, so the tokens differ."""
    argv = ["serve", "--tiny", "--model", "mixtral", "--adapters", "2", "--max_batch", "2",
            "--num_requests", "4", "--max_new_tokens", "6", "--fused_steps", "3", "--paged",
            "--page_size", "4"]
    (want,), _ = run_jax(argv)
    (got,), code = run_port(argv, params=jax_params("mixtral", max_batch=2))
    assert code is None
    port_keys = {"h2d_copies", "recovery_fetches", "tp_degree", "tier_d2h_copies",
                 "tier_h2d_copies", "tier_blocking_spills"}
    assert set(want) <= set(got) and set(got) - set(want) <= port_keys, (
        sorted(set(want) - set(got)), sorted(set(got) - set(want)))
    for key in ("requests_completed", "total_generated_tokens", "decode_blocks",
                "inserted_requests", "adapter_loads", "adapter_hits", "adapter_evictions"):
        assert got.get(key) == want.get(key), key
    assert got["requests_completed"] == 4 and got["adapter_loads"] > 0


def test_adapters_with_quantize_refused_with_jax_message():
    argv = ["serve", "--tiny", "--model", "mixtral", "--adapters", "2", "--quantize"]
    _, want = run_jax(argv)
    _, got = run_port(argv)
    assert got == want and "--adapters with --quantize" in str(got)


def test_grammar_tenancy_on_mixtral_equals_jax(tree):
    """A Mixtral ``CausalLM`` with a grammar pool: the JAX engine's tokens
    for a constrained and a free request, the constrained one parsing."""
    params, _ = tree
    regex = "a[ab]*b"
    submits = [dict(prompt=PROMPTS[0], max_new_tokens=8, grammar="g"),
               dict(prompt=PROMPTS[1], max_new_tokens=6)]
    grammar = dict(grammar_slots=2, grammar_states=16)
    jcfg = jm.MixtralConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    jeng = JaxEngine(JaxLM(jcfg, params, jm.MixtralForCausalLM, **LM, **grammar).compile(),
                     block_steps=K, rng=jax.random.key(42))
    jeng.register_grammar("g", regex=regex)
    want = _streams(jeng, submits)
    eng = ServeEngine(CausalLM(_cfg(), mixtral_params_from_jax(params), tm.MixtralForCausalLM,
                               device="cpu", **LM, **grammar), block_steps=K, seed=42)
    eng.register_grammar("g", regex=regex)
    got = _streams(eng, submits)
    assert got == want
    assert re.fullmatch(regex, detokenize(got[0], default_token_table(128)))


def test_pool_at_tp2_over_kv_multiplier_equals_tp1(tree):
    _, jad = tree
    cfg = _cfg(kv_size_multiplier=2)

    def serve(rank=0, tp=1):
        sd = tl.init_params(cfg, torch.Generator().manual_seed(0), model_cls=tm.MixtralForCausalLM,
                            tp_rank=rank, tp_size=tp)
        lm = CausalLM(cfg, sd, tm.MixtralForCausalLM, device="cpu", **LM, **POOL)
        assert lm.model.model.lora_layout.kv_compact
        ads = {n: lora_params_from_jax(a, TCFG, tp_rank=rank, tp_size=tp, kv_size_multiplier=2)
               for n, a in jad.items()}
        return _streams(ServeEngine(lm, block_steps=K, seed=42), adapters=ads)

    want = serve()
    for got in mesh.run_in_threads(2, lambda r: serve(r, 2)):
        assert got == want


def test_trap6_pool_refuses_mlp_and_expert_leaves_by_name(tree, monkeypatch):
    params, jad = tree
    sd = mixtral_params_from_jax(params)
    ad = lora_params_from_jax(jad["a0"], TCFG)
    a, b = next(iter(ad.values())).values()
    for leaf in ("model.layers.0.mlp.gate_proj.kernel", "model.layers.0.moe.experts.gate"):
        bad = {**ad, leaf: {"lora_a": a, "lora_b": b}}
        eng = ServeEngine(CausalLM(_cfg(), sd, tm.MixtralForCausalLM, device="cpu", **LM, **POOL),
                          block_steps=K, seed=42)
        with pytest.raises(ValueError, match=re.escape(leaf)):
            eng.register_adapter("bad", bad, TCFG)
    # JAX's pool refuses an MLP target too: it has no stacks for it
    jcfg = jm.MixtralConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    jeng = JaxEngine(JaxLM(jcfg, params, jm.MixtralForCausalLM, **LM, **POOL).compile(),
                     block_steps=K, rng=jax.random.key(42))
    jbad = {**jad["a0"], "['model']['layers']['block']['mlp']['gate_proj']['kernel']":
            next(iter(jad["a0"].values()))}
    with pytest.raises(ValueError, match="outside the pool's coverage"):
        jeng.register_adapter("bad", jbad, JCFG)
    # planted: a pool that keeps the MLP targets takes the MLP leaf silently
    monkeypatch.setattr(tl, "pool_targets", lambda cfg: set(cfg.lora_targets))
    eng = ServeEngine(CausalLM(_cfg(), sd, tm.MixtralForCausalLM, device="cpu", **LM, **POOL),
                      block_steps=K, seed=42)
    eng.register_adapter("bad", {**ad, "model.layers.0.mlp.gate_proj.kernel": {
        "lora_a": a, "lora_b": torch.zeros((a.shape[1], 64))}}, TCFG)
