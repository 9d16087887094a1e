"""The port's LoRA core (``neuronx_distributed_tpu_torch/lora/core.py``),
its JAX converter and the model's pool correction, held against the JAX
package.

- ``merge_lora`` and ``lora_params_from_jax`` against JAX ``merge_lora``
  on one seeded adapter tree with a nonzero ``B``: the merged weights
  agree (fp32, 1e-6), for the default targets, for ``qkv`` alone and with
  the embedding;
- ``init_lora`` adapts the weights JAX's ``init_lora`` adapts (the
  converter's keys), ``A`` at std ``1/sqrt(fan_in)``, ``B`` zero;
- a model with an adapter loaded into a pool slot gives the logits of the
  same model with ``merge_lora``'d weights (fp32, 2e-5), and a slot-0 row
  the logits of a model built without LoRA, bit for bit.

Tiny model: 2 layers, hidden 32, GQA 4/2 heads, fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.lora import core as jlora
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    lora_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference.adapters import AdapterPool, target_leaf_name
from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora, merge_lora
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
TARGETS = {"default": ("qkv", "o_proj", "gate_proj", "up_proj", "down_proj"),
           "qkv": ("qkv",), "embed": ("embed", "o_proj", "down_proj")}


@pytest.fixture(scope="module")
def base():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, llama_params_from_jax(params)


def _jax_adapter(params, cfg, seed):
    """A JAX ``init_lora`` tree with a nonzero B (0.05 * normal, as the
    JAX multi-LoRA tests make theirs)."""
    ad = jlora.init_lora(params, cfg, jax.random.key(seed))
    return {k: {"lora_a": np.asarray(v["lora_a"]),
                "lora_b": np.asarray(0.05 * jax.random.normal(
                    jax.random.fold_in(jax.random.key(seed + 1), j), v["lora_b"].shape))}
            for j, (k, v) in enumerate(sorted(ad.items()))}


@pytest.mark.parametrize("targets", sorted(TARGETS))
def test_merge_and_converter_match_jax_merge(base, targets):
    params, sd = base
    jcfg = jlora.LoraConfig(r=4, lora_alpha=8.0, target_modules=TARGETS[targets])
    tcfg = LoraConfig(r=4, lora_alpha=8.0, target_modules=TARGETS[targets])
    ad = _jax_adapter(params, jcfg, 3)
    want = llama_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jlora.merge_lora(params, ad, jcfg)))
    got = merge_lora(sd, lora_params_from_jax(ad, tcfg), tcfg)
    assert set(got) == set(want)
    changed = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        changed += int(not torch.equal(got[k], sd[k]))
    assert changed == len(lora_params_from_jax(ad, tcfg))


def test_init_lora_adapts_what_jax_adapts(base):
    params, sd = base
    cfg = LoraConfig(r=4)
    jtree = jlora.init_lora(params, jlora.LoraConfig(r=4), jax.random.key(0))
    mine = init_lora(sd, cfg, torch.Generator().manual_seed(0))
    assert set(mine) == set(lora_params_from_jax(jtree, cfg))
    big = init_lora({"x.mlp.up_proj.kernel": torch.zeros(4096, 8)}, cfg,
                    torch.Generator().manual_seed(1))["x.mlp.up_proj.kernel"]
    assert big["lora_a"].shape == (4096, 4) and big["lora_b"].shape == (4, 8)
    assert abs(float(big["lora_a"].std()) * 64 - 1.0) < 0.05
    assert not big["lora_b"].any()
    with pytest.raises(ValueError, match="target_modules"):
        init_lora(sd, LoraConfig(target_modules=("nothing",)), torch.Generator())
    with pytest.raises(ValueError, match="rank"):
        lora_params_from_jax(jtree, LoraConfig(r=8))
    assert LoraConfig(r=8, lora_alpha=16.0).scaling == 2.0


@pytest.mark.parametrize("path,leaf", [
    ("model.layers.1.attention.qkv.q_kernel", "q"), ("model.layers.0.attention.qkv.v_kernel", "v"),
    ("model.layers.0.attention.o_proj.kernel", "o_proj"),
    ("model.layers.1.mlp.down_proj.kernel", "down_proj"), ("model.embed.embedding", None),
    ("model.layers.0.input_norm.scale", None)])
def test_target_leaf_name(path, leaf):
    assert target_leaf_name(path) == leaf


def _logits(model, ids, slots=None):
    model.model.adapter_idx = None if slots is None else torch.as_tensor(slots)
    with torch.no_grad():
        return model(ids).float()


@pytest.mark.parametrize("rank", [4, 2])
def test_pool_slot_equals_merged_weights(base, rank):
    """One adapter in slot 1 of a rank-4 pool (rank 2: zero-padded), a base
    row beside it in slot 0: the adapter row's logits are the merged
    model's, the base row's those of a model without LoRA, bit for bit."""
    params, sd = base
    cfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    lcfg = LoraConfig(r=rank, lora_alpha=8.0)
    jcfg = jlora.LoraConfig(r=rank, lora_alpha=8.0)
    ad = lora_params_from_jax(_jax_adapter(params, jcfg, 7), lcfg)
    pooled = tl.LlamaForCausalLM(dataclasses.replace(cfg, lora_rank=4, lora_slots=3))
    pooled.load_state_dict(sd)
    pool = AdapterPool(pooled.model.lora_pool, pooled.model.lora_layout)
    pool.register("a", ad, lcfg)
    slot = pool.acquire("a")
    plain = tl.LlamaForCausalLM(cfg)
    plain.load_state_dict(sd)
    merged = tl.LlamaForCausalLM(cfg)
    merged.load_state_dict(merge_lora(sd, ad, lcfg))
    ids = torch.as_tensor(np.random.default_rng(1).integers(1, 127, (2, 12)))
    got = _logits(pooled, ids, [slot, 0])
    np.testing.assert_allclose(got[0].numpy(), _logits(merged, ids[:1])[0].numpy(),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(got[1], _logits(plain, ids[1:])[0])
    assert torch.equal(_logits(pooled, ids), _logits(plain, ids))
