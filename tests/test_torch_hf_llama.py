"""The port's HF Llama converter, against ``transformers`` and against the
JAX package's converter, on the CPU.

A small ``transformers.LlamaForCausalLM(LlamaConfig(...))`` is built in
this process with random weights from a seed (nothing is downloaded) and
saved to a temporary directory as safetensors. The port reads its config
and weights, and its logits and loss must match the HF model's (fp32: 2e-5
on logits of about 1, 1e-5 on the loss: the two frameworks sum in another
order). The port's state dict must equal the JAX package's
``hf_to_nxd_llama`` carried over by ``llama_params_from_jax``, and the round
trip HF -> port -> HF must give the same bytes (fused QKV too).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_tpu.converters import hf_llama as jhf
from neuronx_distributed_tpu_torch.converters import hf_llama as thf
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    neuronx_distributed_config,
)

LOGIT_TOL = 2e-5
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=80, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
    model = transformers.LlamaForCausalLM(cfg).eval()
    for p in model.parameters():   # norms away from 1, so their mapping shows
        if p.dim() == 1:
            p.data.uniform_(0.5, 1.5)
    out = tmp_path_factory.mktemp("hf")
    model.save_pretrained(out, safe_serialization=True)
    return out, model


def test_logits_and_loss_match_transformers(hf_dir):
    path, hf = hf_dir
    cfg = dataclasses.replace(thf.config_from_hf(str(path)), dtype=torch.float32,
                              param_dtype=torch.float32, remat_policy=None)
    assert (cfg.vocab_size, cfg.num_layers, cfg.num_kv_heads, cfg.rope_theta) == (
        96, 2, 2, 500000.0)
    state = thf.hf_to_nxd_llama(thf.load_hf_safetensors(str(path)), cfg)
    model = initialize_parallel_model(neuronx_distributed_config(),
                                      lambda: tl.LlamaForCausalLM(cfg), device="cpu",
                                      params=state)
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 96, (2, 40)))
    with torch.no_grad():
        want = hf(input_ids=ids, labels=ids)
        logits = model.module(ids)
        labels = torch.cat([ids[:, 1:], torch.full((2, 1), -100)], dim=1)
        loss = model.module.loss(ids, labels)
    np.testing.assert_allclose(logits.numpy(), want.logits.numpy(), atol=LOGIT_TOL)
    np.testing.assert_allclose(float(loss), float(want.loss), atol=LOSS_TOL)


def test_conversion_equals_jax_and_config_fields(hf_dir):
    path, _ = hf_dir
    hf = thf.load_hf_safetensors(str(path))
    jcfg = jhf.config_from_hf(str(path))
    tcfg = thf.config_from_hf(str(path))
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "max_seq_len", "rope_theta", "rms_norm_eps", "head_dim_",
              "tie_word_embeddings"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    want = llama_params_from_jax(jhf.hf_to_nxd_llama(
        {k: v.numpy() for k, v in hf.items()}, jcfg, dtype=jnp.float32))
    got = thf.hf_to_nxd_llama(hf, tcfg, dtype=torch.float32)
    assert set(got) == set(want)
    for n, t in want.items():
        assert torch.equal(got[n], t), n


@pytest.mark.parametrize("fused", [False, True])
def test_round_trip_is_exact(hf_dir, tmp_path, fused):
    path, _ = hf_dir
    hf = thf.load_hf_safetensors(str(path))
    cfg = thf.config_from_hf(str(path))
    if fused:
        for i in range(cfg.num_layers):
            pre = f"model.layers.{i}.self_attn."
            hf[pre + "qkv_proj.weight"] = torch.cat([hf.pop(pre + f"{n}_proj.weight")
                                                     for n in "qkv"])
    state = thf.hf_to_nxd_llama(hf, cfg, dtype=torch.float32, fused_qkv=fused)
    back = thf.nxd_to_hf_llama(state, cfg, fused_qkv=fused)
    assert set(back) == set(hf)
    out = str(tmp_path / "model.safetensors")
    thf.save_hf_safetensors(back, out)
    again = thf.load_hf_safetensors(out)
    for n, t in hf.items():
        assert torch.equal(again[n], t), n


def test_cli_converts_both_ways(hf_dir, tmp_path):
    path, _ = hf_dir
    thf.main(["--input", str(path), "--output", str(tmp_path / "ckpt")])
    thf.main(["--input", str(tmp_path / "ckpt"), "--output", str(tmp_path / "hf"),
              "--direction", "nxd2hf", "--config", str(path)])
    want = thf.load_hf_safetensors(str(path))
    got = thf.load_hf_safetensors(str(tmp_path / "hf"))
    for n, t in want.items():
        assert torch.equal(got[n], t.float()), n
