"""The port's family-generic HF converter (``converters/hf.py``) against
``transformers`` and against the JAX package's converter, on the CPU.

For GPT-NeoX, BERT, Mixtral and DBRX a small ``transformers`` model is built
in this process from a config with seeded weights (biases and norms moved
off 0 and 1, so a misplaced one shows; nothing is downloaded) and saved as
safetensors. The port reads its config and weights (``FAMILIES[...]``), and
its logits must match the HF model's at fp32 (``atol=2e-4``: the tiny
models' logits reach about 3, and the frameworks sum in other orders;
Mixtral and DBRX run ``all_experts``, as HF evaluates every routed expert).
The round trip HF -> port -> HF gives the same bytes; the port's state
dict equals the JAX package's ``hf_to_nxd_*`` carried over by
``*_params_from_jax``; ``detect_family`` names every family; the CLI
converts both ways; and ``lora.core.export_merged_hf`` writes a NeoX
checkpoint that ``transformers`` serves with the merged model's logits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_tpu.converters import hf as jhf
from neuronx_distributed_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from neuronx_distributed_tpu_torch.converters import hf as thf
from neuronx_distributed_tpu_torch.converters.hf_llama import load_hf_safetensors
from neuronx_distributed_tpu_torch.converters.jax_params import (
    bert_params_from_jax,
    gpt_neox_params_from_jax,
    mixtral_params_from_jax,
)
from neuronx_distributed_tpu_torch.lora.core import LoraConfig, export_merged_hf, merge_lora
from neuronx_distributed_tpu_torch.models.bert import BertForPreTraining
from neuronx_distributed_tpu_torch.models.gpt_neox import GPTNeoXForCausalLM
from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM

TOL = 2e-4
FAMILY_NAMES = ("gpt_neox", "bert", "mixtral", "dbrx")
HF = {
    "gpt_neox": (transformers.GPTNeoXConfig, transformers.GPTNeoXForCausalLM, dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, rotary_pct=0.25,
        rotary_emb_base=10000, use_parallel_residual=True, layer_norm_eps=1e-5,
        tie_word_embeddings=False, hidden_act="gelu", attention_dropout=0.0,
        hidden_dropout=0.0)),
    "bert": (transformers.BertConfig, transformers.BertForPreTraining, dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, type_vocab_size=2,
        layer_norm_eps=1e-12, hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)),
    "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM, dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
        num_local_experts=4, num_experts_per_tok=2, attention_dropout=0.0)),
    "dbrx": (transformers.DbrxConfig, transformers.DbrxForCausalLM, dict(
        d_model=32, n_heads=4, n_layers=2, max_seq_len=64, vocab_size=96,
        attn_config=dict(kv_n_heads=2, clip_qkv=8.0, rope_theta=10000.0),
        ffn_config=dict(ffn_hidden_size=48, moe_num_experts=4, moe_top_k=2),
        attn_pdrop=0.0, resid_pdrop=0.0)),
}
PORT_MODEL = {"gpt_neox": GPTNeoXForCausalLM, "bert": BertForPreTraining,
              "mixtral": MixtralForCausalLM, "dbrx": MixtralForCausalLM}
# buffers and the tied decoder's duplicates: no weights of their own
SKIP = ("rotary_emb", "position_ids", "masked_bias", "cls.predictions.decoder.")


@pytest.fixture(scope="module")
def hf_models(tmp_path_factory):
    out = {}
    for fam in FAMILY_NAMES:
        cfg_cls, model_cls, kw = HF[fam]
        torch.manual_seed(0)
        model = model_cls(cfg_cls(**kw)).eval()
        for name, p in model.named_parameters():   # biases and norms off 0 and 1
            if p.dim() == 1:
                p.data.uniform_(0.5, 1.5) if "norm" in name.lower() else p.data.normal_(0, 0.1)
        path = tmp_path_factory.mktemp(fam)
        model.save_pretrained(path, safe_serialization=True)
        out[fam] = (str(path), model)
    return out


def _hf_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if not any(s in k for s in SKIP) and not (k.endswith("attention.bias")
                                                       and "gpt_neox" in k)}


def _port_config(fam, path):
    over = dict(dtype=torch.float32, param_dtype=torch.float32, use_flash_attention=False)
    cfg = thf.FAMILIES[fam].config_from_hf(path)
    if fam == "bert":
        over["hidden_dropout"] = 0.0
    else:
        over["remat_policy"] = None
    if fam in ("mixtral", "dbrx"):
        over["moe_mode"] = "all_experts"   # HF runs every routed token, no capacity
    return dataclasses.replace(cfg, **over)


def _inputs():
    rs = np.random.RandomState(0)
    ids = rs.randint(5, 96, (2, 16))
    tt = rs.randint(0, 2, (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 11:] = 0
    return ids, tt, mask


@pytest.mark.parametrize("fam", FAMILY_NAMES)
def test_logits_match_transformers(fam, hf_models):
    path, hf = hf_models[fam]
    cfg = _port_config(fam, path)
    state = thf.FAMILIES[fam].hf_to_nxd(load_hf_safetensors(path), cfg)
    model = PORT_MODEL[fam](cfg)
    model.load_state_dict(state, strict=True)
    ids, tt, mask = (torch.as_tensor(x) for x in _inputs())
    with torch.no_grad():
        if fam == "bert":
            want = hf(ids, attention_mask=mask, token_type_ids=tt)
            mlm, nsp = model(ids, tt, mask)
            valid = mask.bool()   # HF's masked positions attend too; compare the rest
            np.testing.assert_allclose(mlm[valid].numpy(),
                                       want.prediction_logits[valid].numpy(), atol=TOL)
            np.testing.assert_allclose(nsp.numpy(), want.seq_relationship_logits.numpy(),
                                       atol=TOL)
        else:
            np.testing.assert_allclose(model(ids).numpy(), hf(ids).logits.numpy(), atol=TOL)


@pytest.mark.parametrize("fam", FAMILY_NAMES)
def test_roundtrip_exact_and_equal_to_jax(fam, hf_models):
    path, hf = hf_models[fam]
    cfg = _port_config(fam, path)
    hf_state = _hf_state(hf)
    fam_ = thf.FAMILIES[fam]
    ours = fam_.hf_to_nxd(hf_state, cfg)
    back = fam_.nxd_to_hf(ours, cfg)
    assert set(back) == set(hf_state), set(back) ^ set(hf_state)
    for k, v in hf_state.items():
        assert torch.equal(back[k], v), k
    # the JAX converter's tree, carried over, is the port's state dict
    jfam = jhf.FAMILIES[fam]
    jcfg = jfam.config_from_hf(path)
    jtree = jax.tree_util.tree_map(np.asarray, jfam.hf_to_nxd(
        {k: v.numpy() for k, v in hf_state.items()}, jcfg))
    carried = {"gpt_neox": gpt_neox_params_from_jax, "bert": bert_params_from_jax,
               "mixtral": mixtral_params_from_jax, "dbrx": mixtral_params_from_jax}[fam](jtree)
    assert set(carried) == set(ours)
    for k, v in ours.items():
        assert torch.equal(carried[k], v), k


def test_detect_family(hf_models, tmp_path):
    for fam in FAMILY_NAMES:
        assert thf.detect_family(_hf_state(hf_models[fam][1])) == fam
        assert jhf.detect_family(list(_hf_state(hf_models[fam][1]))) == fam
    assert thf.detect_family(["model.layers.0.self_attn.q_proj.weight"]) == "llama"
    with pytest.raises(ValueError, match="cannot infer"):
        thf.detect_family(["encoder.weight"])


@pytest.mark.parametrize("fam", ("gpt_neox", "bert"))
def test_cli_both_directions(fam, hf_models, tmp_path):
    path, hf = hf_models[fam]
    ckpt = tmp_path / "ckpt"
    thf.main(["--input", path, "--output", str(ckpt)])     # auto-detected
    state, _ = load_checkpoint(str(ckpt))
    cfg = thf.FAMILIES[fam].config_from_hf(path)
    want = thf.FAMILIES[fam].hf_to_nxd(load_hf_safetensors(path), cfg)
    assert set(state) == set(want) and all(torch.equal(state[k], want[k]) for k in want)
    out = tmp_path / "hf"
    with pytest.raises(SystemExit):
        thf.main(["--input", str(ckpt), "--output", str(out), "--direction", "nxd2hf"])
    thf.main(["--input", str(ckpt), "--output", str(out), "--direction", "nxd2hf",
              "--model", fam, "--config", path])
    back = load_hf_safetensors(str(out / "model.safetensors"))
    for k, v in _hf_state(hf).items():
        assert torch.equal(back[k], v), k


def test_export_merged_hf_neox_serves_in_transformers(hf_models, tmp_path):
    """A NeoX LoRA merge exported through ``FAMILIES`` (the refusal for
    families other than Llama is gone): ``transformers`` loads it and gives
    the port's merged model's logits."""
    path, _ = hf_models["gpt_neox"]
    cfg = _port_config("gpt_neox", path)
    base = thf.hf_to_nxd_neox(load_hf_safetensors(path), cfg)
    g = torch.Generator().manual_seed(3)
    lora = {n: {"lora_a": torch.randn((base[n].shape[0], 4), generator=g),
                "lora_b": torch.randn((4, base[n][0].numel()), generator=g) * 0.05}
            for n in ("model.layers.0.attention.o_proj.kernel", "model.layers.1.mlp.up.kernel",
                      "model.layers.0.attention.qkv.q_kernel")}
    lcfg = LoraConfig(r=4, lora_alpha=8.0)
    saved = export_merged_hf(base, lora, lcfg, cfg, str(tmp_path), family="gpt_neox")
    merged = merge_lora(base, lora, lcfg)
    model = GPTNeoXForCausalLM(cfg)
    model.load_state_dict(merged, strict=True)
    hf = transformers.GPTNeoXForCausalLM.from_pretrained(path).eval()
    hf.load_state_dict(load_hf_safetensors(saved), strict=False)
    ids = torch.as_tensor(_inputs()[0])
    with torch.no_grad():
        np.testing.assert_allclose(model(ids).numpy(), hf(ids).logits.numpy(), atol=TOL)
    # and a port checkpoint of the merged tree converts the same way
    save_checkpoint(str(tmp_path / "m"), "merged", merged)
    state, _ = load_checkpoint(str(tmp_path / "m"))
    assert all(torch.equal(state[k], merged[k]) for k in merged)
