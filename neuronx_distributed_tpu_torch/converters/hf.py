"""HF <-> port conversion of every model family, from and to local
safetensors files.

Counterpart of ``neuronx_distributed_tpu/converters/hf.py`` (the
reference's family-generic ``checkpoint_converter.py``) in the port's
state-dict names. :data:`FAMILIES` maps a family to its ``(config_from_hf,
hf_to_nxd, nxd_to_hf)``; :func:`detect_family` reads the family from the
checkpoint's key prefixes. HF's ``(out, in)`` weights transpose to the
port's ``(in, out)`` kernels and each layer keeps its own entries.

* ``llama``: ``converters/hf_llama.py``.
* ``mixtral``: the Llama attention; each expert's ``w1``/``w3``/``w2``
  stacked into the ``(E, H, I)``/``(E, I, H)`` tensors of ``ExpertMLPs``.
* ``gpt_neox``: the fused ``query_key_value`` rows are ordered per head
  ``[q_h, k_h, v_h]`` (not ``[Q; K; V]``); biases everywhere, biased
  LayerNorms.
* ``bert``: the encoder and the MLM/NSP heads (``cls.predictions``,
  ``cls.seq_relationship``); the MLM decoder is the tied word embedding, its
  bias ``cls.predictions.bias``.
* ``dbrx``: the fused ``Wqkv`` in ``[Q; K; V]`` order, experts pre-fused as
  ``w1``/``v1``/``w2`` of ``(E * I, H)``, bias-free LayerNorms.

Files are read and written by ``checkpoint/tensor_file.py``; nothing is
downloaded.

    python -m neuronx_distributed_tpu_torch.converters.hf \\
        --input HF_DIR --output CKPT_DIR [--direction hf2nxd|nxd2hf] [--model auto|...]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch

from neuronx_distributed_tpu_torch.converters.hf_llama import (
    _t,
    config_from_hf as llama_config_from_hf,
    hf_to_nxd_llama,
    load_hf_safetensors,
    nxd_to_hf_llama,
    save_hf_checkpoint,
)

Tree = Dict[str, torch.Tensor]


def _read_hf_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "config.json") if os.path.isdir(path) else path) as f:
        return json.load(f)


def _cast(out: Tree, dtype: torch.dtype) -> Tree:
    return {k: v.to(dtype).contiguous() for k, v in out.items()}


def _getter(state: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Callable:
    return lambda name: state[name].detach().cpu().to(dtype)


# --------------------------------------------------------------------- mixtral

def mixtral_config_from_hf(path: str):
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig

    hc = _read_hf_config(path)
    return MixtralConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"], num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        num_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        max_seq_len=hc.get("max_position_embeddings", 4096), rope_theta=hc.get("rope_theta", 1e6),
        rms_norm_eps=hc.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=hc.get("tie_word_embeddings", False),
        num_experts=hc["num_local_experts"], top_k=hc["num_experts_per_tok"])


def hf_to_nxd_mixtral(hf: Mapping[str, Any], config, dtype: Optional[torch.dtype] = None) -> Tree:
    """The attention, embedding and norms as Llama's; each layer's experts
    stacked into the fused ``(E, H, I)`` gate/up and ``(E, I, H)`` down."""
    cfg = config
    out = hf_to_nxd_llama({k: v for k, v in hf.items() if "block_sparse_moe" not in k}, cfg,
                          dtype=torch.float32)
    for i in range(cfg.num_layers):
        moe = f"model.layers.{i}.block_sparse_moe"
        out[f"model.layers.{i}.moe.router.kernel"] = _t(hf[f"{moe}.gate.weight"]).T
        for ours, w in (("gate", "w1"), ("up", "w3"), ("down", "w2")):
            out[f"model.layers.{i}.moe.experts.{ours}"] = torch.stack([
                _t(hf[f"{moe}.experts.{e}.{w}.weight"]).T for e in range(cfg.num_experts)])
    return _cast(out, dtype or cfg.param_dtype)


def nxd_to_hf_mixtral(state: Mapping[str, torch.Tensor], config,
                      dtype: torch.dtype = torch.float32) -> Tree:
    cfg = config
    get = _getter(state, dtype)
    out = nxd_to_hf_llama({k: v for k, v in state.items() if ".moe." not in k}, cfg, dtype=dtype)
    for i in range(cfg.num_layers):
        moe = f"model.layers.{i}.block_sparse_moe"
        out[f"{moe}.gate.weight"] = get(f"model.layers.{i}.moe.router.kernel").T
        for ours, w in (("gate", "w1"), ("up", "w3"), ("down", "w2")):
            stacked = get(f"model.layers.{i}.moe.experts.{ours}")
            for e in range(cfg.num_experts):
                out[f"{moe}.experts.{e}.{w}.weight"] = stacked[e].T
    return {k: v.contiguous() for k, v in out.items()}


# -------------------------------------------------------------------- gpt_neox

def neox_config_from_hf(path: str):
    from neuronx_distributed_tpu_torch.models.gpt_neox import GPTNeoXConfig

    hc = _read_hf_config(path)
    return GPTNeoXConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"], num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"], num_kv_heads=hc["num_attention_heads"],
        max_seq_len=hc.get("max_position_embeddings", 2048),
        rope_theta=hc.get("rotary_emb_base", 10000.0), rotary_pct=hc.get("rotary_pct", 0.25),
        use_parallel_residual=hc.get("use_parallel_residual", True),
        layer_norm_eps=hc.get("layer_norm_eps", 1e-5),
        tie_word_embeddings=hc.get("tie_word_embeddings", False))


_NEOX_DENSE = (("attention.dense", "attention.o_proj"), ("mlp.dense_h_to_4h", "mlp.up"),
               ("mlp.dense_4h_to_h", "mlp.down"))
_NEOX_NORMS = (("input_layernorm", "input_norm"), ("post_attention_layernorm", "post_attn_norm"))


def hf_to_nxd_neox(hf: Mapping[str, Any], config, dtype: Optional[torch.dtype] = None) -> Tree:
    cfg = config
    H, N, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim_
    out: Tree = {"model.embed.embedding": _t(hf["gpt_neox.embed_in.weight"]),
                 "model.final_norm.ln.scale": _t(hf["gpt_neox.final_layer_norm.weight"]),
                 "model.final_norm.ln.bias": _t(hf["gpt_neox.final_layer_norm.bias"])}
    for i in range(cfg.num_layers):
        pre, ours = f"gpt_neox.layers.{i}.", f"model.layers.{i}."
        # (N * 3 * D, H), rows per head [q, k, v] -> kernels (H, N, D), biases (N, D)
        w = _t(hf[f"{pre}attention.query_key_value.weight"]).reshape(N, 3, D, H)
        b = _t(hf[f"{pre}attention.query_key_value.bias"]).reshape(N, 3, D)
        for j, c in enumerate("qkv"):
            out[f"{ours}attention.qkv.{c}_kernel"] = w[:, j].permute(2, 0, 1)
            out[f"{ours}attention.qkv.{c}_bias"] = b[:, j]
        for name, port in _NEOX_DENSE:
            out[f"{ours}{port}.kernel"] = _t(hf[f"{pre}{name}.weight"]).T
            out[f"{ours}{port}.bias"] = _t(hf[f"{pre}{name}.bias"])
        for name, port in _NEOX_NORMS:
            out[f"{ours}{port}.ln.scale"] = _t(hf[f"{pre}{name}.weight"])
            out[f"{ours}{port}.ln.bias"] = _t(hf[f"{pre}{name}.bias"])
    if not cfg.tie_word_embeddings:
        if "embed_out.weight" not in hf:
            raise KeyError("gpt_neox checkpoint has tie_word_embeddings=False but no "
                           "'embed_out.weight': refusing to substitute the input embedding as "
                           "the lm_head")
        out["lm_head.kernel"] = _t(hf["embed_out.weight"]).T
    return _cast(out, dtype or cfg.param_dtype)


def nxd_to_hf_neox(state: Mapping[str, torch.Tensor], config,
                   dtype: torch.dtype = torch.float32) -> Tree:
    cfg = config
    H, N, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim_
    get = _getter(state, dtype)
    out: Tree = {"gpt_neox.embed_in.weight": get("model.embed.embedding"),
                 "gpt_neox.final_layer_norm.weight": get("model.final_norm.ln.scale"),
                 "gpt_neox.final_layer_norm.bias": get("model.final_norm.ln.bias")}
    if "lm_head.kernel" in state:
        out["embed_out.weight"] = get("lm_head.kernel").T
    for i in range(cfg.num_layers):
        pre, ours = f"gpt_neox.layers.{i}.", f"model.layers.{i}."
        w = torch.stack([get(f"{ours}attention.qkv.{c}_kernel").permute(1, 2, 0)
                         for c in "qkv"], dim=1)                          # (N, 3, D, H)
        out[f"{pre}attention.query_key_value.weight"] = w.reshape(N * 3 * D, H)
        b = torch.stack([get(f"{ours}attention.qkv.{c}_bias") for c in "qkv"], dim=1)
        out[f"{pre}attention.query_key_value.bias"] = b.reshape(N * 3 * D)
        for name, port in _NEOX_DENSE:
            out[f"{pre}{name}.weight"] = get(f"{ours}{port}.kernel").T
            out[f"{pre}{name}.bias"] = get(f"{ours}{port}.bias")
        for name, port in _NEOX_NORMS:
            out[f"{pre}{name}.weight"] = get(f"{ours}{port}.ln.scale")
            out[f"{pre}{name}.bias"] = get(f"{ours}{port}.ln.bias")
    return {k: v.contiguous() for k, v in out.items()}


# ------------------------------------------------------------------------ bert

def bert_config_from_hf(path: str):
    from neuronx_distributed_tpu_torch.models.bert import BertConfig

    hc = _read_hf_config(path)
    return BertConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"], num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        max_position_embeddings=hc.get("max_position_embeddings", 512),
        type_vocab_size=hc.get("type_vocab_size", 2),
        layer_norm_eps=hc.get("layer_norm_eps", 1e-12))


# HF name -> port name: dense layers (weight transposed, bias) and LayerNorms
_BERT_DENSE = (("bert.pooler.dense", "bert.pooler"),
               ("cls.predictions.transform.dense", "mlm_transform"),
               ("cls.seq_relationship", "nsp_head"))
_BERT_NORMS = (("bert.embeddings.LayerNorm", "bert.embed_norm"),
               ("cls.predictions.transform.LayerNorm", "mlm_norm"))
_BERT_EMBEDS = ("word_embeddings", "position_embeddings", "token_type_embeddings")
_BERT_LAYER_DENSE = (("attention.output.dense", "attention.output"),
                     ("intermediate.dense", "intermediate"), ("output.dense", "mlp_output"))
_BERT_LAYER_NORMS = (("attention.output.LayerNorm", "attention_norm"),
                     ("output.LayerNorm", "output_norm"))
_BERT_QKV = (("query", "q"), ("key", "k"), ("value", "v"))


def hf_to_nxd_bert(hf: Mapping[str, Any], config, dtype: Optional[torch.dtype] = None) -> Tree:
    cfg = config
    H, N, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim_
    out: Tree = {f"bert.{e}.embedding": _t(hf[f"bert.embeddings.{e}.weight"])
                 for e in _BERT_EMBEDS}
    out["mlm_bias"] = _t(hf["cls.predictions.bias"])

    def dense(name, port):
        out[f"{port}.kernel"] = _t(hf[f"{name}.weight"]).T
        out[f"{port}.bias"] = _t(hf[f"{name}.bias"])

    def norm(name, port):
        out[f"{port}.ln.scale"] = _t(hf[f"{name}.weight"])
        out[f"{port}.ln.bias"] = _t(hf[f"{name}.bias"])

    for name, port in _BERT_DENSE:
        dense(name, port)
    for name, port in _BERT_NORMS:
        norm(name, port)
    for i in range(cfg.num_layers):
        pre, ours = f"bert.encoder.layer.{i}.", f"bert.layers.{i}."
        for name, c in _BERT_QKV:
            out[f"{ours}attention.qkv.{c}_kernel"] = _t(
                hf[f"{pre}attention.self.{name}.weight"]).T.reshape(H, N, D)
            out[f"{ours}attention.qkv.{c}_bias"] = _t(
                hf[f"{pre}attention.self.{name}.bias"]).reshape(N, D)
        for name, port in _BERT_LAYER_DENSE:
            dense(pre + name, ours + port)
        for name, port in _BERT_LAYER_NORMS:
            norm(pre + name, ours + port)
    return _cast(out, dtype or cfg.param_dtype)


def nxd_to_hf_bert(state: Mapping[str, torch.Tensor], config,
                   dtype: torch.dtype = torch.float32) -> Tree:
    cfg = config
    H, N, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim_
    get = _getter(state, dtype)
    out: Tree = {f"bert.embeddings.{e}.weight": get(f"bert.{e}.embedding") for e in _BERT_EMBEDS}
    out["cls.predictions.bias"] = get("mlm_bias")

    def dense(name, port):
        out[f"{name}.weight"] = get(f"{port}.kernel").T
        out[f"{name}.bias"] = get(f"{port}.bias")

    def norm(name, port):
        out[f"{name}.weight"] = get(f"{port}.ln.scale")
        out[f"{name}.bias"] = get(f"{port}.ln.bias")

    for name, port in _BERT_DENSE:
        dense(name, port)
    for name, port in _BERT_NORMS:
        norm(name, port)
    for i in range(cfg.num_layers):
        pre, ours = f"bert.encoder.layer.{i}.", f"bert.layers.{i}."
        for name, c in _BERT_QKV:
            out[f"{pre}attention.self.{name}.weight"] = get(
                f"{ours}attention.qkv.{c}_kernel").reshape(H, N * D).T
            out[f"{pre}attention.self.{name}.bias"] = get(
                f"{ours}attention.qkv.{c}_bias").reshape(N * D)
        for name, port in _BERT_LAYER_DENSE:
            dense(pre + name, ours + port)
        for name, port in _BERT_LAYER_NORMS:
            norm(pre + name, ours + port)
    return {k: v.contiguous() for k, v in out.items()}


# ------------------------------------------------------------------------ dbrx

def dbrx_config_from_hf(path: str):
    """HF's ``DbrxConfig`` nests the attention and FFN settings under
    ``attn_config`` and ``ffn_config``; the model is the MoE stack with
    bias-free LayerNorms and clipped QKV (``models/mixtral.py``'s ``dbrx``)."""
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig

    hc = _read_hf_config(path)
    attn = hc.get("attn_config", {}) or {}
    ffn = hc.get("ffn_config", {}) or {}
    return MixtralConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["d_model"],
        intermediate_size=ffn.get("ffn_hidden_size", 10752), num_layers=hc["n_layers"],
        num_heads=hc["n_heads"], num_kv_heads=attn.get("kv_n_heads", 8),
        rope_theta=attn.get("rope_theta", 5e5), num_experts=ffn.get("moe_num_experts", 16),
        top_k=ffn.get("moe_top_k", 4), max_seq_len=hc.get("max_seq_len", 2048),
        tie_word_embeddings=hc.get("tie_word_embeddings", False),
        norm_type="layernorm", norm_bias=False, qkv_clip=attn.get("clip_qkv"))


def hf_to_nxd_dbrx(hf: Mapping[str, Any], config, dtype: Optional[torch.dtype] = None) -> Tree:
    """HF's ``transformer.blocks.*``: ``Wqkv`` in ``[Q; K; V]`` order; the
    experts' ``w1``/``v1``/``w2`` of ``(E * I, H)`` (HF computes ``x @
    w1[e].T``, ``x @ v1[e].T`` and ``a @ w2[e]``): gate and up transpose to
    ``(E, H, I)``, down stays ``(E, I, H)``."""
    cfg = config
    E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    N, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    out: Tree = {"model.embed.embedding": _t(hf["transformer.wte.weight"]),
                 "model.final_norm.ln.scale": _t(hf["transformer.norm_f.weight"])}
    for i in range(cfg.num_layers):
        blk, ours = f"transformer.blocks.{i}.", f"model.layers.{i}."
        q, k, v = torch.split(_t(hf[f"{blk}norm_attn_norm.attn.Wqkv.weight"]),
                              [N * D, Nkv * D, Nkv * D], dim=0)
        out[f"{ours}attention.qkv.q_kernel"] = q.T.reshape(H, N, D)
        out[f"{ours}attention.qkv.k_kernel"] = k.T.reshape(H, Nkv, D)
        out[f"{ours}attention.qkv.v_kernel"] = v.T.reshape(H, Nkv, D)
        out[f"{ours}attention.o_proj.kernel"] = _t(
            hf[f"{blk}norm_attn_norm.attn.out_proj.weight"]).T
        out[f"{ours}input_norm.ln.scale"] = _t(hf[f"{blk}norm_attn_norm.norm_1.weight"])
        out[f"{ours}post_attn_norm.ln.scale"] = _t(hf[f"{blk}norm_attn_norm.norm_2.weight"])
        out[f"{ours}moe.router.kernel"] = _t(hf[f"{blk}ffn.router.layer.weight"]).T
        mlp = f"{blk}ffn.experts.mlp."
        out[f"{ours}moe.experts.gate"] = _t(hf[mlp + "w1"]).reshape(E, I, H).transpose(1, 2)
        out[f"{ours}moe.experts.up"] = _t(hf[mlp + "v1"]).reshape(E, I, H).transpose(1, 2)
        out[f"{ours}moe.experts.down"] = _t(hf[mlp + "w2"]).reshape(E, I, H)
    if not cfg.tie_word_embeddings:
        out["lm_head.kernel"] = _t(hf["lm_head.weight"]).T
    return _cast(out, dtype or cfg.param_dtype)


def nxd_to_hf_dbrx(state: Mapping[str, torch.Tensor], config,
                   dtype: torch.dtype = torch.float32) -> Tree:
    cfg = config
    E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    N, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    get = _getter(state, dtype)
    out: Tree = {"transformer.wte.weight": get("model.embed.embedding"),
                 "transformer.norm_f.weight": get("model.final_norm.ln.scale")}
    if "lm_head.kernel" in state:
        out["lm_head.weight"] = get("lm_head.kernel").T
    for i in range(cfg.num_layers):
        blk, ours = f"transformer.blocks.{i}.", f"model.layers.{i}."
        q = get(f"{ours}attention.qkv.q_kernel").reshape(H, N * D).T
        k = get(f"{ours}attention.qkv.k_kernel").reshape(H, Nkv * D).T
        v = get(f"{ours}attention.qkv.v_kernel").reshape(H, Nkv * D).T
        out[f"{blk}norm_attn_norm.attn.Wqkv.weight"] = torch.cat([q, k, v])
        out[f"{blk}norm_attn_norm.attn.out_proj.weight"] = get(
            f"{ours}attention.o_proj.kernel").T
        out[f"{blk}norm_attn_norm.norm_1.weight"] = get(f"{ours}input_norm.ln.scale")
        out[f"{blk}norm_attn_norm.norm_2.weight"] = get(f"{ours}post_attn_norm.ln.scale")
        out[f"{blk}ffn.router.layer.weight"] = get(f"{ours}moe.router.kernel").T
        mlp = f"{blk}ffn.experts.mlp."
        out[mlp + "w1"] = get(f"{ours}moe.experts.gate").transpose(1, 2).reshape(E * I, H)
        out[mlp + "v1"] = get(f"{ours}moe.experts.up").transpose(1, 2).reshape(E * I, H)
        out[mlp + "w2"] = get(f"{ours}moe.experts.down").reshape(E * I, H)
    return {k: v.contiguous() for k, v in out.items()}


# -------------------------------------------------------------------- registry

class Family(NamedTuple):
    config_from_hf: Callable[[str], Any]
    hf_to_nxd: Callable[..., Tree]
    nxd_to_hf: Callable[..., Tree]


FAMILIES: Dict[str, Family] = {
    "llama": Family(llama_config_from_hf, hf_to_nxd_llama, nxd_to_hf_llama),
    "mixtral": Family(mixtral_config_from_hf, hf_to_nxd_mixtral, nxd_to_hf_mixtral),
    "gpt_neox": Family(neox_config_from_hf, hf_to_nxd_neox, nxd_to_hf_neox),
    "bert": Family(bert_config_from_hf, hf_to_nxd_bert, nxd_to_hf_bert),
    "dbrx": Family(dbrx_config_from_hf, hf_to_nxd_dbrx, nxd_to_hf_dbrx),
}


def detect_family(hf_keys) -> str:
    """The family of a checkpoint from its key prefixes."""
    keys = list(hf_keys)
    if any("block_sparse_moe" in k for k in keys):
        return "mixtral"
    if any("norm_attn_norm" in k for k in keys):   # DBRX's own submodule
        return "dbrx"
    if any(k.startswith("gpt_neox.") for k in keys):
        return "gpt_neox"
    if any(k.startswith("bert.") for k in keys):
        return "bert"
    if any(k.startswith("model.layers.") for k in keys):
        return "llama"
    raise ValueError(f"cannot infer model family from keys like {keys[:5]}")


def main(argv=None):
    """Convert an HF directory to a port checkpoint (``hf2nxd``), or a port
    checkpoint's params (a bare state dict or a saved ``TrainState``) to an
    HF ``model.safetensors`` (``nxd2hf``, which needs ``--model`` and
    ``--config``)."""
    from neuronx_distributed_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True, help="HF dir/file, or a port checkpoint dir")
    p.add_argument("--output", required=True)
    p.add_argument("--direction", choices=["hf2nxd", "nxd2hf"], default="hf2nxd")
    p.add_argument("--model", choices=[*FAMILIES, "auto"], default="auto")
    p.add_argument("--config", help="HF config.json (default: <input>/config.json)")
    p.add_argument("--tag", default=None, help="checkpoint tag (default: the newest complete)")
    args = p.parse_args(argv)
    if args.direction == "hf2nxd":
        hf = load_hf_safetensors(args.input)
        fam = FAMILIES[detect_family(hf) if args.model == "auto" else args.model]
        params = fam.hf_to_nxd(hf, fam.config_from_hf(args.config or args.input))
        save_checkpoint(args.output, tag=args.tag or "converted", state=params)
        return
    if args.model == "auto":
        raise SystemExit("--direction nxd2hf requires an explicit --model")
    if not args.config:
        raise SystemExit("--direction nxd2hf requires --config pointing at the HF model dir (the "
                         "port checkpoint under --input has no config.json)")
    fam = FAMILIES[args.model]
    state, _ = load_checkpoint(args.input, tag=args.tag)
    params = state.get("params", state)
    save_hf_checkpoint(fam.nxd_to_hf(params, fam.config_from_hf(args.config)), args.output)


if __name__ == "__main__":
    main()
