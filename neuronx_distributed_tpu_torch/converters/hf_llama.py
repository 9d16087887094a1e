"""HF <-> port conversion of Llama weights, from and to local safetensors
files.

Counterpart of ``neuronx_distributed_tpu/converters/hf_llama.py`` in the
port's state-dict names (``models/llama.py``): HF's ``(out, in)`` weights
transpose to the port's ``(in, out)`` kernels, the Q/K/V projections take
the ``(hidden, heads, head_dim)`` layout with K/V compact at
``num_kv_heads``, and each decoder layer keeps its own entries
(``model.layers.{i}...``). ``fused_qkv`` reads and writes one
``self_attn.qkv_proj.weight`` of ``[q; k; v]`` rows. Files are read and
written by ``checkpoint/tensor_file.py``, with PyTorch alone; nothing is
downloaded.

    python -m neuronx_distributed_tpu_torch.converters.hf_llama \\
        --input HF_DIR --output CKPT_DIR [--direction hf2nxd|nxd2hf]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.checkpoint.tensor_file import (
    load_safetensors,
    save_safetensors,
)

Tree = Dict[str, torch.Tensor]

# port name under model.layers.{i} -> HF name under model.layers.{i}
_DENSE = {
    "attention.o_proj.kernel": "self_attn.o_proj.weight",
    "mlp.gate_proj.kernel": "mlp.gate_proj.weight",
    "mlp.up_proj.kernel": "mlp.up_proj.weight",
    "mlp.down_proj.kernel": "mlp.down_proj.weight",
}
_NORMS = {"input_norm.scale": "input_layernorm.weight",
          "post_attn_norm.scale": "post_attention_layernorm.weight"}


def load_hf_safetensors(path: str) -> Tree:
    """An HF checkpoint: one ``.safetensors`` file, or every such file in a
    directory (``model-0000x-of-0000y.safetensors`` shards)."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {path}")
    else:
        files = [path]
    state: Tree = {}
    for f in files:
        state.update(load_safetensors(f))
    return state


def save_hf_safetensors(state: Mapping[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_safetensors(state, path)


def save_hf_checkpoint(state: Mapping[str, Any], out_dir: str) -> str:
    """``state`` as ``out_dir/model.safetensors``; returns its path."""
    path = os.path.join(out_dir, "model.safetensors")
    save_hf_safetensors(state, path)
    return path


def _t(x) -> torch.Tensor:
    """A CPU float tensor of an HF entry (tensor or array; bf16 widened to
    fp32, as the JAX converter reads it)."""
    t = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.float() if t.dtype == torch.bfloat16 else t


def hf_to_nxd_llama(hf: Mapping[str, Any], config, dtype: Optional[torch.dtype] = None,
                    fused_qkv: bool = False) -> Tree:
    """A full HF Llama state dict -> the port's ``LlamaForCausalLM`` state
    dict, each tensor in ``dtype`` (default ``config.param_dtype``)."""
    cfg = config
    L, H = cfg.num_layers, cfg.hidden_size
    N, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = dtype or cfg.param_dtype
    out: Tree = {"model.embed.embedding": _t(hf["model.embed_tokens.weight"]),
                 "model.final_norm.scale": _t(hf["model.norm.weight"])}
    for i in range(L):
        pre = f"model.layers.{i}."
        if fused_qkv:
            q, k, v = torch.split(_t(hf[f"{pre}self_attn.qkv_proj.weight"]),
                                  [N * D, Nkv * D, Nkv * D], dim=0)
        else:
            q, k, v = (_t(hf[f"{pre}self_attn.{n}_proj.weight"]) for n in "qkv")
        out[f"{pre}attention.qkv.q_kernel"] = q.T.reshape(H, N, D)
        out[f"{pre}attention.qkv.k_kernel"] = k.T.reshape(H, Nkv, D)
        out[f"{pre}attention.qkv.v_kernel"] = v.T.reshape(H, Nkv, D)
        for port, name in _DENSE.items():
            if f"{pre}{name}" in hf:
                out[pre + port] = _t(hf[f"{pre}{name}"]).T
        for port, name in _NORMS.items():
            out[pre + port] = _t(hf[f"{pre}{name}"])
    if not cfg.tie_word_embeddings:
        out["lm_head.kernel"] = _t(hf.get("lm_head.weight", hf["model.embed_tokens.weight"])).T
    return {k: v.to(dt).contiguous() for k, v in out.items()}


def nxd_to_hf_llama(state: Mapping[str, torch.Tensor], config,
                    dtype: torch.dtype = torch.float32, fused_qkv: bool = False) -> Tree:
    """The port's state dict -> HF names and layouts, each tensor in
    ``dtype``."""
    cfg = config
    L, H = cfg.num_layers, cfg.hidden_size
    N, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def get(name):
        return state[name].detach().cpu().to(dtype)

    out: Tree = {"model.embed_tokens.weight": get("model.embed.embedding"),
                 "model.norm.weight": get("model.final_norm.scale")}
    if "lm_head.kernel" in state:
        out["lm_head.weight"] = get("lm_head.kernel").T
    for i in range(L):
        pre = f"model.layers.{i}."
        q = get(f"{pre}attention.qkv.q_kernel").reshape(H, N * D).T
        k = get(f"{pre}attention.qkv.k_kernel").reshape(H, Nkv * D).T
        v = get(f"{pre}attention.qkv.v_kernel").reshape(H, Nkv * D).T
        if fused_qkv:
            out[f"{pre}self_attn.qkv_proj.weight"] = torch.cat([q, k, v])
        else:
            for n, w in zip("qkv", (q, k, v)):
                out[f"{pre}self_attn.{n}_proj.weight"] = w
        for port, name in _DENSE.items():
            if pre + port in state:
                out[f"{pre}{name}"] = get(pre + port).T
        for port, name in _NORMS.items():
            out[f"{pre}{name}"] = get(pre + port)
    return {k: v.contiguous() for k, v in out.items()}


def config_from_hf(path: str):
    """The port's ``LlamaConfig`` from an HF ``config.json`` (a file, or a
    directory holding one). Rope scaling other than ``llama3`` raises."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, RopeScaling

    with open(os.path.join(path, "config.json") if os.path.isdir(path) else path) as f:
        hc = json.load(f)
    scaling = None
    rs = hc.get("rope_scaling") or {}
    rs_type = rs.get("rope_type", rs.get("type"))
    if rs and rs_type != "llama3":
        raise NotImplementedError(
            f"rope_scaling type {rs_type!r} not supported (llama3 only); linear/yarn/dynamic/"
            "longrope need their own frequency maps")
    if rs_type == "llama3":
        scaling = RopeScaling(
            factor=rs.get("factor", 8.0), low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get("original_max_position_embeddings", 8192))
    return LlamaConfig(
        rope_scaling=scaling, vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"], num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        num_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        head_dim=hc.get("head_dim"),
        max_seq_len=hc.get("max_position_embeddings", 4096),
        rope_theta=hc.get("rope_theta", 10000.0), rms_norm_eps=hc.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=hc.get("tie_word_embeddings", False))


def main(argv=None):
    """Convert an HF directory to a port checkpoint (``hf2nxd``), or a port
    checkpoint's params (a bare state dict or a saved ``TrainState``) to an
    HF ``model.safetensors`` (``nxd2hf``)."""
    from neuronx_distributed_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True, help="HF dir/file, or a port checkpoint dir")
    p.add_argument("--output", required=True)
    p.add_argument("--direction", choices=["hf2nxd", "nxd2hf"], default="hf2nxd")
    p.add_argument("--config", help="HF config.json (default: <input>/config.json)")
    p.add_argument("--fused-qkv", action="store_true")
    p.add_argument("--tag", default=None, help="checkpoint tag (default: the newest complete)")
    args = p.parse_args(argv)
    cfg = config_from_hf(args.config or args.input)
    if args.direction == "hf2nxd":
        params = hf_to_nxd_llama(load_hf_safetensors(args.input), cfg, fused_qkv=args.fused_qkv)
        save_checkpoint(args.output, tag=args.tag or "converted", state=params)
    else:
        state, _ = load_checkpoint(args.input, tag=args.tag)
        params = state.get("params", state)
        save_hf_checkpoint(nxd_to_hf_llama(params, cfg, fused_qkv=args.fused_qkv), args.output)


if __name__ == "__main__":
    main()
