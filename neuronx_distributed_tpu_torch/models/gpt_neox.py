"""GPT-NeoX model family (the parallel-residual decoder), trained under TP,
SP, CP and DP.

Counterpart of ``neuronx_distributed_tpu/models/gpt_neox.py`` (the
reference's ``tp_dp_gpt_neox_hf_pretrain`` examples). Against Llama: the
residual is parallel, ``x + attn(ln1(x)) + mlp(ln2(x))`` (the serial form
under ``use_parallel_residual=False``); every norm is a biased LayerNorm;
the QKV, output and MLP projections carry biases; the MLP is
``down(gelu(up(x)))`` with the exact GELU; and rotary embeddings turn only
the first ``rotary_pct`` of each head (``rope_dims``). The embedding, the
layer stack, the final norm and the head are the Llama stack's, through the
``layer_cls`` seam of :class:`~.llama.LlamaForCausalLM`; the stack builds
its rotary tables for ``config.rope_dims``, whose frequencies take
``rope_dims`` as their denominator base (slicing a full-head table would
give other frequencies).

Weight names follow the flax tree: ``model.layers.{i}.attention.qkv.
{q,k,v}_{kernel,bias}``, ``...attention.o_proj.{kernel,bias}``,
``...mlp.{up,down}.{kernel,bias}``, ``...{input,post_attn}_norm.ln.
{scale,bias}``. Token generation (``decode=True``) raises, as in JAX: the
reference trains NeoX only.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_supported
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    apply_rotary,
)
from neuronx_distributed_tpu_torch.ops.attention import attention
from neuronx_distributed_tpu_torch.ops.ring_attention import ring_attention
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    GQAQKVColumnParallelLinear,
    RowParallelLinear,
)


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig(LlamaConfig):
    rotary_pct: float = 0.25
    use_parallel_residual: bool = True
    layer_norm_eps: float = 1e-5
    norm_type: str = "layernorm"   # every norm, the final one included: biased LayerNorm

    @property
    def rope_dims(self) -> int:
        return int(self.head_dim_ * self.rotary_pct)


def gpt_neox_6_9b(**over) -> GPTNeoXConfig:
    return GPTNeoXConfig(**{**dict(
        vocab_size=50432, hidden_size=4096, intermediate_size=16384,
        num_layers=32, num_heads=32, num_kv_heads=32, rotary_pct=0.25,
    ), **over})


def gpt_neox_20b(**over) -> GPTNeoXConfig:
    return GPTNeoXConfig(**{**dict(
        vocab_size=50432, hidden_size=6144, intermediate_size=24576,
        num_layers=44, num_heads=64, num_kv_heads=64, rotary_pct=0.25,
    ), **over})


def apply_partial_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         rotary_dims: int) -> torch.Tensor:
    """Rotate the first ``rotary_dims`` of each head of ``x`` (b, s, n, d)
    and pass the rest through; ``cos``/``sin`` are tables built for
    ``rotary_dims``."""
    if rotary_dims >= x.shape[-1]:
        return apply_rotary(x, cos, sin)
    rot, rest = x[..., :rotary_dims], x[..., rotary_dims:]
    return torch.cat([apply_rotary(rot, cos, sin), rest], dim=-1)


class GPTNeoXAttention(nn.Module):
    def __init__(self, config: GPTNeoXConfig, device=None, group=None):
        super().__init__()
        cfg = self.config = config
        if cfg.decode:
            raise NotImplementedError("GPT-NeoX decode/KV-cache serving: use the Llama-family "
                                      "serving stack (the reference's NeoX support is training "
                                      "only)")
        hd = cfg.head_dim_
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device, group=group,
                  sequence_parallel=cfg.sequence_parallel)
        self.qkv = GQAQKVColumnParallelLinear(cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                                              hd, use_bias=True,
                                              kv_size_multiplier=cfg.kv_size_multiplier, **kw)
        self.o_proj = RowParallelLinear(cfg.num_heads * hd, cfg.hidden_size, use_bias=True, **kw)
        self.cp_group = None   # set by LlamaModel under context_parallel

    def forward(self, x, rope, cache=None, layer: int = 0, lora=None, chunk_ctx=None):
        cfg = self.config
        q, k, v = self.qkv(x)
        cos, sin = rope
        rd = cfg.rope_dims
        q, k = apply_partial_rotary(q, cos, sin, rd), apply_partial_rotary(k, cos, sin, rd)
        s = q.shape[1]   # the whole sequence (x is the rank's shard under SP)
        if cfg.context_parallel:
            o = ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True, group=self.cp_group, layout=cfg.cp_layout,
                               block_q=cfg.attention_block_q, block_k=cfg.attention_block_k)
        else:
            blk_q, blk_k = cfg.blocks_for(s)
            o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                          use_flash=cfg.use_flash_attention and flash_supported(s, s, blk_q,
                                                                                blk_k),
                          block_q=blk_q, block_k=blk_k)
        return self.o_proj(o.transpose(1, 2).reshape(x.shape[0], s, -1))


class GPTNeoXMLP(nn.Module):
    def __init__(self, config: GPTNeoXConfig, device=None, group=None):
        super().__init__()
        cfg = config
        kw = dict(use_bias=True, dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                  group=group, sequence_parallel=cfg.sequence_parallel)
        self.up = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.down(nn.functional.gelu(self.up(x)))


class GPTNeoXDecoderLayer(nn.Module):
    """``x + attn(ln1(x)) + mlp(ln2(x))``, or with
    ``use_parallel_residual=False`` the serial ``x += attn(ln1(x)); x +=
    mlp(ln2(x))``."""

    def __init__(self, config: GPTNeoXConfig, device=None, group=None):
        super().__init__()
        cfg = self.config = config
        if cfg.lora_rank:
            raise NotImplementedError("a LoRA serving pool on a GPT-NeoX model: NeoX does not "
                                      "serve")
        self.input_norm = cfg.make_norm(device, group)
        self.attention = GPTNeoXAttention(cfg, device, group)
        self.post_attn_norm = cfg.make_norm(device, group)
        self.mlp = GPTNeoXMLP(cfg, device, group)

    def forward(self, x, rope, cache=None, layer: int = 0, lora=None, chunk_ctx=None):
        attn = self.attention(self.input_norm(x), rope)
        if self.config.use_parallel_residual:
            return x + attn + self.mlp(self.post_attn_norm(x))
        x = x + attn
        return x + self.mlp(self.post_attn_norm(x))


class GPTNeoXForCausalLM(LlamaForCausalLM):
    """The Llama stack with the NeoX decoder block: rotary tables over
    ``rope_dims`` and the biased LayerNorm at the end (``norm_type``)."""

    layer_cls = GPTNeoXDecoderLayer
