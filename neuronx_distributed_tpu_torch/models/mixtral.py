"""Mixtral model family for serving: Llama attention and the MoE block.

Counterpart of ``neuronx_distributed_tpu/models/mixtral.py``: the Llama
stack (embedding, rotary tables, KV cache, head) with each decoder layer's
MLP replaced by :class:`~neuronx_distributed_tpu_torch.moe.layer.MoE`,
through the ``layer_cls`` seam of :class:`LlamaModel`. Weight names follow
the flax tree (``model.layers.{i}.moe.router.kernel``,
``model.layers.{i}.moe.experts.gate``, ...). In decode mode (``CausalLM``)
the block takes the JAX package's inference dispatch: a decode step of
``T`` tokens runs ``selective`` when ``T * top_k / num_experts <
selective_loading_threshold``, else ``all_experts``, and context encoding
runs ``all_experts``.

Not ported: training (the auxiliary losses, ``mixtral_loss``), expert
parallelism, DBRX's ``norm_type="layernorm"`` and LoRA adapters on a
Mixtral model (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses

from torch import nn

from neuronx_distributed_tpu_torch.models.llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
)
from neuronx_distributed_tpu_torch.moe.layer import MoE
from neuronx_distributed_tpu_torch.parallel.layers import RMSNorm


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    moe_mode: str = "capacity_factor"  # context and training: | "all_experts"
    capacity_factor: float = 1.25
    router: str = "top_k"
    selective_loading_threshold: float = 0.5
    norm_type: str = "rmsnorm"


def mixtral_8x7b(**over) -> MixtralConfig:
    return MixtralConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6,
        num_experts=8, top_k=2,
    ), **over})


class MixtralDecoderLayer(nn.Module):
    def __init__(self, config: MixtralConfig, device=None, group=None):
        super().__init__()
        cfg = config
        if group is not None:
            raise NotImplementedError("Mixtral (the MoE block and expert parallelism) under "
                                      "tensor parallelism is not ported: ROADMAP queue A")
        if cfg.norm_type != "rmsnorm":
            raise NotImplementedError(f'norm_type={cfg.norm_type!r} (DBRX) is not ported yet: '
                                      "ROADMAP queue A")
        if cfg.lora_rank:
            raise NotImplementedError("LoRA adapters on a Mixtral model are not ported yet: "
                                      "ROADMAP queue A")
        norm = dict(epsilon=cfg.rms_norm_eps, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                    device=device)
        self.input_norm = RMSNorm(cfg.hidden_size, **norm)
        self.attention = LlamaAttention(cfg, device)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, **norm)
        self.moe = MoE(cfg.num_experts, cfg.hidden_size, cfg.intermediate_size,
                       top_k=cfg.top_k, router=cfg.router, mode=cfg.moe_mode,
                       capacity_factor=cfg.capacity_factor, dtype=cfg.dtype,
                       param_dtype=cfg.param_dtype, inference=cfg.decode,
                       selective_loading_threshold=cfg.selective_loading_threshold,
                       device=device)

    def forward(self, x, rope, cache=None, layer=0, lora=None, chunk_ctx=None):
        x = x + self.attention(self.input_norm(x), rope, cache, layer, lora, chunk_ctx)
        return x + self.moe(self.post_attn_norm(x))


class MixtralModel(LlamaModel):
    """The Llama stack with the MoE decoder block."""

    layer_cls = MixtralDecoderLayer


class MixtralForCausalLM(LlamaForCausalLM):
    """``LlamaForCausalLM`` with the MoE decoder block: the same head and
    ``tie_word_embeddings`` handling."""

    layer_cls = MixtralDecoderLayer
