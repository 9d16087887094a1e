"""Mixtral model family: Llama attention and the MoE block, served and
trained.

Counterpart of ``neuronx_distributed_tpu/models/mixtral.py``: the Llama
stack (embedding, rotary tables, KV cache, head) with each decoder layer's
MLP replaced by :class:`~neuronx_distributed_tpu_torch.moe.layer.MoE`,
through the ``layer_cls`` seam of :class:`LlamaModel`. Weight names follow
the flax tree (``model.layers.{i}.moe.router.kernel``,
``model.layers.{i}.moe.experts.gate``, ...). Every norm comes from
``config.make_norm``: RMSNorm, or DBRX's bias-free LayerNorm
(``norm_type="layernorm"``, ``norm_bias=False``, weights ``ln.scale``).

Serving: in decode mode (``CausalLM``) the block takes the JAX package's
inference dispatch: a decode step of ``T`` tokens runs ``selective`` when
``T * top_k / num_experts < selective_loading_threshold``, else
``all_experts``, and context encoding runs ``all_experts``.

Training: :func:`mixtral_loss` is the cross entropy plus every block's
auxiliary loss. Built with a tensor-parallel ``group``, an expert-parallel
``ep_group`` and a data-parallel ``dp_group`` (``trainer/model.py`` passes
the mesh's), the attention is Llama's TP attention, a rank holds its
experts' slices and the MoE blocks trade tokens over the ep group
(``moe/expert_mlps.py``), their capacity and load balance over the global
batch; ``sequence_parallel`` takes the MoE block's SP exit and re-entry.

Not ported: serving under a TP group (``CausalLM`` refuses it), LoRA
adapters on a Mixtral model, and the MoE block under context or pipeline
parallelism (each raises by name: ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from neuronx_distributed_tpu_torch.models.llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
)
from neuronx_distributed_tpu_torch.moe.layer import MoE, collect_aux_losses, record_aux_losses


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    moe_mode: str = "capacity_factor"  # context and training: | "all_experts"
    capacity_factor: float = 1.25
    router: str = "top_k"
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 0.0
    selective_loading_threshold: float = 0.5
    # DBRX: bias-free LayerNorms (HF DbrxBlock norm_1/norm_2/norm_f)
    norm_type: str = "rmsnorm"  # | "layernorm"
    norm_bias: bool = True
    layer_norm_eps: float = 1e-5


def mixtral_8x7b(**over) -> MixtralConfig:
    return MixtralConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6,
        num_experts=8, top_k=2,
    ), **over})


def dbrx(**over) -> MixtralConfig:
    """DBRX's widths (the reference serves it through the same MoE stack,
    ``examples/inference/run_dbrx.py``): 16 experts, top-4 routing,
    bias-free LayerNorms, ``clip_qkv`` 8."""
    return MixtralConfig(**{**dict(
        vocab_size=100352, hidden_size=6144, intermediate_size=10752,
        num_layers=40, num_heads=48, num_kv_heads=8, rope_theta=5e5,
        num_experts=16, top_k=4,
        norm_type="layernorm", norm_bias=False, qkv_clip=8.0,
    ), **over})


class MixtralDecoderLayer(nn.Module):
    def __init__(self, config: MixtralConfig, device=None, group=None, ep_group=None,
                 dp_group=None):
        super().__init__()
        cfg = config
        if cfg.lora_rank:
            raise NotImplementedError("LoRA adapters on a Mixtral model are not ported yet: "
                                      "ROADMAP queue A")
        self.input_norm = cfg.make_norm(device, group)
        self.attention = LlamaAttention(cfg, device, group)
        self.post_attn_norm = cfg.make_norm(device, group)
        self.moe = MoE(cfg.num_experts, cfg.hidden_size, cfg.intermediate_size,
                       top_k=cfg.top_k, router=cfg.router, mode=cfg.moe_mode,
                       capacity_factor=cfg.capacity_factor, dtype=cfg.dtype,
                       param_dtype=cfg.param_dtype, inference=cfg.decode,
                       selective_loading_threshold=cfg.selective_loading_threshold,
                       device=device, sequence_parallel=cfg.sequence_parallel,
                       aux_loss_coef=cfg.aux_loss_coef, z_loss_coef=cfg.z_loss_coef,
                       tp_group=group, ep_group=ep_group, dp_group=dp_group)

    def forward(self, x, rope, cache=None, layer=0, lora=None, chunk_ctx=None):
        x = x + self.attention(self.input_norm(x), rope, cache, layer, lora, chunk_ctx)
        return x + self.moe(self.post_attn_norm(x))


class MixtralModel(LlamaModel):
    """The Llama stack with the MoE decoder block."""

    layer_cls = MixtralDecoderLayer


class MixtralForCausalLM(LlamaForCausalLM):
    """``LlamaForCausalLM`` with the MoE decoder block: the same head and
    ``tie_word_embeddings`` handling. ``ep_group``/``dp_group``: the
    expert- and data-parallel groups of its MoE blocks (None: one rank)."""

    layer_cls = MixtralDecoderLayer

    def __init__(self, config: MixtralConfig, device=None, group=None, cp_group=None,
                 ep_group=None, dp_group=None):
        if config.context_parallel:
            raise NotImplementedError("the MoE block under context parallelism is not ported "
                                      "(its capacity would need the zigzag token order): "
                                      "ROADMAP queue A")
        super().__init__(config, device, group=group, cp_group=cp_group,
                         layer_kwargs=dict(ep_group=ep_group, dp_group=dp_group))


def mixtral_loss(model: MixtralForCausalLM, input_ids: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = -100) -> torch.Tensor:
    """The mean next-token cross entropy (``model.loss``) plus the summed
    auxiliary losses of its MoE blocks (JAX ``mixtral_loss``; the reference
    adds the aux loss in its training loop)."""
    with record_aux_losses(model):
        ce = model.loss(input_ids, labels, ignore_index=ignore_index)
        aux = collect_aux_losses(model)
    return ce + aux.to(ce.device)
