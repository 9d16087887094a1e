"""BERT model family (the encoder and its pretraining heads), trained under
TP and DP.

Counterpart of ``neuronx_distributed_tpu/models/bert.py`` (the reference's
``tp_dp_bert_large_hf_pretrain_hdf5.py``: HF ``BertForPreTraining`` with
parallel self-attention, the MLM and NSP losses, the MLM decoder tied to the
word embedding). Weight names follow the flax tree:
``bert.word_embeddings.embedding`` (vocab-parallel),
``bert.{position,token_type}_embeddings.embedding``, ``bert.embed_norm.ln.*``,
``bert.layers.{i}.attention.qkv.{q,k,v}_{kernel,bias}``,
``bert.layers.{i}.attention.output.*``, ``bert.layers.{i}.{attention_norm,
intermediate, mlp_output, output_norm}.*``, ``bert.pooler.*``,
``mlm_transform.*``, ``mlm_norm.ln.*``, ``mlm_bias`` and ``nsp_head.*``.

Attention is bidirectional. The padding mask becomes the flash kernel's
position masks, as in JAX: every query at position ``s - 1``, a valid key at
0 and a masked key at ``s``, which no query sees; a shape the kernel's
contract refuses takes the dense route under the same masks.

Tensor parallelism (``group``): the QKV, the attention output, the
intermediate and the MLP output are the TP layers of ``parallel/layers.py``,
the word embedding is vocab-parallel and the MLM logits come out
vocab-sharded (``ParallelEmbedding.attend`` plus the rank's slice of
``mlm_bias``, which :attr:`BertForPreTraining.partition_specs` declares
sharded on dim 0) into the vocab-parallel cross entropy. The pooler, the
NSP head, the MLM transform and its norm are replicated: their inputs are
the same on every rank and so are their gradients, which count once.

Dropout (``hidden_dropout`` after the embeddings and inside each layer)
draws its masks from ``(dropout_seed, site)``: each site's mask comes from
a generator seeded by the pair, so the recompute of activation
checkpointing draws the same mask as the forward, and the ranks of a TP
group, which share the seed, drop the same units of their replicated
activations. The masks are not JAX's (threefry is not reproduced): parity
with JAX runs deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_supported
from neuronx_distributed_tpu_torch.models.llama import _remat
from neuronx_distributed_tpu_torch.ops.attention import attention
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    GQAQKVColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
    SPLayerNorm,
    _param,
)
from neuronx_distributed_tpu_torch.parallel.loss import parallel_cross_entropy
from neuronx_distributed_tpu_torch.parallel.mappings import all_reduce_sum_
from neuronx_distributed_tpu_torch.parallel.mesh import group_size


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash_attention: bool = True
    attention_block_q: int = 128
    attention_block_k: int = 128
    remat_policy: Optional[str] = None
    sequence_parallel: bool = False   # accepted for config parity: the encoder runs whole
    # explicit head_dim (head padding appends heads, after which
    # hidden_size // num_heads no longer equals it)
    head_dim: Optional[int] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


def bert_large(**over) -> BertConfig:
    """L24_A16_H1024: the reference example's model (BASELINE config #2)."""
    return BertConfig(**{**dict(hidden_size=1024, intermediate_size=4096, num_layers=24,
                                num_heads=16), **over})


def bert_base(**over) -> BertConfig:
    return BertConfig(**{**dict(hidden_size=768, intermediate_size=3072, num_layers=12,
                                num_heads=12), **over})


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias``, kernel ``(in, out)``,
    replicated under TP."""

    def __init__(self, in_features: int, features: int, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((in_features, features), param_dtype, device)
        self.bias = _param((features,), param_dtype, device)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class Embed(nn.Module):
    """flax's ``nn.Embed``: a replicated table ``embedding``."""

    def __init__(self, num_embeddings: int, features: int, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((num_embeddings, features), param_dtype, device)

    def forward(self, ids):
        e = self.embedding if self.dtype is None else self.embedding.to(self.dtype)
        return e[ids]


def dropout(x: torch.Tensor, rate: float, seed: Optional[int], site: int) -> torch.Tensor:
    """flax's ``nn.Dropout`` (keep with probability ``1 - rate``, kept
    units scaled by ``1 / (1 - rate)``) with its mask drawn from a generator
    seeded by ``(seed, site)``: the same call draws the same mask. ``seed``
    None (or ``rate`` 0) is the deterministic pass-through."""
    if seed is None or rate <= 0.0:
        return x
    g = torch.Generator(device=x.device).manual_seed((int(seed) * 1_000_003 + site) % 2**62)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def mask_positions(attention_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The padding mask (b, s), 1 = token, as the kernel's positions: every
    query at ``s - 1``, valid keys at 0, masked keys at ``s``."""
    b, s = attention_mask.shape
    kv = torch.where(attention_mask.bool(), 0, s).to(torch.int32)
    return torch.full((b, s), s - 1, dtype=torch.int32, device=attention_mask.device), kv


class BertSelfAttention(nn.Module):
    """Bidirectional TP attention; the output projection is ``output``."""

    def __init__(self, config: BertConfig, device=None, group=None):
        super().__init__()
        cfg = self.config = config
        hd = cfg.head_dim_
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device, group=group)
        self.qkv = GQAQKVColumnParallelLinear(cfg.hidden_size, cfg.num_heads, cfg.num_heads, hd,
                                              use_bias=True, **kw)
        self.output = RowParallelLinear(cfg.num_heads * hd, cfg.hidden_size, use_bias=True,
                                        **kw)

    def forward(self, x, positions):
        cfg = self.config
        q, k, v = self.qkv(x)
        b, s = x.shape[0], x.shape[1]
        q_pos, kv_pos = positions
        use_flash = cfg.use_flash_attention and flash_supported(
            s, s, cfg.attention_block_q, cfg.attention_block_k)
        o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False,
                      use_flash=use_flash, block_q=cfg.attention_block_q,
                      block_k=cfg.attention_block_k, q_positions=q_pos, kv_positions=kv_pos)
        return self.output(o.transpose(1, 2).reshape(b, s, -1))


class BertLayer(nn.Module):
    """Post-LN encoder block: ``LN(x + dropout(sublayer(x)))`` twice."""

    def __init__(self, config: BertConfig, device=None, group=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device, group=group)
        nkw = dict(epsilon=cfg.layer_norm_eps, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                   device=device)
        self.attention = BertSelfAttention(cfg, device, group)
        self.attention_norm = SPLayerNorm(cfg.hidden_size, **nkw)
        self.intermediate = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size,
                                                 use_bias=True, **kw)
        self.mlp_output = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size,
                                            use_bias=True, **kw)
        self.output_norm = SPLayerNorm(cfg.hidden_size, **nkw)

    def forward(self, x, positions, seed: Optional[int] = None, site: int = 0):
        p = self.config.hidden_dropout
        h = dropout(self.attention(x, positions), p, seed, site)
        x = self.attention_norm(x + h)
        h = self.mlp_output(nn.functional.gelu(self.intermediate(x)))
        return self.output_norm(x + dropout(h, p, seed, site + 1))


class BertModel(nn.Module):
    """Embeddings (word, position, token type; LayerNorm; dropout), the
    encoder stack and the tanh pooler over ``[CLS]``. Returns
    ``(sequence_output, pooled_output)``."""

    def __init__(self, config: BertConfig, device=None, group=None):
        super().__init__()
        cfg = self.config = config
        ekw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.group = group
        self.word_embeddings = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, group=group,
                                                 **ekw)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size, **ekw)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size, **ekw)
        self.embed_norm = SPLayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps, **ekw)
        self.layers = nn.ModuleList(BertLayer(cfg, device, group)
                                    for _ in range(cfg.num_layers))
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, **ekw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                dropout_seed: Optional[int] = None):
        cfg = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(torch.arange(s, device=dev))
             + self.token_type_embeddings(token_type_ids))
        x = dropout(self.embed_norm(x), cfg.hidden_dropout, dropout_seed, 0)
        positions = mask_positions(attention_mask)
        remat = _remat(cfg)
        for i, layer in enumerate(self.layers):
            if remat is not None:
                x = checkpoint(layer, x, positions, dropout_seed, 1 + 2 * i, **remat)
            else:
                x = layer(x, positions, dropout_seed, 1 + 2 * i)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled

    def attend(self, x):
        return self.word_embeddings.attend(x)


class BertForPreTraining(nn.Module):
    """The MLM and NSP heads (HF ``BertForPreTraining``): ``forward``
    returns ``(prediction_logits, seq_relationship_logits)``, the first the
    rank's vocabulary shard under a ``group``. The MLM decoder is the word
    embedding (tied) plus ``mlm_bias``."""

    def __init__(self, config: BertConfig, device=None, group=None):
        super().__init__()
        cfg = self.config = config
        self.group = group
        self.tp = group_size(group)
        ekw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.bert = BertModel(cfg, device, group)
        self.mlm_transform = Dense(cfg.hidden_size, cfg.hidden_size, **ekw)
        self.mlm_norm = SPLayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps, **ekw)
        self.mlm_bias = _param((cfg.vocab_size // self.tp,), cfg.param_dtype, device)
        self.nsp_head = Dense(cfg.hidden_size, 2, **ekw)
        # mlm_bias lies outside every TP layer: its vocabulary shard on dim 0
        self.partition_specs = {"mlm_bias": ("tp",)}

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                dropout_seed: Optional[int] = None):
        x, pooled = self.bert(input_ids, token_type_ids, attention_mask, dropout_seed)
        h = self.mlm_norm(nn.functional.gelu(self.mlm_transform(x)))
        logits = self.bert.attend(h) + self.mlm_bias.to(h.dtype)
        return logits, self.nsp_head(pooled)

    def loss(self, input_ids, masked_lm_labels, next_sentence_labels, token_type_ids=None,
             attention_mask=None, deterministic: bool = True,
             dropout_seed: Optional[int] = None, ignore_index: int = -100,
             dp_group=None) -> torch.Tensor:
        """The MLM cross entropy's mean over the labels that are not
        ``ignore_index`` (vocab-parallel) plus the NSP cross entropy's mean
        over the rows. Not ``deterministic``: dropout from ``dropout_seed``.
        ``dp_group``: the data-parallel group whose ranks hold the other
        rows of the global batch; the MLM mean is then over the global
        batch's labelled tokens, as JAX takes it (the rank's loss is its
        sum times the DP degree over the global count, so the train step's
        DP mean of the losses and of the gradients is the global one)."""
        if not deterministic and dropout_seed is None and self.config.hidden_dropout > 0:
            raise ValueError("dropout needs a dropout_seed")
        seed = None if deterministic else dropout_seed
        mlm, nsp = self(input_ids, token_type_ids, attention_mask, seed)
        per_tok = parallel_cross_entropy(mlm, masked_lm_labels, ignore_index=ignore_index,
                                         group=self.group)
        count = (masked_lm_labels != ignore_index).float().sum()
        dp = group_size(dp_group)
        if dp > 1:
            count = all_reduce_sum_(count.reshape(1).clone(), dp_group).reshape(())
        mlm_loss = per_tok.sum() * dp / torch.clamp(count, min=1.0)
        logp = torch.log_softmax(nsp.float(), dim=-1)
        nsp_loss = -torch.gather(logp, -1, next_sentence_labels.long()[:, None]).mean()
        return mlm_loss + nsp_loss
