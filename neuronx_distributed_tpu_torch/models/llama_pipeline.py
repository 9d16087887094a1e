"""Pipeline-parallel Llama: a rank's stage of the model on the pipeline engine.

Counterpart of ``neuronx_distributed_tpu/models/llama_pipeline.py``
(``PipelinedLlama``). The JAX model stacks every decoder layer on one axis
sharded over ``pp`` and replicates the embedding, the final norm and the
head over ``pp``. Here a rank builds only its stage, the reference's
layout: its chunks' decoder layers, the embedding on the first stage and
the final norm and head on the last. The stage's module
(:class:`PipelineStage`) names every weight as ``LlamaForCausalLM`` does,
by global layer index (``model.layers.{i}...``), so values, checkpoints
and converted JAX trees move between the two models by name, the VPP
order undone (JAX ``canonical_layer_params``).

:meth:`PipelinedLlama.loss` runs the whole schedule, forward and backward,
inside one autograd function (JAX's combined 1F1B pass under a custom
VJP): it returns the mean cross entropy, the same on every pp rank (the
last stage's sums all-reduced over pp), and its backward hands autograd
the stage's gradients, so ``trainer.make_train_step`` takes it unchanged.
Without autograd recording it runs the forward schedule only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_tpu_torch._device import DeviceLike, resolve_device
from neuronx_distributed_tpu_torch.inference.partition import param_partition_specs
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaDecoderLayer,
    _remat,
    init_params,
    rotary_embedding,
)
from neuronx_distributed_tpu_torch.parallel import mesh as ps
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    ParallelEmbedding,
    RMSNorm,
)
from neuronx_distributed_tpu_torch.parallel.loss import parallel_cross_entropy
from neuronx_distributed_tpu_torch.parallel.mappings import all_reduce_sum_
from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size
from neuronx_distributed_tpu_torch.parallel.partitioning import local_state_dict
from neuronx_distributed_tpu_torch.pipeline.engine import (
    SCHEDULES,
    PipelineEngine,
    microbatch,
    stage_layers,
)
from neuronx_distributed_tpu_torch.trainer.model import ParallelModel, _rebind


class PipelineStage(nn.Module):
    """One rank's part of ``LlamaForCausalLM``, under its names: the layers
    of its chunks (``chunks``: canonical layer indices a chunk), the
    embedding when ``first``, the final norm and ``lm_head`` when
    ``last``. ``group``: the tensor-parallel group."""

    def __init__(self, config: LlamaConfig, chunks: List[List[int]], first: bool, last: bool,
                 device=None, group=None):
        super().__init__()
        cfg = self.config = config
        self.chunks, self.first, self.last, self.group = chunks, first, last, group
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.model = nn.Module()
        if first:
            self.model.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, group=group,
                                                 **kw)
        self.model.layers = nn.ModuleDict({
            str(i): LlamaDecoderLayer(cfg, device, group=group)
            for ids in chunks for i in ids})
        if last:
            self.model.final_norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps,
                                            group=group, **kw)
            self.lm_head = ColumnParallelLinear(cfg.hidden_size, cfg.vocab_size,
                                                use_bias=False, group=group,
                                                gather_output=False, **kw)

    def chunk(self, c: int, x: torch.Tensor, rope) -> torch.Tensor:
        """Chunk ``c``'s layers over ``x`` (each checkpointed under the
        config's remat policy while autograd records, as in ``LlamaModel``)."""
        remat = _remat(self.config)
        for i in self.chunks[c]:
            layer = self.model.layers[str(i)]
            x = checkpoint(layer, x, rope, **remat) if remat is not None else layer(x, rope)
        return x

    def head(self, y: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.model.final_norm(y))


class _PipelineLoss(torch.autograd.Function):
    """The schedule's forward and backward in the forward; the backward
    returns the stage's gradients scaled by the incoming one."""

    @staticmethod
    def forward(ctx, pm, ids, labels, *params):
        loss, grads = pm._run(ids, labels, train=True)
        ctx.grads = grads
        return loss

    @staticmethod
    def backward(ctx, g):
        grads, ctx.grads = ctx.grads, None
        return (None, None, None, *(None if t is None else t.mul_(g.to(t.dtype))
                                    for t in grads))


@dataclasses.dataclass
class PipelinedLlama:
    """This rank's stage of a pipelined Llama (JAX ``PipelinedLlama``).

    ``num_chunks > 1`` runs the interleaved (VPP) schedules: rank ``r``
    holds virtual stages ``c * num_stages + r``. ``schedule``: ``"1f1b"``
    (the reference's default: bounded stash; with chunks, interleaved
    1F1B) or ``"gpipe"``. ``remat``: checkpoint each stage's forward when
    ``config.remat_policy`` is None (the layers checkpoint themselves
    otherwise). ``stage`` and the groups default to the current mesh's
    (off-mesh: one stage holds everything); ``device`` is where
    :meth:`init_params` and :meth:`as_parallel_model` put the weights."""

    config: LlamaConfig
    num_stages: int
    num_microbatches: int
    remat: bool = True
    num_chunks: int = 1
    schedule: str = "1f1b"
    stage: Optional[int] = None
    pp_group: object = None
    tp_group: object = None

    def __post_init__(self):
        cfg = self.config
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if cfg.num_layers % (self.num_stages * self.num_chunks) != 0:
            raise ValueError(
                f"num_layers {cfg.num_layers} not divisible by stages*chunks "
                f"({self.num_stages}*{self.num_chunks})")
        if self.num_chunks > 1 and self.num_microbatches % self.num_stages != 0:
            raise ValueError(
                f"interleaved (num_chunks={self.num_chunks}) requires "
                f"num_microbatches ({self.num_microbatches}) divisible by "
                f"num_stages ({self.num_stages}) — microbatches enter in pp-groups")
        if cfg.tie_word_embeddings:
            raise NotImplementedError("tied embeddings with PP: use the non-PP model")
        if hasattr(cfg, "num_experts"):
            raise NotImplementedError("the MoE block (a Mixtral config) under pipeline "
                                      "parallelism has no reference: the JAX PipelinedLlama "
                                      "builds dense layers from a Mixtral config and drops "
                                      "its experts (ROADMAP queue C, C13)")
        on_mesh = ps.model_parallel_is_initialized()
        if on_mesh and self.pp_group is None and ps.get_pipeline_model_parallel_size() > 1:
            self.pp_group = ps.get_pipeline_model_parallel_group()
        if on_mesh and self.tp_group is None and ps.get_tensor_model_parallel_size() > 1:
            self.tp_group = ps.get_tensor_model_parallel_group()
        if self.stage is None:
            self.stage = group_rank(self.pp_group)
        self.engine = PipelineEngine(self.num_stages, self.num_microbatches, self.num_chunks,
                                     self.schedule, self.pp_group,
                                     remat=self.remat and cfg.remat_policy is None)
        self.chunks = stage_layers(cfg.num_layers, self.num_stages, self.num_chunks, self.stage)
        self.first, self.last = self.stage == 0, self.stage == self.num_stages - 1
        self.module: Optional[PipelineStage] = None

    # --- weights ---------------------------------------------------------

    def build(self, device=None) -> PipelineStage:
        """The stage's module on ``device`` (weights uninitialized)."""
        return PipelineStage(self.config, self.chunks, self.first, self.last, device,
                             self.tp_group)

    def stage_names(self) -> List[str]:
        with torch.device("meta"):
            return list(self.build().state_dict())

    def init_params(self, generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
        """The stage's seeded weights: the values ``models.llama.init_params``
        gives ``LlamaForCausalLM`` for the same generator (every leaf drawn
        whole in the same order; other stages' leaves dropped one at a
        time), this tensor-parallel rank's shards."""
        names = set(self.stage_names())
        return init_params(self.config, generator, device=device,
                           tp_rank=group_rank(self.tp_group), tp_size=group_size(self.tp_group),
                           keep=names.__contains__)

    def canonical_layer_params(self, params: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
        """The stage's decoder-layer leaves in canonical layer order (names
        carry the global index already, so only the order changes)."""
        def layer(n: str) -> int:
            return int(n.split(".")[2])

        return {n: params[n] for n in sorted((n for n in params if n.startswith("model.layers.")),
                                             key=lambda n: (layer(n), n))}

    # --- the schedule ----------------------------------------------------

    def _rope(self, seq: int, device):
        cfg = self.config
        if seq > cfg.max_seq_len:
            raise ValueError(f"sequence length {seq} exceeds max_seq_len {cfg.max_seq_len}")
        return rotary_embedding(torch.arange(seq, dtype=torch.int32, device=device),
                                cfg.head_dim_, cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling)

    def _run(self, ids: torch.Tensor, labels: Optional[torch.Tensor], train: bool):
        """The schedule on this rank: ``(loss, grads)`` with ``labels``,
        else the last stage's logits by microbatch."""
        cfg, mod = self.config, self.module
        device = ids.device
        rope = self._rope(ids.shape[1], device)
        ids_mb = microbatch(ids, self.num_microbatches)
        act_shape = (ids_mb[0].shape[0], ids.shape[1], cfg.hidden_size)

        def first_fn(i):
            return mod.model.embed(i)

        chunk_fns = [(lambda x, c=c: mod.chunk(c, x, rope)) for c in range(self.num_chunks)]
        if labels is None:
            outs = self.engine.run(first_fn, chunk_fns, lambda y, _: mod.head(y), ids_mb,
                                   [None] * self.num_microbatches, act_shape, cfg.dtype,
                                   device, train=False)
            return outs

        labels_mb = microbatch(labels, self.num_microbatches)

        def last_fn(y, lab):
            per_tok = parallel_cross_entropy(mod.head(y), lab, ignore_index=-100,
                                             group=self.tp_group)
            return per_tok.sum(), (lab != -100).sum().float()

        count = (labels != -100).sum().float().reshape(1)
        scale = 1.0 / torch.clamp(count, min=1.0)
        params = list(mod.parameters())
        for p in params:
            p.grad = None
        outs = self.engine.run(first_fn, chunk_fns, last_fn, ids_mb, labels_mb, act_shape,
                               cfg.dtype, device, train=train, loss_scale=scale.reshape(()))
        total = torch.zeros(1, dtype=torch.float32, device=device)
        if self.last:
            total += sum(o[0].detach().float() for o in outs)
        # the last stage's sum on every rank (JAX's psum over pp)
        all_reduce_sum_(total, self.pp_group)
        loss = (total * scale).reshape(())
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        return loss, grads

    def loss(self, params: Mapping[str, torch.Tensor], input_ids: torch.Tensor,
             labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
        """Mean cross entropy over the non-ignored tokens, computed per
        microbatch on the last stage as each drains. ``params``: the stage's
        weights by name (bound to the module, no copy). While autograd
        records the schedule's backward runs too and the result carries the
        stage's gradients."""
        self._require_module()
        _rebind(dict(self.module.named_parameters()), params)
        input_ids, labels = torch.as_tensor(input_ids), torch.as_tensor(labels)
        if ignore_index != -100:
            labels = torch.where(labels == ignore_index, -100, labels)
        leaves = list(self.module.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in leaves):
            return _PipelineLoss.apply(self, input_ids, labels, *leaves)
        with torch.no_grad():
            count = torch.clamp((labels != -100).sum().float(), min=1.0)
            total = torch.zeros(1, dtype=torch.float32, device=input_ids.device)
            if self.last:
                labels_mb = microbatch(labels, self.num_microbatches)
                for lab, logits in zip(labels_mb, self._run(input_ids, None, False)):
                    total += parallel_cross_entropy(logits, lab, ignore_index=-100,
                                                    group=self.tp_group).sum()
            else:
                self._run(input_ids, None, False)
            all_reduce_sum_(total, self.pp_group)
            return (total / count).reshape(())

    def apply(self, params: Mapping[str, torch.Tensor], input_ids: torch.Tensor) -> torch.Tensor:
        """Full-batch logits (vocab-sharded under TP) on every pp rank: the
        inference and debug surface; training uses :meth:`loss`."""
        self._require_module()
        _rebind(dict(self.module.named_parameters()), params)
        input_ids = torch.as_tensor(input_ids)
        with torch.no_grad():
            outs = self._run(input_ids, None, False)
            vocab = self.config.vocab_size // group_size(self.tp_group)
            logits = (torch.cat(outs, 0).float() if self.last else torch.zeros(
                (*input_ids.shape, vocab), dtype=torch.float32, device=input_ids.device))
            all_reduce_sum_(logits, self.pp_group)
        return logits.to(self.config.dtype)

    def _require_module(self) -> None:
        if self.module is None:
            raise RuntimeError("the stage has no weights: call as_parallel_model() or "
                               "set_params() first")

    def set_params(self, params: Mapping[str, torch.Tensor], device: DeviceLike = None,
                   copy: bool = True) -> None:
        """Materialize the stage's module on ``device`` from ``params`` (this
        stage's tensors by name, or a whole model's: the stage takes its
        own; global tensors or this tensor-parallel rank's shards), each
        copied in its param dtype (``copy=False``: a tensor already on
        ``device`` in that dtype is taken as it is)."""
        dev = resolve_device(device)
        with torch.device("meta"):
            module = self.build()
        shapes = module.state_dict()
        given = local_state_dict({n: params[n] for n in shapes}, param_partition_specs(module),
                                 group_rank(self.tp_group), group_size(self.tp_group),
                                 {n: t.shape for n, t in shapes.items()})
        state = {n: given[n].to(device=dev, dtype=shapes[n].dtype, copy=copy) for n in shapes}
        module.load_state_dict(state, strict=True, assign=True)
        self.module = module

    # --- trainer integration ---------------------------------------------

    def as_parallel_model(self, sample_ids=None, seed: int = 0, device: DeviceLike = None,
                          params: Optional[Mapping[str, torch.Tensor]] = None):
        """The trainer's ``ParallelModel`` over this stage: seeded weights
        (the whole model's values for ``seed``) or ``params``, on ``device``
        (``cuda`` unless asked otherwise). ``sample_ids`` is accepted for the
        JAX signature. Train with ``make_train_step(model, opt, lambda p, b,
        r: pm.loss(p, b["ids"], b["labels"]))``."""
        dev = resolve_device(device)
        fresh = params is None
        if fresh:
            params = self.init_params(torch.Generator(device=dev).manual_seed(seed), device=dev)
        self.set_params(params, dev, copy=not fresh)   # a fresh init is the stage's own
        self.module.requires_grad_(True)
        return ParallelModel(module=self.module, device=dev, seed=seed, group=self.tp_group,
                             pp_group=self.pp_group,
                             params={n: p.detach() for n, p in self.module.named_parameters()})

