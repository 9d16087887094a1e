"""The training step: forward, backward, clip and optimizer update.

Counterpart of ``neuronx_distributed_tpu/trainer/step.py``. The JAX step is
one jitted program; here it is eager PyTorch with the same semantics:
gradients by autograd, ``grad_accum_steps`` microbatches accumulated as an
fp32 mean, the clip scale handed to the optimizer, the update through the
optimizer's ``update_and_params_local`` (fp32-master AdamW: the single-pass
kernel on every leaf it takes, the plain formula on the rest; plain AdamW:
its plain code), and the new params written back into the trainable
tensors. ``loss`` and ``grad_norm`` come back as device tensors: the step
reads nothing back to the host.

LoRA (JAX ``step.py:115-135``): ``state.params`` is the flat adapter tree,
gradients are taken with respect to the adapters only, and the layers add
their in-activation correction (``lora/core.py``). With dropout each step
draws one seed per adapter from ``state.rng`` (a CPU ``torch.Generator``,
part of the train state and so of its checkpoint), or takes the step's
``lora_masks``.

Donation: with ``donate=True`` (the default) the old state's tensors are
reused in place, as JAX reuses donated buffers, and the old state must not
be used again. With ``donate=False`` the old state stays valid: the step
works on a copy of the optimizer state and points the trainable tensors at
new ones.

Parallel worlds (JAX ``step.py:137-257``): each rank runs the step on its
own rows of the global batch and its own shards. The data-parallel
reduction comes once a step, after the ``grad_accum_steps`` microbatches:
the mean over DP of each gradient, reduce-scattered along its ZeRO-1 dim
(``optimizer/zero1.py``) or all-reduced where its state is not DP-sharded
(ZeRO off, or no dim divides). The clip norm is the global one over the
sharded gradients (``parallel/grads.py``), the same on every rank. The
update then runs on the rank's state shards (B4 where the shard is a
supported leaf) and the new param shards are all-gathered over DP into the
params. ``loss`` is the mean of the data-parallel ranks' losses (the
reference's mean of per-rank means; equal to JAX's global mean when the
ranks count the same tokens). A state made by :func:`create_train_state`
on a world of several ranks carries its ``layout`` (leaf path ->
``checkpoint.core.Piece``) for the multi-rank checkpoint.

Expert parallelism: an expert leaf's owner receives, through the MoE
all-to-all, the gradient of every rank of its ep group, so its gradient
is summed over the expert-data-parallel group only (the ranks holding the
same experts), divided by the DP degree like every other, and its ZeRO-1
state shards over edp (``optimizer/zero1.py``); the clip norm counts each
expert slice once (``parallel/grads.py``). The loss the step reports is the
DP mean of the ranks' losses, which under ``models.mixtral.mixtral_loss``
is JAX's global loss (``moe/routing.py``).

Context parallelism: each rank's gradients are its tokens' share (the
loss is the global mean), so they are summed over the cp group before the
DP reduction: JAX's ``DP_AXES`` leave cp out of ZeRO while GSPMD still
reduces over it. ZeRO-1 shards over DP only. Pipeline parallelism: a
``PipelinedLlama`` stage's loss runs the whole schedule, its backward
included, and its gradients are the stage's; every leaf lives on one
stage, so the clip norm sums the squares over the pp group, and every
rank clips by the same scale and reports the last stage's loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.checkpoint.core import Piece
from neuronx_distributed_tpu_torch.optimizer.zero1 import (
    all_gather_into,
    all_reduce_mean_,
    reduce_scatter_mean,
)
from neuronx_distributed_tpu_torch.parallel import mesh as ps
from neuronx_distributed_tpu_torch.parallel.grads import get_grad_norm
from neuronx_distributed_tpu_torch.parallel.mappings import all_reduce_sum_
from neuronx_distributed_tpu_torch.trainer.model import ParallelModel
from neuronx_distributed_tpu_torch.trainer.optimizer import NxDOptimizer

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Step counter (a () int32 device tensor), the trainable params by
    name, the optimizer state, and the generator the step's LoRA dropout
    draws from. ``layout`` describes the state (where each leaf's block
    lies in its global tensor, and which rank writes it) and is not saved."""

    step: torch.Tensor
    params: Tree
    opt_state: Any
    rng: Optional[torch.Generator] = None
    layout: Optional[Dict[str, Piece]] = dataclasses.field(
        default=None, repr=False, compare=False, metadata={"checkpoint": False})


def _state_layout(optimizer: NxDOptimizer, params: Tree,
                  opt_state) -> Optional[Dict[str, Piece]]:
    """Each sharded or replicated leaf's :class:`Piece` on this rank (None
    on one rank): a param is its TP shard, written by its data-parallel
    rank 0; a state leaf its ZeRO-1 slice of that shard, written by its own
    rank (or, not DP-sharded, like its param); a TP-replicated leaf is
    written by its tensor-parallel rank 0, and every leaf by context-parallel
    rank 0 (the cp ranks hold the same state). Under pipeline parallelism a
    leaf lives on one stage, under its global name."""
    if not ps.model_parallel_is_initialized() or ps.get_world_size() == 1:
        return None
    plan = optimizer.zero1_plan
    cp_own = ps.context_parallel_rank() == 0
    out: Dict[str, Piece] = {}
    for n, p in params.items():
        shape = tuple(p.shape)
        glob = plan.global_shape(n, shape)
        tp_own = (plan.tp_dim(n) is not None or plan.tp_rank == 0) and cp_own
        # replicas of the leaf: the DP ranks, or an expert leaf's edp ranks
        first = plan.reduction(n)[2] == 0
        out[f".params['{n}']"] = Piece(glob, plan.param_offset(n, shape), tp_own and first)
        zero = plan.zero(n)
        state_piece = Piece(glob, plan.state_offset(n, shape) if zero
                            else plan.param_offset(n, shape),
                            tp_own and (zero or first))
        for field in getattr(opt_state, "_fields", ()):
            tree = getattr(opt_state, field)
            if isinstance(tree, dict) and n in tree:
                out[f".opt_state.{field}['{n}']"] = state_piece
    return out


def create_train_state(model: ParallelModel, optimizer: NxDOptimizer) -> TrainState:
    """The first state: the trainable params (the adapters under LoRA),
    their optimizer state (born in its ZeRO-1 shards), a generator seeded
    ``seed + 2``, and on several ranks the state's layout."""
    params = model.trainable_params
    opt_state = optimizer.init(params)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=model.device),
                      params=params, opt_state=opt_state,
                      rng=torch.Generator().manual_seed(model.seed + 2),
                      layout=_state_layout(optimizer, params, opt_state))


def make_train_step(model: ParallelModel, optimizer: NxDOptimizer,
                    loss_fn: Callable[..., torch.Tensor], donate: bool = True,
                    grad_accum_steps: int = 1
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, batch, rng=None, lora_masks=None) -> (state,
    metrics)``.

    ``loss_fn(params, batch, rng) -> scalar loss`` runs the model on
    ``params`` (``model.apply(params, ...)``, or the module itself); under
    LoRA it gets the frozen base (``model.params``) and the adapters ride
    in the layers. ``batch`` is a dict of arrays or tensors with a leading
    batch dim, which ``grad_accum_steps > 1`` splits into that many
    microbatches; each gets the same ``rng`` and the same dropout seeds.
    ``lora_masks`` (adapter weight name -> bool keep-mask shaped like the
    layer's input) replaces the drawn dropout masks for this step."""
    tx = optimizer.tx
    lora_cfg = model.lora_config
    leaves = model.trainable_leaves()
    names = list(leaves)
    plan = optimizer.zero1_plan
    dp_group, dp = plan.dp_group, plan.dp
    # in the trainable tree's order: every rank issues the collectives alike
    # (a set's order varies from process to process)
    zero = [n for n in names if plan.zero(n)]
    layout = dict(tp_group=model.group, dp_group=dp_group, pp_group=model.pp_group,
                  tp_sharded={n for n in names if plan.tp_dim(n) is not None},
                  dp_sharded=set(zero), ep_sharded=set(plan.expert),
                  edp_group=plan.edp_group)
    # each ZeRO leaf's shard of the new params, written by the update and
    # all-gathered into the params (allocated at the first step)
    shard_out: Tree = {}

    def reduce_over_dp(loss, grads):
        """The DP means: the loss, and each gradient (its ZeRO slice); an
        expert leaf's gradient is summed over its edp group alone (its
        owner already holds its ep group's share) and divided by dp."""
        loss = all_reduce_sum_(loss.float().reshape(1), dp_group).reshape(()) / dp
        out = {}
        for n, g in grads.items():
            group, ranks, _ = plan.reduction(n)
            out[n] = (reduce_scatter_mean(g, plan.dims[n], group, ranks, divisor=dp) if n in zero
                      else all_reduce_mean_(g.contiguous(), group, dp))
        return loss, out

    def zero_update(grads, opt_state, params, scale):
        """The update on the state shards; the new param shards all-gathered
        over DP into the params (new tensors without donation)."""
        if not shard_out:
            shard_out.update({n: torch.empty(plan.shard(n, params[n]).shape,
                                             dtype=params[n].dtype, device=params[n].device)
                              for n in zero})
        if not hasattr(opt_state, "master"):   # plain AdamW reads the old values
            for n in zero:
                shard_out[n].copy_(plan.shard(n, params[n]))
        out = {n: shard_out[n] if n in zero else (params[n] if donate else
                                                  torch.empty_like(params[n]))
               for n in params}
        local = {n: shard_out[n] if n in zero else params[n] for n in params}
        new, opt_state = tx.update_and_params_local(grads, opt_state, local, scale=scale,
                                                    out=out)
        for n in zero:
            target = params[n] if donate else torch.empty_like(params[n])
            group, ranks, _ = plan.reduction(n)
            all_gather_into(target, new[n], plan.dims[n], group, ranks)
            new[n] = target
        return new, opt_state

    def value_and_grad(params: Tree, batch, rng):
        loss = loss_fn(model.params if lora_cfg is not None else params, batch, rng)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def step_fn(state: TrainState, batch, rng=None,
                lora_masks: Optional[Mapping[str, torch.Tensor]] = None):
        model.bind_trainable(state.params)
        dropout = model.lora_dropout
        if dropout is not None:
            if lora_masks is not None:
                dropout.use_masks(lora_masks)
            else:
                dropout.draw(state.rng, sorted(model.lora_specs))
        if grad_accum_steps > 1:
            lead = len(next(iter(batch.values())))
            if lead % grad_accum_steps:
                raise ValueError(f"batch leading dim {lead} not divisible by "
                                 f"grad_accum_steps={grad_accum_steps}")
            m = lead // grad_accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in state.params.items()}
            for i in range(grad_accum_steps):
                micro = {key: x[i * m:(i + 1) * m] for key, x in batch.items()}
                loss_i, grads_i = value_and_grad(state.params, micro, rng)
                loss = loss + loss_i.float()
                for n, g in grads_i.items():
                    acc[n] += g.float()
            loss = loss / grad_accum_steps
            grads = {n: (a / grad_accum_steps).to(state.params[n].dtype) for n, a in acc.items()}
            del acc
        else:
            loss, grads = value_and_grad(state.params, batch, rng)
        if model.cp_group is not None:
            # each cp rank holds its tokens' share: the gradient is the sum
            grads = {n: all_reduce_sum_(g.contiguous(), model.cp_group)
                     for n, g in grads.items()}
        if dp_group is not None:
            loss, grads = reduce_over_dp(loss, grads)
        metrics = {"loss": loss}
        scale = None
        if optimizer.grad_clipping:
            # the clip scale (clip_grads_with_norm's coefficient) rides into
            # the optimizer
            grad_norm = get_grad_norm(grads, **layout)
            scale = torch.clamp(optimizer.max_grad_norm / (grad_norm + 1e-6), max=1.0)
            metrics["grad_norm"] = grad_norm
        opt_state = state.opt_state if donate else state.opt_state.clone()
        with torch.no_grad():
            if zero:
                new_params, opt_state = zero_update(grads, opt_state, state.params, scale)
            else:
                # donated params take the new values in place, written by the
                # update itself (the kernel writes each param once)
                new_params, opt_state = tx.update_and_params_local(
                    grads, opt_state, state.params, scale=scale,
                    out=state.params if donate else None)
            del grads
        model.bind_trainable(new_params)
        return dataclasses.replace(state, step=state.step + 1, params=new_params,
                                   opt_state=opt_state), metrics

    return step_fn
