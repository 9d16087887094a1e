"""The training step: forward, backward, clip and optimizer update.

Counterpart of ``neuronx_distributed_tpu/trainer/step.py``. The JAX step is
one jitted program; here it is eager PyTorch with the same semantics:
gradients by autograd, ``grad_accum_steps`` microbatches accumulated as an
fp32 mean, the clip scale folded into the optimizer's grad cast, the fused
``update_and_params`` (or, with ``optimizer_kernel=True``, the single-pass
AdamW kernel on every leaf it takes), and the new params written back into
the module's parameters. ``loss`` and ``grad_norm`` come back as device
tensors: the step reads nothing back to the host.

Donation: with ``donate=True`` (the default) the old state's tensors are
reused in place, as JAX reuses donated buffers, and the old state must not
be used again. With ``donate=False`` the old state stays valid: the step
works on a copy of the optimizer state and points the module at new param
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.parallel.grads import get_grad_norm
from neuronx_distributed_tpu_torch.trainer.model import ParallelModel
from neuronx_distributed_tpu_torch.trainer.optimizer import NxDOptimizer

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Step counter (a () int32 device tensor), params by name, optimizer
    state."""

    step: torch.Tensor
    params: Tree
    opt_state: Any


def create_train_state(model: ParallelModel, optimizer: NxDOptimizer) -> TrainState:
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=model.device),
                      params=dict(model.params), opt_state=optimizer.init(model.params))


def make_train_step(model: ParallelModel, optimizer: NxDOptimizer,
                    loss_fn: Callable[..., torch.Tensor], donate: bool = True,
                    grad_accum_steps: int = 1, optimizer_kernel: Optional[bool] = None
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, batch, rng=None) -> (state, metrics)``.

    ``loss_fn(params, batch, rng) -> scalar loss`` runs the model on
    ``params`` (``model.apply(params, ...)``, or the module itself: the step
    points it at ``state.params`` first). ``batch`` is a dict of arrays or
    tensors with a leading batch dim, which ``grad_accum_steps > 1`` splits
    into that many microbatches; each gets the same ``rng``. The optimizer
    is a fused transformation (``adamw_fp32_master``); its kernel route is
    opt-in, as in the JAX package."""
    tx = optimizer.tx
    update = tx.update_and_params_local if optimizer_kernel else tx.update_and_params
    module_params = dict(model.module.named_parameters())

    def value_and_grad(state: TrainState, batch, rng):
        loss = loss_fn(state.params, batch, rng)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [module_params[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def step_fn(state: TrainState, batch, rng=None):
        model.bind(state.params)
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
                loss_i, grads_i = value_and_grad(state, micro, rng)
                loss = loss + loss_i.float()
                for n, g in grads_i.items():
                    acc[n] += g.float()
            loss = loss / grad_accum_steps
            grads = {n: (a / grad_accum_steps).to(state.params[n].dtype) for n, a in acc.items()}
            del acc
        else:
            loss, grads = value_and_grad(state, batch, rng)
        metrics = {"loss": loss}
        scale = None
        if optimizer.grad_clipping:
            # the clip scale (clip_grads_with_norm's coefficient) rides into
            # the optimizer's fp32 grad cast; clipped grads are never written
            grad_norm = get_grad_norm(grads)
            scale = torch.clamp(optimizer.max_grad_norm / (grad_norm + 1e-6), max=1.0)
            metrics["grad_norm"] = grad_norm
        opt_state = state.opt_state if donate else state.opt_state.clone()
        with torch.no_grad():
            # donated params take the new values in place, written by the
            # update itself (the kernel writes each param once)
            new_params, opt_state = update(grads, opt_state, state.params, scale=scale,
                                           out=state.params if donate else None)
            del grads
        model.bind(new_params)
        return TrainState(step=state.step + 1, params=new_params, opt_state=opt_state), metrics

    return step_fn
