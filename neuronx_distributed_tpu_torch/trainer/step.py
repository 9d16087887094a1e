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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.parallel.grads import get_grad_norm
from neuronx_distributed_tpu_torch.trainer.model import ParallelModel
from neuronx_distributed_tpu_torch.trainer.optimizer import NxDOptimizer

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Step counter (a () int32 device tensor), the trainable params by
    name, the optimizer state, and the generator the step's LoRA dropout
    draws from."""

    step: torch.Tensor
    params: Tree
    opt_state: Any
    rng: Optional[torch.Generator] = None


def create_train_state(model: ParallelModel, optimizer: NxDOptimizer) -> TrainState:
    """The first state: the trainable params (the adapters under LoRA),
    their optimizer state, and a generator seeded ``seed + 2``."""
    params = model.trainable_params
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=model.device),
                      params=params, opt_state=optimizer.init(params),
                      rng=torch.Generator().manual_seed(model.seed + 2))


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
        metrics = {"loss": loss}
        scale = None
        if optimizer.grad_clipping:
            # the clip scale (clip_grads_with_norm's coefficient) rides into
            # the optimizer
            grad_norm = get_grad_norm(grads)
            scale = torch.clamp(optimizer.max_grad_norm / (grad_norm + 1e-6), max=1.0)
            metrics["grad_norm"] = grad_norm
        opt_state = state.opt_state if donate else state.opt_state.clone()
        with torch.no_grad():
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
