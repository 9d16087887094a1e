"""The user's training recipe (JAX ``lightning/module.py``): subclass and
implement :meth:`configure_model`, :meth:`model_inputs` and
:meth:`training_loss`; override the others as needed."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

Tree = Dict[str, torch.Tensor]
Batch = Dict[str, Any]


class NxDLightningModule:
    """Declarative training recipe consumed by :class:`NxDTrainer`."""

    def __init__(self, nxd_config: Dict[str, Any], learning_rate: Any = 1e-4,
                 weight_decay: float = 0.01, grad_accum_steps: int = 1):
        self.nxd_config = nxd_config
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_accum_steps = int(grad_accum_steps)

    # --- required hooks --------------------------------------------------

    def configure_model(self) -> nn.Module:
        """Build the module (built on the meta device, then materialized by
        ``initialize_parallel_model``)."""
        raise NotImplementedError

    def model_inputs(self, batch: Batch):
        """Example arguments from a batch (the JAX signature's; the port's
        modules know their shapes from their config)."""
        raise NotImplementedError

    def training_loss(self, model, params: Tree, batch: Batch,
                      rng: torch.Generator) -> torch.Tensor:
        """Scalar loss. ``model`` is the trainer's ``ParallelModel``: run it
        as ``model.apply(params, ..., method="loss")``. ``rng`` is the
        step's generator (seeded ``seed + step + 1``)."""
        raise NotImplementedError

    # --- optional hooks --------------------------------------------------

    def validation_loss(self, model, params: Tree, batch: Batch,
                        rng: torch.Generator) -> torch.Tensor:
        return self.training_loss(model, params, batch, rng)

    def configure_optimizer(self, model):
        """The ``NxDOptimizer`` (default: the trainer factory with this
        module's lr and weight decay), its transformation wrapped in
        :func:`~neuronx_distributed_tpu_torch.optimizer.multi_steps.multi_steps`
        when ``grad_accum_steps > 1``."""
        from neuronx_distributed_tpu_torch.optimizer.multi_steps import multi_steps
        from neuronx_distributed_tpu_torch.trainer import initialize_parallel_optimizer

        opt = initialize_parallel_optimizer(self.nxd_config, model,
                                            learning_rate=self.learning_rate,
                                            weight_decay=self.weight_decay)
        if self.grad_accum_steps > 1:
            opt.tx = multi_steps(opt.tx, self.grad_accum_steps)
        return opt
