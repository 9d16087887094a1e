"""Optimizer wrapper and factory, on one device.

Counterpart of ``neuronx_distributed_tpu/trainer/optimizer.py``: the
gradient transformation plus the clipping config the train step reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from neuronx_distributed_tpu_torch.optimizer.adamw import (
    FusedGradientTransformation,
    adamw_fp32_master,
)
from neuronx_distributed_tpu_torch.trainer.model import ParallelModel


@dataclasses.dataclass
class NxDOptimizer:
    """The transformation and its clipping config. ZeRO-1 shards the
    optimizer state over the data-parallel ranks; on one device there is one
    rank and the plan shards nothing, so ``zero_one_enabled`` is recorded and
    changes nothing until the data-parallel slice."""

    tx: FusedGradientTransformation
    grad_clipping: bool
    max_grad_norm: float
    zero_one_enabled: bool

    def init(self, params):
        return self.tx.init(params)


def initialize_parallel_optimizer(nxd_config: Dict[str, Any], model: ParallelModel,
                                  tx: Optional[FusedGradientTransformation] = None,
                                  learning_rate: Any = 1e-4, weight_decay: float = 0.01,
                                  **adam_kwargs) -> NxDOptimizer:
    """fp32-master AdamW when ``mixed_precision_config.use_master_weights``
    (the default), or the given ``tx``. ``model`` is accepted for the JAX
    signature (its ZeRO-1 plan needs it there)."""
    opt_cfg = nxd_config["optimizer_config"]
    if tx is None:
        if not nxd_config["mixed_precision_config"]["use_master_weights"]:
            raise NotImplementedError(
                "use_master_weights=False (plain AdamW on the params themselves) is not "
                "ported yet (ROADMAP queue A, training line)")
        tx = adamw_fp32_master(learning_rate, weight_decay=weight_decay, **adam_kwargs)
    return NxDOptimizer(tx=tx, grad_clipping=bool(opt_cfg["grad_clipping"]),
                        max_grad_norm=float(opt_cfg["max_grad_norm"]),
                        zero_one_enabled=bool(opt_cfg["zero_one_enabled"]))
