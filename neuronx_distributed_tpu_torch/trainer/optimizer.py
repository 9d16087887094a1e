"""Optimizer wrapper and factory.

Counterpart of ``neuronx_distributed_tpu/trainer/optimizer.py``: the
gradient transformation, the clipping config the train step reads, and the
ZeRO-1 plan (``optimizer/zero1.py``) made from the trainable specs. With
LoRA the optimizer sees only the adapters (``model.trainable_params``): the
frozen base has no optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from neuronx_distributed_tpu_torch.optimizer.adamw import (
    FusedGradientTransformation,
    adamw,
    adamw_fp32_master,
)
from neuronx_distributed_tpu_torch.optimizer.zero1 import Zero1Plan, make_zero1_plan
from neuronx_distributed_tpu_torch.trainer.model import ParallelModel


@dataclasses.dataclass
class NxDOptimizer:
    """The transformation, its clipping config and the ZeRO-1 plan: with
    ``zero_one_enabled`` each leaf's state is this rank's data-parallel
    slice of it (on one rank, or where no dim divides, the whole leaf)."""

    tx: FusedGradientTransformation
    grad_clipping: bool
    max_grad_norm: float
    zero_one_enabled: bool
    zero1_plan: Zero1Plan

    def init(self, params):
        """The state, born sharded: built from each param's ZeRO slice, so
        no rank ever holds a leaf's whole fp32 state."""
        plan = self.zero1_plan
        return self.tx.init({n: plan.shard(n, p).contiguous() for n, p in params.items()})


def initialize_parallel_optimizer(nxd_config: Dict[str, Any], model: ParallelModel,
                                  tx: Optional[FusedGradientTransformation] = None,
                                  learning_rate: Any = 1e-4, weight_decay: float = 0.01,
                                  **adam_kwargs) -> NxDOptimizer:
    """fp32-master AdamW when ``mixed_precision_config.use_master_weights``
    (the default), plain AdamW on the params otherwise, or the given ``tx``;
    the ZeRO-1 plan from ``model``'s trainable specs (``zero_one_enabled``
    adds the DP axes to each leaf's state, else the state mirrors the
    params' TP layout)."""
    opt_cfg = nxd_config["optimizer_config"]
    if tx is None:
        make = (adamw_fp32_master if nxd_config["mixed_precision_config"]["use_master_weights"]
                else adamw)
        tx = make(learning_rate, weight_decay=weight_decay, **adam_kwargs)
    zero1 = bool(opt_cfg["zero_one_enabled"])
    plan = make_zero1_plan(model.trainable_specs, model.trainable_params, augment=zero1)
    return NxDOptimizer(tx=tx, grad_clipping=bool(opt_cfg["grad_clipping"]),
                        max_grad_norm=float(opt_cfg["max_grad_norm"]),
                        zero_one_enabled=zero1, zero1_plan=plan)
