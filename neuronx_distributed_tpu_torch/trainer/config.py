"""Training configuration: a nested dict with warn-and-default validation of
the parallel degrees and the per-subsystem configs.

The port's own copy of ``neuronx_distributed_tpu/trainer/config.py`` (a
pure dict, so user scripts read identically); :func:`neuronx_distributed_config`
fills defaults and validates.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Optional

logger = logging.getLogger("nxd")

_OPTIMIZER_DEFAULTS: Dict[str, Any] = {
    "zero_one_enabled": True,
    "grad_clipping": True,
    "max_grad_norm": 1.0,
}

_MIXED_PRECISION_DEFAULTS: Dict[str, Any] = {
    # an explicit dtype policy: compute and storage dtypes by name
    "use_master_weights": True,
    "compute_dtype": "bfloat16",
    "param_dtype": "float32",
    "use_master_weights_in_ckpt": False,
}

_MODEL_INIT_DEFAULTS: Dict[str, Any] = {
    # kept for the JAX config's shape; the port builds on the meta device and
    # materializes each weight once on its target device either way
    "jit_sharded_init": True,
    "seed": 0,
}

_PIPELINE_DEFAULTS: Dict[str, Any] = {
    "num_microbatches": 1,
    "schedule": "1f1b",  # "1f1b" | "interleaved"
    "virtual_pipeline_size": 1,
}


def neuronx_distributed_config(
    tensor_parallel_size: int = 1,
    pipeline_parallel_size: int = 1,
    expert_parallel_size: int = 1,
    context_parallel_size: int = 1,
    sequence_parallel: Optional[bool] = None,
    pipeline_config: Optional[Dict[str, Any]] = None,
    optimizer_config: Optional[Dict[str, Any]] = None,
    activation_checkpoint_config: Optional[Any] = None,
    model_init_config: Optional[Dict[str, Any]] = None,
    mixed_precision_config: Optional[Dict[str, Any]] = None,
    lora_config: Optional[Any] = None,
) -> Dict[str, Any]:
    """Assemble and validate the config dict.

    Unknown keys inside sub-configs warn and are kept; missing keys default.
    """

    def merged(defaults: Dict[str, Any], user: Optional[Dict[str, Any]], name: str) -> Dict[str, Any]:
        out = copy.deepcopy(defaults)
        for k, v in (user or {}).items():
            if k not in defaults:
                logger.warning("unknown key %r in %s — keeping as-is", k, name)
            out[k] = v
        return out

    cfg: Dict[str, Any] = {
        "tensor_parallel_size": int(tensor_parallel_size),
        "pipeline_parallel_size": int(pipeline_parallel_size),
        "expert_parallel_size": int(expert_parallel_size),
        "context_parallel_size": int(context_parallel_size),
        "sequence_parallel": bool(sequence_parallel),  # None (default) -> False
        "pipeline_config": merged(_PIPELINE_DEFAULTS, pipeline_config, "pipeline_config"),
        "optimizer_config": merged(_OPTIMIZER_DEFAULTS, optimizer_config, "optimizer_config"),
        "mixed_precision_config": merged(
            _MIXED_PRECISION_DEFAULTS, mixed_precision_config, "mixed_precision_config"
        ),
        "model_init_config": merged(_MODEL_INIT_DEFAULTS, model_init_config, "model_init_config"),
        "activation_checkpoint_config": activation_checkpoint_config,
        "lora_config": lora_config,
        # Keys the USER explicitly set (vs defaults): initialize_parallel_model
        # applies model-config overrides only for these, so a default never
        # silently clobbers a model's own dtype/remat choice — and an explicit
        # setting is never a silent no-op.
        "_explicit_keys": {
            "mixed_precision_config": sorted((mixed_precision_config or {}).keys()),
            # record SET-ness, not the value: an explicit False must override
            # a model config's sequence_parallel=True just like True does
            "sequence_parallel": sequence_parallel is not None,
        },
    }
    if cfg["sequence_parallel"] and cfg["tensor_parallel_size"] == 1:
        logger.warning("sequence_parallel=True with tensor_parallel_size=1 has no effect")
    return cfg
