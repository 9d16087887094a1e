"""Training: config, model and optimizer wrappers, the train step.

Submodules load on first attribute access, as in the package root."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "neuronx_distributed_config": "config",
    "ParallelModel": "model",
    "initialize_parallel_model": "model",
    "NxDOptimizer": "optimizer",
    "initialize_parallel_optimizer": "optimizer",
    "TrainState": "step",
    "create_train_state": "step",
    "make_train_step": "step",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
