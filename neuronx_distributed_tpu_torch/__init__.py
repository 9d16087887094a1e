"""PyTorch/CUDA port of ``neuronx_distributed_tpu``: serving and training.

The JAX package beside this one is the reference; each module here mirrors
the JAX module of the same path and name. The serving path runs
``ServeEngine`` -> ``CausalLM`` -> Llama -> attention; the training path
runs ``initialize_parallel_model`` -> ``initialize_parallel_optimizer`` ->
``create_train_state`` -> ``make_train_step`` -> ``LlamaForCausalLM.loss``
on one device. Their kernels (flash attention forward and backward, paged
decode attention, fused AdamW) are CUDA C++ written for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of carrying on silently on the CPU. Every
kernel wrapper computes its plain PyTorch version for CPU tensors, and
launches its kernel (or raises) for CUDA tensors.

This package imports ``torch`` and ``numpy`` and nothing of JAX: the
submodules load lazily, so ``import neuronx_distributed_tpu_torch`` is cheap.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("converters", "inference", "kernels", "lora", "models", "observability", "ops",
               "optimizer", "parallel", "trainer")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
