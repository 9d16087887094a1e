"""Device resolution shared by the port's entry points and kernel wrappers."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device. Asking for CUDA
    (explicitly or by default) on a machine without a GPU raises: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Kernel routing for a wrapper's inputs: True when they all lie on a
    CUDA device (launch the kernel), False when they all lie on the CPU
    (compute the plain version). Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        devs = {t.device for t in tensors if t is not None}
        if len(devs) != 1:
            raise ValueError(f"inputs span several CUDA devices: {sorted(map(str, devs))}")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"inputs must all lie on one CUDA device or all on the CPU, got {sorted(kinds)}")
