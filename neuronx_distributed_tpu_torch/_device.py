"""Device resolution shared by the port's entry points and kernel wrappers."""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

# the local rank of a process-per-rank launch (``parallel.mesh.init_distributed``)
_LOCAL_RANK: Optional[int] = None


def bind_local_rank(local_rank: Optional[int]) -> None:
    """This process's rank on its host: the default device becomes
    ``cuda:{local_rank}``."""
    global _LOCAL_RANK
    _LOCAL_RANK = None if local_rank is None else int(local_rank)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device; in a
    process-per-rank launch (a bound local rank) the rank's own card
    ``cuda:{local_rank}``, made the current device. Asking for CUDA
    (explicitly or by default) on a machine without a GPU raises: the port
    never falls back to the CPU on its own."""
    bound = device is None and _LOCAL_RANK is not None
    if bound:
        device = f"cuda:{_LOCAL_RANK}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if bound:
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {_LOCAL_RANK} has no card: "
                               f"{torch.cuda.device_count()} visible; name the device")
        torch.cuda.set_device(dev)
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


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (arrays by name) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
