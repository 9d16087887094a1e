"""Multi-process bootstrap and per-rank batch feeding over ``torch.distributed``.

Counterpart of ``neuronx_distributed_tpu/parallel/distributed.py``. The JAX
package joins every host into one runtime (``jax.distributed.initialize``)
and assembles global arrays from each host's rows; here every rank is a
process of its own in the default group, and each data-parallel rank feeds
its own rows of the global batch, on its own device.

Launch contract: the JAX package's trio, or ``torchrun``'s environment:

    NXD_COORDINATOR_ADDRESS=<host0>:<port>  (or MASTER_ADDR / MASTER_PORT)
    NXD_NUM_PROCESSES=<world size>          (or WORLD_SIZE)
    NXD_PROCESS_ID=<this process's rank>    (or RANK)

or the equivalent arguments. ``LOCAL_RANK`` (default: the rank) picks the
process's card unless ``device`` names one (several ranks on one card:
``device="cuda:0"`` and ``backend="gloo"``, since NCCL refuses two ranks on
one device).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch import _device
from neuronx_distributed_tpu_torch.parallel import mesh

_ENV_COORD = "NXD_COORDINATOR_ADDRESS"
_ENV_NPROC = "NXD_NUM_PROCESSES"
_ENV_PID = "NXD_PROCESS_ID"


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def _env_coord() -> Optional[str]:
    coord = os.environ.get(_ENV_COORD)
    if coord:
        return coord
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None, local_rank: Optional[int] = None,
                           device: Optional[str] = None,
                           timeout: datetime.timedelta = mesh.DEFAULT_TIMEOUT) -> bool:
    """Join this process into the default group. Each field resolves from
    its argument, then the ``NXD_*`` variable, then ``torchrun``'s. Returns
    True when a multi-process group is (or already was) up, False for a
    world of one or when nothing is configured (a no-op, so scripts call
    this unconditionally). A partial configuration raises ``ValueError``.
    ``backend`` defaults to ``nccl`` with a GPU, else ``gloo``; ``device``
    (a CUDA device) binds the process to that card instead of
    ``cuda:{LOCAL_RANK}``."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = coordinator_address or _env_coord()
    nproc = num_processes if num_processes is not None else _env_int(_ENV_NPROC, "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int(_ENV_PID, "RANK")
    if coord is None and nproc is None and pid is None:
        return False
    if coord is None or nproc is None or pid is None:
        raise ValueError(
            "partial distributed config: need all of coordinator_address "
            f"({coord!r}), num_processes ({nproc!r}), process_id ({pid!r}) — set "
            f"{_ENV_COORD}/{_ENV_NPROC}/{_ENV_PID} (or MASTER_ADDR/MASTER_PORT, WORLD_SIZE, "
            "RANK) or pass them explicitly")
    if int(nproc) == 1:
        return False
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if device is not None and torch.device(device).type == "cuda":
        local_rank = torch.device(device).index or 0
    mesh.init_distributed(backend, rank=int(pid), world_size=int(nproc), local_rank=local_rank,
                          init_method=f"tcp://{coord}", timeout=timeout)
    return True


def host_batch_slice(global_batch_size: int) -> slice:
    """The rows of the global batch this rank feeds: its data-parallel
    rank's slice once model parallel is initialized (every rank of a
    tensor-parallel group feeds the same rows), else the default group's
    process slice (the JAX process-order contract), else everything."""
    if mesh.model_parallel_is_initialized():
        return mesh.data_batch_slice(global_batch_size)
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by process count {n}")
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def shard_host_batch(batch: Mapping[str, Any], device: _device.DeviceLike = None) -> dict:
    """This rank's :func:`host_batch_slice` rows of a global batch (a dict
    of arrays or tensors with a leading batch dim), on ``device`` (the
    rank's card unless named)."""
    dev = _device.resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        out[k] = t[host_batch_slice(t.shape[0])].to(dev)
    return out
