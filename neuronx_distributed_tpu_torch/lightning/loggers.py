"""Metric loggers (JAX ``lightning/loggers.py``): scalars written on the
logging process only, rank 0 of the default ``torch.distributed`` group
(every process when there is no group). TensorBoard writing uses
``torch.utils.tensorboard``'s ``SummaryWriter`` when it imports and falls
back to line-delimited JSON otherwise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def _is_logging_process() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class BaseLogger:
    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        pass


class JsonLogger(BaseLogger):
    """Line-delimited JSON metrics, ``{log_dir}/{name}.jsonl``."""

    def __init__(self, log_dir: str, name: str = "metrics"):
        self.enabled = _is_logging_process()
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = None
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(self.path, "a")

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._fh is None:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def finalize(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TensorBoardLogger(BaseLogger):
    """TensorBoard scalars under ``{log_dir}/{name}`` on the logging
    process, or a :class:`JsonLogger` there when no ``SummaryWriter``
    imports."""

    def __init__(self, log_dir: str, name: str = "nxd"):
        self.enabled = _is_logging_process()
        self._writer = None
        self._fallback: Optional[JsonLogger] = None
        if not self.enabled:
            return
        path = os.path.join(log_dir, name)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=path)
        except Exception:  # noqa: BLE001 - tensorboard missing or broken
            self._fallback = JsonLogger(path)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.enabled:
            return
        if self._writer is not None:
            for k, v in metrics.items():
                if hasattr(v, "__float__"):
                    self._writer.add_scalar(k, float(v), step)
        elif self._fallback is not None:
            self._fallback.log_metrics(metrics, step)

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.close()
        if self._fallback is not None:
            self._fallback.finalize()
