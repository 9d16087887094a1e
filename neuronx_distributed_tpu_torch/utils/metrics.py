"""Training metrics: ``Throughput``, a moving average of sequences a
second (``batch x world x accumulation / dt`` over a window of calls), and
``MetricsWriter``, one JSON object a line (``step``, ``time``, then the
metrics, each a float where it has one), written by rank 0 only. The port's
own copy of ``neuronx_distributed_tpu/utils/metrics.py``: the same line
format, so one reader takes both packages' files.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, Optional


class Throughput:
    """Sequences a second over the last ``window`` calls."""

    def __init__(self, batch_size: int, world_size: int = 1,
                 grad_accum_steps: int = 1, window: int = 10):
        self.seqs_per_step = batch_size * world_size * grad_accum_steps
        self.times: deque = deque(maxlen=window)
        self.last = time.perf_counter()

    def get_throughput(self) -> float:
        now = time.perf_counter()
        self.times.append(now - self.last)
        self.last = now
        return self.seqs_per_step * len(self.times) / sum(self.times)


class MetricsWriter:
    """Appends one JSON line per :meth:`log` to ``path`` (None, or a rank
    other than 0: writes nothing)."""

    def __init__(self, path: Optional[str]):
        from neuronx_distributed_tpu_torch.utils import process_rank

        self.path = path if process_rank() == 0 else None
        self._fh = None
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._fh = open(self.path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        if self._fh is None:
            return
        rec: Dict[str, Any] = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
