"""A host-side event timeline dumped as Chrome ``trace_event`` JSON (load
in ``chrome://tracing`` or Perfetto): labelled begin/end events, an instant
marker a step, and a rewrite of the file at each step end so a crash loses
at most one step. Each rank writes its own file (``path.json`` on rank 0,
``path.rank{r}.json`` elsewhere). The port's own copy of
``neuronx_distributed_tpu/utils/timeline.py``; device time comes from
:mod:`neuronx_distributed_tpu_torch.utils.profiler`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class Timeline:
    """Begin/end label events of one rank (``rank`` None: this process's
    ``torch.distributed`` rank, 0 without a group)."""

    def __init__(self, trace_file_path: Optional[str], rank: Optional[int] = None):
        self.enabled = trace_file_path is not None
        self.path = trace_file_path
        if rank is None:
            from neuronx_distributed_tpu_torch.utils import process_rank

            rank = process_rank()
        self.rank = rank
        self._events: List[Dict] = []
        self._t0 = time.perf_counter()
        self._step = 0

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _event(self, label: str, ph: str, **extra) -> None:
        self._events.append({"name": label, "ph": ph, "ts": self._now_us(),
                             "pid": self.rank, "tid": 0, **extra})

    def mark_event_start(self, label: str) -> None:
        if self.enabled:
            self._event(label, "B")

    def mark_event_end(self, label: str) -> None:
        if self.enabled:
            self._event(label, "E")

    def mark_step_end(self) -> None:
        """An instant marker between steps, then a rewrite of the file."""
        if not self.enabled:
            return
        self._event(f"step_{self._step}", "i", s="g")
        self._step += 1
        self._dump_events()

    def _dump_events(self) -> None:
        if not self.enabled:
            return
        path = f"{self.path}.rank{self.rank}.json" if self.rank else f"{self.path}.json"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": self._events}, fh)

    def __enter__(self) -> "Timeline":
        return self

    def __exit__(self, *exc) -> None:
        self._dump_events()


class EventScope:
    """``with EventScope(timeline, "fwd_mb3"):`` marks a span."""

    def __init__(self, timeline: Timeline, label: str):
        self.timeline = timeline
        self.label = label

    def __enter__(self):
        self.timeline.mark_event_start(self.label)

    def __exit__(self, *exc):
        self.timeline.mark_event_end(self.label)


def scope(timeline: Timeline, label: str) -> EventScope:
    return EventScope(timeline, label)
