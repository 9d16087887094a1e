"""Profiler hooks on ``torch.profiler``: :func:`profile_steps` traces the
block (host operators and, where a card is present, its kernels) and writes
a Chrome trace into ``logdir``; :func:`step_annotation` names one step in
that trace. The port's counterpart of
``neuronx_distributed_tpu/utils/profiler.py`` (``jax.profiler`` there).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_steps(logdir: Optional[str]) -> Iterator[None]:
    """Trace everything inside the block to ``logdir/trace.json`` (no-op
    when ``logdir`` is None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def step_annotation(step: int):
    """``with step_annotation(i): state, m = step(state, batch)``: the
    step's span in the trace, named ``train_step_{i}``."""
    return torch.profiler.record_function(f"train_step_{step}")
