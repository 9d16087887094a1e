"""Shared utilities: divide and padding math, logging, training metrics,
the host timeline and profiler hooks.

The port's own copy of ``neuronx_distributed_tpu/utils/`` (``__init__``,
``logger``, ``metrics``, ``profiler``, ``timeline``) on PyTorch: the rank
is the ``torch.distributed`` rank when a process group is live (0
otherwise), and the profiler is ``torch.profiler``.
"""

from neuronx_distributed_tpu_torch.utils.logger import get_log_level, get_logger  # noqa: F401
from neuronx_distributed_tpu_torch.utils.metrics import MetricsWriter, Throughput  # noqa: F401
from neuronx_distributed_tpu_torch.utils.profiler import profile_steps, step_annotation  # noqa: F401
from neuronx_distributed_tpu_torch.utils.timeline import EventScope, Timeline  # noqa: F401


def divide(numerator: int, denominator: int) -> int:
    """Exact division, or ``ValueError`` when ``denominator`` does not
    divide ``numerator``."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")
    return numerator // denominator


def pad_to_multiple(value: int, multiple: int) -> int:
    """The smallest multiple of ``multiple`` that is at least ``value``."""
    return ((value + multiple - 1) // multiple) * multiple


def process_rank() -> int:
    """This rank's place in its world: the parallel state's rank (a thread
    rank has one of its own), else the live ``torch.distributed`` group's,
    else 0."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import mesh

    if mesh.model_parallel_is_initialized():
        return mesh.get_state().rank
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
