"""Logging: a named logger whose level comes from ``NXD_LOG_LEVEL``
(``off|error|warning|info|debug|trace``, default ``info``) and whose format
drops timestamps under ``NXD_LOG_HIDE_TIME``. By default only rank 0 of a
live ``torch.distributed`` group emits (every process emits when no group
is initialized); ``rank0_only=False`` logs on every rank. The port's own
copy of ``neuronx_distributed_tpu/utils/logger.py``.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict

_LEVELS: Dict[str, int] = {
    "off": logging.CRITICAL + 10,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG - 5,
}

_configured: Dict[str, logging.Logger] = {}


def get_log_level() -> int:
    """The level ``NXD_LOG_LEVEL`` names; an unknown name raises."""
    name = os.environ.get("NXD_LOG_LEVEL", "info").strip().lower()
    if name not in _LEVELS:
        raise ValueError(f"NXD_LOG_LEVEL must be one of {sorted(_LEVELS)}, got {name!r}")
    return _LEVELS[name]


class _Rank0Filter(logging.Filter):
    """Pass records on rank 0 only; the rank is read per record, so the
    filter holds before and after the group is initialized."""

    def filter(self, record: logging.LogRecord) -> bool:
        from neuronx_distributed_tpu_torch.utils import process_rank

        return process_rank() == 0


def get_logger(name: str = "nxd", rank0_only: bool = True) -> logging.Logger:
    """One logger per ``(name, rank0_only)``, configured on first use."""
    key = f"{name}:{rank0_only}"
    if key in _configured:
        return _configured[key]
    logger = logging.getLogger(name if rank0_only else f"{name}.allranks")
    logger.setLevel(get_log_level())
    logger.propagate = False
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        fmt = "%(name)s [%(levelname)s] %(message)s"
        if not os.environ.get("NXD_LOG_HIDE_TIME"):
            fmt = "%(asctime)s " + fmt
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
    if rank0_only:
        logger.addFilter(_Rank0Filter())
    _configured[key] = logger
    return logger
