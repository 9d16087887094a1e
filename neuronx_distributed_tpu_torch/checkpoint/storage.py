"""Checkpoint storage: the control plane a checkpoint or a conversation
park keeps on storage (directories, marker files, listing, deletes, raw
payload reads). The port's own copy of the filesystem half of
``neuronx_distributed_tpu/checkpoint/storage.py`` (stdlib only):
``BaseCheckpointStorage``, ``FilesysCheckpointStorage`` (every write a
temporary file and an atomic rename), ``_retry`` with its
``NXD_STORAGE_RETRIES`` / ``NXD_STORAGE_RETRY_BASE_S`` knobs, and
``create_checkpoint_storage``.

The object-store backend of the JAX package rides ``tensorstore``, which the
port does not depend on: an object-store URL raises ``ValueError`` (ROADMAP
A9, checkpoints) rather than landing on the local filesystem.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import time
from typing import Callable, List, Optional

logger = logging.getLogger("nxd")

# retry policy defaults, overridable per storage instance (ctor args) or
# process-wide via env: NXD_STORAGE_RETRIES / NXD_STORAGE_RETRY_BASE_S
_DEFAULT_RETRIES = 3
_DEFAULT_BASE_DELAY = 0.5


class BaseCheckpointStorage:
    def __init__(self, dirname: str):
        self.dirname = dirname

    # --- control-plane ops used by the checkpoint core ---
    def dir_exists(self, path: str) -> bool:
        raise NotImplementedError

    def file_exists(self, path: str) -> bool:
        raise NotImplementedError

    def save_text(self, text: str, path: str) -> None:
        raise NotImplementedError

    def save_bytes(self, data: bytes, path: str) -> None:
        raise NotImplementedError

    def load_text(self, path: str) -> str:
        raise NotImplementedError

    def list_dirs(self, path: str = "") -> List[str]:
        raise NotImplementedError

    def remove_dir(self, path: str) -> None:
        raise NotImplementedError

    def remove_file(self, path: str) -> None:
        raise NotImplementedError

    def makedirs(self, path: str = "") -> None:
        raise NotImplementedError

    # integrity-manifest surface: recursive file listing + raw payload
    # reads, so the checkpoint core can checksum every shard the writer
    # produced and verify them on load
    def list_files(self, path: str = "") -> List[str]:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def abspath(self, path: str = "") -> str:
        return os.path.join(self.dirname, path) if path else self.dirname


class FilesysCheckpointStorage(BaseCheckpointStorage):
    """Local / NFS / FUSE-mounted filesystem storage."""

    def dir_exists(self, path: str) -> bool:
        return os.path.isdir(self.abspath(path))

    def file_exists(self, path: str) -> bool:
        return os.path.isfile(self.abspath(path))

    def save_text(self, text: str, path: str) -> None:
        p = self.abspath(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, p)  # atomic marker write

    def save_bytes(self, data: bytes, path: str) -> None:
        p = self.abspath(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)  # atomic payload write

    def load_text(self, path: str) -> str:
        with open(self.abspath(path)) as f:
            return f.read()

    def list_dirs(self, path: str = "") -> List[str]:
        p = self.abspath(path)
        if not os.path.isdir(p):
            return []
        return sorted(d for d in os.listdir(p) if os.path.isdir(os.path.join(p, d)))

    def remove_dir(self, path: str) -> None:
        shutil.rmtree(self.abspath(path), ignore_errors=True)

    def remove_file(self, path: str) -> None:
        try:
            os.remove(self.abspath(path))
        except FileNotFoundError:
            pass

    def makedirs(self, path: str = "") -> None:
        os.makedirs(self.abspath(path), exist_ok=True)

    def list_files(self, path: str = "") -> List[str]:
        root = self.abspath(path)
        if not os.path.isdir(root):
            return []
        out = []
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                out.append(os.path.relpath(os.path.join(dirpath, f), root))
        return sorted(out)

    def read_bytes(self, path: str) -> bytes:
        with open(self.abspath(path), "rb") as f:
            return f.read()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _env_float(name: str) -> Optional[float]:
    v = os.environ.get(name)
    return float(v) if v else None


def _retry(fn: Callable, attempts: Optional[int] = None,
           base_delay: Optional[float] = None, jitter: float = 0.25):
    """Retry with exponential backoff + jitter (reference
    ``_list_with_retry``, checkpoint_storage.py:280 — same policy for every
    object-store op). Jitter desynchronizes the retry waves of a whole
    training fleet hitting one throttled bucket — without it every host
    re-fires at the same instant and re-triggers the throttle. Attempts and
    base delay resolve ctor-arg > env (``NXD_STORAGE_RETRIES`` /
    ``NXD_STORAGE_RETRY_BASE_S``) > default (3 / 0.5s)."""
    if attempts is None:
        attempts = _env_int("NXD_STORAGE_RETRIES") or _DEFAULT_RETRIES
    if base_delay is None:
        base_delay = _env_float("NXD_STORAGE_RETRY_BASE_S")
        if base_delay is None:
            base_delay = _DEFAULT_BASE_DELAY
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — storage errors vary by backend
            if i == attempts - 1:
                raise
            # nxdcheck: waive determinism -- retry backoff jitter is wall timing only (it spreads storage retries across hosts); it never feeds a scheduling decision or a replayed stream
            delay = base_delay * (2 ** i) * (1.0 + jitter * random.random())
            logger.warning("storage op failed (%s); retry %d/%d in %.2fs",
                           e, i + 1, attempts, delay)
            time.sleep(delay)


def create_checkpoint_storage(dirname: str) -> BaseCheckpointStorage:
    """The storage for ``dirname``: a filesystem path gets
    :class:`FilesysCheckpointStorage`; an object-store URL (``scheme://``)
    raises, since the port has no object-store backend yet (ROADMAP A9)."""
    if "://" in dirname:
        raise ValueError(
            f"{dirname!r}: object-store checkpoint storage is not ported (it needs "
            f"tensorstore; ROADMAP A9, checkpoints) — pass a filesystem path")
    return FilesysCheckpointStorage(dirname)
