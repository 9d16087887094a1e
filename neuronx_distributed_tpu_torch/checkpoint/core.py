"""Tagged, crash-safe, async checkpoints.

Counterpart of ``neuronx_distributed_tpu/checkpoint/core.py``, with its
protocol kept exactly:

* a ``checkpoint`` marker is written when a save begins and a ``done``
  marker (the completion sequence number, one more than the largest done so
  far) only after the payload, ``user_content.json`` and the integrity
  manifest are written; resume takes the done tag with the largest number;
* a save first removes every interrupted tag (a marker without ``done``)
  other than its own, and re-saving a tag removes its old ``done`` first;
* retention keeps the newest ``num_kept`` done tags, and a delete removes
  ``done`` before the directory, so an interrupted delete never reads as a
  complete checkpoint; a failed retention never fails the save;
* ``manifest.json`` holds the sha256 and size of every payload file:
  ``load_checkpoint(verify=True)`` raises :class:`CheckpointIntegrityError`
  on a flipped byte, a missing, truncated or extra file;
* ``async_save=True`` copies every tensor to host memory before
  :func:`save_checkpoint` returns (the train step updates its tensors in
  place right after), and one writer thread writes; every save, sync or
  async, runs on that thread, so cleanup and retention never race a
  pending save. :func:`finalize_checkpoint` waits for them, and runs at
  exit.

The payload differs from the JAX package's (orbax there, which this port
does not use): ``state/tensors.safetensors`` holds every tensor leaf by its
path (``checkpoint/tensor_file.py``) and ``state/tree.json`` the structure
and the non-tensor leaves (numbers, strings, None). A ``torch.Generator``
leaf is saved as its state and restored into a generator on the target's
device. The two packages' files are not interchangeable.

A state is a tree of dicts, lists, tuples, named tuples and dataclasses
(``TrainState``) over tensors, numpy arrays, generators and scalars.
:func:`load_checkpoint` with ``target`` gives a tree of the target's
structure, each tensor on its target's device in its dtype; without one,
nested dicts and lists of CPU tensors.

One rank: the multi-rank protocol (rank 0 owning the control plane,
barriers over the group) comes with the data- and tensor-parallel training
slice, and :func:`save_checkpoint` under a live group of more than one rank
raises ``NotImplementedError``.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.checkpoint.storage import (
    BaseCheckpointStorage,
    create_checkpoint_storage,
)
from neuronx_distributed_tpu_torch.checkpoint.tensor_file import (
    load_safetensors,
    save_safetensors,
)

logger = logging.getLogger("nxd")

_CHECKPOINT_MARKER = "checkpoint"   # save started
_DONE_MARKER = "done"               # save completed (its sequence number)
_USER_CONTENT = "user_content.json"
_PAYLOAD_DIR = "state"
_MANIFEST = "manifest.json"         # payload checksums, written before done
_TENSORS = "tensors.safetensors"
_TREE = "tree.json"


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint's payload does not match its integrity manifest (or the
    manifest is missing under ``verify=True``)."""


# --------------------------------------------------------------- the tree

def _flatten(tree, path: str, out: List[Tuple[str, Any]]):
    """The skeleton of ``tree`` (JSON), collecting ``(path, leaf)`` in
    ``out``; paths are JAX-style key strings."""
    if isinstance(tree, dict):
        return {"dict": [[k, _flatten(v, f"{path}['{k}']", out)] for k, v in tree.items()]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"dict": [[f, _flatten(getattr(tree, f), f"{path}.{f}", out)]
                         for f in tree._fields]}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {"dict": [[f.name, _flatten(getattr(tree, f.name), f"{path}.{f.name}", out)]
                         for f in dataclasses.fields(tree)]}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, f"{path}[{i}]", out) for i, v in enumerate(tree)]}
    out.append((path, tree))
    return {"leaf": path}


def _rebuild(skeleton, leaves: Dict[str, Any]):
    if "leaf" in skeleton:
        return leaves[skeleton["leaf"]]
    if "dict" in skeleton:
        return {k: _rebuild(v, leaves) for k, v in skeleton["dict"]}
    return [_rebuild(v, leaves) for v in skeleton["list"]]


def _restore_into(target, path: str, leaves: Dict[str, Any]):
    """A tree of ``target``'s structure with the saved leaves, each tensor
    cast to its target's dtype on its target's device."""
    if isinstance(target, dict):
        return {k: _restore_into(v, f"{path}['{k}']", leaves) for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_restore_into(getattr(target, f), f"{path}.{f}", leaves)
                              for f in target._fields))
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _restore_into(getattr(target, f.name), f"{path}.{f.name}", leaves)
            for f in dataclasses.fields(target) if f.init})
    if isinstance(target, (list, tuple)):
        return type(target)(_restore_into(v, f"{path}[{i}]", leaves)
                            for i, v in enumerate(target))
    if path not in leaves:
        raise KeyError(f"the checkpoint has no leaf {path!r}")
    got = leaves[path]
    if isinstance(target, torch.Generator):
        g = torch.Generator(device=target.device)
        g.set_state(got)
        return g
    if isinstance(target, torch.Tensor):
        if tuple(got.shape) != tuple(target.shape):
            raise ValueError(f"{path}: saved {tuple(got.shape)}, target {tuple(target.shape)}")
        return got.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return got.numpy().astype(target.dtype)
    return got


def _snapshot(state) -> Tuple[dict, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Host copies of every tensor leaf (made now), the skeleton and the
    JSON leaves."""
    leaves: List[Tuple[str, Any]] = []
    skeleton = _flatten(state, "", leaves)
    tensors, scalars = {}, {}
    for path, leaf in leaves:
        if isinstance(leaf, torch.Generator):
            tensors[path] = leaf.get_state().clone()
            scalars[path] = {"generator": True}
        elif isinstance(leaf, torch.Tensor):
            tensors[path] = leaf.detach().to("cpu", copy=True)
        elif isinstance(leaf, np.ndarray):
            tensors[path] = torch.from_numpy(np.array(leaf, order="C"))
        elif leaf is None or isinstance(leaf, (bool, int, float, str)):
            scalars[path] = {"value": leaf}
        else:
            raise TypeError(f"checkpoint leaf {path!r} is a {type(leaf).__name__}: tensors, "
                            f"arrays, generators and scalars only")
    return skeleton, tensors, scalars


# ---------------------------------------------------------- integrity

def _payload_manifest(storage: BaseCheckpointStorage, tag: str) -> dict:
    """sha256 and size of every payload file the writer produced."""
    root = f"{tag}/{_PAYLOAD_DIR}"
    files = {}
    for rel in storage.list_files(root):
        data = storage.read_bytes(f"{root}/{rel}")
        files[rel] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
    return {"version": 1, "algo": "sha256", "files": files}


def verify_checkpoint(storage: BaseCheckpointStorage, tag: str) -> None:
    """Recompute the payload checksums against the manifest; raise
    :class:`CheckpointIntegrityError` naming the first missing, corrupted or
    unmanifested file."""
    if not storage.file_exists(f"{tag}/{_MANIFEST}"):
        raise CheckpointIntegrityError(
            f"checkpoint {tag!r} has no integrity manifest ({_MANIFEST}); re-save or load "
            f"with verify=False")
    expected = json.loads(storage.load_text(f"{tag}/{_MANIFEST}")).get("files", {})
    root = f"{tag}/{_PAYLOAD_DIR}"
    present = set(storage.list_files(root))
    for rel in sorted(expected):
        if rel not in present:
            raise CheckpointIntegrityError(f"checkpoint {tag!r}: payload file {rel!r} is missing")
        data = storage.read_bytes(f"{root}/{rel}")
        got = hashlib.sha256(data).hexdigest()
        if got != expected[rel]["sha256"] or len(data) != expected[rel]["bytes"]:
            raise CheckpointIntegrityError(
                f"checkpoint {tag!r}: payload file {rel!r} is corrupted (sha256 {got[:12]}… != "
                f"manifest {expected[rel]['sha256'][:12]}…, {len(data)} vs "
                f"{expected[rel]['bytes']} bytes)")
    extra = present - set(expected)
    if extra:
        raise CheckpointIntegrityError(
            f"checkpoint {tag!r}: unmanifested payload files {sorted(extra)[:4]}")


# ------------------------------------------------------------ the writer

_executor: Optional[ThreadPoolExecutor] = None
_pending: list = []
_lock = threading.Lock()
# the last save's wall seconds on the writer thread, by part: "write"
# (payload), "publish" (manifest, done, retention)
last_save_seconds: Dict[str, float] = {}


def _get_executor() -> ThreadPoolExecutor:
    global _executor
    if _executor is None:
        _executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="nxd-ckpt")
        atexit.register(finalize_checkpoint)
    return _executor


def finalize_checkpoint() -> None:
    """Block until every pending save is complete; a failed save raises
    here."""
    with _lock:
        pending, _pending[:] = _pending[:], []
    for fut in pending:
        fut.result()


def _tags_with_state(storage: BaseCheckpointStorage):
    started = [t for t in storage.list_dirs() if storage.file_exists(f"{t}/{_CHECKPOINT_MARKER}")]
    done = [t for t in started if storage.file_exists(f"{t}/{_DONE_MARKER}")]
    return started, done


def _done_seq(storage: BaseCheckpointStorage, tag: str) -> float:
    try:
        return float(storage.load_text(f"{tag}/{_DONE_MARKER}"))
    except (OSError, ValueError):
        return -1.0


def _newest(storage: BaseCheckpointStorage, tags) -> Optional[str]:
    return max(tags, key=lambda t: _done_seq(storage, t)) if tags else None


def has_checkpoint(checkpoint_dir: str) -> bool:
    """Whether any completed tag is present."""
    return bool(_tags_with_state(create_checkpoint_storage(checkpoint_dir))[1])


def latest_tag(checkpoint_dir: str) -> Optional[str]:
    """The newest completed tag (None when there is none)."""
    storage = create_checkpoint_storage(checkpoint_dir)
    return _newest(storage, _tags_with_state(storage)[1])


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def save_checkpoint(checkpoint_dir: str, tag: str, state: Any,
                    user_content: Optional[dict] = None, async_save: bool = False,
                    num_kept: Optional[int] = None) -> None:
    """Save ``state`` under ``{checkpoint_dir}/{tag}``. Every tensor is
    copied to host memory before this returns; with ``async_save`` the
    files are written on the writer thread afterwards (a failure raises at
    :func:`finalize_checkpoint`), otherwise before it returns."""
    if _world_size() > 1:
        raise NotImplementedError(
            "save_checkpoint under a torch.distributed group of more than one rank: the "
            "multi-rank protocol (rank 0 owns the markers, barriers fence the payload) comes "
            "with the data- and tensor-parallel training slice (ROADMAP queue A)")
    storage = create_checkpoint_storage(checkpoint_dir)
    skeleton, tensors, scalars = _snapshot(state)

    def write():
        storage.makedirs()
        started, done = _tags_with_state(storage)
        for t in started:
            if t not in done and t != tag:
                logger.warning("removing interrupted checkpoint %r", t)
                storage.remove_dir(t)
        storage.makedirs(tag)
        storage.save_text("", f"{tag}/{_CHECKPOINT_MARKER}")
        # re-saving a tag: its old completion goes first, so a crash in the
        # overwrite never leaves a half-written payload marked done
        storage.remove_file(f"{tag}/{_DONE_MARKER}")
        t0 = time.perf_counter()
        storage.remove_dir(f"{tag}/{_PAYLOAD_DIR}")
        storage.makedirs(f"{tag}/{_PAYLOAD_DIR}")
        save_safetensors(tensors, storage.abspath(f"{tag}/{_PAYLOAD_DIR}/{_TENSORS}"))
        storage.save_text(json.dumps({"skeleton": skeleton, "scalars": scalars}),
                          f"{tag}/{_PAYLOAD_DIR}/{_TREE}")
        t1 = time.perf_counter()
        seq = 1 + max([0] + [int(_done_seq(storage, t)) for t in _tags_with_state(storage)[1]])
        if user_content is not None:
            storage.save_text(json.dumps(user_content), f"{tag}/{_USER_CONTENT}")
        storage.save_text(json.dumps(_payload_manifest(storage, tag)), f"{tag}/{_MANIFEST}")
        storage.save_text(str(seq), f"{tag}/{_DONE_MARKER}")
        if num_kept is not None and num_kept > 0:
            try:
                order = sorted(_tags_with_state(storage)[1], key=lambda t: _done_seq(storage, t))
                for old in order[:-num_kept]:
                    storage.remove_file(f"{old}/{_DONE_MARKER}")
                    storage.remove_dir(old)
            except OSError:
                logger.warning("checkpoint retention cleanup failed for %r; continuing (the "
                               "save is complete)", tag, exc_info=True)
        last_save_seconds.update(write=t1 - t0, publish=time.perf_counter() - t1)

    fut = _get_executor().submit(write)
    with _lock:
        _pending.append(fut)
    if not async_save:
        try:
            fut.result()
        finally:
            with _lock:
                if fut in _pending:
                    _pending.remove(fut)


def load_checkpoint(checkpoint_dir: str, tag: Optional[str] = None, target: Any = None,
                    verify: bool = False) -> Tuple[Any, Optional[dict]]:
    """Load ``tag`` (default: the newest completed one) after any pending
    save; returns ``(state, user_content)``. ``verify=True`` checks every
    payload file against the manifest first."""
    finalize_checkpoint()
    storage = create_checkpoint_storage(checkpoint_dir)
    done = _tags_with_state(storage)[1]
    if tag is None:
        tag = _newest(storage, done)
        if tag is None:
            raise FileNotFoundError(f"no completed checkpoint under {checkpoint_dir}")
    elif tag not in done:
        raise FileNotFoundError(f"checkpoint tag {tag!r} not complete in {checkpoint_dir}")
    if verify:
        verify_checkpoint(storage, tag)
    root = f"{tag}/{_PAYLOAD_DIR}"
    tree = json.loads(storage.load_text(f"{root}/{_TREE}"))
    leaves: Dict[str, Any] = dict(load_safetensors(storage.abspath(f"{root}/{_TENSORS}")))
    for path, s in tree["scalars"].items():
        if "value" in s:
            leaves[path] = s["value"]
    if target is not None:
        state = _restore_into(target, "", leaves)
    else:
        state = _rebuild(tree["skeleton"], leaves)
    user_content = None
    if storage.file_exists(f"{tag}/{_USER_CONTENT}"):
        user_content = json.loads(storage.load_text(f"{tag}/{_USER_CONTENT}"))
    return state, user_content
