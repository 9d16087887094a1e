"""Tagged, crash-safe, async checkpoints, over one rank or many.

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
* ``async_save=True`` copies every tensor this rank writes to host memory
  before :func:`save_checkpoint` returns (the train step updates its tensors
  in place right after), and the rank's writer thread writes; every save,
  sync or async, runs on that thread, so cleanup and retention never race a
  pending save. :func:`finalize_checkpoint` waits for them, and runs at
  exit.

Many ranks (JAX ``:276-330``): the world, the rank and a store every rank
reaches come from the parallel state (``parallel/mesh.py``; a
``torch.distributed`` group of more than one rank without it is refused).
Rank 0 alone does the cleanup, the markers, the manifest and retention.
The ranks agree through the store, never through a collective (a writer
thread must not issue one while the training thread runs its own): no rank
writes its payload before rank 0 has dropped a stale ``done`` and cleared
the payload, ``done`` appears only after every rank's write has landed,
and a rank that failed leaves the tag interrupted. Each save returns (or
finalizes) only after every rank saw it published.

Pieces: each tensor leaf is stored once in its global layout. A state may
carry a ``layout`` (``TrainState.layout``: leaf path -> :class:`Piece`,
the global shape, where the rank's block starts and whether this rank
writes it, so a tensor-parallel shard is written by its data-parallel rank
0 and a ZeRO-1 state shard by its own rank); a leaf without one is
replicated and written by rank 0. Rank ``r`` writes
``state/tensors.safetensors`` (rank 0) or ``state/tensors.rank{r}.safetensors``
with its blocks, and ``state/index[.rank{r}].json`` with each block's global
shape, offset and shape; rank 0 adds ``state/tree.json``, the structure and
the non-tensor leaves (numbers, strings, None). Under pipeline parallelism
a leaf lives on one stage (under its global name: a layer by its global
index, the VPP order undone), so each later stage's first rank adds its
own structure, ``state/tree.rank{r}.json``, and a load merges them. :func:`load_checkpoint`
assembles any block from the pieces that cover it, so a tag saved at one
layout loads at another: ``target``'s layout (or, without one, the whole
global tensors) decides. A ``torch.Generator`` leaf is saved as its state
and restored into a generator on the target's device. The payload differs
from the JAX package's (orbax there, which this port does not use): the
two packages' files are not interchangeable.

A state is a tree of dicts, lists, tuples, named tuples and dataclasses
(``TrainState``) over tensors, numpy arrays, generators and scalars.
:func:`load_checkpoint` with ``target`` gives a tree of the target's
structure, each tensor on its target's device in its dtype; without one,
nested dicts and lists of CPU tensors, each leaf global.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import hashlib
import json
import logging
import math
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
    SafetensorsReader,
    save_safetensors,
)

logger = logging.getLogger("nxd")

_CHECKPOINT_MARKER = "checkpoint"   # save started
_DONE_MARKER = "done"               # save completed (its sequence number)
_USER_CONTENT = "user_content.json"
_PAYLOAD_DIR = "state"
_MANIFEST = "manifest.json"         # payload checksums, written before done
_TREE = "tree.json"
# how long a rank waits for its peers at one step of the protocol
AGREE_TIMEOUT = datetime.timedelta(seconds=600)


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint's payload does not match its integrity manifest (or the
    manifest is missing under ``verify=True``)."""


@dataclasses.dataclass(frozen=True)
class Piece:
    """A rank's block of one leaf: the leaf's global shape, where the block
    starts in it (the block's shape is the rank's tensor's), and whether
    this rank writes it (one writer a block)."""

    global_shape: Tuple[int, ...]
    offset: Tuple[int, ...]
    owner: bool


def _tensor_name(rank: int) -> str:
    return "tensors.safetensors" if rank == 0 else f"tensors.rank{rank:05d}.safetensors"


def _index_name(rank: int) -> str:
    return "index.json" if rank == 0 else f"index.rank{rank:05d}.json"


def _tree_name(rank: int) -> str:
    return _TREE if rank == 0 else f"tree.rank{rank:05d}.json"


def _merge_skeleton(a: dict, b: dict) -> dict:
    """The union of two stages' structures (``a``'s order first)."""
    if "dict" in a and "dict" in b:
        keys = dict(a["dict"])
        for k, v in b["dict"]:
            keys[k] = _merge_skeleton(keys[k], v) if k in keys else v
        return {"dict": list(keys.items())}
    return a


# --------------------------------------------------------------- the tree

def _skipped(f) -> bool:
    # a dataclass field that describes the state rather than holding it
    return f.metadata.get("checkpoint") is False


def _flatten(tree, path: str, out: List[Tuple[str, Any]]):
    """The skeleton of ``tree`` (JSON), collecting ``(path, leaf)`` in
    ``out``; paths are JAX-style key strings."""
    if isinstance(tree, dict):
        return {"dict": [[k, _flatten(v, f"{path}['{k}']", out)] for k, v in tree.items()]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"dict": [[f, _flatten(getattr(tree, f), f"{path}.{f}", out)]
                         for f in tree._fields]}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {"dict": [[f.name, _flatten(None if _skipped(f) else getattr(tree, f.name),
                                           f"{path}.{f.name}", out)]
                         for f in dataclasses.fields(tree)]}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, f"{path}[{i}]", out) for i, v in enumerate(tree)]}
    out.append((path, tree))
    return {"leaf": path}


def _rebuild(skeleton, leaves):
    if "leaf" in skeleton:
        return leaves(skeleton["leaf"])
    if "dict" in skeleton:
        return {k: _rebuild(v, leaves) for k, v in skeleton["dict"]}
    return [_rebuild(v, leaves) for v in skeleton["list"]]


def _restore_into(target, path: str, reader: "_PieceReader", layout: Dict[str, Piece]):
    """A tree of ``target``'s structure with the saved leaves, each tensor
    the block of ``target``'s layout (or the whole leaf), cast to its
    target's dtype on its target's device."""
    if isinstance(target, dict):
        return {k: _restore_into(v, f"{path}['{k}']", reader, layout) for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_restore_into(getattr(target, f), f"{path}.{f}", reader, layout)
                              for f in target._fields))
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _restore_into(getattr(target, f.name), f"{path}.{f.name}", reader, layout)
            for f in dataclasses.fields(target) if f.init and not _skipped(f)})
    if isinstance(target, (list, tuple)):
        return type(target)(_restore_into(v, f"{path}[{i}]", reader, layout)
                            for i, v in enumerate(target))
    if not reader.has(path):
        raise KeyError(f"the checkpoint has no leaf {path!r}")
    if isinstance(target, torch.Generator):
        g = torch.Generator(device=target.device)
        g.set_state(reader.leaf(path))
        return g
    if isinstance(target, torch.Tensor):
        piece = layout.get(path)
        if piece is not None:
            got = reader.leaf(path, tuple(piece.offset), tuple(target.shape),
                              tuple(piece.global_shape))
        else:
            got = reader.leaf(path)
            if tuple(got.shape) != tuple(target.shape):
                raise ValueError(f"{path}: saved {tuple(got.shape)}, target "
                                 f"{tuple(target.shape)}")
        return got.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return reader.leaf(path).numpy().astype(target.dtype)
    return reader.leaf(path)


def _snapshot(state, rank: int):
    """Host copies of every tensor leaf this rank writes (made now), their
    index entries, the skeleton and the JSON leaves."""
    leaves: List[Tuple[str, Any]] = []
    skeleton = _flatten(state, "", leaves)
    layout = getattr(state, "layout", None) or {}
    tensors, index, scalars = {}, {}, {}
    for path, leaf in leaves:
        if isinstance(leaf, torch.Generator):
            t = leaf.get_state()
            scalars[path] = {"generator": True}
        elif isinstance(leaf, torch.Tensor):
            t = leaf.detach()
        elif isinstance(leaf, np.ndarray):
            t = torch.from_numpy(np.array(leaf, order="C"))
        elif leaf is None or isinstance(leaf, (bool, int, float, str)):
            scalars[path] = {"value": leaf}
            continue
        else:
            raise TypeError(f"checkpoint leaf {path!r} is a {type(leaf).__name__}: tensors, "
                            f"arrays, generators and scalars only")
        piece = layout.get(path)
        if piece is None:
            piece = Piece(tuple(t.shape), (0,) * t.dim(), rank == 0)
        if piece.owner:
            tensors[path] = t.to("cpu", copy=True)
            index[path] = {"global_shape": list(piece.global_shape),
                           "offset": list(piece.offset), "shape": list(t.shape)}
    return skeleton, tensors, index, scalars


class _PieceReader:
    """The saved pieces of a tag: assembles any block of a leaf from the
    pieces that cover it, reading each piece once."""

    def __init__(self, storage: BaseCheckpointStorage, root: str, files: List[str]):
        self.pieces: Dict[str, list] = {}
        self.scalars: Dict[str, Any] = {}
        self.files: Dict[str, SafetensorsReader] = {}
        self.cache: Dict[Tuple[str, str], torch.Tensor] = {}
        indexes = [f for f in files if f.startswith("index") and f.endswith(".json")]
        for rel in indexes:
            tensors = rel.replace("index", "tensors", 1).replace(".json", ".safetensors")
            for path, e in json.loads(storage.load_text(f"{root}/{rel}")).items():
                self.pieces.setdefault(path, []).append(
                    (tensors, tuple(e["offset"]), tuple(e["shape"]), tuple(e["global_shape"])))
        for rel in files:
            if rel.startswith("tensors") and rel.endswith(".safetensors"):
                self.files[rel] = SafetensorsReader(storage.abspath(f"{root}/{rel}"))
        if not indexes:   # a payload written before pieces: every tensor whole
            for rel, r in self.files.items():
                for k in r.keys():
                    shape = tuple(r.header[k]["shape"])
                    self.pieces.setdefault(k, []).append((rel, (0,) * len(shape), shape, shape))

    def has(self, path: str) -> bool:
        return path in self.pieces or path in self.scalars

    def _piece(self, rel: str, path: str) -> torch.Tensor:
        key = (rel, path)
        if key not in self.cache:
            self.cache[key] = self.files[rel].get(path)
        return self.cache[key]

    def leaf(self, path: str, offset=None, shape=None, global_shape=None):
        if path in self.scalars:
            return self.scalars[path]
        pieces = self.pieces[path]
        saved_global = pieces[0][3]
        if global_shape is not None and tuple(global_shape) != saved_global:
            raise ValueError(f"{path}: saved global shape {saved_global}, target "
                             f"{tuple(global_shape)}")
        if offset is None:
            offset, shape = (0,) * len(saved_global), saved_global
        out, covered = None, 0
        for rel, off, shp, _ in pieces:
            lo = [max(a, b) for a, b in zip(offset, off)]
            hi = [min(a + n, b + m) for a, n, b, m in zip(offset, shape, off, shp)]
            if any(x >= y for x, y in zip(lo, hi)):
                continue
            src = self._piece(rel, path)
            if out is None:
                out = torch.empty(shape, dtype=src.dtype)
            out[tuple(slice(x - a, y - a) for x, y, a in zip(lo, hi, offset))] = \
                src[tuple(slice(x - b, y - b) for x, y, b in zip(lo, hi, off))]
            covered += math.prod(y - x for x, y in zip(lo, hi))
        if out is None and math.prod(shape) == 0:
            out = self._piece(pieces[0][0], path).new_empty(shape)
        if covered != math.prod(shape):
            raise ValueError(f"{path}: the saved pieces cover {covered} of the "
                             f"{math.prod(shape)} elements at offset {tuple(offset)}")
        return out


# ---------------------------------------------------------- integrity

def _payload_manifest(storage: BaseCheckpointStorage, tag: str) -> dict:
    """sha256 and size of every payload file the ranks produced."""
    root = f"{tag}/{_PAYLOAD_DIR}"
    files = {}
    for rel in storage.list_files(root):
        data = storage.read_bytes(f"{root}/{rel}")
        files[rel] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
    return {"version": 1, "algo": "sha256", "files": files}


def verify_checkpoint(storage: BaseCheckpointStorage, tag: str) -> None:
    """Recompute the payload checksums (every rank's files) against the
    manifest; raise :class:`CheckpointIntegrityError` naming the first
    missing, corrupted or unmanifested file."""
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


# ------------------------------------------------------- the world, the writer

@dataclasses.dataclass
class _World:
    rank: int
    size: int
    store: Any
    # writes a structure file: rank 0, and each later pipeline stage's first rank
    stage_lead: bool = False


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _world() -> _World:
    """This rank's world, from the parallel state (the thread-rank launch
    has no default group: every thread reads its own)."""
    from neuronx_distributed_tpu_torch.parallel import mesh

    if mesh.model_parallel_is_initialized():
        st = mesh.get_state()
        if st.world_size > 1 and st.store is None:
            raise RuntimeError("the parallel state has no store to agree through")
        lead = all(i == 0 for axis, i in st.coords().items() if axis != mesh.PP_AXIS)
        return _World(st.rank, st.world_size, st.store, lead)
    if _world_size() > 1:
        raise NotImplementedError(
            "a checkpoint under a torch.distributed group of more than one rank needs the "
            "parallel state: call initialize_model_parallel() first (the protocol reads its "
            "ranks and its store from it)")
    return _World(0, 1, None)


def _agree(world: _World, key: str, ok: bool) -> bool:
    """Every rank's verdict on one step of a save, through the store: True
    when all were ok. A single rank agrees with itself."""
    if world.size == 1:
        return ok
    world.store.set(f"{key}/{world.rank}", "1" if ok else "0")
    keys = [f"{key}/{r}" for r in range(world.size)]
    world.store.wait(keys, AGREE_TIMEOUT)
    return all(world.store.get(k) == b"1" for k in keys)


class _Writer:
    """A training thread's writer: one worker thread and its pending saves."""

    def __init__(self, rank: int):
        self.executor = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix=f"nxd-ckpt-r{rank}")
        self.pending: list = []


_writers: Dict[Tuple[int, int], _Writer] = {}
_lock = threading.Lock()
# the last save's wall seconds on the writer thread, by part: "write"
# (payload), "publish" (manifest, done, retention)
last_save_seconds: Dict[str, float] = {}


def _writer(rank: int) -> _Writer:
    key = (threading.get_ident(), rank)
    with _lock:
        if not _writers:
            atexit.register(_finalize_all)
        if key not in _writers:
            _writers[key] = _Writer(rank)
        return _writers[key]


def _drain(w: _Writer) -> None:
    with _lock:
        pending, w.pending[:] = w.pending[:], []
    for fut in pending:
        fut.result()


def finalize_checkpoint() -> None:
    """Block until every pending save of this thread is complete (and, with
    many ranks, published to every rank); a failed save raises here."""
    me = threading.get_ident()
    for (ident, _), w in list(_writers.items()):
        if ident == me:
            _drain(w)


def _finalize_all() -> None:
    for w in list(_writers.values()):
        _drain(w)


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


def save_checkpoint(checkpoint_dir: str, tag: str, state: Any,
                    user_content: Optional[dict] = None, async_save: bool = False,
                    num_kept: Optional[int] = None) -> None:
    """Save ``state`` under ``{checkpoint_dir}/{tag}``; with many ranks every
    rank calls this with its own state, in the same order. Every tensor this
    rank writes is copied to host memory before this returns; with
    ``async_save`` the files are written on the rank's writer thread
    afterwards (a failure raises at :func:`finalize_checkpoint`), otherwise
    before it returns."""
    world = _world()
    storage = create_checkpoint_storage(checkpoint_dir)
    skeleton, tensors, index, scalars = _snapshot(state, world.rank)
    w = _writer(world.rank)
    # every rank issues its saves in the same order: its own count names
    # the save's keys in the store
    key = (f"ckpt/{world.store.add(f'ckpt/count/{world.rank}', 1)}" if world.size > 1
           else "ckpt")
    lead = world.rank == 0
    payload = f"{tag}/{_PAYLOAD_DIR}"

    def begin():
        err: Optional[Exception] = None
        if lead:
            try:
                storage.makedirs()
                started, done = _tags_with_state(storage)
                for t in started:
                    if t not in done and t != tag:
                        logger.warning("removing interrupted checkpoint %r", t)
                        storage.remove_dir(t)
                storage.makedirs(tag)
                storage.save_text("", f"{tag}/{_CHECKPOINT_MARKER}")
                # re-saving a tag: its old completion goes first, so a crash in
                # the overwrite never leaves a half-written payload marked done
                storage.remove_file(f"{tag}/{_DONE_MARKER}")
                storage.remove_dir(payload)
                storage.makedirs(payload)
            except Exception as e:  # noqa: BLE001 - every rank must still agree
                err = e
        if not _agree(world, f"{key}/begin", err is None):
            raise RuntimeError(f"checkpoint {tag!r}: control-plane begin failed") from err

    def write():
        begin()
        t0 = time.perf_counter()
        err: Optional[Exception] = None
        try:
            storage.makedirs(payload)
            if tensors or lead:
                save_safetensors(tensors, storage.abspath(f"{payload}/{_tensor_name(world.rank)}"))
                storage.save_text(json.dumps(index), f"{payload}/{_index_name(world.rank)}")
            if lead or world.stage_lead:
                storage.save_text(json.dumps({"skeleton": skeleton, "scalars": scalars}),
                                  f"{payload}/{_tree_name(world.rank)}")
        except Exception as e:  # noqa: BLE001 - every rank must still agree
            err = e
        # every rank's pieces durable before the completion marker; a rank
        # that failed leaves the tag interrupted
        if not _agree(world, f"{key}/end", err is None):
            raise RuntimeError(f"checkpoint {tag!r}: payload write failed") from err
        t1 = time.perf_counter()
        pub_err: Optional[Exception] = None
        if lead:
            try:
                seq = 1 + max([0] + [int(_done_seq(storage, t))
                                     for t in _tags_with_state(storage)[1]])
                if user_content is not None:
                    storage.save_text(json.dumps(user_content), f"{tag}/{_USER_CONTENT}")
                storage.save_text(json.dumps(_payload_manifest(storage, tag)),
                                  f"{tag}/{_MANIFEST}")
                storage.save_text(str(seq), f"{tag}/{_DONE_MARKER}")
            except Exception as e:  # noqa: BLE001 - every rank must still agree
                pub_err = e
            if pub_err is None and num_kept is not None and num_kept > 0:
                try:
                    order = sorted(_tags_with_state(storage)[1],
                                   key=lambda t: _done_seq(storage, t))
                    for old in order[:-num_kept]:
                        storage.remove_file(f"{old}/{_DONE_MARKER}")
                        storage.remove_dir(old)
                except OSError:
                    logger.warning("checkpoint retention cleanup failed for %r; continuing (the "
                                   "save is complete)", tag, exc_info=True)
        # every rank sees the published tag before its save returns
        if not _agree(world, f"{key}/published", pub_err is None):
            raise RuntimeError(f"checkpoint {tag!r}: completion publish failed") from pub_err
        last_save_seconds.update(write=t1 - t0, publish=time.perf_counter() - t1)

    fut = w.executor.submit(write)
    with _lock:
        w.pending.append(fut)
    if not async_save:
        try:
            fut.result()
        finally:
            with _lock:
                if fut in w.pending:
                    w.pending.remove(fut)


def load_checkpoint(checkpoint_dir: str, tag: Optional[str] = None, target: Any = None,
                    verify: bool = False) -> Tuple[Any, Optional[dict]]:
    """Load ``tag`` (default: the newest completed one) after any pending
    save; returns ``(state, user_content)``. With ``target`` each tensor is
    the block the target's ``layout`` names (or the whole leaf), whatever
    layout the tag was saved at. ``verify=True`` checks every payload file,
    every rank's, against the manifest first."""
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
    files = storage.list_files(root)
    tree = json.loads(storage.load_text(f"{root}/{_TREE}"))
    for rel in sorted(f for f in files if f.startswith("tree.rank") and f.endswith(".json")):
        stage = json.loads(storage.load_text(f"{root}/{rel}"))
        tree["skeleton"] = _merge_skeleton(tree["skeleton"], stage["skeleton"])
        tree["scalars"] = {**stage["scalars"], **tree["scalars"]}
    reader = _PieceReader(storage, root, files)
    reader.scalars = {p: s["value"] for p, s in tree["scalars"].items() if "value" in s}
    if target is not None:
        state = _restore_into(target, "", reader, getattr(target, "layout", None) or {})
    else:
        state = _rebuild(tree["skeleton"], reader.leaf)
    user_content = None
    if storage.file_exists(f"{tag}/{_USER_CONTENT}"):
        user_content = json.loads(storage.load_text(f"{tag}/{_USER_CONTENT}"))
    return state, user_content
