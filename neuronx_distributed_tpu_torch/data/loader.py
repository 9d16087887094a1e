"""Token-shard dataset: a native mmap reader with background prefetch.

The port's own copy of ``neuronx_distributed_tpu/data/loader.py``: the same
shard format (``write_token_shard`` writes the same bytes), the same C++
reader (``_native/tokenshard.cpp``: mmap'd shards, epoch shuffling, a
prefetch thread and a bounded queue, bound with ``ctypes``) and the same
numpy path, so both packages yield the same batches for the same shards,
seed and ``rank``/``world_size``. The reader is built with ``g++`` on first
use into the git-ignored ``build/native/`` at the repository root
(``kernels/_build.py``), never beside its source. ``native=None`` falls back
to the numpy path when it cannot be built; ``native=True`` raises instead.
Batches are numpy arrays: the training loop moves them to the device.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

_MAGIC = 0x4E58445348415244  # "NXDSHARD"
_HEADER = np.dtype([("magic", "<u8"), ("seq_len", "<u8"), ("num_seqs", "<u8")])


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write a (num_seqs, seq_len) int32 token array as a shard file."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    if tokens.ndim != 2:
        raise ValueError(f"tokens must be (num_seqs, seq_len), got {tokens.shape}")
    header = np.zeros((), _HEADER)
    header["magic"] = _MAGIC
    header["seq_len"] = tokens.shape[1]
    header["num_seqs"] = tokens.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(header.tobytes())
        fh.write(tokens.tobytes())


_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[Exception] = None


def _load_native() -> Optional[ctypes.CDLL]:
    """The C++ reader, built with ``g++`` into ``build/native/`` on first use
    and loaded; None when it cannot be built (the error is kept for
    ``native=True``, which raises it)."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    from neuronx_distributed_tpu_torch.kernels._build import native_library

    try:
        lib = ctypes.CDLL(str(native_library(Path(__file__).resolve().parent / "_native"
                                             / "tokenshard.cpp")))
    except (OSError, RuntimeError) as e:
        _lib_error = e
        return None
    lib.tsr_open.restype = ctypes.c_void_p
    lib.tsr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                             ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                             ctypes.c_uint64, ctypes.c_uint64,
                             ctypes.c_uint64, ctypes.c_uint64]
    lib.tsr_next.restype = ctypes.c_int
    lib.tsr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.tsr_total_seqs.restype = ctypes.c_uint64
    lib.tsr_total_seqs.argtypes = [ctypes.c_void_p]
    lib.tsr_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


class TokenShardDataset:
    """Iterate `{"ids", "labels"}` LM batches from token shards.

    ``labels`` are next-token shifted; the final position's label is the
    ignore index (the synthetic generators yield seq_len+1 tokens instead —
    shards store exactly seq_len, matching on-disk corpora).

    The stream position is CHECKPOINTABLE in O(1): each epoch's permutation
    is a pure function of ``shuffle_seed + epoch``, so ``(epoch, cursor)``
    pins the stream exactly — :meth:`state_dict` after N batches and
    :meth:`load_state_dict` on a fresh dataset resume at batch N without
    replaying ``next()`` N times. The position is tracked
    host-side per CONSUMED batch, so the native reader's prefetch run-ahead
    never leaks into the saved state. One live iterator per dataset."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 shuffle: bool = True, shuffle_seed: int = 0,
                 ignore_index: int = -100, native: Optional[bool] = None,
                 rank: int = 0, world_size: int = 1):
        """``rank``/``world_size`` shard the epoch permutation across
        processes (a ``DistributedSampler``'s role): rank r reads positions r, r+world, r+2·world, … of each epoch's
        shuffled order; the remainder ``total % world`` is dropped so every
        rank yields the same number of rows per epoch. Pass the
        ``torch.distributed`` rank and world size."""
        self.paths = list(paths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed
        self.ignore_index = ignore_index
        if world_size < 1 or not (0 <= rank < world_size):
            raise ValueError(f"bad rank/world_size: {rank}/{world_size}")
        self.rank = rank
        self.world_size = world_size
        if not self.paths:
            raise ValueError("no shard paths")
        with open(self.paths[0], "rb") as fh:
            header = np.frombuffer(fh.read(_HEADER.itemsize), _HEADER)[0]
        if header["magic"] != _MAGIC:
            raise ValueError(f"{self.paths[0]}: not a token shard")
        self.seq_len = int(header["seq_len"])
        # validate shardability up front (headers are cheap) so both backends
        # fail with the same actionable message, not the native reader's
        # opaque nullptr
        total = 0
        for p in self.paths:
            hdr = np.fromfile(p, _HEADER, count=1)
            if hdr.size:
                total += int(hdr[0]["num_seqs"])
        if total < world_size:
            raise ValueError(
                f"{total} sequences cannot shard across {world_size} ranks")
        lib = _load_native() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("the native reader was asked for but did not build") from _lib_error
        self._lib = lib
        self._handle = None
        self._total = total
        self._epoch = 0          # stream position AFTER the last served batch
        self._cursor = 0
        self.batches_served = 0

    @property
    def using_native(self) -> bool:
        return self._lib is not None

    @property
    def _per_rank(self) -> int:
        return self._total // self.world_size

    # --- checkpointable stream position ---------------------------------

    def state_dict(self) -> Dict[str, int]:
        """Position after the last served batch — save with the training
        checkpoint; a fresh dataset given this via :meth:`load_state_dict`
        serves the very next batch a straight run would."""
        return {"epoch": self._epoch, "cursor": self._cursor,
                "shuffle_seed": self.shuffle_seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        seed = state.get("shuffle_seed", self.shuffle_seed)
        if seed != self.shuffle_seed:
            raise ValueError(
                f"stream state was saved under shuffle_seed {seed}, this "
                f"dataset uses {self.shuffle_seed}: epoch permutations differ")
        self._epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])

    def _advance(self) -> None:
        """Move the host-side position one batch forward — the exact wrap
        rule of the C reader's fill_batch (epoch check BEFORE each row, so a
        non-dividing batch carries its remainder into the next epoch)."""
        for _ in range(self.batch_size):
            if self._cursor >= self._per_rank:
                self._cursor = 0
                self._epoch += 1
            self._cursor += 1
        self.batches_served += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._lib is not None:
            yield from self._iter_native()
        else:
            yield from self._iter_python()

    def _to_batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        labels = np.full_like(ids, self.ignore_index)
        labels[:, :-1] = ids[:, 1:]
        return {"ids": ids, "labels": labels}

    @property
    def _native_seed(self) -> int:
        # the C reader's 0 means "no shuffle"; +1 keeps user seed 0 shuffling
        return (self.shuffle_seed + 1) if self.shuffle else 0

    def _iter_native(self):
        lib = self._lib
        c_paths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        handle = lib.tsr_open(c_paths, len(self.paths), self.seq_len,
                              self.batch_size, self._native_seed,
                              self.rank, self.world_size,
                              self._epoch, self._cursor)
        if not handle:
            raise RuntimeError(f"tsr_open failed for {self.paths}")
        out = np.empty((self.batch_size, self.seq_len), np.int32)
        try:
            while True:
                rc = lib.tsr_next(
                    handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if rc != 0:
                    return
                self._advance()
                yield self._to_batch(out.copy())
        finally:
            lib.tsr_close(handle)

    def _iter_python(self):
        """Fallback: numpy memmap with the native reader's stream semantics —
        per-ROW cursor that wraps+reshuffles at epoch boundaries, so a
        non-dividing batch size carries its remainder into the next epoch's
        first batch exactly like tokenshard.cpp's fill_batch (and
        total < batch_size still yields batches). With ``shuffle=False``
        the two backends are bit-identical; shuffled permutations differ
        (std::mt19937_64 vs numpy RandomState) but cover the same epochs."""
        maps: List[np.ndarray] = []
        for p in self.paths:
            header = np.fromfile(p, _HEADER, count=1)[0]
            if header["magic"] != _MAGIC or int(header["seq_len"]) != self.seq_len:
                raise ValueError(f"{p}: bad shard header")
            maps.append(np.memmap(p, np.int32, "r", offset=_HEADER.itemsize,
                                  shape=(int(header["num_seqs"]), self.seq_len)))
        total = sum(m.shape[0] for m in maps)

        def lookup(gi: int) -> np.ndarray:
            for m in maps:
                if gi < m.shape[0]:
                    return m[gi]
                gi -= m.shape[0]
            raise IndexError(gi)

        def make_order(epoch: int) -> np.ndarray:
            if not self.shuffle:
                return np.arange(total)
            return np.random.RandomState(
                self.shuffle_seed + epoch).permutation(total)

        per_rank = total // self.world_size
        if per_rank == 0:
            raise ValueError(
                f"{total} sequences cannot shard across {self.world_size} ranks")
        epoch, cursor = self._epoch, self._cursor  # resume point (O(1) seek)
        order = make_order(epoch)
        while True:
            ids = np.empty((self.batch_size, self.seq_len), np.int32)
            for row in range(self.batch_size):
                if cursor >= per_rank:
                    cursor, epoch = 0, epoch + 1
                    order = make_order(epoch)
                ids[row] = lookup(int(order[cursor * self.world_size + self.rank]))
                cursor += 1
            self._advance()
            yield self._to_batch(ids)
