"""Durable conversation tier: crash-safe park and resume of idle sessions.

The port's own copy of ``neuronx_distributed_tpu/inference/conversation_tier.py``
(numpy, hashlib, json and the port's ``checkpoint/storage.py``), and
byte-compatible with it: a directory written by either package resumes in
the other. The third rung of the capacity ladder below the device pool and
the host tier (``HostPageTier``): a :class:`ConversationParkStore` holds a
parked conversation's KV pages and its per-request engine state on the
checkpoint storage backend, durable across process death.

* **Page framing** is the ``HostPageTier`` shape: one ``{cache-leaf path:
  (L, page_size, kv, hd) array}`` dict a page, a crc32 over its sorted
  leaves, and ``tp_degree`` and ``page_dtype`` stamps, so a store written at
  another mesh degree or pool dtype is refused structurally (the resume
  re-prefills; KV is never rescaled or requantized). The leaf names are the
  JAX cache's paths (:data:`LEAF_PATHS`): the port's pools (``keys``,
  ``values``, ``k_scales``, ``v_scales``) sort otherwise once scales are
  present, and the crc walks the sorted names. :func:`to_store_page` and
  :func:`from_store_page` map between the two at the store boundary.
* **bfloat16** travels as its 16-bit pattern (numpy has no bfloat16 unless
  something registers it) and is framed under the dtype name ``bfloat16``,
  the name the JAX package writes and casts by: an ``int16`` frame would
  make the JAX reader convert values and land wrong pages whose crc still
  matched. A ``bfloat16`` frame decodes to ``int16`` bits here.
* **Durability** is the checkpoint-integrity pattern: every shard (the
  state JSON and the page files) first, then ``manifest.json`` with each
  shard's sha256 and byte count, and only then the ``done`` marker, each
  write atomic (a temporary file and a rename). A reader trusts nothing
  without the marker, so a park torn by a crash is never half-trusted: the
  directory is quarantined and the conversation re-prefills.

Failure semantics (``faults.py``'s park seam injects each one):

* the KV write fails: the park lands state-only (prompt, generated tokens,
  rng stamp), and the next resume re-prefills;
* a torn manifest (no done marker): quarantined at the next load or
  :meth:`ConversationParkStore.sweep`, the engine re-prefills from its own
  record (in process) or its snapshot (after a restart);
* a read failure, or bytes corrupted at rest: the sha256/crc32 mismatch is
  caught, the directory quarantined, and the resume re-prefills from the
  parked state, which is verified on its own.

Each of them ends on the engine's replay path, whose per-request rng keeps
the stream a cold run's: a park fault costs latency, never a token. The
store writes only under the directory its caller names.

``host_ms`` accumulates the wall ms of the store's host steps for the
park (``park_frame``, ``park_crc32``, ``park_sha256``, ``park_io``) and
the load (``load_io``, ``load_sha256``, ``load_frame``, ``load_crc32``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from neuronx_distributed_tpu_torch.checkpoint.storage import (
    BaseCheckpointStorage,
    create_checkpoint_storage,
)
from neuronx_distributed_tpu_torch.inference.paged_cache import HostPageTier

MANIFEST_VERSION = 1
_DONE = "done"
_QUARANTINED = "quarantined"
_MANIFEST = "manifest.json"
_STATE = "state.json"

# the JAX engine's page leaves: ``keystr`` of the Llama cache paths its
# ``_read_page_bytes`` names (pinned by tests/test_torch_park.py)
_ATTN = "['model']['layers']['block']['attention']"
LEAF_PATHS = {"keys": f"{_ATTN}['cached_key']", "values": f"{_ATTN}['cached_value']",
              "k_scales": f"{_ATTN}['cached_key_scale']",
              "v_scales": f"{_ATTN}['cached_value_scale']"}
_POOL_OF = {v: k for k, v in LEAF_PATHS.items()}
BF16 = "bfloat16"


def to_store_page(page: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A page from the engine's page I/O (pool name -> array) under the JAX
    leaf paths the store frames."""
    return {LEAF_PATHS[name]: arr for name, arr in page.items()}


def from_store_page(payload: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A stored page (leaf path -> array) under the engine's pool names;
    raises :class:`ParkIntegrityError` on a leaf the port has no pool for."""
    try:
        return {_POOL_OF[path]: arr for path, arr in payload.items()}
    except KeyError as e:
        raise ParkIntegrityError(f"page leaf {e.args[0]!r} names no pool of the port")


class ParkError(RuntimeError):
    """Base class: a park-store operation could not complete."""


class ParkWriteFailed(ParkError):
    """The KV shard write failed: the caller parks state-only."""


class ParkReadFailed(ParkError):
    """A resume read failed: re-prefill from the parked state or the
    engine's own records."""


class ParkIntegrityError(ParkError):
    """Stored bytes failed sha256/crc verification, or the manifest is torn
    or quarantined: the conversation must re-prefill."""


def _page_crc(payload: Dict[str, np.ndarray]) -> int:
    return HostPageTier._crc(payload)


def _encode_page(payload: Dict[str, np.ndarray], bf16: bool = False) -> bytes:
    """One page's leaf dict as a deterministic byte string: sorted leaves,
    each framed as (key, dtype name, shape, raw bytes). No pickle: the bytes
    are content-addressed by the manifest's sha256. ``bf16``: the pool is
    bfloat16, whose leaves arrive as int16 bits and are framed as
    ``bfloat16``."""
    out = [b"NXDPAGE1", len(payload).to_bytes(4, "little")]
    for key in sorted(payload):
        arr = np.ascontiguousarray(payload[key])
        name = BF16 if bf16 and arr.dtype == np.int16 else str(arr.dtype)
        kb, db = key.encode(), name.encode()
        out += [len(kb).to_bytes(4, "little"), kb, len(db).to_bytes(2, "little"), db,
                len(arr.shape).to_bytes(1, "little")]
        out += [int(d).to_bytes(8, "little") for d in arr.shape]
        raw = arr.tobytes()
        out += [len(raw).to_bytes(8, "little"), raw]
    return b"".join(out)


def _decode_page(data: bytes) -> Dict[str, np.ndarray]:
    """:func:`_encode_page` read back; a ``bfloat16`` leaf comes back as its
    int16 bits."""
    if data[:8] != b"NXDPAGE1":
        raise ParkIntegrityError("bad page shard magic")
    off = 8
    n = int.from_bytes(data[off:off + 4], "little")
    off += 4
    payload: Dict[str, np.ndarray] = {}
    for _ in range(n):
        klen = int.from_bytes(data[off:off + 4], "little")
        off += 4
        key = data[off:off + klen].decode()
        off += klen
        dlen = int.from_bytes(data[off:off + 2], "little")
        off += 2
        name = data[off:off + dlen].decode()
        dtype = np.dtype(np.int16) if name == BF16 else np.dtype(name)
        off += dlen
        ndim = data[off]
        off += 1
        shape = []
        for _ in range(ndim):
            shape.append(int.from_bytes(data[off:off + 8], "little"))
            off += 8
        blen = int.from_bytes(data[off:off + 8], "little")
        off += 8
        payload[key] = np.frombuffer(data[off:off + blen], dtype=dtype).reshape(shape).copy()
        off += blen
    if off != len(data):
        raise ParkIntegrityError("trailing bytes in page shard")
    return payload


@dataclasses.dataclass
class ParkedConversation:
    """One conversation loaded back from the store. ``payloads`` is None
    for a state-only park (the KV write failed at park time): the caller
    must re-prefill from ``state``."""

    request_id: int
    manifest_id: str
    state: dict
    payloads: Optional[List[Dict[str, np.ndarray]]]
    tp_degree: int
    page_dtype: str


class ConversationParkStore:
    """Durable park/resume store for idle conversations (JAX
    ``conversation_tier.py:140``).

    ``write_fault_hook`` / ``read_fault_hook`` are the park seam of
    :class:`~neuronx_distributed_tpu_torch.inference.faults.FaultInjector`
    (``on_park_write`` / ``on_park_read``): consulted once per park and once
    per load, they may force a write failure (state-only park), a torn
    manifest (done marker suppressed), a read failure, or an at-rest byte
    flip (which the checksums then catch), each ending in re-prefill."""

    def __init__(self, dirname: str, storage: Optional[BaseCheckpointStorage] = None):
        self.dirname = dirname
        self.storage = storage or create_checkpoint_storage(dirname)
        self.write_fault_hook: Optional[Callable[[], Optional[str]]] = None
        self.read_fault_hook: Optional[Callable[[], Optional[str]]] = None
        self.stats = {"parks": 0, "state_only_parks": 0, "torn_parks": 0, "loads": 0,
                      "load_faults": 0, "quarantined": 0, "removed": 0}
        self.host_ms = {k: 0.0 for k in ("park_frame", "park_crc32", "park_sha256", "park_io",
                                         "load_io", "load_sha256", "load_frame", "load_crc32")}

    @contextmanager
    def _timed(self, step: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_ms[step] += (time.perf_counter() - t0) * 1e3

    # --- naming ----------------------------------------------------------

    @staticmethod
    def _conv_dir(rid: int) -> str:
        return f"conv-{int(rid):08d}"

    @staticmethod
    def _rid_of(dirname: str) -> Optional[int]:
        if not dirname.startswith("conv-"):
            return None
        try:
            return int(dirname[len("conv-"):])
        except ValueError:
            return None

    # --- write path -------------------------------------------------------

    def park(self, rid: int, state: dict, payloads: Optional[List[Dict[str, np.ndarray]]],
             tp_degree: int = 1, page_dtype: str = "float32") -> Tuple[str, Optional[str]]:
        """Write one conversation durably; returns ``(manifest_id,
        verdict)``, the verdict the injected fault (None clean, ``'fail'``:
        the park landed state-only, ``'torn'``: the shards landed but the
        done marker did not, and readers quarantine it). Write order: shards,
        manifest (a sha256 a shard), done marker, each write atomic."""
        conv = self._conv_dir(rid)
        verdict = self.write_fault_hook() if self.write_fault_hook else None
        # a re-park of the same id drops the old generation first, so a
        # crash mid-rewrite never pairs an old done marker with new shards
        with self._timed("park_io"):
            self.storage.remove_dir(conv)
            self.storage.makedirs(conv)
        if verdict == "fail":
            payloads = None   # the KV shard write "failed": park state-only
            self.stats["state_only_parks"] += 1
        files: Dict[str, dict] = {}
        crcs: List[int] = []
        bf16 = str(page_dtype) == BF16
        with self._timed("park_frame"):
            state_bytes = json.dumps(state, sort_keys=True).encode()
        self._save_shard(conv, _STATE, state_bytes, files)
        for i, payload in enumerate(payloads or []):
            with self._timed("park_frame"):
                data = _encode_page(payload, bf16)
            self._save_shard(conv, f"page-{i:06d}.bin", data, files)
            with self._timed("park_crc32"):
                crcs.append(_page_crc(payload))
        manifest = {
            "version": MANIFEST_VERSION, "algo": "sha256", "request_id": int(rid),
            "pages": len(crcs), "crcs": crcs, "tp_degree": int(tp_degree),
            "page_dtype": str(page_dtype), "state_only": payloads is None, "files": files,
        }
        with self._timed("park_io"):
            self.storage.save_text(json.dumps(manifest, sort_keys=True), f"{conv}/{_MANIFEST}")
        if verdict == "torn":
            # the crash-mid-park shape: everything but the done marker
            self.stats["torn_parks"] += 1
            return conv, verdict
        with self._timed("park_io"):
            self.storage.save_text(_DONE, f"{conv}/{_DONE}")
        self.stats["parks"] += 1
        return conv, verdict

    def _save_shard(self, conv: str, rel: str, data: bytes, files: Dict[str, dict]) -> None:
        with self._timed("park_sha256"):
            files[rel] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
        with self._timed("park_io"):
            self.storage.save_bytes(data, f"{conv}/{rel}")

    # --- read path --------------------------------------------------------

    def contains(self, rid: int) -> bool:
        """True iff a complete (done-marked, unquarantined) park exists."""
        conv = self._conv_dir(rid)
        return (self.storage.file_exists(f"{conv}/{_DONE}")
                and not self.storage.file_exists(f"{conv}/{_QUARANTINED}"))

    def manifest(self, rid: int) -> dict:
        return json.loads(self.storage.load_text(f"{self._conv_dir(rid)}/{_MANIFEST}"))

    def parked_bytes(self, rid: int) -> int:
        """Durable bytes of one parked conversation (the manifest's sum)."""
        return sum(int(f["bytes"]) for f in self.manifest(rid)["files"].values())

    def load(self, rid: int) -> ParkedConversation:
        """Read one parked conversation back, every shard's sha256 and every
        page's crc32 verified against the manifest. Torn or corrupt state
        quarantines the directory and raises; the caller re-prefills. A
        state-only park returns ``payloads=None``."""
        conv = self._conv_dir(rid)
        self.stats["loads"] += 1
        if self.storage.file_exists(f"{conv}/{_QUARANTINED}"):
            raise ParkIntegrityError(f"{conv} is quarantined")
        if not self.storage.file_exists(f"{conv}/{_DONE}"):
            # torn: the park never completed; quarantine so no later reader
            # half-trusts it
            if self.storage.file_exists(f"{conv}/{_MANIFEST}") or \
                    self.storage.file_exists(f"{conv}/{_STATE}"):
                self.quarantine(rid)
            raise ParkIntegrityError(f"{conv} has no done marker (torn park)")
        verdict = self.read_fault_hook() if self.read_fault_hook else None
        if verdict == "fail":
            self.stats["load_faults"] += 1
            raise ParkReadFailed(f"injected read failure for {conv}")
        try:
            with self._timed("load_io"):
                m = json.loads(self.storage.load_text(f"{conv}/{_MANIFEST}"))
        except Exception as e:
            self.quarantine(rid)
            raise ParkIntegrityError(f"{conv} manifest unreadable: {e}")
        if m.get("version") != MANIFEST_VERSION or m.get("algo") != "sha256":
            self.quarantine(rid)
            raise ParkIntegrityError(f"{conv} manifest version/algo mismatch")
        shards: Dict[str, bytes] = {}
        try:
            with self._timed("load_io"):
                for rel in sorted(m["files"]):
                    shards[rel] = self.storage.read_bytes(f"{conv}/{rel}")
        except Exception as e:
            self.stats["load_faults"] += 1
            raise ParkReadFailed(f"{conv} shard read failed: {e}")
        if verdict == "corrupt":
            # garble one byte of the largest shard: a real flip, which the
            # verification below must catch
            victim = max(sorted(shards), key=lambda r: len(shards[r]))
            raw = bytearray(shards[victim])
            raw[len(raw) // 2] ^= 0xFF
            shards[victim] = bytes(raw)
        for rel, want in m["files"].items():
            data = shards.get(rel)
            with self._timed("load_sha256"):
                bad = (data is None or len(data) != int(want["bytes"])
                       or hashlib.sha256(data).hexdigest() != want["sha256"])
            if bad:
                self.quarantine(rid)
                raise ParkIntegrityError(f"{conv}/{rel} failed sha256 verify")
        state = json.loads(shards[_STATE].decode())
        payloads: Optional[List[Dict[str, np.ndarray]]] = None
        if not m.get("state_only"):
            payloads = []
            for i in range(int(m["pages"])):
                with self._timed("load_frame"):
                    payload = _decode_page(shards[f"page-{i:06d}.bin"])
                with self._timed("load_crc32"):
                    ok = _page_crc(payload) == int(m["crcs"][i])
                if not ok:
                    self.quarantine(rid)
                    raise ParkIntegrityError(f"{conv} page {i} failed crc32 verify")
                payloads.append(payload)
        return ParkedConversation(
            request_id=int(m["request_id"]), manifest_id=conv, state=state, payloads=payloads,
            tp_degree=int(m.get("tp_degree", 1)), page_dtype=str(m.get("page_dtype", "float32")))

    def recover_state(self, rid: int) -> Optional[dict]:
        """The degradation ladder's middle rung: the state JSON of a damaged
        park, returned only when the manifest reads and the state shard
        passes its sha256 (an unverified state could replay wrong tokens).
        Never raises; None sends the caller to its own records."""
        conv = self._conv_dir(rid)
        try:
            m = json.loads(self.storage.load_text(f"{conv}/{_MANIFEST}"))
            want = m["files"][_STATE]
            data = self.storage.read_bytes(f"{conv}/{_STATE}")
            if (len(data) != int(want["bytes"])
                    or hashlib.sha256(data).hexdigest() != want["sha256"]):
                return None
            return json.loads(data.decode())
        except Exception:
            return None

    # --- lifecycle --------------------------------------------------------

    def quarantine(self, rid: int) -> None:
        """Mark a conversation directory poison: it leaves
        :meth:`list_parked` and :meth:`contains`, and every later load
        refuses it. A marker, not a delete: the bytes stay for post-mortem."""
        self.storage.save_text(_QUARANTINED, f"{self._conv_dir(rid)}/{_QUARANTINED}")
        self.stats["quarantined"] += 1

    def remove(self, rid: int) -> None:
        """Drop a conversation after a resume (or abandonment)."""
        self.storage.remove_dir(self._conv_dir(rid))
        self.stats["removed"] += 1

    def list_parked(self) -> List[int]:
        """Request ids with complete parks, ascending: what a fresh process
        may ``submit(resume=rid)``."""
        out = []
        for d in self.storage.list_dirs():
            rid = self._rid_of(d)
            if rid is not None and self.contains(rid):
                out.append(rid)
        return sorted(out)

    def sweep(self) -> Tuple[List[int], List[int]]:
        """Crash clean-up: quarantine every torn directory (no done marker).
        Returns ``(resumable ids, newly quarantined ids)``."""
        ok, torn = [], []
        for d in self.storage.list_dirs():
            rid = self._rid_of(d)
            if rid is None:
                continue
            if self.contains(rid):
                ok.append(rid)
            elif not self.storage.file_exists(f"{d}/{_QUARANTINED}"):
                self.quarantine(rid)
                torn.append(rid)
        return sorted(ok), sorted(torn)
