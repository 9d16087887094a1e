"""Multi-LoRA serving: a device-resident pool of adapters (S-LoRA, Sheng
et al.; Punica, Chen et al.).

Counterpart of ``neuronx_distributed_tpu/inference/adapters.py``. Rank-r
adapters are small next to the base model, so many share one model: each
targeted projection adds ``s * (x @ A) @ B`` per batch row with the row's
own ``(A, B, s)``, gathered from a pool of slots by the row's
``adapter_idx`` (``models/llama.py``, ``LlamaConfig.lora_rank``).

Device layout: the model's one fp32 buffer ``lora_pool (slots, layers,
per_layer)``, one contiguous slot per adapter (``LoraLayout`` places each
matrix in a layer's chunk). The pool writes a slot in place, with a copy
into the buffer the model and a captured decode block read: loading or
repairing an adapter never rebinds a tensor. Slot 0 is the identity
adapter, all zeros, so rows without an adapter run the base model bit for
bit. Adapters are zero-padded to the pool's rank (exact: padded ``A``
columns meet padded ``B`` rows of zeros), so mixed ranks share one pool.

Residency (:class:`AdapterPool`) is the KV ``PageAllocator`` pattern:
residency holds one refcount, each admission pin one more, and a cold load
evicts the least recently used unpinned adapter. Every registered adapter
carries a crc32 over its padded bytes, checked against the device's bytes
on every acquire: a corrupted slot (the ``adapter`` fault seam of
``faults.py``) is caught and rewritten from the host registry before the
pin, never served. On CUDA the check's device-to-host copy runs on a side
stream that waits only for the slot's last write, not for a decode block
in flight.

Sizing: one resident adapter is ``layers * per_layer`` fp32 words
(:meth:`AdapterPool.adapter_bytes`); the pool is ``slots`` of those.
"""

from __future__ import annotations

import re
import time
import zlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.paged_cache import PageAllocator

# what a garbled adapter slot holds in one element of an A block (JAX
# ``adapters.py:278``)
GARBLE_ADAPTER = 104729.0

_QKV_KERNELS = {"q_kernel": "q", "k_kernel": "k", "v_kernel": "v"}
_LAYER = re.compile(r"(?:^|\.)layers\.(\d+)\.")


class AdapterPoolExhausted(RuntimeError):
    """Every non-identity slot is pinned by an in-flight request and none is
    evictable: the admission is shed with
    ``Rejected(reason="adapter_pool_exhausted")``."""


class AdapterLoadError(RuntimeError):
    """An adapter load failed (injected IO fault). Retryable: the admission
    requeues, and is never served under a wrong or half-written adapter."""


def target_leaf_name(param_path: str) -> Optional[str]:
    """The pool's projection name of one adapted weight (a port weight name
    such as ``model.layers.3.attention.qkv.k_kernel``): ``q``/``k``/``v``
    under the fused qkv, the module name elsewhere (``o_proj``,
    ``gate_proj``, ...); None when the weight is no serving target."""
    parts = param_path.split(".")
    if len(parts) < 2:
        return None
    module, kernel = parts[-2], parts[-1]
    if module == "qkv":
        return _QKV_KERNELS.get(kernel)
    return module if kernel == "kernel" else None


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype != torch.float32 else x.numpy()
    return np.asarray(x, np.float32)


class ResidentPool:
    """Residency of named entries in ``n_slots`` device slots, slot 0
    reserved (the identity): refcounted slots on a :class:`PageAllocator`
    (1 = resident, more = pinned), LRU eviction of unpinned entries, and
    the acquire order of JAX ``adapters.py:315``: fault verdict, load or
    hit, garble on ``"corrupt"``, a check of the device's bytes against
    the registry, repair, pin. Subclasses say how a slot is written,
    garbled and checked. Counters are attributes: ``loads``, ``hits``,
    ``evictions``, ``pins``, ``releases``, ``repairs``, ``load_failures``,
    ``resident_peak``, and ``garbled`` (slots a ``"corrupt"`` verdict
    garbled: a verdict on an acquire the full pool refuses garbles
    nothing); ``acquire_ms`` and ``load_ms`` hold the wall ms of each
    acquire and each cold load."""

    kind = "adapter"
    exhausted_error = AdapterPoolExhausted
    load_error = AdapterLoadError

    def __init__(self, n_slots: int, device: torch.device):
        if n_slots < 2:
            raise ValueError(f"{self.kind} pool needs >= 2 slots (slot 0 is the identity "
                             f"{self.kind}), got {n_slots}")
        self.n_slots = int(n_slots)
        self.device = torch.device(device)
        self.allocator = PageAllocator(self.n_slots, reserved=1)
        self.resident: Dict[str, int] = {}
        self._registry: Dict[str, dict] = {}
        self._last_used: Dict[str, int] = {}
        self._clock = 0
        self.fault_hook: Optional[Callable[[], Optional[str]]] = None
        self.loads = self.evictions = self.pins = self.releases = self.hits = 0
        self.repairs = self.load_failures = self.resident_peak = self.garbled = 0
        self.acquire_ms: List[float] = []
        self.load_ms: List[float] = []
        self._tracer = None
        self._block_fn = None
        self._m_slots = None
        self._m_load = None
        # per slot, the event behind its last write (CUDA): a check waits
        # for that write and nothing else. The pool's reset at session
        # start is every slot's first write.
        self._written: Dict[int, torch.cuda.Event] = {}
        self._side: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._written = {s: ev for s in range(self.n_slots)}

    # --- observability ---------------------------------------------------

    def attach_observability(self, tracer, metrics, block_fn=None) -> None:
        """Lifecycle instants (``<kind>:load``, ``:evict``, ``:repair``,
        ``:pin``, ``:load_fail``) on the ``("cache", kind)`` lane, the
        slots-in-use gauge and the load-latency histogram."""
        self._tracer = tracer
        self._block_fn = block_fn
        self._m_slots = metrics.gauge(
            f"serve_{self.kind}_slots_in_use",
            help=f"device-resident {self.kind}s (identity slot excluded)")
        self._m_load = metrics.histogram(
            f"serve_{self.kind}_load_ms", help=f"cold {self.kind} load wall ms", lo=0.01)

    def _note(self, name: str, **args) -> None:
        if self._m_slots is not None:
            self._m_slots.set(self.in_use())
        if self._tracer is not None and self._tracer.enabled:
            block = None if self._block_fn is None else int(self._block_fn())
            self._tracer.instant(name, ("cache", self.kind), block=block,
                                 args={**args, "resident": self.in_use()})

    # --- introspection ---------------------------------------------------

    def registered(self, name: str) -> bool:
        return name in self._registry

    def is_resident(self, name: str) -> bool:
        return name in self.resident

    def slot_of(self, name: str) -> int:
        return self.resident[name]

    def in_use(self) -> int:
        return self.allocator.in_use()

    def pinned(self, name: str) -> int:
        slot = self.resident.get(name)
        return 0 if slot is None else max(int(self.allocator.refcount[slot]) - 1, 0)

    # --- device access ---------------------------------------------------

    def _after_write(self, slot: int) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._written[slot] = ev

    def _read_slot(self, slot: int, read: Callable[[], None]) -> None:
        """Run ``read`` (device-to-host copies of the slot) once the slot's
        last write has run: on CUDA on a side stream that waits for that
        write alone, then block until the read itself is done."""
        if self.device.type != "cuda":
            read()
            return
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        ev = self._written.get(slot)
        with torch.cuda.stream(self._side):
            if ev is not None:
                self._side.wait_event(ev)
            read()
            done = torch.cuda.Event()
            done.record(self._side)
        done.synchronize()

    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory() if self.device.type == "cuda" else t

    def _write_slot(self, slot: int, entry: dict) -> None:
        raise NotImplementedError

    def _garble_slot(self, slot: int) -> None:
        raise NotImplementedError

    def _intact(self, slot: int, entry: dict) -> bool:
        raise NotImplementedError

    # --- residency / pinning --------------------------------------------

    def _evict_one(self) -> Optional[str]:
        """LRU eviction of a resident, unpinned (refcount-1) entry."""
        victims = [n for n, s in self.resident.items() if self.allocator.refcount[s] == 1]
        if not victims:
            return None
        name = min(victims, key=lambda n: self._last_used.get(n, 0))
        slot = self.resident.pop(name)
        self.allocator.release([slot])
        self._last_used.pop(name, None)
        self.evictions += 1
        self._note(f"{self.kind}:evict", **{self.kind: name}, slot=int(slot))
        return name

    def acquire(self, name: str) -> int:
        """Make ``name`` resident (loading, evicting as needed), check the
        device's bytes against the registry (repairing a corrupted slot in
        place), and take one pin. Returns the slot. Raises the pool's
        exhausted error (full, nothing evictable) or load error (injected
        load fault, retryable)."""
        t_acq = time.perf_counter()
        entry = self._registry.get(name)
        if entry is None:
            raise ValueError(f"unknown {self.kind} {name!r} (register first)")
        verdict = self.fault_hook() if self.fault_hook is not None else None
        if verdict == "fail":
            self.load_failures += 1
            self._note(f"{self.kind}:load_fail", **{self.kind: name})
            raise self.load_error(f"injected load failure for {name!r}")
        self._clock += 1
        slot = self.resident.get(name)
        loaded = False
        if slot is None:
            t0 = time.perf_counter()
            pages = self.allocator.alloc(1)
            if pages is None:
                self._evict_one()
                pages = self.allocator.alloc(1)
            if pages is None:
                raise self.exhausted_error(f"all {self.n_slots - 1} {self.kind} slots pinned; "
                                           f"cannot load {name!r}")
            slot = pages[0]
            self._write_slot(slot, entry)
            self.resident[name] = slot
            self.loads += 1
            self.resident_peak = max(self.resident_peak, self.in_use())
            loaded = True
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.load_ms.append(dt_ms)
            if self._m_load is not None:
                self._m_load.observe(dt_ms)
            self._note(f"{self.kind}:load", **{self.kind: name}, slot=int(slot),
                       ms=round(dt_ms, 3))
        else:
            self.hits += 1
        if verdict == "corrupt":
            self._garble_slot(slot)
            self.garbled += 1
        if not self._intact(slot, entry):
            # the registry copy is authoritative: rewrite in place
            self._write_slot(slot, entry)
            self.repairs += 1
            self._note(f"{self.kind}:repair", **{self.kind: name}, slot=int(slot))
        self._last_used[name] = self._clock
        self.allocator.retain([slot])
        self.pins += 1
        self._note(f"{self.kind}:pin", **{self.kind: name}, slot=int(slot), loaded=loaded)
        self.acquire_ms.append((time.perf_counter() - t_acq) * 1e3)
        return int(slot)

    def release(self, name: str) -> None:
        """Drop one pin; the entry stays resident until LRU eviction."""
        slot = self.resident.get(name)
        if slot is None:
            return
        self.allocator.release([slot])
        self.releases += 1

    def evict(self, name: str) -> bool:
        """Drop an unpinned resident entry; False when absent or pinned."""
        slot = self.resident.get(name)
        if slot is None or self.allocator.refcount[slot] != 1:
            return False
        self.resident.pop(name)
        self.allocator.release([slot])
        self._last_used.pop(name, None)
        self.evictions += 1
        self._note(f"{self.kind}:evict", **{self.kind: name}, slot=int(slot))
        return True


class AdapterPool(ResidentPool):
    """Pool of ``pool.shape[0]`` adapters padded to ``layout.rank`` over the
    model's ``lora_pool`` buffer ``pool (slots, layers, per_layer)``, laid
    out by ``layout`` (``models/llama.py``). One per session: the
    ``CausalLM`` resets the buffer when a session starts.

    :meth:`register` stores an adapter's padded host bytes and crc32 (no
    device work); :meth:`acquire` makes it resident, checks the device
    copy and pins it; :meth:`release` unpins (it stays resident).
    ``fault_hook`` is the ``adapter`` seam of ``faults.py``."""

    def __init__(self, pool: torch.Tensor, layout):
        super().__init__(pool.shape[0], pool.device)
        self.pool = pool
        self.layout = layout
        self.max_rank = layout.rank
        self.num_layers = int(pool.shape[1])
        self._leaves = layout.leaves()
        # leaf name -> (fan_in, fan_out)
        self.targets: Dict[str, Tuple[int, int]] = {
            leaf: (v[2], v[3]) for leaf, v in self._leaves.items()}
        # the garble's element: layer 0 of the first A block
        self._garble_at = next(iter(layout.groups.values())).a_offset
        self._host: Optional[torch.Tensor] = None

    def adapter_bytes(self) -> int:
        """fp32 bytes one resident adapter takes over every layer and
        target (``A``, ``B`` and scales): the pool is ``n_slots`` of them."""
        return self.num_layers * self.layout.per_layer * 4

    def register(self, name: str, lora_params: Mapping[str, Mapping], lora_config) -> None:
        """Store ``name``'s padded host bytes and crc32 (residency comes at
        :meth:`acquire`). ``lora_params``: an ``init_lora`` tree of the port
        (one entry a layer, keyed by weight name; ``lora_params_from_jax``
        makes one from a JAX tree); ``lora_config`` gives the scaling.
        Raises when a weight is outside the pool's coverage or its rank
        exceeds ``max_rank``."""
        if name in self._registry:
            raise ValueError(f"adapter {name!r} already registered")
        lay, R = self.layout, self.max_rank
        view = np.zeros((self.num_layers, lay.per_layer), np.float32)
        scale = float(lora_config.scaling)
        placed = 0
        for pstr, ad in lora_params.items():
            leaf = target_leaf_name(pstr)
            m = _LAYER.search(pstr)
            if leaf is None or leaf not in self.targets or m is None:
                raise ValueError(f"adapter {name!r} targets {pstr} which is outside the pool's "
                                 f"coverage {sorted(self.targets)} of decoder layers")
            layer = int(m.group(1))
            if layer >= self.num_layers:
                raise ValueError(f"adapter {name!r} leaf {pstr}: layer {layer} of "
                                 f"{self.num_layers}")
            a, b = _np32(ad["lora_a"]), _np32(ad["lora_b"])
            if a.ndim != 2 or b.ndim != 2:
                raise ValueError(f"adapter {name!r} leaf {pstr}: A {a.shape}, B {b.shape} are "
                                 f"not one layer's matrices")
            r = a.shape[-1]
            if r > R:
                raise ValueError(f"adapter {name!r} rank {r} exceeds pool max_rank {R}")
            gname, col, fan_in, fan_out, b_off, s_idx = self._leaves[leaf]
            if a.shape[0] != fan_in or b.shape != (r, fan_out):
                raise ValueError(f"adapter {name!r} leaf {pstr}: A {a.shape}, B {b.shape} for "
                                 f"fan_in {fan_in}, fan_out {fan_out}")
            g = lay.groups[gname]
            width = len(g.leaves) * R
            view[layer, g.a_offset: g.a_offset + fan_in * width].reshape(
                fan_in, width)[:, col: col + r] = a
            view[layer, b_off: b_off + R * fan_out].reshape(R, fan_out)[:r] = b
            view[layer, lay.scale_offset + s_idx] = scale
            placed += 1
        if not placed:
            raise ValueError(f"adapter {name!r} is empty")
        self._registry[name] = {"host": self._pinned(torch.from_numpy(view)), "scale": scale,
                                "crc": zlib.crc32(view)}

    def _write_slot(self, slot: int, entry: dict) -> None:
        self.pool[slot].copy_(entry["host"], non_blocking=True)
        self._after_write(slot)

    def _garble_slot(self, slot: int) -> None:
        """Corrupt one device element of the slot (the seam's ``"corrupt"``
        verdict): the acquire-time crc must catch it."""
        self.pool[slot, 0, self._garble_at].fill_(GARBLE_ADAPTER)
        self._after_write(slot)

    def _intact(self, slot: int, entry: dict) -> bool:
        """crc32 of the device slot's bytes against the registry's."""
        if self._host is None:
            self._host = self._pinned(torch.empty(self.pool.shape[1:], dtype=torch.float32))
        self._read_slot(slot, lambda: self._host.copy_(self.pool[slot], non_blocking=True))
        return zlib.crc32(self._host.numpy()) == entry["crc"]
