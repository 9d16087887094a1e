"""Causal-LM serving runtime: bucketed prefill into a slot pool, per-slot
decode, and generation.

Counterpart of ``neuronx_distributed_tpu/inference/causal_lm.py``. The KV
cache is a fixed pool of ``max_batch`` slots with per-slot lengths;
``insert`` prefills chosen slots while the others keep decoding. In paged
mode (``page_size``) the slots resolve through block tables into a shared
page pool, with radix prefix reuse: a prefix hit prefills only the suffix.

Where the JAX package compiles programs (prefill per bucket, a donated
decode step, a K-step fused ``lax.scan``), this runtime runs prefill and
single steps eagerly and updates the cache in place. The K-step fused
decode is :meth:`CausalLM.compile_session_decode_fused`: on CUDA one
captured ``torch.cuda.CUDAGraph`` that advances every slot K tokens per
replay (the counterpart of the jitted scan), on the CPU the same body run
eagerly. A graph is bound to the addresses it was captured over, so a
``CausalLM`` owns one set of device buffers — the KV pools and a
:class:`SlotState` that packs the per-slot decode state with the block
tables — and :meth:`CausalLM.start_session` resets them for each new
session (one live session per ``CausalLM``).

Tenants (JAX ``causal_lm.py:253-298``): ``lora_rank`` gives the model a
pool of adapter slots (``inference/adapters.py``) that every forward reads
per row, and ``grammar_slots`` a pool of grammar tables
(``inference/grammar.py``) that every draw of the fused block and of the
engine's first tokens masks with. Both pools are device buffers of this
``CausalLM``, written in place, so one captured block serves every mix of
adapters and grammars; each session gets fresh pool bookkeeping over them
(:meth:`CausalLM.new_adapter_pool`, :meth:`CausalLM.new_grammar_pool`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from neuronx_distributed_tpu_torch._device import DeviceLike, resolve_device
from neuronx_distributed_tpu_torch.inference.adapters import AdapterPool
from neuronx_distributed_tpu_torch.inference.grammar import (
    GrammarPool,
    default_token_table,
    grammar_allowed,
    grammar_tables,
    reset_grammar_tables,
)
from neuronx_distributed_tpu_torch.inference.paged_cache import PagedKVCache
from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
from neuronx_distributed_tpu_torch.inference.sampling import (
    Sampler,
    SlotSampler,
    draw_rows,
    request_seed,
    split_key,
)
from neuronx_distributed_tpu_torch.models.llama import KVCache, page_storage_dtype

# the kernel wrappers a decode step can reach (flash attention runs only at
# 128 tokens and up); a replay adds to their launch counters what one run
# of the captured body launched
_KERNEL_WRAPPERS = (paged_decode_attention,)


def infer_prompt_lengths(prompt_ids: np.ndarray, pad_token_id: int = 0) -> np.ndarray:
    """Length of each right-padded prompt = 1 + rightmost non-pad position."""
    nonpad = np.asarray(prompt_ids) != pad_token_id
    s = prompt_ids.shape[1]
    last = s - 1 - np.argmax(nonpad[:, ::-1], axis=1)
    return np.where(nonpad.any(axis=1), last + 1, 0).astype(np.int32)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (b, max_new_tokens), pad after eos
    lengths: np.ndarray         # (b,) generated lengths incl. eos


class SlotState:
    """The per-slot decode state of a session, packed in one int32 buffer on
    the device with a host mirror of the same layout: one ``(max_batch,)``
    row per field of ``FIELDS`` (``temperature`` holds fp32 bits), then the
    ``(max_batch, pages_per_seq)`` block tables in paged mode. The KV
    cache's ``cache_index`` and ``block_table`` are views of the device
    buffer, so one copy refreshes all of it.

    The session API keeps ``length`` and the tables; the caller of a fused
    decode runner keeps the rest. Whoever changes the host mirror says which
    part: ``dirty`` for all of it (:meth:`push` copies the whole mirror), or
    :meth:`mark_rows` for some slots, whose fields and table rows one copy
    and a row-masked merge on the device then replace while every other
    row keeps what the device holds (a decode block run since the host last
    read it has advanced ``tok``, ``count``, ``done`` and ``length`` there).
    :meth:`take_tok` makes a marked row's ``tok`` a device value instead, an
    index into a buffer the caller hands to :meth:`sync` (a first token
    still on the device), and latches its ``done`` on its ``eos`` there;
    with ``grammar_tables`` set, a grammar row's ``gstate`` also takes the
    token's transition there and ``done`` latches on an accept-terminal
    landing. ``adapter`` and ``grammar`` are the rows' pool slots,
    ``gstate`` their DFA state and ``budget`` their token budget.

    The whole-mirror copy is synchronous (pageable memory). The merge's
    copy leaves from one of two pinned buffers on CUDA and does not wait for
    the device: a buffer is written again only after the event recorded
    behind its last copy has passed, so no copy is in flight from a buffer
    the host changes."""

    FIELDS = ("tok", "key_lo", "key_hi", "count", "length", "active", "done", "eos", "greedy",
              "temperature", "adapter", "grammar", "gstate", "budget")

    def __init__(self, batch: int, table_cols: int, device: torch.device):
        self.batch, self.table_cols = batch, table_cols
        n = len(self.FIELDS) * batch + batch * table_cols
        self.host = np.zeros((n,), np.int32)
        self.dev = torch.zeros((n,), dtype=torch.int32, device=device)
        self.dirty = False
        self.grammar_tables: Optional[Dict[str, torch.Tensor]] = None
        # rows to merge at the next sync, and the device source of their tok
        self._rows = np.zeros((batch,), bool)
        self._tok_src = np.full((batch,), -1, np.int32)
        # the merge: the slot row of each element of the packed buffer, and
        # the staged copy (mirror, row mask, tok sources) on the device
        row_of = np.concatenate([np.tile(np.arange(batch), len(self.FIELDS)),
                                 np.repeat(np.arange(batch), table_cols)])
        self._row_of = torch.as_tensor(row_of, dtype=torch.long, device=device)
        self._staged = torch.zeros((n + 2 * batch,), dtype=torch.int32, device=device)
        self._pinned: list = []
        self._copied: list = [None, None]   # the event behind each pinned buffer's copy
        self._turn = 0

    def _span(self, name: str) -> slice:
        i = self.FIELDS.index(name)
        return slice(i * self.batch, (i + 1) * self.batch)

    def host_field(self, name: str) -> np.ndarray:
        f = self.host[self._span(name)]
        return f.view(np.float32) if name == "temperature" else f

    def dev_field(self, name: str) -> torch.Tensor:
        f = self.dev[self._span(name)]
        return f.view(torch.float32) if name == "temperature" else f

    def _table_span(self) -> slice:
        return slice(len(self.FIELDS) * self.batch, self.host.size)

    @property
    def host_table(self) -> np.ndarray:
        return self.host[self._table_span()].reshape(self.batch, self.table_cols)

    @property
    def dev_table(self) -> torch.Tensor:
        return self.dev[self._table_span()].view(self.batch, self.table_cols)

    def push(self) -> None:
        """One host-to-device copy of the whole mirror."""
        self.dev.copy_(torch.from_numpy(self.host))
        self.dirty = False
        self._rows[:] = False
        self._tok_src[:] = -1

    def mark_rows(self, rows) -> None:
        """Copy these slots' rows of the mirror at the next :meth:`sync`."""
        self._rows[np.asarray(rows, np.int64)] = True

    def take_tok(self, slot: int, index: int) -> None:
        """At the next :meth:`sync`, ``slot``'s tok is ``firsts[index]`` of
        the device buffer passed there (the slot must be marked too)."""
        self._tok_src[slot] = index

    def _merge(self, firsts: Optional[torch.Tensor]) -> None:
        n, b = self.host.size, self.batch
        packed = np.concatenate([self.host, self._rows.astype(np.int32), self._tok_src])
        if self.dev.device.type == "cuda":
            if not self._pinned:
                self._pinned = [torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
                                for _ in range(2)]
            buf, done = self._pinned[self._turn], self._copied[self._turn]
            if done is not None:
                done.synchronize()   # the last copy from this buffer has left it
            buf.numpy()[:] = packed
            self._staged.copy_(buf, non_blocking=True)
            self._copied[self._turn] = torch.cuda.Event()
            self._copied[self._turn].record()
            self._turn ^= 1
        else:
            self._staged.copy_(torch.from_numpy(packed))
        take_row = self._staged[n:n + b] != 0
        self.dev.copy_(torch.where(take_row[self._row_of], self._staged[:n], self.dev))
        if (self._tok_src >= 0).any():
            if firsts is None:
                raise ValueError("take_tok rows need the firsts buffer at sync")
            src = self._staged[n + b:]
            take = src >= 0
            tok, done, eos = self.dev_field("tok"), self.dev_field("done"), self.dev_field("eos")
            tok.copy_(torch.where(take, firsts[src.clamp(min=0).long()], tok))
            done.copy_(torch.where(take & (eos >= 0) & (tok == eos), 1, done))
            if self.grammar_tables is not None:
                t = self.grammar_tables
                g, gs = self.dev_field("grammar").long(), self.dev_field("gstate")
                adv = take & (g > 0)
                gs.copy_(torch.where(adv, t["next"][g, gs.long(), tok.long()], gs))
                done.copy_(torch.where(adv & t["terminal"][g, gs.long()], 1, done))
        self._rows[:] = False
        self._tok_src[:] = -1

    def sync(self, firsts: Optional[torch.Tensor] = None) -> int:
        """Bring the device up to the mirror's changes: the whole mirror when
        ``dirty``, else the marked rows (``firsts``: the device buffer that
        :meth:`take_tok` indexes). Returns the host-to-device copies made."""
        if self.dirty:
            self.push()
            return 1
        if not self._rows.any():
            return 0
        self._merge(firsts)
        return 1


@dataclasses.dataclass
class DecodeSession:
    """Continuous-batching session: the KV cache, the packed slot state and
    host-side per-slot accounting; ``lengths`` is the host mirror of the
    device ``cache_index``; ``paged`` is the host half of the page pool
    (None on a contiguous slab)."""

    cache: KVCache
    slots: SlotState
    lengths: np.ndarray         # (max_batch,) tokens written per slot
    active: np.ndarray          # (max_batch,) slot in use
    paged: Optional[PagedKVCache] = None
    generation: int = 0
    adapters: Optional[AdapterPool] = None
    grammars: Optional[GrammarPool] = None


class FusedDecode:
    """``steps`` continuous-batching decode iterations for the whole slot
    pool over a :class:`CausalLM`'s device state — the counterpart of the
    JAX package's fused session program. On CUDA the body is captured once
    as a ``torch.cuda.CUDAGraph`` and each call is one replay; on the CPU
    each call runs the same body eagerly. A capture or replay error raises:
    nothing falls back to an eager loop.

    Each step of the body: the model forward on the slot tokens (the cache
    advances in place), counter-based Gumbel noise for every row
    (:func:`counter_gumbel` keyed by the slot's ``key`` at its ``count``),
    the :class:`SlotSampler` draw (greedy rows keep their argmax), the
    emission frozen to ``pad`` for rows done or inactive before the step,
    ``done`` latched on the row's ``eos`` entry (−1 disables) and when its
    next write would pass ``max_seq_len``. The forward reads each row's
    adapter slot; with grammars, the draw is masked by
    :func:`grammar_allowed`, live rows step ``gstate`` to ``next[grammar,
    gstate, token]`` and latch ``done`` on an accept-terminal landing (JAX
    ``causal_lm.py:744-767``); ``gstate`` stays on the device. It writes ``tok``, ``count`` and
    ``done`` back into the slot state (``length`` is the cache index), so a
    steady-state block needs no copy to the device, and leaves in
    :attr:`out` the (steps, b) emissions plus one row of per-slot flags
    (1 where every logit of the block was finite): one fetch a block."""

    def __init__(self, lm: "CausalLM", steps: int, slot_sampler: SlotSampler, pad: int):
        self.lm, self.steps, self.slot_sampler, self.pad = lm, int(steps), slot_sampler, int(pad)
        self.out = torch.zeros((self.steps + 1, lm.max_batch), dtype=torch.int32,
                               device=lm.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # launches one replay makes, per kernel wrapper (read at capture)
        self.launches_per_replay: Dict[str, int] = {}
        self.capture_s = 0.0
        self.replays = 0

    def _body(self) -> None:
        lm, st = self.lm, self.lm._slots
        cache = lm._cache
        f = st.dev_field
        active, greedy = f("active") != 0, f("greedy") != 0
        eos, temperature = f("eos"), f("temperature")
        key_lo, key_hi, count = f("key_lo"), f("key_hi"), f("count")
        done = f("done") != 0
        tok = f("tok")[:, None]
        finite = torch.ones_like(active)
        max_len = lm.config.max_seq_len
        adapter = f("adapter") if lm.lora else None
        tables = lm._grammar_tables
        if tables is not None:
            gidx, gstate, gbudget = f("grammar"), f("gstate"), f("budget")
            gactive, gl = gidx > 0, gidx.long()
        for i in range(self.steps):
            logits = lm._forward(tok, cache, adapter)[:, 0].float()
            finite = finite & torch.isfinite(logits).all(-1)
            allowed = (None if tables is None
                       else grammar_allowed(tables, gidx, gstate, gbudget, count))
            nxt = draw_rows(logits, key_lo, key_hi, count, temperature, greedy,
                            self.slot_sampler, allowed)
            done_before = done
            self.out[i] = torch.where(done | ~active, self.pad, nxt)
            done = done | (active & (eos >= 0) & (nxt == eos))
            if tables is not None:
                adv = gactive & active & ~done_before
                gstate = torch.where(adv, tables["next"][gl, gstate.long(), nxt.long()], gstate)
                done = done | (adv & tables["terminal"][gl, gstate.long()])
            count.add_(1)
            done = done | (active & (cache.cache_index + 1 >= max_len))
            tok = nxt[:, None]
        f("tok").copy_(tok[:, 0])
        f("done").copy_(done.to(torch.int32))
        if tables is not None:
            f("gstate").copy_(gstate)
        self.out[self.steps] = finite.to(torch.int32)

    def capture(self) -> None:
        """Warm the body up once on a side stream (loads every kernel
        module, the ctypes libraries included), then capture it. The
        warm-up decodes for real, so it runs only while no slot is live
        (its writes land in scratch pages or idle slab rows) and the slot
        state is restored from the host mirror after it."""
        lm = self.lm
        if lm._session is not None and lm._session.active.any():
            raise RuntimeError("capture the fused decode before inserting into the session: "
                               "its warm-up decodes every slot")
        t0 = time.perf_counter()
        torch.cuda.synchronize(lm.device)
        side = torch.cuda.Stream(lm.device)
        side.wait_stream(torch.cuda.current_stream(lm.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(lm.device).wait_stream(side)
        warmed = {fn: fn.launches for fn in _KERNEL_WRAPPERS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        torch.cuda.synchronize(lm.device)
        # a capture records launches but runs none: keep only the warm-up's
        self.launches_per_replay = {}
        for fn in _KERNEL_WRAPPERS:
            self.launches_per_replay[fn.__name__] = fn.launches - warmed[fn]
            fn.launches = warmed[fn]
        lm._slots.push()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self, session: DecodeSession) -> torch.Tensor:
        """Advance every slot ``steps`` tokens; returns :attr:`out` on the
        device (fetch it once)."""
        self.lm._check_session(session)
        session.slots.sync()
        if self.lm.device.type == "cuda":
            self.graph.replay()
            for fn in _KERNEL_WRAPPERS:   # the replay launched the captured kernels
                fn.launches += self.launches_per_replay.get(fn.__name__, 0)
        else:
            self._body()
        self.replays += 1
        session.lengths += self.steps
        return self.out


class CausalLM:
    """Bucketed, KV-cached, continuous-batching generation over a decoder
    model class with the :class:`LlamaForCausalLM` interface.

    ``params`` is a state dict (tensors or numpy arrays) in the model's
    naming; it is moved to ``device`` in the config's ``param_dtype``.
    ``device`` defaults to ``cuda`` and must be given as ``"cpu"`` to run
    on the CPU.

    ``lora_rank``/``lora_slots``/``lora_targets``: the adapter pool (slots
    default 8, slot 0 the identity). ``grammar_slots``/``grammar_states``/
    ``grammar_tokens``: the grammar pool over a token table (default
    :func:`default_token_table` of the vocabulary)."""

    def __init__(self, config, params: Mapping[str, Any], model_cls,
                 buckets=(128, 512, 2048), max_batch: int = 4,
                 page_size: Optional[int] = None, page_pool_pages: Optional[int] = None,
                 page_dtype: Optional[str] = None, paged_attn_kernel: bool = False,
                 prefix_cache: bool = True, lora_rank: Optional[int] = None,
                 lora_slots: int = 0, lora_targets: Optional[Sequence[str]] = None,
                 grammar_slots: int = 0, grammar_states: int = 64,
                 grammar_tokens: Optional[Sequence[str]] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = dataclasses.replace(config, decode=True)
        self.paged = bool(page_size)
        self.prefix_cache = bool(prefix_cache)
        if self.paged:
            if self.config.max_seq_len % page_size:
                raise ValueError(f"page_size {page_size} must divide max_seq_len "
                                 f"{self.config.max_seq_len}")
            pool = page_pool_pages or (
                max_batch * (self.config.max_seq_len // page_size) + max_batch)
            self.config = dataclasses.replace(
                self.config, page_size=int(page_size), page_pool_pages=int(pool),
                page_dtype=page_dtype, paged_attn_kernel=bool(paged_attn_kernel))
            page_storage_dtype(self.config)   # validates page_dtype
        elif paged_attn_kernel or page_dtype:
            raise ValueError("page_dtype / paged_attn_kernel require paged mode (pass page_size)")
        self.lora = bool(lora_rank)
        if self.lora:
            slots = int(lora_slots) if lora_slots else 8
            if slots < 2:
                raise ValueError(f"lora_slots must be >= 2 (slot 0 is the identity adapter), "
                                 f"got {slots}")
            over = dict(lora_rank=int(lora_rank), lora_slots=slots)
            if lora_targets:
                over["lora_targets"] = tuple(lora_targets)
            self.config = dataclasses.replace(self.config, **over)
        self.grammar = bool(grammar_slots)
        if self.grammar:
            if grammar_slots < 2:
                raise ValueError(f"grammar_slots must be >= 2 (slot 0 is the identity grammar), "
                                 f"got {grammar_slots}")
            if grammar_states < 2:
                raise ValueError(f"grammar_states must be >= 2, got {grammar_states}")
        self.grammar_slots = int(grammar_slots)
        self.grammar_states = int(grammar_states)
        self.grammar_tokens: Optional[tuple] = None
        if self.grammar:
            if grammar_tokens is None:
                grammar_tokens = default_token_table(config.vocab_size)
            if len(grammar_tokens) != config.vocab_size:
                raise ValueError(f"grammar_tokens has {len(grammar_tokens)} entries for "
                                 f"vocab_size {config.vocab_size}")
            self.grammar_tokens = tuple(grammar_tokens)
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(b for b in buckets if b <= self.config.max_seq_len))
        if not self.buckets:
            raise ValueError(f"no bucket fits max_seq_len {self.config.max_seq_len}")
        with torch.device("meta"):
            model = model_cls(self.config)
        dt = self.config.param_dtype
        state = {k: torch.as_tensor(v).to(device=self.device, dtype=dt)
                 for k, v in params.items()}
        model.load_state_dict(state, strict=True, assign=True)
        if self.lora:   # the pool is no weight: allocated here, zeroed per session
            model.model.lora_pool = torch.zeros(model.model.lora_pool.shape, dtype=torch.float32,
                                                device=self.device)
        self.model = model.eval().requires_grad_(False)
        # device state, made at the first start_session
        self._cache: Optional[KVCache] = None
        self._slots: Optional[SlotState] = None
        self._grammar_tables: Optional[Dict[str, torch.Tensor]] = None
        self._session: Optional[DecodeSession] = None
        self._generation = 0
        self._fused: Dict[tuple, FusedDecode] = {}
        # wall ms of each captured program (warm-up + capture), by signature
        self.capture_ms: Dict[str, float] = {}

    # --- helpers ---------------------------------------------------------

    def _bucket_for(self, s: int) -> int:
        for b in self.buckets:
            if s <= b:
                return b
        raise ValueError(f"prompt length {s} exceeds largest bucket {self.buckets[-1]}")

    def _ids(self, a, dtype=torch.int32) -> torch.Tensor:
        """Host values on the device (int32 by default). On CUDA the copy
        leaves from a fresh pinned buffer without waiting for the device
        (PyTorch's host allocator keeps the buffer until the copy has run),
        so a call made while a decode block runs does not wait for it."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _forward(self, ids: torch.Tensor, cache: KVCache,
                 adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The model on ``ids``; ``adapter_idx`` (rows,) the rows' adapter
        slots (None: the identity)."""
        if self.lora:
            self.model.model.adapter_idx = adapter_idx
        # no_grad rather than inference_mode: the cache tensors made here
        # are updated in place by later calls outside any such mode
        with torch.no_grad():
            return self.model(ids, cache)

    def _adapter_rows(self, adapter_slots, rows: int) -> Optional[torch.Tensor]:
        if not self.lora or adapter_slots is None:
            return None
        slots = np.asarray(adapter_slots, np.int32).reshape(-1)
        if slots.shape != (rows,):
            raise ValueError(f"{slots.size} adapter slots for {rows} rows")
        return self._ids(slots)

    def kv_cache_bytes(self) -> int:
        """Bytes of the session KV pools (every layer, K and V; paged: the
        sink page and the int8 scales included)."""
        cfg = self.config
        hd, n_kv = cfg.head_dim_, cfg.num_kv_heads
        if not self.paged:
            elems = self.max_batch * cfg.max_seq_len * n_kv * hd
            return 2 * cfg.num_layers * elems * torch.empty((), dtype=cfg.dtype).element_size()
        pages = cfg.page_pool_pages + 1
        dtype = page_storage_dtype(cfg)
        per_layer = pages * cfg.page_size * n_kv * hd * torch.empty((), dtype=dtype).element_size()
        if dtype == torch.int8:
            per_layer += pages * n_kv * 4
        return 2 * cfg.num_layers * per_layer

    # --- device state ----------------------------------------------------

    def _device_state(self) -> None:
        """Allocate the KV pools and the slot state once; every session and
        every captured graph of this ``CausalLM`` uses these buffers."""
        if self._cache is not None:
            return
        cfg = self.config
        cols = cfg.max_seq_len // cfg.page_size if self.paged else 0
        self._slots = SlotState(self.max_batch, cols, self.device)
        self._cache = self.model.new_cache(
            self.max_batch, self.device, cache_index=self._slots.dev_field("length"),
            block_table=self._slots.dev_table if self.paged else None)
        if self.grammar:
            self._grammar_tables = grammar_tables(self.grammar_slots, self.grammar_states,
                                                  self.config.vocab_size, self.device)
            self._slots.grammar_tables = self._grammar_tables

    def _check_session(self, session: DecodeSession) -> None:
        if session.generation != self._generation:
            raise RuntimeError("this session was replaced by a later start_session(): a "
                               "CausalLM keeps one live session on its device buffers")

    # --- continuous batching (slot-level session API) --------------------

    def start_session(self) -> DecodeSession:
        """Fresh decode session (all slots free): zeroed pools and slot
        state. Any earlier session of this ``CausalLM`` ends here."""
        self._device_state()
        self._generation += 1
        for pools in (self._cache.keys, self._cache.values, self._cache.k_scales or [],
                      self._cache.v_scales or []):
            for t in pools:
                t.zero_()
        st = self._slots
        st.host[:] = 0
        st.host_field("eos")[:] = -1
        session = DecodeSession(cache=self._cache, slots=st, lengths=st.host_field("length"),
                                active=np.zeros((self.max_batch,), bool),
                                generation=self._generation)
        if self.paged:
            session.paged = PagedKVCache(
                self.config.page_size, self.config.page_pool_pages, self.max_batch,
                self.config.max_seq_len, prefix_cache=self.prefix_cache)
            st.host_table[:] = session.paged.tables
        st.push()
        if self.lora:
            self.model.model.lora_pool.zero_()
            session.adapters = self.new_adapter_pool()
        if self.grammar:
            reset_grammar_tables(self._grammar_tables)
            session.grammars = self.new_grammar_pool()
        self._session = session
        return session

    def new_adapter_pool(self) -> AdapterPool:
        """Adapter-pool bookkeeping over this ``CausalLM``'s pool buffer
        (one per session; :meth:`start_session` makes it)."""
        if not self.lora:
            raise ValueError("CausalLM was built without lora_rank")
        return AdapterPool(self.model.model.lora_pool, self.model.model.lora_layout)

    def new_grammar_pool(self) -> GrammarPool:
        """Grammar-pool bookkeeping over this ``CausalLM``'s tables (one per
        session; :meth:`start_session` makes it)."""
        if not self.grammar:
            raise ValueError("CausalLM was built without grammar_slots")
        self._device_state()
        return GrammarPool(self.grammar_slots, self.grammar_states, self.grammar_tokens,
                           tables=self._grammar_tables)

    def _set_block_tables(self, session: DecodeSession, slot_ids: np.ndarray) -> None:
        """Mirror these slots' host tables; the device copy rides the next
        sync (with their other fields)."""
        session.slots.host_table[slot_ids] = session.paged.tables[slot_ids]
        session.slots.mark_rows(slot_ids)

    def _check_slots(self, slot_ids: np.ndarray) -> None:
        if len(slot_ids) == 0:
            raise ValueError("empty slot_ids")
        if len(np.unique(slot_ids)) != len(slot_ids):
            raise ValueError(f"duplicate slot ids {slot_ids.tolist()}")
        if (slot_ids < 0).any() or (slot_ids >= self.max_batch).any():
            raise ValueError(f"slot ids {slot_ids.tolist()} out of range [0, {self.max_batch})")

    def insert(self, session: DecodeSession, slot_ids, prompt_ids: np.ndarray,
               lengths: Optional[np.ndarray] = None, pad_token_id: int = 0,
               reserve_tokens: Optional[Any] = None,
               ns: Optional[Sequence[Optional[str]]] = None,
               adapter_slots=None) -> torch.Tensor:
        """Prefill ``slot_ids`` with new prompts; every other slot's cache
        rows and lengths are preserved. Right-sized: only the inserted rows
        are prefilled, at their own batch width. ``adapter_slots``: each
        row's adapter-pool slot (None: the identity); ``ns``: each row's
        prefix-index namespace (its adapter). Returns the next-token logits
        ``(len(slot_ids), vocab)``."""
        self._check_session(session)
        slot_ids = np.asarray(slot_ids, np.int32)
        self._check_slots(slot_ids)
        b, s = prompt_ids.shape
        if b != len(slot_ids):
            raise ValueError(f"{b} prompts for {len(slot_ids)} slots")
        if lengths is None:
            lengths = infer_prompt_lengths(prompt_ids, pad_token_id)
        lengths = np.maximum(np.asarray(lengths, np.int32), 1)
        if int(lengths.max()) >= self.config.max_seq_len:
            raise ValueError(f"prompt length {int(lengths.max())} leaves no decode room in "
                             f"max_seq_len {self.config.max_seq_len}")
        aidx = self._adapter_rows(adapter_slots, len(slot_ids))
        if self.paged:
            return self._insert_paged(session, slot_ids, prompt_ids, lengths,
                                      reserve_tokens, ns=ns, aidx=aidx)
        bucket = self._bucket_for(s)
        rows = len(slot_ids)
        ids = np.zeros((rows, bucket), np.int32)
        ids[:, :s] = prompt_ids
        # prefill into a fresh zero slab at the rows' own width, then copy the
        # whole rows into the session slab (stale tails of the slots' earlier
        # requests are overwritten, as the JAX scatter does)
        fresh = self.model.new_cache(rows, self.device)
        logits = self._forward(self._ids(ids), fresh, aidx)
        dst = self._ids(slot_ids, torch.long)
        cache = session.cache
        for layer in range(self.config.num_layers):
            cache.keys[layer].index_copy_(0, dst, fresh.keys[layer])
            cache.values[layer].index_copy_(0, dst, fresh.values[layer])
        cache.cache_index.index_copy_(0, dst, self._ids(lengths))
        session.lengths[slot_ids] = lengths
        session.active[slot_ids] = True
        last = self._ids(np.maximum(lengths - 1, 0), torch.long)
        return logits[torch.arange(rows, device=self.device), last]

    def _insert_paged(self, session: DecodeSession, slot_ids: np.ndarray,
                      prompt_ids: np.ndarray, lengths: np.ndarray, reserve_tokens,
                      ns: Optional[Sequence[Optional[str]]] = None,
                      aidx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Paged admission: per-row prefix lookup and page allocation on the
        host, then one suffix-width prefill that writes the pool in place
        through the rows' block tables. Raises :class:`PagePoolExhausted`
        before any device work when the pool cannot cover the group."""
        pkv = session.paged
        rows = len(slot_ids)
        if reserve_tokens is None:
            totals = np.full((rows,), self.config.max_seq_len, np.int64)
        else:
            totals = lengths.astype(np.int64) + np.broadcast_to(
                np.asarray(reserve_tokens, np.int64), (rows,))
        nss = list(ns) if ns is not None else [None] * rows
        plans = []
        try:
            for i in range(rows):
                plans.append(pkv.plan(prompt_ids[i, : lengths[i]].tolist(), int(totals[i]),
                                      ns=nss[i]))
        except Exception:
            for p in plans:
                pkv.rollback(p)
            raise
        starts = np.asarray([p.start for p in plans], np.int32)
        suffix = lengths - starts
        bucket = self._bucket_for(int(suffix.max()))
        ids = np.zeros((rows, bucket), np.int32)
        for i in range(rows):
            ids[i, : suffix[i]] = prompt_ids[i, starts[i]: lengths[i]]
        tables = np.stack([pkv.table_for(int(slot_ids[i]), plans[i]) for i in range(rows)])
        view = session.cache.rows(self._ids(starts), self._ids(tables))
        try:
            logits = self._forward(self._ids(ids), view, aidx)
        except Exception:
            for p in plans:
                pkv.rollback(p)
            raise
        for i in range(rows):
            pkv.commit(int(slot_ids[i]), plans[i], prompt_ids[i, : lengths[i]].tolist(),
                       ns=nss[i])
        dst = self._ids(slot_ids, torch.long)
        session.cache.cache_index.index_copy_(0, dst, self._ids(lengths))
        session.cache.block_table.index_copy_(0, dst, self._ids(tables))
        session.slots.host_table[slot_ids] = tables
        session.lengths[slot_ids] = lengths
        session.active[slot_ids] = True
        last = self._ids(np.maximum(suffix - 1, 0), torch.long)
        return logits[torch.arange(rows, device=self.device), last]

    def extend(self, session: DecodeSession, slot_ids, chunk_ids: np.ndarray,
               lengths: np.ndarray, starts: np.ndarray,
               tables: Optional[np.ndarray] = None, adapter_slots=None) -> torch.Tensor:
        """Chunked-prefill extension (JAX ``causal_lm.py:1121``): write
        ``lengths[i]`` prompt tokens of row i at positions ``starts[i] ..
        starts[i] + lengths[i]``, attending over what the slot holds below
        ``starts[i]``. The chunk is padded to its bucket; the pad tail's
        writes land past the covered length, behind the position mask, as a
        one-shot insert's pads do. Returns the logits at each row's last real
        chunk token (the next-token logits on a request's final chunk).

        Paged: the forward runs through the caller's ``tables`` (every page
        written so far, scratch beyond), the paged insert's route; the
        slot's device block table is left as it is (scratch until the
        admission commits), so decode blocks run between chunks write the
        idle row into its scratch page. int8 pages: a chunk starting inside
        a page requantizes that page's window, as the insert does. Slab:
        the rows are gathered, extended and scattered back (JAX
        ``_chunk_extend_programs``, ``:1054``). Either way the slot's
        ``cache_index`` becomes ``starts + lengths``, so an idle row's
        decode writes land at or past what the chunks have covered. Runs
        eagerly; it rebinds nothing a captured block reads. The chunk runs
        under the rows' ``adapter_slots`` (the KV it writes is theirs)."""
        self._check_session(session)
        slot_ids = np.asarray(slot_ids, np.int32)
        self._check_slots(slot_ids)
        rows, s = chunk_ids.shape
        if rows != len(slot_ids):
            raise ValueError(f"{rows} chunks for {len(slot_ids)} slots")
        lengths = np.asarray(lengths, np.int32)
        starts = np.asarray(starts, np.int32)
        if (lengths < 1).any():
            raise ValueError(f"empty chunk in {lengths.tolist()}")
        new_len = starts + lengths
        if int(new_len.max()) >= self.config.max_seq_len:
            raise ValueError(f"chunk end {int(new_len.max())} leaves no decode room in "
                             f"max_seq_len {self.config.max_seq_len}")
        bucket = self._bucket_for(s)
        ids = np.zeros((rows, bucket), np.int32)
        ids[:, :s] = chunk_ids
        dst = self._ids(slot_ids, torch.long)
        cache = session.cache
        aidx = self._adapter_rows(adapter_slots, rows)
        if self.paged:
            if tables is None:
                raise ValueError("paged extend needs per-row block tables")
            logits = self._forward(self._ids(ids), cache.rows(self._ids(starts),
                                                              self._ids(tables)), aidx)
        else:
            view = cache.rows(self._ids(starts))
            view.keys = [t.index_select(0, dst) for t in cache.keys]
            view.values = [t.index_select(0, dst) for t in cache.values]
            logits = self._forward(self._ids(ids), view, aidx)
            for layer in range(self.config.num_layers):
                cache.keys[layer].index_copy_(0, dst, view.keys[layer])
                cache.values[layer].index_copy_(0, dst, view.values[layer])
        cache.cache_index.index_copy_(0, dst, self._ids(new_len))
        session.lengths[slot_ids] = new_len
        last = self._ids(np.maximum(lengths - 1, 0), torch.long)
        return logits[torch.arange(rows, device=self.device), last]

    def _decode_step(self, session: DecodeSession, tok: torch.Tensor) -> torch.Tensor:
        """One single-token forward for every slot (inactive slots advance
        harmlessly); ``tok`` (max_batch, 1) int32 on the device."""
        self._check_session(session)
        session.slots.sync()
        logits = self._forward(tok, session.cache,
                               session.slots.dev_field("adapter") if self.lora else None)
        session.lengths += 1
        return logits[:, 0]

    def step(self, session: DecodeSession, tokens) -> torch.Tensor:
        """One decode step for all slots; raises without mutating anything
        when an active slot would write past ``max_seq_len``."""
        over = session.active & (session.lengths + 1 >= self.config.max_seq_len)
        if over.any():
            raise ValueError(f"slots {np.nonzero(over)[0].tolist()} exhausted max_seq_len "
                             f"{self.config.max_seq_len}: re-insert or retire them")
        return self._decode_step(session, self._ids(tokens).reshape(-1, 1))

    def compile_session_decode_fused(self, steps: int,
                                     slot_sampler: Optional[SlotSampler] = None,
                                     pad_token_id: int = 0) -> FusedDecode:
        """The ``steps``-token continuous-batching block as one program
        (:class:`FusedDecode`), cached per ``(steps, slot_sampler, pad)``.
        On CUDA it is captured here — warm-up and capture timed into
        ``capture_ms`` — so call it before inserting into the session (a
        ``ServeEngine`` does so when it is built)."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        slot_sampler = slot_sampler or SlotSampler()
        key = (steps, slot_sampler, pad_token_id)
        runner = self._fused.get(key)
        if runner is None:
            self._device_state()
            runner = FusedDecode(self, steps, slot_sampler, pad_token_id)
            if self.device.type == "cuda":
                runner.capture()
                self.capture_ms[f"session_fused_k{steps}"] = round(runner.capture_s * 1e3, 2)
            self._fused[key] = runner
        return runner

    def compile_decode_fused(self, steps: int, top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             pad_token_id: int = 0) -> FusedDecode:
        """The ``steps``-token block of :meth:`generate` (``fused_chunk``):
        the session program for ``top_k``/``top_p``. Unlike the JAX
        package's, it builds in no temperature, greedy flag or EOS id: those
        are per-slot state that ``generate`` loads before the block, so one
        graph serves every value of them."""
        return self.compile_session_decode_fused(
            steps, SlotSampler(top_k=top_k, top_p=top_p), pad_token_id)

    def retire(self, session: DecodeSession, slot_ids) -> None:
        """Mark slots idle; in paged mode return their pages and point their
        tables back at scratch (on the device at the next sync). Idempotent
        and empty-safe."""
        self._check_session(session)
        slot_ids = np.asarray(slot_ids, np.int32).reshape(-1)
        if len(slot_ids) == 0:
            return
        if (slot_ids < 0).any() or (slot_ids >= self.max_batch).any():
            raise ValueError(f"slot ids {slot_ids.tolist()} out of range [0, {self.max_batch})")
        session.active[slot_ids] = False
        if self.paged and session.paged is not None:
            for slot in slot_ids:
                session.paged.release(int(slot))
            self._set_block_tables(session, slot_ids)

    # --- generation ------------------------------------------------------

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 sampler: Optional[Sampler] = None, eos_token_id: Optional[int] = None,
                 seed: int = 0, lengths: Optional[np.ndarray] = None,
                 pad_token_id: int = 0, fused_chunk: int = 0) -> GenerationResult:
        """Batched generate on the contiguous slot path: prefill the prompts
        into slots 0..b-1, then decode. ``prompt_ids`` (b, s) right-padded
        with ``pad_token_id``. Row r's t-th token draws its noise from
        ``counter_gumbel`` under ``request_seed(seed, r)``.

        ``fused_chunk > 1`` decodes in ``fused_chunk``-token blocks through
        :meth:`compile_decode_fused` (one replay and one fetch a block on
        CUDA), with one shorter block for the tail; the tokens equal the
        stepwise path's."""
        if self.paged:
            raise ValueError("generate() runs the contiguous-slot path; a paged CausalLM "
                             "serves through sessions (insert/step) or ServeEngine")
        sampler = sampler or Sampler(greedy=True)
        b, s = prompt_ids.shape
        mb = self.max_batch
        if b > mb:
            raise ValueError(f"batch {b} exceeds max_batch {mb}")
        if lengths is None:
            lengths = infer_prompt_lengths(prompt_ids, pad_token_id)
        lengths = np.maximum(np.asarray(lengths, np.int32), 1)
        if int(lengths.max()) + max_new_tokens > self.config.max_seq_len:
            raise ValueError(f"prompt ({int(lengths.max())}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds max_seq_len "
                             f"{self.config.max_seq_len}")
        session = self.start_session()
        chunk = int(fused_chunk) if fused_chunk and fused_chunk > 1 else 0
        fused = {}
        if chunk:   # captured before the insert: the warm-up decodes every slot
            tail = (max_new_tokens - 1) % chunk
            for k in {min(chunk, max_new_tokens - 1), tail} - {0, 1}:
                fused[k] = self.compile_decode_fused(k, sampler.top_k, sampler.top_p,
                                                     pad_token_id)
        logits = self.insert(session, np.arange(b), prompt_ids, lengths=lengths)
        greedy = bool(sampler.greedy or sampler.temperature == 0.0)
        st = session.slots
        keys = [split_key(request_seed(seed, r)) for r in range(mb)]
        st.host_field("key_lo")[:] = [k[0] for k in keys]
        st.host_field("key_hi")[:] = [k[1] for k in keys]
        st.host_field("temperature")[:] = 0.0 if greedy else sampler.temperature
        st.host_field("greedy")[:] = int(greedy)
        st.host_field("eos")[:] = -1 if eos_token_id is None else eos_token_id
        st.host_field("active")[:b] = 1
        st.dirty = True
        slot_sampler = SlotSampler(top_k=sampler.top_k, top_p=sampler.top_p)
        f = st.dev_field

        def draw(step_logits: torch.Tensor, t: int) -> np.ndarray:
            """Row tokens of a stepwise draw: the fused body's math."""
            n = step_logits.shape[0]
            counts = torch.full((n,), t, dtype=torch.int32, device=self.device)
            return draw_rows(step_logits, f("key_lo")[:n], f("key_hi")[:n], counts,
                             f("temperature")[:n], f("greedy")[:n] != 0,
                             slot_sampler).cpu().numpy()

        st.sync()
        out = np.zeros((b, max_new_tokens), np.int64)
        gen_len = np.zeros((b,), np.int32)
        done = np.zeros((b,), bool)

        def record(tok_np: np.ndarray, t: int) -> bool:
            nonlocal done, gen_len
            out[:, t] = np.where(done, pad_token_id, tok_np[:b])
            gen_len = np.where(done, gen_len, gen_len + 1)
            if eos_token_id is not None:
                done = done | (tok_np[:b] == eos_token_id)
            return bool(done.all())

        tok = np.zeros((mb,), np.int32)
        tok[:b] = draw(logits, 0)
        finished = record(tok, 0)
        t = 1
        while t < max_new_tokens and not finished:
            k = min(chunk, max_new_tokens - t) if chunk else 1
            if k > 1:
                st.host_field("tok")[:] = tok
                st.host_field("count")[:] = t
                st.host_field("done")[:b] = done
                st.dirty = True
                toks = fused[k](session).cpu().numpy()[:k]
                for row in toks:
                    finished = record(row, t)
                    t += 1
                    if finished:
                        break
                tok = toks[-1].astype(np.int32)
                continue
            step_logits = self.step(session, tok)
            tok = np.zeros((mb,), np.int32)
            tok[:b] = draw(step_logits[:b], t)
            finished = record(tok, t)
            t += 1
        return GenerationResult(tokens=out, lengths=gen_len)
