"""Causal-LM serving runtime: bucketed prefill into a slot pool, per-slot
decode, and generation.

Counterpart of ``neuronx_distributed_tpu/inference/causal_lm.py``. The KV
cache is a fixed pool of ``max_batch`` slots with per-slot lengths;
``insert`` prefills chosen slots while the others keep decoding. In paged
mode (``page_size``) the slots resolve through block tables into a shared
page pool, with radix prefix reuse: a prefix hit prefills only the suffix.

Where the JAX package compiles a program per shape, this runtime runs a
:class:`~neuronx_distributed_tpu_torch.inference.model_builder.CapturedProgram`
per shape, under the JAX package's signature names: on CUDA one
``torch.cuda.CUDAGraph``, captured at the first call with that shape (its
warm-up is that call) and replayed after, on the CPU the eager body. The
programs: ``decode`` (one step of every slot), ``prefill_b{bucket}`` and
``insert_prefill_r{rows}_b{bucket}`` (slab inserts at ``max_batch`` rows
and fewer), ``paged_insert_r{rows}_b{bucket}`` (paged inserts and paged
chunk extends), ``chunk_extend_r{rows}_b{bucket}`` (slab chunk extends),
and the K-step fused decode block ``session_fused_k{K}``
(:meth:`CausalLM.compile_session_decode_fused`, the counterpart of the
jitted scan). Each first call's wall time lands in ``capture_ms`` and, with
a tracer attached, as a ``compile:<signature>`` span on the ``("engine",
"compile")`` lane. Host-side planning (page plans, commits, rollbacks)
stays outside the programs. An insert or extend program computes the head
at each row's last real token only, not over the whole bucket.
``capture_programs=False`` runs the same bodies eagerly on CUDA (the route
the captured one is held against).

Sessions are independent (JAX ``causal_lm.py:888-891``): the weights live
once on the ``CausalLM``, and every mutable device buffer belongs to a
:class:`SessionState` that one session holds at a time — the KV pools, a
:class:`SlotState` that packs the per-slot decode state with the block
tables, the grammar tables and the adapter pool. A graph is bound to the
addresses it was captured over, so the programs live on that state too,
each captured at its first call with it, in the state's own graph pool
(each program's static inputs and outputs lie outside it). Several
sessions of one ``CausalLM`` run side by side, one engine each (a router's
replicas); N live sessions cost N states and N sets of captures.
:meth:`DecodeSession.close` (or dropping the session) hands its state
back: the ``CausalLM`` keeps one such spare, reset in place and with its
programs, for the next :meth:`CausalLM.start_session` (``spare_states``
of them), and frees the others.

Tenants (JAX ``causal_lm.py:253-298``): ``lora_rank`` gives the model a
pool of adapter slots (``inference/adapters.py``) that every forward reads
per row, and ``grammar_slots`` a pool of grammar tables
(``inference/grammar.py``) that every draw of the fused block and of the
engine's first tokens masks with. Both pools are device buffers of a
session's state, written in place, so one captured block serves every mix
of adapters and grammars; each session gets fresh pool bookkeeping over
them (:meth:`CausalLM.new_adapter_pool`, :meth:`CausalLM.new_grammar_pool`).

Tensor parallelism (JAX ``causal_lm.py:395-399``, ``:813-879``): built
with a ``tp_group`` (or under ``parallel.mesh.initialize_model_parallel``,
whose TP group it takes), the model holds the rank's weight shards and
every program gathers the vocab-sharded logits before they leave it, so
every rank draws the same ``counter_gumbel`` noise over the same full
logits and picks the same token. A session's KV pools hold the rank's KV
heads, its adapter pool the rank's slices and its grammar tables the
rank's vocabulary columns (``inference/partition.py``): a grammar's mask
is computed on those columns and gathered beside the logits, and a DFA
transition is looked up on the rank that holds the token's column and
all-reduced (:meth:`CausalLM.grammar_next`). Every rank runs the same host
schedule. A gloo group's collectives cannot be captured in a CUDA graph:
on the card such a group needs ``capture_programs=False`` (and an engine
with ``fused=False``), and anything else raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import time
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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
from neuronx_distributed_tpu_torch.inference.model_builder import CapturedProgram
from neuronx_distributed_tpu_torch.inference.paged_cache import PagedKVCache
from neuronx_distributed_tpu_torch.inference.partition import (
    leaf_partition_spec,
    local_shape,
    sharded_dim,
    sharded_fraction,
)
from neuronx_distributed_tpu_torch.inference.sampling import (
    Sampler,
    SlotSampler,
    draw_rows,
    request_seed,
    split_key,
)
from neuronx_distributed_tpu_torch.models.llama import KVCache, page_storage_dtype
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.layers import adopt_quantized
from neuronx_distributed_tpu_torch.parallel.mappings import (
    all_reduce,
    gather_from_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.quantization.core import quantized_names

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
    # speculation and Medusa attach their per-run metrics (JAX's keys)
    stats: Optional[dict] = None


def percentile_ms(ts, q) -> Optional[float]:
    """q-th percentile of second timings, in ms (None when empty)."""
    return round(float(np.percentile(np.asarray(ts) * 1e3, q)), 2) if ts else None


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
        self.grammar_next = None   # CausalLM.grammar_next over grammar_tables
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
                gs.copy_(torch.where(adv, self.grammar_next(t, g, gs, tok), gs))
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


class SessionState:
    """The device state one session owns: the KV pools, the packed
    :class:`SlotState`, the grammar tables and the adapter pool, and what
    is bound to their addresses — the programs by signature (``programs``,
    the fused blocks in ``fused``), their graph pool, the slab inserts'
    fresh caches and ``capture_ms``, each program's first-call wall ms by
    signature. ``tracer`` takes the compile spans of its captures (the
    engine's that holds the session). ``index`` numbers the states of one
    ``CausalLM`` in allocation order."""

    def __init__(self, lm: "CausalLM", index: int):
        cfg = lm.config
        self.index = index
        cols = cfg.max_seq_len // cfg.page_size if lm.paged else 0
        self.slots = SlotState(lm.max_batch, cols, lm.device)
        self.cache = lm.model.new_cache(
            lm.max_batch, lm.device, cache_index=self.slots.dev_field("length"),
            block_table=self.slots.dev_table if lm.paged else None)
        self.grammar_tables: Optional[Dict[str, torch.Tensor]] = None
        if lm.grammar:
            self.grammar_tables = grammar_tables(lm.grammar_slots, lm.grammar_states,
                                                 lm.grammar_vocab[1] - lm.grammar_vocab[0],
                                                 lm.device)
            self.slots.grammar_tables = self.grammar_tables
            self.slots.grammar_next = lm.grammar_next
        self.lora_pool: Optional[torch.Tensor] = None
        if lm.lora:
            self.lora_pool = torch.zeros(lm._lora_shape, dtype=torch.float32, device=lm.device)
        self.programs: Dict[str, CapturedProgram] = {}
        self.fused: Dict[tuple, "FusedDecode"] = {}
        self.fresh: Dict[int, KVCache] = {}
        self.pool = None
        self.capture_ms: Dict[str, float] = {}
        self.compiled = False
        self.tracer = None
        self.extras: Dict[str, Any] = {}
        self.session: Optional[weakref.ref] = None

    def graph_pool(self):
        """The graph pool every captured program of this state shares (one
        program runs at a time)."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def holder(self) -> Optional["DecodeSession"]:
        """The live session holding this state, if any."""
        s = self.session() if self.session is not None else None
        return s if s is not None and s.state is self else None

    def free(self) -> None:
        """Drop every buffer and program (their device memory goes once
        nothing else holds them)."""
        self.programs.clear()
        self.fused.clear()
        self.fresh.clear()
        self.extras.clear()
        self.cache = self.slots = self.grammar_tables = self.lora_pool = self.pool = None


@dataclasses.dataclass
class DecodeSession:
    """Continuous-batching session: the KV cache, the packed slot state and
    host-side per-slot accounting; ``lengths`` is the host mirror of the
    device ``cache_index``; ``paged`` is the host half of the page pool
    (None on a contiguous slab); ``state`` the device state it holds (None
    once closed). Sessions of one ``CausalLM`` are independent."""

    cache: KVCache
    slots: SlotState
    lengths: np.ndarray         # (max_batch,) tokens written per slot
    active: np.ndarray          # (max_batch,) slot in use
    paged: Optional[PagedKVCache] = None
    adapters: Optional[AdapterPool] = None
    grammars: Optional[GrammarPool] = None
    state: Optional[SessionState] = dataclasses.field(default=None, repr=False)
    _release: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def capture_ms(self) -> Dict[str, float]:
        """This session's programs' first-call wall ms by signature."""
        return self.state.capture_ms if self.state is not None else {}

    def close(self) -> None:
        """End the session: its device state goes back to the ``CausalLM``
        (kept as the spare, or freed). Using the session after raises.
        Idempotent."""
        if self._release is not None:
            self._release()


class FusedDecode:
    """``steps`` continuous-batching decode iterations for the whole slot
    pool over one session's device state — the counterpart of the
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

    def __init__(self, lm: "CausalLM", state: SessionState, steps: int,
                 slot_sampler: SlotSampler, pad: int):
        self.lm, self.state = lm, state
        self.steps, self.slot_sampler, self.pad = int(steps), slot_sampler, int(pad)
        self.out = torch.zeros((self.steps + 1, lm.max_batch), dtype=torch.int32,
                               device=lm.device)
        self.program: Optional[CapturedProgram] = None
        self.capture_s = 0.0
        self.replays = 0

    @property
    def launches_per_replay(self) -> Dict[str, int]:
        """Launches one replay makes, per kernel wrapper (read at capture)."""
        return self.program.launches_per_replay if self.program is not None else {}

    def _body(self) -> None:
        lm, state = self.lm, self.state
        st, cache = state.slots, state.cache
        f = st.dev_field
        active, greedy = f("active") != 0, f("greedy") != 0
        eos, temperature = f("eos"), f("temperature")
        key_lo, key_hi, count = f("key_lo"), f("key_hi"), f("count")
        done = f("done") != 0
        tok = f("tok")[:, None]
        finite = torch.ones_like(active)
        max_len = lm.config.max_seq_len
        adapter = f("adapter") if lm.lora else None
        tables = state.grammar_tables
        if tables is not None:
            gidx, gstate, gbudget = f("grammar"), f("gstate"), f("budget")
            gactive, gl = gidx > 0, gidx.long()
        for i in range(self.steps):
            logits = lm._forward(tok, cache, adapter, state)[:, 0].float()
            finite = finite & torch.isfinite(logits).all(-1)
            allowed = (None if tables is None
                       else lm.grammar_allowed(tables, gidx, gstate, gbudget, count))
            nxt = draw_rows(logits, key_lo, key_hi, count, temperature, greedy,
                            self.slot_sampler, allowed)
            done_before = done
            self.out[i] = torch.where(done | ~active, self.pad, nxt)
            done = done | (active & (eos >= 0) & (nxt == eos))
            if tables is not None:
                adv = gactive & active & ~done_before
                gstate = torch.where(adv, lm.grammar_next(tables, gl, gstate, nxt), gstate)
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
        warm-up decodes for real, so it runs only while no slot of its own
        session is live (its writes land in that session's scratch pages or
        idle slab rows; other sessions may be live) and the slot state is
        restored from the host mirror after it."""
        lm, state = self.lm, self.state
        holder = state.holder()
        if holder is not None and holder.active.any():
            raise RuntimeError("capture the fused decode before inserting into the session: "
                               "its warm-up decodes every slot")
        t0 = time.perf_counter()
        self.program = CapturedProgram(self._body, lm.device, state.graph_pool(),
                                       name=f"session_fused_k{self.steps}")
        self.program.capture()
        torch.cuda.synchronize(lm.device)
        state.slots.push()
        self.capture_s = time.perf_counter() - t0

    def __call__(self, session: DecodeSession) -> torch.Tensor:
        """Advance every slot ``steps`` tokens; returns :attr:`out` on the
        device (fetch it once)."""
        self.lm._check_session(session)
        if session.state is not self.state:
            raise RuntimeError("this fused block was built for another session's state")
        session.slots.sync()
        if self.program is not None:
            self.program.replay()
        else:
            self._body()
        self.replays += 1
        session.lengths += self.steps
        return self.out


class CausalLM:
    """Bucketed, KV-cached, continuous-batching generation over a decoder
    model class with the :class:`LlamaForCausalLM` interface.

    ``params`` is a state dict (tensors or numpy arrays) in the model's
    naming; it is moved to ``device`` in each weight's storage dtype (the
    config's ``param_dtype``). An int8 tree (``quantization.core``
    ``quantize_params``: ``X.qweight`` int8 and ``X.scale`` fp32 pairs)
    serves as it is: its pairs keep their dtypes, the model holds them as
    ``QuantizedKernel``s and every product with them runs through B5, the
    W8A16 GEMM. Tensors already on the device in their dtype are used as
    they are, so a tree larger than half the card loads without a copy.
    ``param_transform`` (JAX's contract): a function of the tree returning
    the model's float state dict, applied inside every forward of every
    program (the model itself stays on the meta device); a route for the
    CPU tests, since on the card it would hold the transformed tree too.
    ``device`` defaults to ``cuda`` and must be given as ``"cpu"`` to run
    on the CPU.

    ``lora_rank``/``lora_slots``/``lora_targets``: the adapter pool (slots
    default 8, slot 0 the identity). ``grammar_slots``/``grammar_states``/
    ``grammar_tokens``: the grammar pool over a token table (default
    :func:`default_token_table` of the vocabulary). ``capture_programs``
    (an attribute too): on CUDA, run the decode, prefill, insert and extend
    forwards as captured programs (default) or eagerly; the CPU runs them
    eagerly either way. ``spare_states`` (an attribute too): how many
    states of ended sessions the ``CausalLM`` keeps, programs and all, for
    later sessions to take over (each a session's device memory; the rest
    are freed).

    ``tp_group``: the tensor-parallel group (default: the current
    ``parallel.mesh`` state's, when one is initialized; else none). Under
    it ``params`` is the rank's shard (``init_params(tp_rank=, tp_size=)``,
    ``llama_params_from_jax(tp_rank=, tp_size=)``). int8 weights, Mixtral
    and speculation are refused at a degree above 1."""

    def __init__(self, config, params: Mapping[str, Any], model_cls,
                 buckets=(128, 512, 2048), max_batch: int = 4,
                 page_size: Optional[int] = None, page_pool_pages: Optional[int] = None,
                 page_dtype: Optional[str] = None, paged_attn_kernel: bool = False,
                 prefix_cache: bool = True, lora_rank: Optional[int] = None,
                 lora_slots: int = 0, lora_targets: Optional[Sequence[str]] = None,
                 grammar_slots: int = 0, grammar_states: int = 64,
                 grammar_tokens: Optional[Sequence[str]] = None,
                 capture_programs: bool = True, param_transform=None,
                 spare_states: int = 1, device: DeviceLike = None, tp_group=None):
        self.device = resolve_device(device)
        self.capture_programs = bool(capture_programs)
        if tp_group is None and mesh.model_parallel_is_initialized():
            tp_group = mesh.get_tensor_model_parallel_group()
        self.tp_group = tp_group
        self.tp, self.tp_rank = mesh.group_size(tp_group), mesh.group_rank(tp_group)
        self._check_capturable()
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
        # the vocabulary columns this rank's grammar tables hold
        v = config.vocab_size
        shape = local_shape((2, 2, v), leaf_partition_spec("need", (2, 2, v), self.tp), self.tp)
        self.grammar_vocab = (self.tp_rank * shape[-1], (self.tp_rank + 1) * shape[-1])
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(b for b in buckets if b <= self.config.max_seq_len))
        if not self.buckets:
            raise ValueError(f"no bucket fits max_seq_len {self.config.max_seq_len}")
        if self.tp > 1 and quantized_names(params):
            raise NotImplementedError("int8 weights under tensor parallelism are not ported "
                                      "(ROADMAP queue A)")
        if self.tp > 1 and hasattr(config, "num_experts"):
            raise NotImplementedError("Mixtral serving under tensor parallelism (the MoE block "
                                      "under a TP group in decode mode) is not ported: ROADMAP "
                                      "queue A; training takes it (examples/mixtral_moe.py)")
        with torch.device("meta"):
            model = (model_cls(self.config) if tp_group is None
                     else model_cls(self.config, group=tp_group))
        state = self._device_params(model, params)
        self.param_transform = param_transform
        self._raw_params: Optional[Dict[str, torch.Tensor]] = None
        if param_transform is None:
            adopt_quantized(model, state)
            model.load_state_dict(state, strict=True, assign=True)
        else:
            # the model stays on meta: every forward binds the transformed
            # tree (the names must be the model's, checked on meta tensors)
            self._raw_params = state
            want = set(model.state_dict())
            got = set(param_transform({k: torch.empty_like(v, device="meta")
                                       for k, v in state.items()}))
            if got != want:
                raise KeyError(f"param_transform gives {sorted(got ^ want)[:8]} not matching "
                               f"the model's weights")
        # the adapter pool is no weight: each session's state holds one (the
        # model reads the one bound into it for each forward)
        self._lora_shape = tuple(model.model.lora_pool.shape) if self.lora else None
        self.model = model.eval().requires_grad_(False)
        # device state (SessionState): the latest session started, and the
        # spare states no session holds (the latest released is reused,
        # programs and all, by the next start_session)
        self._current: Optional[weakref.ref] = None
        self._spares: List[SessionState] = []
        self.spare_states = int(spare_states)
        self._state_ids = itertools.count()
        # wall ms of each program's first call by signature, the latest of
        # any session (warm-up and capture on CUDA, the eager first run
        # otherwise; the fused block: its capture, or its construction on
        # the CPU); ``captures`` lists every one as (state index, signature,
        # ms), each session's own are in its ``capture_ms``
        self.capture_ms: Dict[str, float] = {}
        self.captures: List[Tuple[int, str, float]] = []
        # the tracer of the compile spans of a state with none of its own
        self.tracer = None

    # --- helpers ---------------------------------------------------------

    def _check_capturable(self) -> None:
        """A gloo group on the card cannot run inside captured programs."""
        if (self.device.type == "cuda" and self.capture_programs
                and mesh.group_backend(self.tp_group) == "gloo"):
            raise ValueError("a gloo tensor-parallel group's collectives cannot be captured "
                             "in a CUDA graph: pass capture_programs=False (and serve with "
                             "fused=False)")

    def _gather_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' vocabulary shards of ``x`` (the last dim) gathered to
        full width (``x`` itself without a group)."""
        return gather_from_tensor_parallel_region(x, self.tp_group, -1)

    def grammar_allowed(self, tables: Dict[str, torch.Tensor], gidx: torch.Tensor,
                        gstate: torch.Tensor, gbudget: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
        """:func:`grammar_allowed` over the full vocabulary: each rank's
        mask of its own columns, gathered."""
        return self._gather_vocab(grammar_allowed(tables, gidx, gstate, gbudget, counts))

    def grammar_next(self, tables: Dict[str, torch.Tensor], g: torch.Tensor,
                     gstate: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        """``next[g, gstate, tok]`` for full-vocabulary token ids: under a
        group only the rank holding ``tok``'s column reads it, the others
        give 0, and one all-reduce sums them (every rank then holds the
        state)."""
        g, gstate, tok = g.long(), gstate.long(), tok.long()
        if self.tp_group is None:
            return tables["next"][g, gstate, tok]
        start, stop = self.grammar_vocab
        local = tok - start
        mine = (local >= 0) & (local < stop - start)
        got = tables["next"][g, gstate, local.clamp(0, stop - start - 1)]
        return all_reduce(torch.where(mine, got, 0), self.tp_group)

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

    def _device_params(self, model, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """``params`` on the device: an ``X.qweight``/``X.scale`` pair stays
        int8/fp32, every other leaf takes its weight's storage dtype in the
        model (``param_dtype``; a router's fp32). A tensor already on the
        device in that dtype passes through as it is (no copy)."""
        pairs = quantized_names(params)
        kinds = dict(model.named_parameters())
        out = {}
        for k, v in params.items():
            t = torch.as_tensor(v)
            base = k.rpartition(".")[0]
            if base in pairs and k == base + ".qweight":
                if t.dtype != torch.int8:
                    raise ValueError(f"{k} is {t.dtype}, not int8")
                dt = torch.int8
            elif base in pairs and k == base + ".scale":
                dt = torch.float32
            else:
                p = kinds.get(k)
                dt = p.dtype if p is not None else self.config.param_dtype
            out[k] = t.to(device=self.device, dtype=dt)
        return out

    @contextlib.contextmanager
    def _weights(self):
        """With ``param_transform``: the transformed tree bound into the
        model for one forward (JAX applies it inside every program)."""
        if self.param_transform is None:
            yield
            return
        tree = self.param_transform(self._raw_params)
        saved = []
        try:
            for name, t in tree.items():
                mod_name, _, attr = name.rpartition(".")
                mod = self.model.get_submodule(mod_name)
                saved.append((mod, attr, mod._parameters[attr]))
                mod._parameters[attr] = t
            yield
        finally:
            for mod, attr, p in saved:
                mod._parameters[attr] = p

    def _bind_lora(self, adapter_idx: Optional[torch.Tensor],
                   state: Optional[SessionState]) -> None:
        """The rows' adapter slots and ``state``'s adapter pool into the
        model for one forward (the current state's pool when None)."""
        if self.lora:
            self.model.model.adapter_idx = adapter_idx
            self.model.model.lora_pool = (state or self._default_state()).lora_pool

    def _forward(self, ids: torch.Tensor, cache: KVCache,
                 adapter_idx: Optional[torch.Tensor] = None,
                 state: Optional[SessionState] = None) -> torch.Tensor:
        """The model on ``ids``; ``adapter_idx`` (rows,) the rows' adapter
        slots (None: the identity) in ``state``'s adapter pool."""
        self._bind_lora(adapter_idx, state)
        # no_grad rather than inference_mode: the cache tensors made here
        # are updated in place by later calls outside any such mode
        with torch.no_grad(), self._weights():
            return self._gather_vocab(self.model(ids, cache))

    def _adapter_rows(self, adapter_slots, rows: int) -> list:
        """The rows' adapter slots as a program input (the identity slot 0
        when None), or no input without LoRA."""
        if not self.lora:
            return []
        if adapter_slots is None:
            return [np.zeros((rows,), np.int32)]
        slots = np.asarray(adapter_slots, np.int32).reshape(-1)
        if slots.shape != (rows,):
            raise ValueError(f"{slots.size} adapter slots for {rows} rows")
        return [slots]

    # --- programs --------------------------------------------------------

    def _run(self, state: SessionState, signature: str, body, inputs: Sequence) -> Any:
        """Run ``state``'s program ``signature`` (``body`` over device
        tensors) on ``inputs`` (host arrays or device tensors): a replay of
        its captured graph on CUDA (captured now at its first call), else
        the eager body. The first call's wall time goes into the state's
        and the ``CausalLM``'s ``capture_ms`` and the state's tracer."""
        cuda = self.device.type == "cuda"
        captured = cuda and self.capture_programs
        if captured:
            self._check_capturable()
        prog = state.programs.get(signature)
        if prog is None:
            prog = state.programs[signature] = CapturedProgram(
                body, self.device, state.graph_pool() if cuda else None, name=signature)
        # this call builds the program: its capture, or its first eager run
        first = prog.graph is None if captured else signature not in state.capture_ms
        t0 = time.perf_counter()
        if captured:
            out = prog(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                         for a in inputs))
        else:   # the same body eagerly, on inputs moved to the device
            out = body(*(self._ids(a, torch.from_numpy(np.asarray(a)).dtype)
                         if isinstance(a, np.ndarray) else a for a in inputs))
        if first:
            self._note_capture(state, signature, t0, time.perf_counter())
        return out

    def _note_capture(self, state: SessionState, signature: str, t0: float, t1: float) -> None:
        """Record one program's first call: its wall ms by signature on the
        state and the ``CausalLM``, and a ``compile:<signature>`` span on
        the state's tracer (the engine's that holds it)."""
        ms = round((t1 - t0) * 1e3, 2)
        state.capture_ms[signature] = ms
        self.capture_ms[signature] = ms
        self.captures.append((state.index, signature, ms))
        tr = state.tracer if state.tracer is not None else self.tracer
        if tr is not None and tr.enabled:
            tr.complete("compile:" + signature, ("engine", "compile"), t0, t1)

    def _last_logits(self, ids: torch.Tensor, cache: KVCache, last: torch.Tensor,
                     adapter: Sequence[torch.Tensor], state: SessionState) -> torch.Tensor:
        """The model over ``ids`` (rows, bucket) on ``cache``, its head at
        each row's position ``last`` only: ``(rows, vocab)``."""
        self._bind_lora(adapter[0] if adapter else None, state)
        with torch.no_grad(), self._weights():
            h = self.model.model(ids, cache)
            h = h[torch.arange(ids.shape[0], device=ids.device), last]
            return self._gather_vocab(self.model._head(h[:, None])[:, 0])

    def _fresh_cache(self, state: SessionState, rows: int) -> KVCache:
        """The zeroed-per-call slab a slab insert of ``rows`` rows prefills
        into before its rows go to the session slab (one per row count)."""
        fresh = state.fresh.get(rows)
        if fresh is None:
            fresh = state.fresh[rows] = self.model.new_cache(rows, self.device)
        return fresh

    def _slab_insert_body(self, state: SessionState, rows: int):
        cache, fresh = state.cache, self._fresh_cache(state, rows)
        layers = self.config.num_layers

        def body(ids, dst, lengths, last, *adapter):
            for t in (*fresh.keys, *fresh.values, fresh.cache_index):
                t.zero_()
            logits = self._last_logits(ids, fresh, last, adapter, state)
            # whole rows: the stale tails of the slots' earlier requests go too
            for layer in range(layers):
                cache.keys[layer].index_copy_(0, dst, fresh.keys[layer])
                cache.values[layer].index_copy_(0, dst, fresh.values[layer])
            cache.cache_index.index_copy_(0, dst, lengths)
            return logits

        return body

    def _paged_body(self, state: SessionState):
        cache = state.cache

        def body(ids, starts, tables, last, *adapter):
            # the pools written in place through the rows' own tables
            return self._last_logits(ids, cache.rows(starts, tables), last, adapter, state)

        return body

    def _slab_extend_body(self, state: SessionState):
        cache, layers = state.cache, self.config.num_layers

        def body(ids, dst, starts, new_len, last, *adapter):
            view = cache.rows(starts)
            view.keys = [t.index_select(0, dst) for t in cache.keys]
            view.values = [t.index_select(0, dst) for t in cache.values]
            logits = self._last_logits(ids, view, last, adapter, state)
            for layer in range(layers):
                cache.keys[layer].index_copy_(0, dst, view.keys[layer])
                cache.values[layer].index_copy_(0, dst, view.values[layer])
            cache.cache_index.index_copy_(0, dst, new_len)
            return logits

        return body

    def _decode_body(self, state: SessionState):
        cache, st = state.cache, state.slots

        def body(tok):
            return self._forward(tok, cache, st.dev_field("adapter") if self.lora else None,
                                 state)[:, 0]

        return body

    def compile(self, session: Optional[DecodeSession] = None) -> "CausalLM":
        """Build the JAX package's ``compile()`` programs now for
        ``session`` (by default the latest session started while it lives,
        else the spare state the next :meth:`start_session` takes):
        ``decode`` and, on the slab path, ``prefill_b{bucket}`` for every
        bucket (max_batch rows); the other inserts and extends are built at
        their first call. Each warm-up runs on zero inputs and writes idle
        slab rows or scratch pages of that session, so none of its slots
        may be live; the slot state is restored from the host mirror
        after."""
        if session is not None:
            self._check_session(session)
        state = session.state if session is not None else self._default_state()
        holder = state.holder()
        if holder is not None and holder.active.any():
            raise RuntimeError("compile before inserting into the session: its warm-ups "
                               "write every slot")
        b = self.max_batch
        self._run(state, "decode", self._decode_body(state), [np.zeros((b, 1), np.int32)])
        if not self.paged:
            for bucket in self.buckets:
                self._run(state, f"prefill_b{bucket}", self._slab_insert_body(state, b),
                          [np.zeros((b, bucket), np.int32), np.arange(b, dtype=np.int64),
                           np.ones((b,), np.int32), np.zeros((b,), np.int64),
                           *self._adapter_rows(None, b)])
        state.slots.push()
        state.compiled = True
        return self

    @property
    def compiled(self) -> bool:
        """Whether the default session state (see :meth:`compile`) has been
        compiled."""
        state = self._live_current()
        state = state.state if state is not None else self._spare
        return state is not None and state.compiled

    @property
    def _spare(self) -> Optional[SessionState]:
        """The spare state the next session takes (None when there is
        none)."""
        return self._spares[-1] if self._spares else None

    def kv_leaves(self) -> Dict[str, Tuple[tuple, int]]:
        """One session's KV leaves at full width: per layer ``cached_key``
        and ``cached_value`` (paged: the sink page included) and an int8
        pool's ``cached_key_scale``/``cached_value_scale``, each as
        (global shape, bytes)."""
        cfg = self.config
        hd, n_kv = cfg.head_dim_, cfg.kv_heads()
        size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
        if self.paged:
            pages = cfg.page_pool_pages + 1
            shape, dtype = (pages, cfg.page_size, n_kv, hd), page_storage_dtype(cfg)
        else:
            shape, dtype = (self.max_batch, cfg.max_seq_len, n_kv, hd), cfg.dtype
        out = {}
        for i in range(cfg.num_layers):
            for leaf in ("cached_key", "cached_value"):
                out[f"layers.{i}.{leaf}"] = (shape, int(np.prod(shape)) * size(dtype))
                if dtype == torch.int8:
                    sshape = (pages, 1, n_kv, 1)
                    out[f"layers.{i}.{leaf}_scale"] = (sshape, int(np.prod(sshape)) * 4)
        return out

    def kv_cache_bytes(self) -> Dict[str, int]:
        """One session's KV footprint (JAX ``causal_lm.py:813-861``):
        ``kv_bytes`` what it allocates on this rank (a sharded leaf holds
        ``1/tp`` of its bytes), ``kv_bytes_global`` the full width (what a
        handoff or a host-tier page carries), ``kv_slab_bytes`` this rank's
        bytes of a contiguous slab in the compute dtype for the same batch
        and length (the paged pools' yardstick)."""
        cfg = self.config
        actual = total = 0
        sharded = False
        for name, (shape, nbytes) in self.kv_leaves().items():
            div = self.tp if sharded_dim(leaf_partition_spec(name, shape, self.tp)) is not None \
                else 1
            sharded = sharded or div > 1
            actual += nbytes // div
            total += nbytes
        slab = (2 * cfg.num_layers * self.max_batch * cfg.max_seq_len * cfg.kv_heads()
                * cfg.head_dim_ * torch.empty((), dtype=cfg.dtype).element_size())
        return {"kv_bytes": actual, "kv_bytes_global": total,
                "kv_slab_bytes": slab // self.tp if sharded else slab}

    def kv_page_bytes(self) -> int:
        """Bytes one physical page takes across every layer on this rank
        (JAX ``:863``): the pool-sizing unit. Paged mode only."""
        if not self.paged:
            raise ValueError("kv_page_bytes applies to paged mode only")
        return self.kv_cache_bytes()["kv_bytes"] // (self.config.page_pool_pages + 1)

    def kv_page_bytes_host(self) -> int:
        """Bytes one logical page takes at full width (JAX ``:871``): a
        host-tier or handoff page, whatever the degree. Paged mode only."""
        if not self.paged:
            raise ValueError("kv_page_bytes_host applies to paged mode only")
        return self.kv_cache_bytes()["kv_bytes_global"] // (self.config.page_pool_pages + 1)

    def kv_sharded_fraction(self) -> float:
        """The share of the KV bytes whose leaves shard over the ranks."""
        return sharded_fraction(self.kv_leaves(), self.tp)

    # --- device state ----------------------------------------------------

    def _live_current(self) -> Optional[DecodeSession]:
        """The latest session started, while it is open."""
        s = self._current() if self._current is not None else None
        return s if s is not None and s.state is not None else None

    def _default_state(self) -> SessionState:
        """The state a call that names no session works on: the latest
        session's while it is open, else the spare (made now if none)."""
        s = self._live_current()
        if s is not None:
            return s.state
        if not self._spares:
            self._spares.append(SessionState(self, next(self._state_ids)))
        return self._spares[-1]

    def _graph_pool(self):
        """The default state's graph pool (see :meth:`compile`)."""
        return self._default_state().graph_pool()

    # the latest session's device state (speculation and the tests read it)
    _cache = property(lambda self: self._default_state().cache)
    _fused = property(lambda self: self._default_state().fused)
    _programs = property(lambda self: self._default_state().programs)

    def _take_state(self) -> SessionState:
        """A state for a new session: the spare, else a new one (on CUDA
        after a collection, which may return an abandoned session's)."""
        if not self._spares and self.device.type == "cuda":
            gc.collect()
        if self._spares:
            return self._spares.pop()
        return SessionState(self, next(self._state_ids))

    def _release(self, state: SessionState, session_ref) -> None:
        """``state``'s session ended (closed or collected): it becomes the
        spare, or is freed when there is one already."""
        s = session_ref()
        if s is not None:
            if s.state is not state:
                return
            s.state = s.cache = s.slots = None   # the closed session holds no device memory
        state.session = None
        if state in self._spares:
            return
        if len(self._spares) < self.spare_states:
            self._spares.append(state)
        else:
            if self.device.type == "cuda":   # no graph of it may still run
                torch.cuda.synchronize(self.device)
            state.free()

    def _check_session(self, session: DecodeSession) -> None:
        if session.state is None:
            raise RuntimeError("this session was closed: its device state went back to the "
                               "CausalLM")

    # --- continuous batching (slot-level session API) --------------------

    def start_session(self) -> DecodeSession:
        """Fresh decode session (all slots free) on a device state of its
        own (JAX ``causal_lm.py:888``): zeroed pools and slot state. Other
        sessions of this ``CausalLM`` go on as they were. The state is the
        spare one an ended session left (its programs reused) or a new one
        (its programs captured at first use)."""
        state = self._take_state()
        cache, st = state.cache, state.slots
        for pools in (cache.keys, cache.values, cache.k_scales or [], cache.v_scales or []):
            for t in pools:
                t.zero_()
        st.host[:] = 0
        st.host_field("eos")[:] = -1
        session = DecodeSession(cache=cache, slots=st, lengths=st.host_field("length"),
                                active=np.zeros((self.max_batch,), bool), state=state)
        if self.paged:
            session.paged = PagedKVCache(
                self.config.page_size, self.config.page_pool_pages, self.max_batch,
                self.config.max_seq_len, prefix_cache=self.prefix_cache)
            st.host_table[:] = session.paged.tables
        st.push()
        if self.lora:
            state.lora_pool.zero_()
            self.model.model.lora_pool = state.lora_pool
            session.adapters = self.new_adapter_pool(state)
        if self.grammar:
            reset_grammar_tables(state.grammar_tables)
            session.grammars = self.new_grammar_pool(state)
        ref = weakref.ref(session)
        state.session = ref
        fin = weakref.finalize(session, self._release, state, lambda: None)
        fin.atexit = False

        def release() -> None:
            fin.detach()
            self._release(state, ref)

        session._release = release
        self._current = ref
        return session

    def new_adapter_pool(self, state: Optional[SessionState] = None) -> AdapterPool:
        """Adapter-pool bookkeeping over ``state``'s pool buffer (by default
        the current one's; :meth:`start_session` makes one a session)."""
        if not self.lora:
            raise ValueError("CausalLM was built without lora_rank")
        return AdapterPool((state or self._default_state()).lora_pool,
                           self.model.model.lora_layout)

    def new_grammar_pool(self, state: Optional[SessionState] = None) -> GrammarPool:
        """Grammar-pool bookkeeping over ``state``'s tables (by default the
        current one's; :meth:`start_session` makes one a session)."""
        if not self.grammar:
            raise ValueError("CausalLM was built without grammar_slots")
        return GrammarPool(self.grammar_slots, self.grammar_states, self.grammar_tokens,
                           tables=(state or self._default_state()).grammar_tables,
                           vocab_shard=self.grammar_vocab)

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
        # prefill into a zeroed slab at the rows' own width, then copy the
        # whole rows into the session slab (stale tails of the slots' earlier
        # requests are overwritten, as the JAX scatter does)
        sig = (f"prefill_b{bucket}" if rows == self.max_batch
               else f"insert_prefill_r{rows}_b{bucket}")
        state = session.state
        logits = self._run(state, sig, self._slab_insert_body(state, rows),
                           [ids, slot_ids.astype(np.int64), lengths,
                            np.maximum(lengths - 1, 0).astype(np.int64), *aidx])
        session.lengths[slot_ids] = lengths
        session.active[slot_ids] = True
        return logits

    def _insert_paged(self, session: DecodeSession, slot_ids: np.ndarray,
                      prompt_ids: np.ndarray, lengths: np.ndarray, reserve_tokens,
                      ns: Optional[Sequence[Optional[str]]] = None,
                      aidx: Sequence = ()) -> torch.Tensor:
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
        try:
            logits = self._run(session.state, f"paged_insert_r{rows}_b{bucket}",
                               self._paged_body(session.state),
                               [ids, starts, tables.astype(np.int32),
                                np.maximum(suffix - 1, 0).astype(np.int64), *aidx])
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
        return logits

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
        decode writes land at or past what the chunks have covered. The
        forward is the program ``paged_insert_r{rows}_b{bucket}`` (paged) or
        ``chunk_extend_r{rows}_b{bucket}`` (slab); it rebinds nothing a
        captured block reads. The chunk runs under the rows'
        ``adapter_slots`` (the KV it writes is theirs)."""
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
        aidx = self._adapter_rows(adapter_slots, rows)
        last = np.maximum(lengths - 1, 0).astype(np.int64)
        if self.paged:
            if tables is None:
                raise ValueError("paged extend needs per-row block tables")
            logits = self._run(session.state, f"paged_insert_r{rows}_b{bucket}",
                               self._paged_body(session.state),
                               [ids, starts, np.asarray(tables, np.int32), last, *aidx])
            session.cache.cache_index.index_copy_(0, self._ids(slot_ids, torch.long),
                                                  self._ids(new_len))
        else:
            logits = self._run(session.state, f"chunk_extend_r{rows}_b{bucket}",
                               self._slab_extend_body(session.state),
                               [ids, slot_ids.astype(np.int64), starts, new_len, last, *aidx])
        session.lengths[slot_ids] = new_len
        return logits

    def _decode_step(self, session: DecodeSession, tok: torch.Tensor) -> torch.Tensor:
        """One single-token forward for every slot (inactive slots advance
        harmlessly); ``tok`` (max_batch, 1) int32 on the device."""
        self._check_session(session)
        session.slots.sync()
        logits = self._run(session.state, "decode", self._decode_body(session.state), [tok])
        session.lengths += 1
        return logits

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
                                     pad_token_id: int = 0,
                                     session: Optional[DecodeSession] = None) -> FusedDecode:
        """The ``steps``-token continuous-batching block of ``session`` (by
        default the one :meth:`compile` defaults to) as one program
        (:class:`FusedDecode`), cached on its state per ``(steps,
        slot_sampler, pad)``. On CUDA it is captured here — warm-up and
        capture timed into ``capture_ms`` — so call it before inserting
        into the session (a ``ServeEngine`` does so when it is built);
        other sessions may be live meanwhile."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if self.device.type == "cuda" and mesh.group_backend(self.tp_group) == "gloo":
            raise ValueError("a gloo tensor-parallel group's collectives cannot be captured "
                             "in the fused decode block: serve with fused=False")
        if session is not None:
            self._check_session(session)
        state = session.state if session is not None else self._default_state()
        slot_sampler = slot_sampler or SlotSampler()
        key = (steps, slot_sampler, pad_token_id)
        runner = state.fused.get(key)
        if runner is None:
            t0 = time.perf_counter()
            runner = FusedDecode(self, state, steps, slot_sampler, pad_token_id)
            if self.device.type == "cuda":
                runner.capture()
            self._note_capture(state, f"session_fused_k{steps}", t0, time.perf_counter())
            state.fused[key] = runner
        return runner

    def compile_decode_fused(self, steps: int, top_k: Optional[int] = None,
                             top_p: Optional[float] = None, pad_token_id: int = 0,
                             session: Optional[DecodeSession] = None) -> FusedDecode:
        """The ``steps``-token block of :meth:`generate` (``fused_chunk``):
        the session program for ``top_k``/``top_p``. Unlike the JAX
        package's, it builds in no temperature, greedy flag or EOS id: those
        are per-slot state that ``generate`` loads before the block, so one
        graph serves every value of them."""
        return self.compile_session_decode_fused(
            steps, SlotSampler(top_k=top_k, top_p=top_p), pad_token_id, session=session)

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
                                                     pad_token_id, session=session)
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
