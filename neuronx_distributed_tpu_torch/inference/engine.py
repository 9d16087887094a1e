"""Continuous-batching serving engine: the synchronous and the pipelined
block loop, chunked prefill and cancellation.

Counterpart of the core of ``neuronx_distributed_tpu/inference/engine.py``:
a host-side scheduler that admits queued requests into free slots (prompts
that share a prefill bucket ride one right-sized insert), advances every
live slot ``block_steps`` tokens per scheduling round, and retires streams
on EOS or budget at block boundaries.

``fused=True`` advances a block through the captured K-step program of
:meth:`CausalLM.compile_session_decode_fused` (built with the engine): a
steady-state block is one replay and one fetch of the (K + 1, slots)
result, and a block after an admission or a retirement adds one copy of
the changed slots' state to the device. ``fused=False`` runs the same
schedule step by step with a fetch per token, the reference route. Both
emit identical streams: request r's t-th token is a pure function of its
logits and, when sampled, of ``counter_gumbel`` noise keyed by
``request_seed(seed, r)`` at counter t.

``prefill_chunk_tokens`` C > 0 prefills a prompt longer than C across
rounds, at most C prompt tokens a round, between decode blocks
(:meth:`CausalLM.extend`), so one long prompt does not stall every live
stream, and lifts the bucket ceiling on prompt length. ``async_loop=True``
(fused only) replays block t before it fetches block t - 1. ``cancel``
retires a request in any state. Token streams are the same in every mode.

Overload (JAX ``engine.py:54-67``): ``submit(ttft_deadline_ms=,
deadline_ms=)`` puts deadlines on the virtual block clock
(``block_time_ms`` a block); admission is earliest-deadline-first among
arrived requests (:class:`~.schedq.AdmissionQueue`); a queued or
mid-prefill request past its deadline expires with no tokens, a decoding
one past its completion deadline retires with a partial ``expired``
completion; ``max_queue`` bounds the arrived backlog and sheds by
``shed_policy`` with a :class:`Rejected` verdict and a retry-after. Every
decision reads the virtual clock and the host's own counters, so the
synchronous and the pipelined loop make the same ones.

Observability (JAX ``engine.py:538-565``): ``trace=True`` (or a shared
``tracer``) records each request's lifecycle and the engine's dispatch,
fetch and block spans from host state the scheduler already holds, with no
device synchronisation; ``metrics`` holds the TTFT, inter-token and
dispatch histograms and the queue and pool gauges. :func:`run_trace`
drives a synthetic trace and returns the serving report;
``keep_completions=False`` folds finished streams into counters and
histograms (the memory-bounded streaming report).

Fault tolerance (JAX ``engine.py:68-91``): ``faults=FaultPlan(...)``
(``faults.py``) injects seeded faults at the allocator, at each program
launch (retried with exponential backoff, :class:`DispatchFailed` past
``dispatch_retries``), into live KV pages and into host-tier reads;
``host_tier_pages`` spills cold prefix pages to checksummed host copies and
restores them on a hit (spill, restore, re-prefill, then shed); a
corrupted page is repaired from its tier copy or its readers re-prefill
prompt plus delivered tokens and resume; :meth:`ServeEngine.snapshot` and
:meth:`ServeEngine.from_snapshot` carry every live request across a crash
in the reference's version-1 format. Token ``t`` of request ``r`` is a
function of its logits and ``(seed, r, t)`` alone, so a resumed greedy
stream is the uninterrupted one. A :class:`~.simlm.SimCausalLM` runs the
same scheduler with no device work.

Tenants (JAX ``engine.py:715-760``): on a ``CausalLM`` built with
``lora_rank``, ``register_adapter`` and ``submit(adapter=)`` serve each
request under its own LoRA adapter out of the session's adapter pool; with
``grammar_slots``, ``register_grammar`` and ``submit(grammar=)`` constrain
its stream to a regex or JSON schema. Admission pins the request's adapter
and grammar (a full pool sheds it with ``adapter_pool_exhausted`` or
``grammar_pool_exhausted``, an injected load fault requeues it), the
radix prefix index is namespaced by adapter, every first-token draw and
every step of the decode block masks a constrained row to its grammar,
and retirement unpins. The host follows each constrained stream's DFA
state from the tokens it receives (``finish_reason="grammar_accept"`` on
an accept-terminal landing), so a block stays one replay and one fetch.

Still to port (ROADMAP A5, A8): parking, disaggregation, the router and
the router's ``extract_*``/``load_summary`` seams.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.adapters import (
    AdapterLoadError,
    AdapterPoolExhausted,
)
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.faults import (
    DispatchFailed,
    FaultInjector,
    FaultPlan,
    TransientDispatchError,
)
from neuronx_distributed_tpu_torch.inference.grammar import (
    GrammarLoadError,
    GrammarPoolExhausted,
    grammar_allowed,
)
from neuronx_distributed_tpu_torch.inference.paged_cache import ChunkedPrefill, PagePoolExhausted
from neuronx_distributed_tpu_torch.inference.schedq import AdmissionQueue, shed_deadline_key
from neuronx_distributed_tpu_torch.inference.sampling import (
    Sampler,
    SlotSampler,
    draw_rows,
    request_seed,
    split_key,
)
from neuronx_distributed_tpu_torch.models.llama import page_storage_dtype
from neuronx_distributed_tpu_torch.observability import MetricsRegistry, Tracer, interblock_gaps

# what a garbled page holds (JAX ``engine.py:2368``): ``104729.0`` cast to
# each leaf's dtype, and for int8 leaves the 127 JAX's cast saturates to (a
# float-to-int8 cast out of range is undefined in C and in PyTorch)
GARBLE_FP = 104729.0
GARBLE_INT8 = 127


@dataclasses.dataclass
class Request:
    """One admission-queue entry; ``arrival_block`` is virtual time in
    decode blocks."""

    request_id: int
    prompt: np.ndarray              # (s,) int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    temperature: float = 0.0        # 0.0 => greedy
    greedy: bool = True
    arrival_block: int = 0
    submit_block: int = 0
    start_block: Optional[int] = None
    first_token_block: Optional[int] = None
    # absolute deadlines on the virtual clock (None: none): the first token
    # by ttft_deadline_block, the whole stream by deadline_block
    ttft_deadline_block: Optional[int] = None
    deadline_block: Optional[int] = None
    tenant: str = "default"
    # the registered adapter its tokens are drawn under (None: the base
    # model) and the registered grammar its stream must match (None: free)
    adapter: Optional[str] = None
    grammar: Optional[str] = None


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: np.ndarray              # generated ids (eos included when hit)
    prompt_len: int
    queue_blocks: int
    decode_blocks: int
    ttft_blocks: int = 0
    token_ts: Optional[np.ndarray] = None   # wall perf_counter per token
    submit_ts: Optional[float] = None       # wall perf_counter at submit
    cancelled: bool = False
    # ``expired``: the engine cut the stream off at its deadline (tokens
    # hold what was delivered by then); ``deadline_missed`` also covers a
    # stream that finished late
    expired: bool = False
    deadline_missed: bool = False
    tenant: str = "default"
    adapter: Optional[str] = None
    grammar: Optional[str] = None
    # "eos" | "budget" | "grammar_accept" (the DFA landed in an
    # accept-terminal state) | "expired" | "cancelled"
    finish_reason: str = "budget"


@dataclasses.dataclass
class Rejected:
    """A shed request (JAX ``engine.py:215``): the bounded queue refused it.
    ``retry_after_blocks`` estimates when a resubmission (a new request id)
    has a fresh chance; ``reason`` is ``"queue_full"``,
    ``"pool_exhausted"``, ``"adapter_pool_exhausted"`` or
    ``"grammar_pool_exhausted"``."""

    request_id: int
    retry_after_blocks: int
    queue_depth: int
    reason: str = "queue_full"


@dataclasses.dataclass
class _PrefillInFlight:
    """A chunked admission (JAX ``engine.py:278``): the slot is claimed but
    decode-inactive until the final chunk lands and its first token is
    drawn; ``chunk`` holds the paged page state (None on the slab)."""

    req: Request
    slot: int
    written: int                    # prompt tokens in KV (reused prefix included)
    chunk: Optional[ChunkedPrefill] = None


class ServeEngine:
    """Continuous-batching scheduler over one :class:`CausalLM` session.
    ``block_steps`` is the K knob: each round advances every live slot K
    tokens. Building a fused engine captures its decode block on CUDA,
    outside :meth:`run` (``capture_s``: the wall seconds that took, about 0
    when the ``CausalLM`` had captured it already).

    ``prefill_chunk_tokens`` (JAX ``engine.py:434-441``): 0 admits every
    prompt with one insert; C > 0 prefills any prompt longer than C at most
    C tokens a round, in FIFO order across the admissions in flight, each
    chunk on its own bucket. A prompt past the largest bucket is then
    served. Pool pressure mid-prompt rolls the whole admission back and
    requeues it at the head of the queue.

    ``async_loop`` (JAX ``engine.py:3742``, needs ``fused``): each round
    schedules on the host state as of the last harvest, replays block t,
    and only then waits for block t - 1's fetch. Each replay's output is
    copied on the device into a ring buffer and from there, without a wait,
    into one of two pinned host buffers, so the next replay may overwrite
    the graph's output; a first token drawn at admission stays on the
    device, enters the slot state through the next copy of changed slots
    and comes back with the next block's fetch. The host predicts budget
    exhaustion from its counters, so a request that ends on its budget
    retires at the same block as in the synchronous loop and the schedule
    is the same; one that ends on EOS retires a block later (the latch is
    on the device), two when the EOS is its first token. Finished rows may
    write up to two blocks past their last token: the page reserve is
    ``2 * block_steps``.

    Host operations of the decode blocks, as plain counters: ``replays``
    (fused block programs run), ``host_fetches`` (device-to-host reads) and
    ``h2d_copies`` (slot-state copies to the device). ``nonfinite_logits``
    counts the rows of an insert, of a stepwise step or of a fused block
    whose logits held a non-finite value. ``chunk_program_calls`` and
    ``prefill_chunk_tokens_done`` count the chunk extends and their tokens,
    ``prefill_aborts`` the rolled-back chunked admissions, ``cancelled``
    the requests :meth:`cancel` took.

    Overload knobs (JAX ``engine.py:518-528``): deadlines given in ms are
    converted to blocks at ``block_time_ms`` a block (1.0, the default,
    makes ms and blocks the same: the deterministic basis; on a card, give
    a block's wall time there); ``max_queue`` bounds the arrived backlog,
    shedding by ``shed_policy`` (``"tail"`` the newest arrival,
    ``"deadline"`` the laxest deadline) into ``rejected``. Counters:
    ``expired``, ``shed_evictions`` (queued requests a tighter newcomer
    displaced), ``deferred_admissions`` (pool pressure), ``program_calls``
    (decode programs: a replay a fused block, a forward a step) and
    ``inserted_requests``.

    Observability: ``trace`` turns on a fresh :class:`Tracer` (or pass a
    shared ``tracer``); ``metrics`` is the :class:`MetricsRegistry` the
    histograms and gauges live in; ``name`` is the engine's lane in the
    trace (``"engine"`` by default).

    Faults and recovery (JAX ``engine.py:404-407``): ``faults`` is a
    :class:`FaultPlan` or a :class:`FaultInjector` (one per engine run);
    ``dispatch_retries``/``dispatch_backoff_s`` bound the retry of a failed
    launch; ``host_tier_pages`` > 0 (paged, prefix cache on) keeps spilled
    prefix pages in host memory. Counters: ``dispatch_retry_count``
    (launches retried; the report's ``dispatch_retries``),
    ``corrupt_page_replays``, ``tier_page_repairs``,
    ``injected_corruptions``, ``restored_requests``, and the page I/O,
    which is no decode-block host op: ``tier_d2h_copies`` and
    ``tier_h2d_copies`` (one per leaf kind a batched read or write moves),
    ``tier_blocking_spills`` (spills whose device read waited for a block
    in flight), and ``recovery_fetches`` (first tokens a recovery drain of
    the pipeline fetched). ``keep_completions=False`` keeps no
    :class:`Completion`: finished streams fold into ``completed_count``,
    ``generated_tokens``, ``ontime_tokens``, ``deadline_misses``,
    ``queue_blocks_sum`` and ``ttft_blocks_sum``.

    Tenants: ``adapter_rejects``/``grammar_rejects`` (admissions shed on a
    full pool) and ``adapter_load_retries``/``grammar_load_retries``
    (admissions requeued on a load fault); the pools' own counters live on
    ``session.adapters`` and ``session.grammars``."""

    def __init__(self, lm: CausalLM, block_steps: int = 8, fused: bool = True,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 pad_token_id: int = 0, seed: int = 0, prefill_chunk_tokens: int = 0,
                 async_loop: bool = False, max_queue: Optional[int] = None,
                 shed_policy: str = "tail", block_time_ms: float = 1.0, trace: bool = False,
                 tracer: Optional[Tracer] = None, metrics: Optional[MetricsRegistry] = None,
                 name: Optional[str] = None,
                 faults: Optional[Union[FaultPlan, FaultInjector]] = None,
                 dispatch_retries: int = 3, dispatch_backoff_s: float = 0.001,
                 host_tier_pages: int = 0, keep_completions: bool = True):
        if block_steps < 1:
            raise ValueError(f"block_steps must be >= 1, got {block_steps}")
        if prefill_chunk_tokens < 0:
            raise ValueError(f"prefill_chunk_tokens must be >= 0, got {prefill_chunk_tokens}")
        if prefill_chunk_tokens > lm.buckets[-1]:
            raise ValueError(f"prefill_chunk_tokens {prefill_chunk_tokens} exceeds the largest "
                             f"prefill bucket {lm.buckets[-1]} (each chunk rides a bucket)")
        if async_loop and not fused:
            raise ValueError("async_loop requires fused=True: the pipeline overlaps the fused "
                             "block; the stepwise route is synchronous")
        if shed_policy not in ("tail", "deadline"):
            raise ValueError(f"shed_policy must be 'tail' or 'deadline', got {shed_policy!r}")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if block_time_ms <= 0:
            raise ValueError(f"block_time_ms must be > 0, got {block_time_ms}")
        if dispatch_retries < 0:
            raise ValueError(f"dispatch_retries must be >= 0, got {dispatch_retries}")
        if host_tier_pages < 0:
            raise ValueError(f"host_tier_pages must be >= 0, got {host_tier_pages}")
        if host_tier_pages and not lm.paged:
            raise ValueError("host_tier_pages requires a paged CausalLM")
        if host_tier_pages and not lm.prefix_cache:
            raise ValueError("host_tier_pages requires prefix_cache=True (the tier keeps radix "
                             "entries: without the index there is nothing to mark tiered)")
        # a host-only model (simlm.py): no device work, sampling sites and
        # the decode block read its token function
        self._sim = bool(getattr(lm, "sim", False))
        if self._sim and host_tier_pages:
            raise ValueError("sim engines have no device pages to tier")
        self.lm = lm
        self.block_steps = int(block_steps)
        self.fused = bool(fused)
        self.async_loop = bool(async_loop)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.slot_sampler = SlotSampler(top_k=top_k, top_p=top_p)
        self.pad_token_id = int(pad_token_id)
        self.seed = int(seed)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_policy = shed_policy
        self.block_time_ms = float(block_time_ms)
        self.dispatch_retries = int(dispatch_retries)
        self.dispatch_backoff_s = float(dispatch_backoff_s)
        self.keep_completions = bool(keep_completions)
        self._injector: Optional[FaultInjector] = None
        if faults is not None:
            self._injector = faults if isinstance(faults, FaultInjector) else FaultInjector(faults)
        self.paged = lm.paged
        self.session = lm.start_session()
        self.host_tier_pages = int(host_tier_pages)
        pkv = self.session.paged
        if self.host_tier_pages:
            pkv.enable_tier(self.host_tier_pages, self._read_page_bytes, self._write_page_bytes)
        if self._injector is not None and pkv is not None:
            pkv.allocator.fault_hook = self._injector.on_alloc
            if pkv.tier is not None:
                pkv.tier.fault_hook = self._injector.on_tier_restore
        b = lm.max_batch
        self.lane = str(name) if name else "engine"
        self.tracer = tracer if tracer is not None else Tracer(enabled=bool(trace))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        for pool, hook in ((getattr(self.session, "adapters", None), "on_adapter_acquire"),
                           (getattr(self.session, "grammars", None), "on_grammar_acquire")):
            if pool is not None:
                pool.attach_observability(self.tracer, self.metrics,
                                          block_fn=lambda: self.blocks)
                if self._injector is not None:
                    pool.fault_hook = getattr(self._injector, hook)
        self._m_ttft = self.metrics.histogram("serve_ttft_ms",
                                              help="wall submit->first-token latency")
        self._m_itl = self.metrics.histogram("serve_itl_ms",
                                             help="wall gap between token deliveries")
        self._m_queue = self.metrics.gauge("serve_queue_depth", help="arrived admission backlog")
        self._m_dropped = self.metrics.counter(
            "trace_dropped_events", help="tracer ring-buffer events dropped (export is partial)")
        if self.paged:
            self._m_pool = self.metrics.gauge("serve_page_pool_in_use",
                                              help="allocated KV pages")
        self._disp_hist: Dict[str, Any] = {}
        self._last_tok_ts: Dict[int, float] = {}
        self.queue = AdmissionQueue()
        self.rejected: List[Rejected] = []
        self.slots: List[Optional[Request]] = [None] * b
        self._out: Dict[int, List[int]] = {}
        self._out_ts: Dict[int, List[float]] = {}
        self._submit_ts: Dict[int, float] = {}
        self._finish_reason: Dict[int, str] = {}
        self._ended: set = set()    # streams that hit EOS or their budget
        self.completed: List[Completion] = []
        # host mirrors of the per-slot decode state; the slots an admission
        # or retirement changed go to the device before the next block
        self._active = np.zeros((b,), bool)
        self._done = np.zeros((b,), bool)
        self._eos = np.full((b,), -1, np.int32)
        self._temp = np.zeros((b,), np.float32)
        self._greedy = np.ones((b,), bool)
        self._tok = np.zeros((b,), np.int32)
        self._gen_counts = np.zeros((b,), np.int32)
        self._keys = np.zeros((b, 2), np.int32)
        # tenancy mirrors: each slot's adapter-pool and grammar-pool slot,
        # DFA state and token budget; by request id, the pins held and each
        # constrained stream's DFA state (the host's walk of the tokens it
        # received, which may arrive after its slot retired)
        self.lora = bool(getattr(lm, "lora", False))
        self.grammar = bool(getattr(lm, "grammar", False))
        self._adapter_idx = np.zeros((b,), np.int32)
        self._gidx = np.zeros((b,), np.int32)
        self._gstate = np.zeros((b,), np.int32)
        self._gbudget = np.zeros((b,), np.int32)
        self._adapter_pins: Dict[int, str] = {}
        self._grammar_pins: Dict[int, str] = {}
        self._dfa: Dict[int, int] = {}
        self._staged: set = set()
        self._prefilling: Dict[int, _PrefillInFlight] = {}
        self._prefill_q: deque = deque()
        self._next_id = 0
        self.blocks = 0
        # plain counters, read as attributes
        self.decode_blocks = 0
        self.inserts = 0
        self.replays = 0
        self.host_fetches = 0
        self.h2d_copies = 0
        self.nonfinite_logits = 0
        self.deferred_admissions = 0
        self.chunk_program_calls = 0
        self.prefill_chunk_tokens_done = 0
        self.prefill_aborts = 0
        self.cancelled = 0
        self.program_calls = 0
        self.inserted_requests = 0
        self.expired = 0
        self.shed_evictions = 0
        self.dispatch_retry_count = 0
        self.corrupt_page_replays = 0
        self.tier_page_repairs = 0
        self.injected_corruptions = 0
        self.restored_requests = 0
        self.tier_d2h_copies = 0
        self.tier_h2d_copies = 0
        self.tier_blocking_spills = 0
        self.recovery_fetches = 0
        self.adapter_rejects = 0
        self.adapter_load_retries = 0
        self.grammar_rejects = 0
        self.grammar_load_retries = 0
        # the streaming report's aggregates (every finished stream)
        self.completed_count = 0
        self.generated_tokens = 0
        self.ontime_tokens = 0
        self.deadline_misses = 0
        self.queue_blocks_sum = 0
        self.ttft_blocks_sum = 0
        # recovery work (a corrupted page's readers, a restored snapshot's
        # streams): (request, tokens delivered, their stamps), re-admitted
        # ahead of fresh admissions
        self._replay_q: deque = deque()
        self._replay_tokens = 0     # max_new_tokens summed over _replay_q
        # the pipeline (async_loop): dispatched blocks not yet harvested,
        # first tokens on the device, and retired requests whose last
        # tokens are still in flight (their completions, tokens to come)
        self._inflight: deque = deque()
        self._first_pending: List[dict] = []
        self._tok_from: Dict[int, int] = {}
        self._tail: Dict[int, Completion] = {}
        self._seq = 0
        self._first_next = 0
        self._first_cap = 4 * b     # first tokens drawn between two replays, at most 3b
        if self.async_loop:
            n = (self.block_steps + 1) * b + 2 * self._first_cap
            dev = torch.device("cpu") if self._sim else lm.device
            # [block out (K + 1, b) | first tokens (cap) | their finite flags (cap)]
            self._ring = torch.zeros((n,), dtype=torch.int32, device=dev)
            self._ring_host = [torch.zeros((n,), dtype=torch.int32,
                                           pin_memory=dev.type == "cuda") for _ in range(2)]
            self._ring_turn = 0
        self._fused = None
        t0 = time.perf_counter()
        if self.fused and not self._sim:
            self._fused = lm.compile_session_decode_fused(self.block_steps, self.slot_sampler,
                                                          self.pad_token_id)
        self.capture_s = time.perf_counter() - t0

    # --- submission ------------------------------------------------------

    def register_adapter(self, name: str, lora_params, lora_config) -> None:
        """Register ``name``'s LoRA weights (a port ``init_lora`` tree and
        its ``LoraConfig``) with the session's adapter pool: host only; the
        adapter loads at the first admission that pins it."""
        if not self.lora:
            raise ValueError("register_adapter requires a CausalLM built with lora_rank")
        self.session.adapters.register(name, lora_params, lora_config)

    def register_grammar(self, name: str, regex: Optional[str] = None,
                         json_schema: Optional[dict] = None) -> None:
        """Compile and register a grammar with the session's grammar pool
        (host only; its tables load at the first admission that pins them).
        A bad pattern raises ``GrammarCompileError`` here."""
        if not self.grammar:
            raise ValueError("register_grammar requires a CausalLM built with grammar_slots")
        self.session.grammars.register(name, regex=regex, json_schema=json_schema)

    def _validate_tenancy(self, adapter: Optional[str], grammar: Optional[str],
                          max_new_tokens: int) -> None:
        """JAX ``engine.py:770-815``: a known adapter and grammar, and a
        budget that lets the grammar reach an accept state."""
        if adapter is not None:
            if not self.lora:
                raise ValueError("submit(adapter=) requires a CausalLM built with lora_rank")
            if not self.session.adapters.registered(adapter):
                raise ValueError(f"unknown adapter {adapter!r} (register_adapter first)")
        if grammar is not None:
            if not self.grammar:
                raise ValueError("submit(grammar=) requires a CausalLM built with grammar_slots")
            pool = self.session.grammars
            if not pool.registered(grammar):
                raise ValueError(f"unknown grammar {grammar!r} (register_grammar first)")
            need = pool.min_tokens(grammar)
            if max_new_tokens < need:
                raise ValueError(f"grammar {grammar!r} needs at least {need} tokens to reach an "
                                 f"accept state; max_new_tokens {max_new_tokens} could never "
                                 f"parse")

    def _reserve_slack(self, may_end_on_eos: bool = True) -> int:
        """Decode-overrun page reserve (JAX ``engine.py:1279-1289``): a
        finished row writes at most ``block_steps - 1`` positions past its
        last delivered token, and one block more in the pipelined loop when
        the stream may end on EOS (the latch comes back a block late). A
        request with no EOS id ends on its budget or the cache edge, which
        the pipelined loop retires at the synchronous loop's block: its
        reserve, and so its pages, are the synchronous loop's."""
        return 2 * self.block_steps if self.async_loop and may_end_on_eos else self.block_steps

    def _is_chunked(self, req: Request) -> bool:
        return bool(self.prefill_chunk_tokens and req.prompt.size > self.prefill_chunk_tokens)

    def submit(self, prompt, max_new_tokens: int, sampler: Optional[Sampler] = None,
               eos_token_id: Optional[int] = None, arrival_block: int = 0,
               ttft_deadline_ms: Optional[float] = None, deadline_ms: Optional[float] = None,
               tenant: str = "default", adapter: Optional[str] = None,
               grammar: Optional[str] = None,
               request_id: Optional[int] = None) -> Union[int, Rejected]:
        """Queue a request; returns its id, or the :class:`Rejected` verdict
        when the bounded queue sheds it on arrival (JAX ``engine.py:860``).
        A prompt longer than the largest bucket is accepted when it will be
        chunked. ``ttft_deadline_ms`` and ``deadline_ms`` are budgets from
        the arrival block for the first token and the whole stream, turned
        into blocks at ``block_time_ms``; ``tenant`` is a label the
        completion carries; ``adapter`` and ``grammar`` name a registered
        adapter and grammar."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        room = self.lm.config.max_seq_len - 1
        if prompt.size + max_new_tokens > room:
            raise ValueError(f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds serveable cache room {room}")
        chunked = self.prefill_chunk_tokens and prompt.size > self.prefill_chunk_tokens
        if prompt.size > self.lm.buckets[-1] and not chunked:
            raise ValueError(f"prompt length {prompt.size} exceeds largest bucket "
                             f"{self.lm.buckets[-1]}")
        if self.paged:
            pkv = self.session.paged
            need = pkv.pages_needed(prompt.size, max_new_tokens
                                    + self._reserve_slack(eos_token_id is not None))
            if need > pkv.capacity_pages():
                raise ValueError(f"request needs {need} pages, pool holds at most "
                                 f"{pkv.capacity_pages()}")
        sampler = sampler or Sampler(greedy=True)
        if (sampler.top_k, sampler.top_p) != (self.slot_sampler.top_k, self.slot_sampler.top_p):
            raise ValueError(f"request sampler top_k/top_p {sampler.top_k}/{sampler.top_p} "
                             f"differ from the engine's {self.slot_sampler.top_k}/"
                             f"{self.slot_sampler.top_p}")
        greedy = bool(sampler.greedy or sampler.temperature == 0.0)
        self._validate_tenancy(adapter, grammar, int(max_new_tokens))
        rid = self._next_id if request_id is None else int(request_id)
        req = Request(request_id=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      temperature=0.0 if greedy else float(sampler.temperature),
                      greedy=greedy, arrival_block=int(arrival_block),
                      submit_block=self.blocks,
                      ttft_deadline_block=self._deadline_block(arrival_block, ttft_deadline_ms,
                                                               "ttft_deadline_ms"),
                      deadline_block=self._deadline_block(arrival_block, deadline_ms,
                                                          "deadline_ms"),
                      tenant=str(tenant), adapter=adapter, grammar=grammar)
        self._next_id = max(self._next_id, rid + 1)
        now = time.perf_counter()
        self._submit_ts[rid] = now
        if self.tracer.enabled:
            self.tracer.instant(
                "submit", ("req", rid), block=self.blocks, ts=now,
                args={"prompt_len": int(prompt.size), "max_new_tokens": int(max_new_tokens),
                      "arrival_block": req.arrival_block,
                      "ttft_deadline_block": req.ttft_deadline_block,
                      "deadline_block": req.deadline_block, "tenant": req.tenant,
                      "adapter": req.adapter, "grammar": req.grammar, "engine": self.lane})
        # an arrived request into a full backlog is shed now; a future
        # arrival is shed, if at all, at the block it arrives in
        # (_shed_overflow). Free slots extend the bound only where the page
        # pool could fill them (JAX engine.py:949-965)
        if self.max_queue is not None and req.arrival_block <= self.blocks:
            arrived = self.queue.arrived_count(self.blocks)
            pool_bound = not self._pool_can_admit(req)
            usable = 0 if pool_bound else len(self._free_slots())
            if arrived >= self.max_queue + usable:
                return self._shed(req, pool_bound=pool_bound)
        self.queue.append(req)
        self._m_queue.set(len(self.queue))
        return rid

    def cancel(self, request_id: int) -> bool:
        """Retire a request in whatever state it is in (JAX
        ``engine.py:970``): queued, it is dropped; mid-chunked-prefill, its
        slot is freed and its pages rolled back, with no completion;
        decoding, it retires now with a partial completion
        (``finish_reason="cancelled"``; the pipelined loop first drains,
        and a stream the drain finishes completes normally). Returns False
        when the id is unknown or already completed."""
        queued = self.queue.remove(request_id)
        if queued is not None:
            self._release_pins(queued)
            self._submit_ts.pop(request_id, None)
            self.cancelled += 1
            self._trace_req("cancel", request_id, state="queued")
            return True
        for i, (req, pregen, ts) in enumerate(self._replay_q):
            if req.request_id == request_id:
                # the client holds the delivered tokens: the completion
                # carries them
                del self._replay_q[i]
                self._replay_tokens -= req.max_new_tokens
                self._out[request_id] = list(pregen)
                self._out_ts[request_id] = list(ts)
                self._complete(Completion(
                    request_id=request_id, tokens=np.zeros((0,), np.int64),
                    prompt_len=req.prompt.size,
                    queue_blocks=max((req.start_block if req.start_block is not None
                                      else self.blocks) - req.arrival_block, 0),
                    decode_blocks=self.blocks - (req.start_block or 0),
                    ttft_blocks=max((req.first_token_block if req.first_token_block is not None
                                     else self.blocks) - req.arrival_block, 0),
                    submit_ts=self._submit_ts.pop(request_id, None), cancelled=True,
                    deadline_missed=self._missed(req), tenant=req.tenant,
                    adapter=req.adapter, grammar=req.grammar,
                    finish_reason="cancelled"), self.blocks)
                self._release_pins(req)
                self.cancelled += 1
                return True
        for slot, st in list(self._prefilling.items()):
            if st.req.request_id == request_id:
                self._abort_prefill(slot, requeue=False)
                self._release_pins(st.req)
                self._submit_ts.pop(request_id, None)
                self.cancelled += 1
                self._trace_req("cancel", request_id, state="prefill")
                return True
        if request_id in self._tail:    # retired, its last tokens in flight
            self._flush()
            return False
        for slot, req in enumerate(self.slots):
            if req is not None and req.request_id == request_id:
                if self.async_loop:
                    self._flush()
                    self._retire_finished()
                    if self.slots[slot] is not req:
                        return False
                self._retire([slot], reason="cancelled")
                self.cancelled += 1
                return True
        return False

    # --- scheduling internals -------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    # --- deadlines and shedding -------------------------------------------

    def _deadline_block(self, arrival_block: int, ms: Optional[float],
                        name: str) -> Optional[int]:
        if ms is None:
            return None
        if ms <= 0:
            raise ValueError(f"{name} must be > 0, got {ms}")
        return int(arrival_block) + max(1, int(np.ceil(float(ms) / self.block_time_ms)))

    def _deadline_passed(self, r: Request) -> bool:
        return ((r.ttft_deadline_block is not None and self.blocks > r.ttft_deadline_block)
                or (r.deadline_block is not None and self.blocks > r.deadline_block))

    def _missed(self, req: Request) -> bool:
        """Whether ``req``, retiring now, missed a deadline: its first token
        (the admission's block, the virtual clock's) came after its TTFT
        deadline, or the clock is past its completion deadline."""
        if req.ttft_deadline_block is not None and (
                req.first_token_block is None
                or req.first_token_block > req.ttft_deadline_block):
            return True
        return req.deadline_block is not None and self.blocks > req.deadline_block

    def _delivered(self, slot: int) -> int:
        """Tokens the slot's stream holds by the blocks dispatched so far:
        the host's own count, which the pipelined loop knows a block before
        the tokens come back (JAX reads ``len(_out)``, equal in its
        synchronous loop)."""
        if slot in self._prefilling:
            return 0
        return min(int(self._gen_counts[slot]), self.slots[slot].max_new_tokens)

    def _retry_after(self) -> int:
        """Blocks to drain the backlog (JAX ``engine.py:1267``): the
        undelivered token budget, queued, waiting to replay and in the
        slots, over the pool's ``max_batch * block_steps`` tokens a
        block."""
        inflight = sum(r.max_new_tokens - self._delivered(i)
                       for i, r in enumerate(self.slots) if r is not None)
        rate = max(self.lm.max_batch * self.block_steps, 1)
        return max(1, -(-(self.queue.tokens() + self._replay_tokens + inflight) // rate))

    def _need_pages(self, req: Request) -> int:
        """Pages ``req``'s admission takes: prompt, budget and reserve."""
        return self.session.paged.pages_needed(
            req.prompt.size, req.max_new_tokens + self._reserve_slack(req.eos_token_id is not None))

    def _pool_can_admit(self, req: Request) -> bool:
        """Whether the page pool could take this admission now, counting
        what reclaim (tier spill, else eviction) would free (JAX
        ``engine.py:1291``); the slab always can."""
        if not self.paged:
            return True
        pkv = self.session.paged
        need = self._need_pages(req)
        free = pkv.allocator.available()
        if free < need and pkv.prefix is not None:
            free += pkv.prefix.reclaimable_pages()
        return free >= need

    def _pool_retry_after(self, req: Optional[Request] = None) -> int:
        """Pool-pressure retry estimate (JAX ``engine.py:1309``): 1 block
        when a spill could free what ``req`` needs (the next admission
        attempt reclaims it), else the oldest decoding stream's remaining
        budget in blocks, the earliest retirement that returns pages."""
        pkv = self.session.paged if self.paged else None
        if (req is not None and pkv is not None and pkv.prefix is not None
                and pkv.tier is not None):
            if pkv.allocator.available() + pkv.prefix.spillable_pages() >= self._need_pages(req):
                return 1
        oldest = None
        for slot, r in enumerate(self.slots):
            if r is None or slot in self._prefilling:
                continue
            if oldest is None or (r.start_block or 0) < (self.slots[oldest].start_block or 0):
                oldest = slot
        if oldest is None:
            return 1
        remaining = self.slots[oldest].max_new_tokens - self._delivered(oldest)
        return max(1, -(-remaining // self.block_steps))

    def _note_pool_pressure(self, reqs: Sequence[Request]) -> None:
        """A ``pool_defer`` mark on each deferred request's lane."""
        if self.tracer.enabled:
            free = self.session.paged.allocator.available() if self.paged else None
            for r in reqs:
                self._trace_req("pool_defer", r.request_id, free_pages=free)

    def _shed(self, req: Request, pool_bound: bool = False) -> Union[int, Rejected]:
        """Shed on a full arrived backlog (JAX ``engine.py:1356``): ``tail``
        rejects the newcomer; ``deadline`` rejects the laxest deadline of
        the queue and the newcomer (a displaced queued request surfaces in
        ``rejected``). ``pool_bound``: forced by page-pool exhaustion, said
        in the reason, and the retry-after covers the oldest stream's
        remaining budget."""
        victim = req
        if self.shed_policy == "deadline":
            worst = self.queue.peek_lax_victim(self.blocks)
            if worst is not None and shed_deadline_key(worst) > shed_deadline_key(req):
                self.queue.remove(worst.request_id)
                self.queue.append(req)
                victim = worst
                self.shed_evictions += 1
        retry = self._retry_after()
        if pool_bound:
            retry = max(retry, self._pool_retry_after(victim))
        rej = Rejected(request_id=victim.request_id, retry_after_blocks=retry,
                       queue_depth=self.queue.arrived_count(self.blocks),
                       reason="pool_exhausted" if pool_bound else "queue_full")
        self.rejected.append(rej)
        self._submit_ts.pop(victim.request_id, None)
        self._release_pins(victim)
        self._trace_req("shed", victim.request_id, policy=self.shed_policy, reason=rej.reason,
                        retry_after_blocks=rej.retry_after_blocks, queue_depth=rej.queue_depth,
                        evicted=victim is not req)
        return rej if victim is req else req.request_id

    def _shed_overflow(self) -> None:
        """The backlog bound at a block boundary (JAX ``engine.py:1397``):
        requests submitted ahead of their arrival arrive here, and the
        arrived backlog past ``max_queue`` plus the slots still free after
        admission is shed by policy."""
        if self.max_queue is None:
            return
        limit = self.max_queue + len(self._free_slots())
        while True:
            arrived = self.queue.arrived_count(self.blocks)
            if arrived <= limit:
                return
            victim = (self.queue.peek_lax_victim(self.blocks) if self.shed_policy == "deadline"
                      else self.queue.peek_tail_victim(self.blocks))
            if victim is None:
                return
            # traced: whether the victim is not the newest arrival (the
            # deadline policy evicted a queued request ahead of it)
            evicted = (self.tracer.enabled
                       and victim is not self.queue.peek_tail_victim(self.blocks))
            self.queue.remove(victim.request_id)
            self.rejected.append(Rejected(request_id=victim.request_id,
                                          retry_after_blocks=self._retry_after(),
                                          queue_depth=arrived - 1))
            self._submit_ts.pop(victim.request_id, None)
            self._release_pins(victim)
            self._trace_req("shed", victim.request_id, policy=self.shed_policy,
                            at="block_boundary", queue_depth=arrived - 1, evicted=evicted)

    def _expire_request(self, req: Request) -> None:
        """A deadline passed before decoding began: an empty ``expired``
        completion now (JAX ``engine.py:1590``)."""
        rid = req.request_id
        self._trace_req("expire", rid, generated=0, state="pre_decode", deadline_missed=True)
        waited = max(self.blocks - req.arrival_block, 0)
        self._emit_completion(Completion(
            request_id=rid, tokens=np.zeros((0,), np.int64), prompt_len=req.prompt.size,
            queue_blocks=waited, decode_blocks=0, ttft_blocks=waited,
            token_ts=np.zeros((0,), np.float64), submit_ts=self._submit_ts.pop(rid, None),
            expired=True, deadline_missed=True, tenant=req.tenant, adapter=req.adapter,
            grammar=req.grammar, finish_reason="expired"))
        self._release_pins(req)
        self.expired += 1

    def _expire_queued(self) -> None:
        for r in self.queue.expire_due(self.blocks):
            self._expire_request(r)

    def _expire_prefilling(self) -> None:
        """A deadline passed mid-chunked-prefill: the admission rolls back
        (pages released, as ``cancel`` does) and the request expires."""
        for slot, st in list(self._prefilling.items()):
            if self._deadline_passed(st.req):
                self._abort_prefill(slot, requeue=False)
                self._expire_request(st.req)

    def _expire_decoding(self) -> None:
        """Streams past their completion deadline retire now with the
        tokens delivered so far (JAX ``engine.py:1639``). The decision reads
        the virtual clock; the pipelined loop drains first, so the partial
        holds every token the synchronous loop's does."""
        def victims():
            ended = self._done | self._budget_done()
            return [slot for slot, r in enumerate(self.slots)
                    if r is not None and slot not in self._prefilling and not ended[slot]
                    and r.deadline_block is not None and self.blocks > r.deadline_block]

        if not victims():
            return
        self._flush()
        late = victims()    # a stream the drain finished retires normally
        if late:
            self._retire(late, reason="expired")
            self.expired += len(late)

    # --- observability seams ----------------------------------------------

    def _trace_req(self, name: str, rid: int, ts: Optional[float] = None,
                   block: Optional[int] = None, **args) -> None:
        """An instant on request ``rid``'s lane."""
        if self.tracer.enabled:
            self.tracer.instant(name, ("req", rid), ts=ts,
                                block=self.blocks if block is None else block,
                                args=args or None)

    def _dispatch(self, kind: str, fn):
        """Run one program launch (``insert``, ``extend`` or ``decode``)
        with retry (JAX ``engine.py:1431``): the fault injector, when armed,
        fails the launch before ``fn`` runs, so a retry re-runs nothing on
        the device; each failure is a ``fault:dispatch`` instant on the
        faults lane, the next attempt waits ``dispatch_backoff_s * 2**(n -
        1)``, and past ``dispatch_retries`` retries :class:`DispatchFailed`
        is raised. A launch that ran is timed (host side) into
        ``serve_dispatch_ms{kind}`` and, traced, a span on the dispatch
        lane. It waits for nothing on the device."""
        hist = self._disp_hist.get(kind)
        if hist is None:
            hist = self._disp_hist[kind] = self.metrics.histogram(
                "serve_dispatch_ms", help="program launch wall ms (host side)", kind=kind)
        attempts = 0
        while True:
            try:
                if self._injector is not None:
                    self._injector.before_dispatch(kind)
                t0 = time.perf_counter()
                out = fn()
                t1 = time.perf_counter()
                hist.observe((t1 - t0) * 1e3)
                if self.tracer.enabled:
                    self.tracer.complete(kind, (self.lane, "dispatch"), t0, t1, block=self.blocks,
                                         args={"retries": attempts} if attempts else None)
                return out
            except TransientDispatchError as e:
                attempts += 1
                self.dispatch_retry_count += 1
                if self.tracer.enabled:
                    self.tracer.instant("fault:dispatch", (self.lane, "faults"), block=self.blocks,
                                        args={"kind": kind, "attempt": attempts,
                                              "error": str(e)})
                if attempts > self.dispatch_retries:
                    raise DispatchFailed(f"{kind} dispatch failed {attempts} times "
                                         f"(retry budget {self.dispatch_retries})") from e
                delay = self.dispatch_backoff_s * (2 ** (attempts - 1))
                if delay > 0:
                    time.sleep(delay)

    def _trace_queued(self, req: Request, now: float) -> None:
        """The request's ``queued`` span: from its submit to the moment a
        slot took it."""
        if self.tracer.enabled:
            self.tracer.complete("queued", ("req", req.request_id),
                                 self._submit_ts.get(req.request_id, now), now,
                                 block=self.blocks,
                                 args={"queue_blocks": max(self.blocks - req.arrival_block, 0)})

    def _observe_first_token(self, req: Request, slot: int, now: float, **extra) -> None:
        """The first token at admission, on the virtual clock: the TTFT
        histogram and the ``admit``/``first_token`` marks (the pipelined
        loop's token is still on the device; the mark does not wait)."""
        sts = self._submit_ts.get(req.request_id)
        if sts is not None:
            self._m_ttft.observe((now - sts) * 1e3)
        self._trace_req("admit", req.request_id, ts=now, slot=int(slot), **extra)
        self._trace_req("first_token", req.request_id, ts=now,
                        ttft_blocks=max(self.blocks - req.arrival_block, 0))

    def _observe_block(self) -> None:
        """Per-round levels (JAX ``engine.py:3468``): the arrived backlog
        and the pool's pages in use as gauges and, traced, counter tracks."""
        depth = self.queue.arrived_count(self.blocks)
        self._m_queue.set(depth)
        self._m_dropped.set(self.tracer.dropped)
        if self.tracer.enabled:
            self.tracer.counter("queue_depth", (self.lane, "queue"), depth, block=self.blocks)
        if self.paged:
            pkv = self.session.paged
            in_use = pkv.allocator.in_use()
            self._m_pool.set(in_use)
            if self.tracer.enabled:
                self.tracer.counter("pages_in_use", ("cache", "pool"), in_use,
                                    block=self.blocks)
                if pkv.tier is not None:
                    self.tracer.counter("tier_pages", ("cache", "tier"), pkv.tier_pages(),
                                        block=self.blocks)
        if self.tracer.enabled:   # resident adapters and grammars (JAX engine.py:3490)
            if self.lora:
                self.tracer.counter("adapter_pool_pages", ("cache", "adapter"),
                                    self.session.adapters.in_use(), block=self.blocks)
            if self.grammar:
                self.tracer.counter("grammar_pool_slots", ("cache", "grammar"),
                                    self.session.grammars.in_use(), block=self.blocks)

    def request_timeline(self, request_id: int) -> List[dict]:
        """The request's recorded lifecycle, oldest first (JAX
        ``engine.py:4011``): per event its name, wall ``ts_ms`` from the
        tracer's epoch, virtual ``block``, ``dur_ms`` for spans and args.
        Empty when tracing was off."""
        picked = [(i, ev) for i, ev in enumerate(self.tracer.events())
                  if ev["lane"] == ("req", request_id)]
        picked.sort(key=lambda t: (t[1]["ts"], t[0]))
        out = []
        for _, ev in picked:
            d = {"name": ev["name"], "ts_ms": round((ev["ts"] - self.tracer._t0) * 1e3, 3),
                 "block": ev["block"], "args": ev["args"] or {}}
            if ev["ph"] == "X":
                d["dur_ms"] = round(ev["dur"] * 1e3, 3)
            out.append(d)
        return out

    def _draw(self, logits: torch.Tensor, keys: np.ndarray, counts, temps: np.ndarray,
              greedy: np.ndarray, allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows' tokens under their keys at their token counters (within
        ``allowed`` when given), then one flag a row (1 where its logits are
        all finite), as one int32 tensor ``(2 * rows,)`` on the device: the
        fused block's sampling math."""
        h2d = self.lm._ids
        tok = draw_rows(logits, h2d(keys[:, 0]), h2d(keys[:, 1]), h2d(counts),
                        h2d(temps, torch.float32), h2d(greedy, torch.bool), self.slot_sampler,
                        allowed)
        return torch.cat([tok, torch.isfinite(logits).all(-1).to(torch.int32)])

    def _first_allowed(self, reqs: Sequence[Request], gstates,
                       counts) -> Optional[torch.Tensor]:
        """The budget-aware mask of a first-token draw (insert, final chunk,
        replay) for requests at DFA states ``gstates`` and token counters
        ``counts``: the block's :func:`grammar_allowed` on the device
        tables (JAX builds the same boolean on the host, ``:1202``). None
        when no request is constrained."""
        if not self.grammar or all(r.grammar is None for r in reqs):
            return None
        h2d = self.lm._ids
        return grammar_allowed(self.session.grammars.tables,
                               h2d([self._grammar_slot(r) for r in reqs]), h2d(gstates),
                               h2d([r.max_new_tokens for r in reqs]), h2d(counts))

    def _sim_draw(self, rids: Sequence[int], counts: Sequence[int]) -> torch.Tensor:
        """:meth:`_draw`'s layout from the sim token function (every row
        finite), on the host."""
        toks = self.lm.sim_first_tokens(rids, counts)
        return torch.tensor(toks + [1] * len(toks), dtype=torch.int32)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A blocking read of a block's (or a step's) output: a ``fetch``
        span on the dispatch lane when traced."""
        self.host_fetches += 1
        if not self.tracer.enabled:
            return t.cpu().numpy()
        t0 = time.perf_counter()
        out = t.cpu().numpy()
        self.tracer.complete("fetch", (self.lane, "dispatch"), t0, time.perf_counter(),
                             block=self.blocks)
        return out

    def _admit(self) -> None:
        """Expire the queued requests past their deadline, admit arrived
        ones into free slots, then bound what is left of the arrived backlog
        (``max_queue``), as JAX ``engine.py:1670`` does."""
        self._expire_queued()
        try:
            self._admit_loop()
        finally:
            self._shed_overflow()

    def _admit_loop(self) -> None:
        """Admission in EDF order, deque position on a tie (JAX
        ``engine.py:1685-1754``): a long prompt takes the chunked path
        alone; otherwise the head request's bucket defines a group, which
        grows until a request of another bucket or a long one; each group
        is one right-sized insert. Each request pins its adapter and its
        grammar first (keyed on (tenant, adapter)): one that cannot is shed
        or requeued and sits out the rest of this round, while its group
        mates still ride the insert."""
        deferred: set = set()
        while True:
            free = self._free_slots()
            if not free:
                return
            order = self.queue.peek_edf(self.blocks, deferred, len(free))
            if not order:
                return
            head = order[0]
            if self._is_chunked(head):
                self.queue.remove(head.request_id)
                if not (self._acquire(head, "adapter") and self._acquire(head, "grammar")):
                    deferred.add(head.request_id)
                    continue
                self._begin_chunked(head, free[0])
                continue
            bucket = self.lm._bucket_for(head.prompt.size)
            group = []
            for r in order:
                if self._is_chunked(r) or self.lm._bucket_for(r.prompt.size) != bucket:
                    break
                group.append(r)
            for r in group:
                self.queue.remove(r.request_id)
            admitted = []
            for r in group:
                if self._acquire(r, "adapter") and self._acquire(r, "grammar"):
                    admitted.append(r)
                else:
                    deferred.add(r.request_id)
            group = admitted
            if not group:
                continue
            try:
                self._insert_group(group, free[: len(group)])
            except PagePoolExhausted:
                # no device work ran: requeue, retry the head alone first
                self.deferred_admissions += 1
                self.queue.extendleft(reversed(group[1:]))
                self._note_pool_pressure(group[1:])
                try:
                    self._insert_group(group[:1], free[:1])
                except PagePoolExhausted:
                    self.queue.appendleft(group[0])
                    self._note_pool_pressure(group[:1])
                    return

    # --- tenancy: adapter and grammar pins ------------------------------

    def _acquire(self, req: Request, kind: str) -> bool:
        """Load and pin ``req``'s adapter or grammar (``kind``) at admission
        (JAX ``engine.py:1039``, ``:1107``); True when it needs none or
        holds its pin. False means it does not admit this round: a full
        pool sheds it (``Rejected(reason="<kind>_pool_exhausted")``, its
        other pin released), a load fault requeues it at the head."""
        name = getattr(req, kind)
        pins = self._adapter_pins if kind == "adapter" else self._grammar_pins
        if name is None or not getattr(self, "lora" if kind == "adapter" else "grammar"):
            return True
        if req.request_id in pins:
            return True
        pool = self.session.adapters if kind == "adapter" else self.session.grammars
        exhausted = AdapterPoolExhausted if kind == "adapter" else GrammarPoolExhausted
        load_error = AdapterLoadError if kind == "adapter" else GrammarLoadError
        loads_before = pool.loads
        try:
            slot = pool.acquire(name)
        except exhausted:
            rej = Rejected(request_id=req.request_id, retry_after_blocks=self._pool_retry_after(),
                           queue_depth=self.queue.arrived_count(self.blocks),
                           reason=f"{kind}_pool_exhausted")
            self.rejected.append(rej)
            setattr(self, f"{kind}_rejects", getattr(self, f"{kind}_rejects") + 1)
            self._submit_ts.pop(req.request_id, None)
            self._release_pins(req)
            self._trace_req("shed", req.request_id, reason=rej.reason, **{kind: name},
                            retry_after_blocks=rej.retry_after_blocks)
            return False
        except load_error as e:
            setattr(self, f"{kind}_load_retries", getattr(self, f"{kind}_load_retries") + 1)
            self._trace_req(f"{kind}_defer", req.request_id, **{kind: name}, error=str(e))
            self.queue.appendleft(req)
            return False
        pins[req.request_id] = name
        self._trace_req(f"{kind}_load", req.request_id, **{kind: name}, slot=int(slot),
                        cold=pool.loads > loads_before)
        return True

    def _adapter_slot(self, req: Request) -> int:
        if req.adapter is None or not self.lora:
            return 0
        return self.session.adapters.slot_of(req.adapter)

    def _grammar_slot(self, req: Request) -> int:
        if req.grammar is None or not self.grammar:
            return 0
        return self.session.grammars.slot_of(req.grammar)

    def _release_pins(self, req: Request) -> None:
        """Drop ``req``'s adapter and grammar pins (they stay resident)."""
        name = self._adapter_pins.pop(req.request_id, None)
        if name is not None:
            self.session.adapters.release(name)
        name = self._grammar_pins.pop(req.request_id, None)
        if name is not None:
            self.session.grammars.release(name)

    def _set_tenancy(self, slot: int, req: Optional[Request], gstate: int = 0) -> None:
        """The slot's tenancy mirrors for ``req`` (None: an idle slot), and
        the DFA state its stream's walk starts from."""
        self._adapter_idx[slot] = 0 if req is None else self._adapter_slot(req)
        self._gidx[slot] = 0 if req is None else self._grammar_slot(req)
        self._gstate[slot] = gstate
        self._gbudget[slot] = 0 if req is None else req.max_new_tokens
        if req is not None and self._gidx[slot]:
            self._dfa[req.request_id] = gstate

    def _grammar_walk(self, name: str, state: int, tokens: Sequence[int]) -> int:
        """The DFA state after ``tokens`` (a resumed stream's, JAX
        ``engine.py:1166``)."""
        dfa = self.session.grammars.grammar(name)
        for t in tokens:
            state = dfa.walk(state, int(t))
            if state < 0:
                raise ValueError(f"delivered token {int(t)} violates grammar {name!r}: the "
                                 f"recovery record is corrupt")
        return state

    def _start_stream(self, slot: int, req: Request, temp: float, greedy: bool,
                      tok: Optional[int], first_idx: Optional[int], now: float,
                      **extra) -> None:
        """Hand ``slot`` to the decode pool with its first token: ``tok``,
        fetched, or, in the pipelined loop, entry ``first_idx`` of the first
        tokens left on the device (``extra``: args of the ``admit`` mark)."""
        rid = req.request_id
        req.first_token_block = self.blocks
        self._observe_first_token(req, slot, now, **extra)
        self.slots[slot] = req
        self._out[rid] = []
        self._out_ts[rid] = []
        self._keys[slot] = split_key(request_seed(self.seed, rid))
        self._active[slot] = True
        self._done[slot] = False
        self._eos[slot] = -1 if req.eos_token_id is None else req.eos_token_id
        self._temp[slot] = temp
        self._greedy[slot] = greedy
        self._gen_counts[slot] = 1
        self._set_tenancy(slot, req)
        self._staged.add(slot)
        if tok is None:
            self._tok[slot] = 0
            self._tok_from[slot] = first_idx
            self._first_pending.append(dict(slot=slot, req=req, idx=first_idx, seq=self._seq,
                                            block=self.blocks))
        else:
            self._tok[slot] = tok
            self._record(slot, tok, now)

    def _first_tokens(self, drawn: torch.Tensor, rows: int):
        """The first tokens of ``rows`` admissions: fetched now (the
        synchronous loop), or copied on the device beside the next block's
        output (the pipelined loop; returns their first index there)."""
        if not self.async_loop:
            got = drawn.cpu().numpy()
            self.nonfinite_logits += int((got[rows:] == 0).sum())
            return got[:rows], None
        i0, cap = self._first_next, self._first_cap
        if i0 + rows > cap:
            raise RuntimeError(f"{i0 + rows} first tokens between two blocks, room for {cap}")
        base = (self.block_steps + 1) * self.lm.max_batch
        self._ring[base + i0: base + i0 + rows].copy_(drawn[:rows])
        self._ring[base + cap + i0: base + cap + i0 + rows].copy_(drawn[rows:])
        self._first_next += rows
        return None, i0

    def _insert_group(self, group: List[Request], slot_ids: List[int]) -> None:
        rows = len(group)
        bucket = self.lm._bucket_for(max(r.prompt.size for r in group))
        ids = np.zeros((rows, bucket), np.int32)
        lens = np.zeros((rows,), np.int32)
        for i, r in enumerate(group):
            ids[i, : r.prompt.size] = r.prompt
            lens[i] = r.prompt.size
        reserve = np.asarray([r.max_new_tokens + self._reserve_slack(r.eos_token_id is not None)
                              for r in group], np.int64)
        aslots = (np.asarray([self._adapter_slot(r) for r in group], np.int32)
                  if self.lora else None)
        tier_before = self._tier_marker()
        # prefix KV is a function of (tokens, adapter): the radix walk is
        # namespaced by adapter (JAX engine.py:1808)
        logits = self._dispatch("insert", lambda: self.lm.insert(
            self.session, np.asarray(slot_ids, np.int32), ids, lengths=lens,
            pad_token_id=self.pad_token_id, reserve_tokens=reserve if self.paged else None,
            ns=[r.adapter for r in group] if self.paged else None, adapter_slots=aslots))
        self._note_tier_restore(group, tier_before)
        self.inserts += 1
        self.inserted_requests += rows
        temps = np.asarray([r.temperature for r in group], np.float32)
        greedy = np.asarray([r.greedy for r in group], bool)
        # token index 0 of each request's key stream
        if self._sim:
            drawn = self._sim_draw([r.request_id for r in group], [0] * rows)
        else:
            keys = np.asarray([split_key(request_seed(self.seed, r.request_id))
                               for r in group], np.int32)
            zero = np.zeros((rows,), np.int32)
            drawn = self._draw(logits, keys, zero, temps, greedy,
                               self._first_allowed(group, zero, zero))
        first, i0 = self._first_tokens(drawn, rows)
        now = time.perf_counter()
        for i, (r, slot) in enumerate(zip(group, slot_ids)):
            r.start_block = self.blocks
            self._trace_queued(r, now)
            self._start_stream(slot, r, temps[i], greedy[i],
                               None if first is None else int(first[i]),
                               None if first is not None else i0 + i, now,
                               bucket=bucket, rows=rows)

    # --- chunked prefill -------------------------------------------------

    def _begin_chunked(self, req: Request, slot: int) -> None:
        """Claim ``slot`` for a chunked admission (JAX ``engine.py:1898``):
        it leaves the free pool now but stays decode-inactive; a prefix hit
        starts the prefill at the page-aligned reused length."""
        chunk, written = None, 0
        if self.paged:
            reserve = req.max_new_tokens + self._reserve_slack(req.eos_token_id is not None)
            tier_before = self._tier_marker()
            chunk = self.session.paged.begin_chunked(req.prompt.tolist(),
                                                     req.prompt.size + reserve, ns=req.adapter)
            written = chunk.start
            self._note_tier_restore([req], tier_before)
        req.start_block = self.blocks
        self._trace_queued(req, time.perf_counter())
        self._trace_req("chunk_begin", req.request_id, slot=int(slot),
                        prompt_len=int(req.prompt.size), prefix_reused_tokens=int(written))
        self.slots[slot] = req
        self._active[slot] = False
        self._done[slot] = False
        # the chunks prefill under the request's adapter: their KV is its
        self._adapter_idx[slot] = self._adapter_slot(req)
        self._prefilling[slot] = _PrefillInFlight(req=req, slot=slot, written=written,
                                                  chunk=chunk)
        self._prefill_q.append(slot)

    def _advance_prefill(self) -> None:
        """Spend this round's prefill budget (JAX ``engine.py:1933``): up to
        ``prefill_chunk_tokens`` prompt tokens across the admissions in
        flight, FIFO. Pool pressure mid-chunk rolls the whole admission
        back and requeues it at the queue head."""
        budget = self.prefill_chunk_tokens
        while budget > 0 and self._prefill_q:
            slot = self._prefill_q[0]
            st = self._prefilling[slot]
            req = st.req
            remaining = req.prompt.size - st.written
            n = min(budget, remaining)
            final = n == remaining
            tables = None
            if self.paged:
                pkv = self.session.paged
                try:
                    pkv.extend_chunked(st.chunk, st.written + n, final=final)
                except PagePoolExhausted:
                    self._abort_prefill(slot, requeue=True)
                    self.deferred_admissions += 1
                    return
                tables = pkv.chunk_table(slot, st.chunk)[None]
            ids = req.prompt[st.written: st.written + n][None]
            aslots = [self._adapter_idx[slot]] if self.lora else None
            logits = self._dispatch("extend", lambda: self.lm.extend(
                self.session, [slot], ids, [n], [st.written], tables=tables,
                adapter_slots=aslots))
            self.chunk_program_calls += 1
            self.prefill_chunk_tokens_done += n
            st.written += n
            budget -= n
            self._trace_req("prefill_chunk", req.request_id, tokens=int(n),
                            written=int(st.written), of=int(req.prompt.size), final=bool(final))
            if final:
                self._finish_prefill(slot, st, logits)

    def _finish_prefill(self, slot: int, st: _PrefillInFlight, logits: torch.Tensor) -> None:
        """The final chunk landed (JAX ``engine.py:1978``): commit the pages
        and draw the first token at token index 0 of the request's key
        stream, the token a one-shot insert draws."""
        req = st.req
        self._prefill_q.popleft()
        del self._prefilling[slot]
        if self.paged:
            self.session.paged.finish_chunked(slot, st.chunk)
        self.session.active[slot] = True
        self.inserts += 1
        self.inserted_requests += 1
        if self._sim:
            drawn = self._sim_draw([req.request_id], [0])
        else:
            key = np.asarray([split_key(request_seed(self.seed, req.request_id))], np.int32)
            zero = np.zeros((1,), np.int32)
            drawn = self._draw(logits, key, zero, np.asarray([req.temperature], np.float32),
                               np.asarray([req.greedy]), self._first_allowed([req], zero, zero))
        first, i0 = self._first_tokens(drawn, 1)
        self._start_stream(slot, req, req.temperature, req.greedy,
                           None if first is None else int(first[0]), i0, time.perf_counter(),
                           chunked=True)

    def _abort_prefill(self, slot: int, requeue: bool) -> None:
        """Unwind a chunked admission in one step (JAX ``engine.py:2045``):
        pages released, the slot freed; ``requeue`` puts the request back at
        the queue head (its prefill restarts later)."""
        st = self._prefilling.pop(slot)
        self._prefill_q.remove(slot)
        if st.chunk is not None:
            self.session.paged.abort_chunked(slot, st.chunk)
        self.slots[slot] = None
        self._active[slot] = False
        self._set_tenancy(slot, None)
        self.session.lengths[slot] = 0
        self.session.active[slot] = False
        self._staged.add(slot)
        self.prefill_aborts += 1
        self._trace_req("prefill_abort", st.req.request_id, requeue=bool(requeue),
                        written=int(st.written))
        if requeue:
            st.req.start_block = None
            self.queue.appendleft(st.req)

    # --- emissions and retirement ----------------------------------------

    def _deliver(self, req: Request, token: int, ts: float, block: int,
                 slot: Optional[int] = None) -> bool:
        """Append one emitted token to ``req``'s stream unless it already
        ended (a ``tok`` mark stamped with the ``block`` that emitted it,
        and the gap since the last delivery into ``serve_itl_ms``); returns
        whether the stream has ended (EOS, budget, or an accept-terminal
        state of its grammar). A constrained stream's DFA state in its
        ``slot`` follows the token (JAX ``engine.py:1179``)."""
        rid = req.request_id
        if rid in self._ended or rid not in self._out:
            return True
        out = self._out[rid]
        out.append(token)
        self._out_ts[rid].append(ts)
        # the tokens of one fetch share a stamp: only gaps between
        # deliveries are inter-token latency
        last = self._last_tok_ts.get(rid)
        if last is not None and ts > last:
            self._m_itl.observe((ts - last) * 1e3)
        self._last_tok_ts[rid] = ts
        self._trace_req("tok", rid, ts=ts, block=block, t=int(token), i=len(out) - 1)
        if req.eos_token_id is not None and token == req.eos_token_id:
            self._ended.add(rid)
            self._finish_reason.setdefault(rid, "eos")
        if len(out) >= req.max_new_tokens:
            self._ended.add(rid)
            self._finish_reason.setdefault(rid, "budget")
        if rid in self._dfa:
            dfa = self.session.grammars.grammar(req.grammar)
            nxt = dfa.walk(self._dfa[rid], token)
            # a forbidden token (never drawn for a live row) keeps the state
            if nxt >= 0:
                self._dfa[rid] = nxt
                if slot is not None and self.slots[slot] is req:
                    self._gstate[slot] = nxt
                if dfa.terminal[nxt]:
                    self._ended.add(rid)
                    if self._finish_reason.get(rid) != "eos":
                        self._finish_reason[rid] = "grammar_accept"
        return rid in self._ended

    def _record(self, slot: int, token: int, ts: float, req: Optional[Request] = None,
                block: Optional[int] = None) -> None:
        """Deliver a token of ``req`` (by default the slot's request),
        emitted in ``block`` (by default the current one), and latch the
        slot's done when the stream ended."""
        req = self.slots[slot] if req is None else req
        block = self.blocks if block is None else block
        if req is not None and self._deliver(req, token, ts, block, slot) \
                and self.slots[slot] is req:
            self._done[slot] = True

    def _awaiting(self, rid: int) -> bool:
        """Whether a token of ``rid`` is still in flight (pipelined loop)."""
        return (any(r is not None and r.request_id == rid for rec in self._inflight
                    for r in rec["reqs"])
                or any(p["req"].request_id == rid for p in self._first_pending))

    def _retire(self, slots: List[int], reason: Optional[str] = None) -> None:
        """Free ``slots`` and complete their requests (``reason``:
        ``"cancelled"``, ``"expired"``, or None for a stream that ended); a
        request whose last tokens are in flight completes when they are
        harvested. Deadlines are judged now, on the virtual clock."""
        self.lm.retire(self.session, np.asarray(slots, np.int32))
        for slot in slots:
            req = self.slots[slot]
            rid = req.request_id
            expired = reason == "expired"
            comp = Completion(
                request_id=rid, tokens=np.zeros((0,), np.int64), prompt_len=req.prompt.size,
                queue_blocks=max(req.start_block - req.arrival_block, 0),
                decode_blocks=self.blocks - req.start_block,
                ttft_blocks=max(req.first_token_block - req.arrival_block, 0),
                submit_ts=self._submit_ts.pop(rid, None), cancelled=reason == "cancelled",
                expired=expired, deadline_missed=expired or self._missed(req),
                tenant=req.tenant, adapter=req.adapter, grammar=req.grammar,
                finish_reason=reason or "")
            # unpinned at the slot's release, in either loop (the adapter
            # and grammar stay resident)
            self._release_pins(req)
            self.slots[slot] = None
            self._active[slot] = False
            self._done[slot] = False
            self._set_tenancy(slot, None)
            self._tok_from.pop(slot, None)
            self._staged.add(slot)
            if reason is None and self._awaiting(rid):
                self._tail[rid] = (comp, self.blocks)
            else:
                self._complete(comp, self.blocks)

    def _complete(self, comp: Completion, block: int) -> None:
        """Fill in ``comp``'s tokens and hand it out, with a ``retire``,
        ``expire`` or ``cancel`` mark stamped with the retiring ``block``."""
        rid = comp.request_id
        self._dfa.pop(rid, None)
        comp.tokens = np.asarray(self._out.pop(rid), np.int64)
        comp.token_ts = np.asarray(self._out_ts.pop(rid), np.float64)
        self._last_tok_ts.pop(rid, None)
        reason = self._finish_reason.pop(rid, "budget")
        comp.finish_reason = comp.finish_reason or reason
        self._ended.discard(rid)
        self._trace_req("cancel" if comp.cancelled else "expire" if comp.expired else "retire",
                        rid, block=block, generated=len(comp.tokens),
                        deadline_missed=comp.deadline_missed)
        self._emit_completion(comp)

    def _emit_completion(self, comp: Completion) -> None:
        """Every finished stream leaves here (JAX ``engine.py:1528``): into
        the streaming report's counters, and into ``completed`` when
        ``keep_completions``."""
        self.completed_count += 1
        self.generated_tokens += len(comp.tokens)
        self.queue_blocks_sum += comp.queue_blocks
        self.ttft_blocks_sum += comp.ttft_blocks
        if comp.deadline_missed:
            self.deadline_misses += 1
        if not (comp.deadline_missed or comp.expired or comp.cancelled):
            self.ontime_tokens += len(comp.tokens)
        if self.keep_completions:
            self.completed.append(comp)

    def _budget_done(self) -> np.ndarray:
        """Decoding rows whose budget the blocks dispatched so far spend
        (JAX ``engine.py:3797``): the host's own count, which in the
        pipelined loop retires them at the block the synchronous loop
        does."""
        maxn = np.asarray([0 if r is None else r.max_new_tokens for r in self.slots], np.int64)
        return self._active & (self._gen_counts >= maxn)

    def _retire_finished(self) -> None:
        """Retire the decoding slots whose stream ended: latched done, or
        (the host's own count) budget spent by the blocks dispatched."""
        finished = np.nonzero(self._done | self._budget_done())[0]
        finished = [int(i) for i in finished
                    if self.slots[i] is not None and int(i) not in self._prefilling]
        if finished:
            self._retire(finished)

    # --- recovery: replay, page I/O, corrupted pages ----------------------
    # Token t of request r is a function of its logits and (seed, r, t):
    # a request whose KV is lost re-prefills prompt + delivered tokens and
    # resumes at index len(delivered) with the stream it would have had.

    def _tier_marker(self) -> Optional[int]:
        """Tier restores so far, before an admission (None without a
        tier): paired with :meth:`_note_tier_restore`."""
        pkv = self.session.paged if self.paged else None
        return None if pkv is None or pkv.tier is None else pkv.tier_restored_pages

    def _note_tier_restore(self, group: Sequence[Request], before: Optional[int]) -> None:
        """A ``tier_restore`` mark on each request of an admission that
        restored pages from the host tier (JAX ``engine.py:1764``; a group
        shares one count)."""
        if before is None or not self.tracer.enabled:
            return
        delta = self.session.paged.tier_restored_pages - before
        if delta > 0:
            for r in group:
                self._trace_req("tier_restore", r.request_id, pages=int(delta),
                                group_rows=len(group))

    def _drain_replays(self) -> None:
        """Re-admit recovery work into free slots ahead of fresh admissions
        (JAX ``engine.py:2084``): streams the client is consuming already.
        Pool pressure defers the rest to the next round."""
        while self._replay_q:
            free = self._free_slots()
            if not free:
                return
            req, pregen, ts = self._replay_q[0]
            try:
                self._replay_admission(req, pregen, ts, free[0])
            except PagePoolExhausted:
                self.deferred_admissions += 1
                self._note_pool_pressure(())
                return
            except (AdapterPoolExhausted, GrammarPoolExhausted):
                # a stream the client is consuming is never shed: it waits
                # for a pin to come back (JAX engine.py:2097)
                self.deferred_admissions += 1
                return
            except (AdapterLoadError, GrammarLoadError) as e:
                kind = "adapter" if isinstance(e, AdapterLoadError) else "grammar"
                setattr(self, f"{kind}_load_retries", getattr(self, f"{kind}_load_retries") + 1)
                self._trace_req(f"{kind}_defer", req.request_id,
                                **{kind: getattr(req, kind)}, state="replay")
                return
            self._replay_q.popleft()
            self._replay_tokens -= req.max_new_tokens

    def _replay_admission(self, req: Request, pregen: List[int], ts: List[float],
                          slot: int) -> None:
        """Rebuild a request's KV and resume its stream at token
        ``len(pregen)`` (JAX ``engine.py:2125``): prompt + delivered tokens
        prefill through largest-bucket ``extend`` chunks (surviving prefix
        pages reused, tiered ones restored), then token ``g`` is drawn at
        counter ``g`` under the request's key. Any exception unwinds the
        admission whole; the request stays queued for replay."""
        if self.async_loop:
            self._flush(recovery=True)
        # re-pin the stream's adapter and grammar before any page work (they
        # may have been evicted meanwhile); a full pool or a load fault
        # defers the replay (_drain_replays), never a wrong adapter
        for kind, pins in (("adapter", self._adapter_pins), ("grammar", self._grammar_pins)):
            name = getattr(req, kind)
            if name is not None and getattr(self, "lora" if kind == "adapter" else "grammar") \
                    and req.request_id not in pins:
                getattr(self.session, kind + "s").acquire(name)
                pins[req.request_id] = name
        aslot = self._adapter_slot(req)
        g = len(pregen)
        seq = (np.concatenate([req.prompt, np.asarray(pregen, np.int32)]) if g
               else np.asarray(req.prompt, np.int32))
        total = int(seq.size)
        chunk_cap = self.lm.buckets[-1]
        st, written = None, 0
        pkv = self.session.paged if self.paged else None
        if pkv is not None:
            tier_before = self._tier_marker()
            st = pkv.begin_chunked(seq.tolist(), total + (req.max_new_tokens - g)
                                   + self._reserve_slack(req.eos_token_id is not None),
                                   ns=req.adapter)
            written = st.start
            self._note_tier_restore([req], tier_before)
        logits = None
        try:
            while written < total:
                n = min(chunk_cap, total - written)
                tables = None
                if pkv is not None:
                    pkv.extend_chunked(st, written + n, final=written + n == total)
                    tables = pkv.chunk_table(slot, st)[None]
                ids, w = seq[written: written + n][None], written
                logits = self._dispatch("extend", lambda: self.lm.extend(
                    self.session, [slot], ids, [n], [w], tables=tables,
                    adapter_slots=[aslot] if self.lora else None))
                written += n
        except BaseException:
            if pkv is not None:
                pkv.abort_chunked(slot, st)
            self.session.lengths[slot] = 0
            self.session.active[slot] = False
            self._staged.add(slot)
            raise
        if pkv is not None:
            pkv.finish_chunked(slot, st)
        self.session.active[slot] = True
        rid = req.request_id
        # a resumed constrained stream's DFA state is a function of the
        # tokens it delivered: walk them, then mask token g as the
        # uninterrupted run would have
        rstate = (self._grammar_walk(req.grammar, 0, pregen)
                  if self.grammar and req.grammar is not None else 0)
        if self._sim:
            tok = self.lm.sim_token(rid, g)
        else:
            key = np.asarray([split_key(request_seed(self.seed, rid))], np.int32)
            got = self._draw(logits, key, np.full((1,), g, np.int32),
                             np.asarray([req.temperature], np.float32), np.asarray([req.greedy]),
                             self._first_allowed([req], [rstate], [g])).cpu().numpy()
            self.nonfinite_logits += int(got[1] == 0)
            tok = int(got[0])
        now = time.perf_counter()
        if req.start_block is None:
            req.start_block = self.blocks
        if req.first_token_block is None:
            req.first_token_block = self.blocks
        self.slots[slot] = req
        self._out[rid] = [int(t) for t in pregen]
        self._out_ts[rid] = list(ts[:g])
        self._keys[slot] = split_key(request_seed(self.seed, rid))
        self._active[slot] = True
        self._done[slot] = False
        self._eos[slot] = -1 if req.eos_token_id is None else req.eos_token_id
        self._temp[slot] = req.temperature
        self._greedy[slot] = req.greedy
        self._tok[slot] = tok
        self._gen_counts[slot] = g + 1
        self._set_tenancy(slot, req, rstate)
        self._staged.add(slot)
        if g == 0:
            self._observe_first_token(req, slot, now, replayed=True)
        else:
            # the resumed token's stamp: a sorted timeline shows the replay
            # before the token it resumed
            self._trace_req("replay_admit", rid, ts=now, slot=int(slot), resumed_at=int(g))
        self._record(slot, tok, now)
        self.inserts += 1
        self.inserted_requests += 1

    def _page_dtype(self) -> str:
        """The page pools' storage dtype as a string (``"int8"``,
        ``"bfloat16"``, ...); a sim engine's is ``"float32"``."""
        if self._sim:
            return "float32"
        return str(page_storage_dtype(self.lm.config)).replace("torch.", "")

    def _page_pools(self) -> Dict[str, List[torch.Tensor]]:
        """The per-layer tensors whose dim 0 is the page, by leaf name: a
        page's K and V (and an int8 pool's scales) travel, garble and are
        checksummed together, in name order."""
        c = self.session.cache
        pools = {"keys": c.keys, "values": c.values}
        if c.k_scales is not None:
            pools.update(k_scales=c.k_scales, v_scales=c.v_scales)
        return pools

    def _read_pages_bytes(self, pages: List[int]) -> List[Dict[str, np.ndarray]]:
        """Host copies of ``pages`` across every layer (JAX
        ``engine.py:2318``): per leaf one gather of the page list from each
        layer's pool and one blocking device-to-host copy, split into a
        ``{leaf: (layers, page_size, kv_heads, head_dim) array}`` per page.
        bf16 travels as its int16 bit pattern."""
        idx = self.lm._ids(pages, torch.long)
        out: List[Dict[str, np.ndarray]] = [{} for _ in pages]
        for name, pools in self._page_pools().items():
            got = torch.stack([t.index_select(0, idx) for t in pools], 1)
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16)
            arr = got.cpu().numpy()
            self.tier_d2h_copies += 1
            for i in range(len(pages)):
                out[i][name] = arr[i]
        return out

    def _write_pages_bytes(self, pages: List[int], datas: List[Dict[str, np.ndarray]]) -> None:
        """Write host copies back into ``pages`` in place (JAX
        ``engine.py:2334``): per leaf one blocking host-to-device copy and
        one indexed copy into each layer's pool, the tensors a captured
        decode block reads."""
        idx = self.lm._ids(pages, torch.long)
        for name, pools in self._page_pools().items():
            src = torch.from_numpy(np.stack([d[name] for d in datas], 1)).to(self.lm.device)
            self.tier_h2d_copies += 1
            if pools[0].dtype == torch.bfloat16:
                src = src.view(torch.bfloat16)
            for layer, t in enumerate(pools):
                t.index_copy_(0, idx, src[layer])

    def _read_page_bytes(self, page: int) -> Dict[str, np.ndarray]:
        """One page's host copy: the tier's spill read. In the pipelined
        loop it waits for the block in flight (``tier_blocking_spills``)."""
        if self._inflight:
            self.tier_blocking_spills += 1
        return self._read_pages_bytes([page])[0]

    def _write_page_bytes(self, page: int, data: Dict[str, np.ndarray]) -> None:
        """One page written back: the tier's restore and repair write."""
        self._write_pages_bytes([page], [data])

    def _corrupt_page_bytes(self, pages: List[int]) -> None:
        """Garble ``pages`` in every layer's pools, in place (JAX
        ``engine.py:2357``), so recovery must rewrite the bytes: fp and
        scale leaves take 104729.0 (104960 in bf16), int8 leaves 127, the
        value JAX's cast of 104729.0 to int8 saturates to."""
        if self._sim:
            return
        idx = self.lm._ids(pages, torch.long)
        for pools in self._page_pools().values():
            for t in pools:
                t.index_fill_(0, idx, GARBLE_INT8 if t.dtype == torch.int8 else GARBLE_FP)

    def inject_page_corruption(self, pages: List[int]) -> None:
        """Declare ``pages`` corrupted between rounds (JAX
        ``engine.py:2376``): their bytes are garbled and the whole
        repair-or-replay recovery runs."""
        if not self.paged:
            raise ValueError("page corruption applies to paged engines only")
        self._handle_corrupt_pages([int(p) for p in pages])
        self.injected_corruptions += len(pages)

    def _handle_corrupt_pages(self, pages: List[int]) -> None:
        """Corrupted-page recovery in dependency order (JAX
        ``engine.py:2386``): garble the bytes; repair in place each page
        whose entry holds a checksum-valid tier copy; invalidate the rest in
        the prefix index; roll back the chunked admissions holding one (they
        requeue); queue a replay of every decoding stream reading through
        one. The pipelined loop drains first and retires what the drain
        finished, which must not replay past its budget."""
        pkv = self.session.paged
        if self.async_loop:
            self._flush(recovery=True)
            self._retire_finished()
        bad = {int(p) for p in pages}
        if self.tracer.enabled:
            self.tracer.instant("fault:corrupt_pages", (self.lane, "faults"), block=self.blocks,
                                args={"pages": sorted(bad)})
        self._corrupt_page_bytes(sorted(bad))
        if pkv.tier is not None:
            repaired = {p for p in sorted(bad) if pkv.repair_page_from_tier(p)}
            self.tier_page_repairs += len(repaired)
            bad -= repaired
            if not bad:
                return
        if pkv.prefix is not None:
            pkv.prefix.invalidate_pages(sorted(bad))
        for slot, st in list(self._prefilling.items()):
            held = set(st.chunk.shared + st.chunk.owned) if st.chunk else set()
            if bad & held:
                self._abort_prefill(slot, requeue=True)
        for slot in range(self.lm.max_batch):
            req = self.slots[slot]
            if req is None or slot in self._prefilling or not bad & set(pkv.slot_pages(slot)):
                continue
            rid = req.request_id
            pregen = list(self._out.get(rid, []))
            ts = list(self._out_ts.get(rid, []))
            self.lm.retire(self.session, np.asarray([slot], np.int32))
            self.slots[slot] = None
            self._active[slot] = False
            self._done[slot] = False
            self._set_tenancy(slot, None)   # its pins survive for the replay
            self._staged.add(slot)
            self._replay_q.append((req, pregen, ts))
            self._replay_tokens += req.max_new_tokens
            self.corrupt_page_replays += 1
            self._trace_req("corrupt_replay", rid, delivered=len(pregen))
        self._drain_replays()

    # --- snapshot / restore ------------------------------------------------

    def snapshot(self) -> dict:
        """The scheduler's state at a round boundary as a JSON-able dict,
        JAX's version-1 format key for key (JAX ``engine.py:3175``): the
        knobs, the seed as JAX key data (``[0, seed]``), and every live
        request's prompt, delivered tokens, deadlines and state (decoding,
        prefill or queued). Completed requests are not in it. The pipelined
        loop drains first and retires what the drain finished."""
        if self._sim:
            raise ValueError("sim engines have no rng/device state to snapshot")
        if self.async_loop:
            self._flush(recovery=True)
            self._retire_finished()

        def enc(r: Request, state: str, generated: List[int]) -> dict:
            # a constrained stream carries its grammar's name and its DFA
            # state, recomputable from its tokens (and recomputed on
            # restore)
            gstate = None
            if r.grammar is not None and self.grammar:
                try:
                    gstate = self._grammar_walk(r.grammar, 0, generated)
                except (KeyError, ValueError):
                    gstate = None
            return {"grammar": r.grammar, "grammar_state": gstate,
                    "request_id": int(r.request_id), "prompt": [int(t) for t in r.prompt],
                    "max_new_tokens": int(r.max_new_tokens),
                    "eos_token_id": None if r.eos_token_id is None else int(r.eos_token_id),
                    "temperature": float(r.temperature), "greedy": bool(r.greedy),
                    "arrival_block": int(r.arrival_block),
                    "ttft_deadline_block": r.ttft_deadline_block,
                    "deadline_block": r.deadline_block,
                    "generated": [int(t) for t in generated], "state": state,
                    "tenant": r.tenant, "adapter": r.adapter}

        reqs = []
        for slot, r in enumerate(self.slots):
            if r is None:
                continue
            if slot in self._prefilling:
                d = enc(r, "prefill", [])
                d["prefill_written"] = int(self._prefilling[slot].written)
                reqs.append(d)
            else:
                reqs.append(enc(r, "decoding", self._out[r.request_id]))
        for req, pregen, _ts in self._replay_q:
            reqs.append(enc(req, "decoding", pregen))
        for r in self.queue.ordered():
            reqs.append(enc(r, "queued", []))
        return {
            "version": 1,
            "blocks": int(self.blocks),
            "next_id": int(self._next_id),
            "rng": [(self.seed >> 32) & 0xFFFFFFFF, self.seed & 0xFFFFFFFF],
            "config": {
                "block_steps": self.block_steps, "fused": self.fused,
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "top_k": self.slot_sampler.top_k, "top_p": self.slot_sampler.top_p,
                "pad_token_id": self.pad_token_id, "max_queue": self.max_queue,
                "shed_policy": self.shed_policy, "block_time_ms": self.block_time_ms,
                "dispatch_retries": self.dispatch_retries,
                "host_tier_pages": self.host_tier_pages, "paged": self.paged,
                "async_loop": self.async_loop, "park_idle_blocks": 0, "park_dir": None,
            },
            # tier content is not kept (host buffers die with the process);
            # the restored engine re-enables an empty tier and re-prefills
            "requests": reqs,
            "parked": [],
        }

    def save_snapshot(self, path: str) -> None:
        """Write :meth:`snapshot` to ``path`` crash-safely: a temporary file,
        then an atomic rename, so a reader never sees half a snapshot."""
        with self.tracer.span("snapshot_save", (self.lane, "snapshot"), block=self.blocks):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f)
            os.replace(tmp, path)

    @classmethod
    def from_snapshot(cls, lm: CausalLM, snap: Union[dict, str],
                      adapters: Optional[dict] = None, grammars: Optional[dict] = None,
                      **overrides) -> "ServeEngine":
        """An engine rebuilt from a :meth:`snapshot` (a dict or a file
        path; JAX ``engine.py:3296``) on a fresh session of ``lm``: queued
        and mid-prefill requests re-enter the queue with their ids and
        deadlines, decoding ones replay prompt + delivered tokens and resume
        where they stopped. ``overrides`` patch knobs (``fused=False``
        restores into the stepwise route; the streams are the same). A
        fused engine on the ``CausalLM`` that took the snapshot reuses its
        captured decode block. Adapter weights and grammar tables are not in
        a snapshot: ``adapters`` (``{name: (lora_params, lora_config)}``)
        and ``grammars`` (``{name: {"regex": ...} | {"json_schema": ...}}``)
        register them again, and each replay pins its own (JAX
        ``engine.py:3334-3346``). Snapshots with parked conversations (not
        ported) are refused."""
        if isinstance(snap, str):
            with open(snap) as f:
                snap = json.load(f)
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version {snap.get('version')}")
        if snap.get("parked"):
            raise ValueError("the snapshot holds parked conversations: parking is not ported "
                             "(ROADMAP A8.5)")
        cfg = dict(snap.get("config", {}))
        cfg.pop("paged", None)   # the lm decides
        if cfg.pop("park_idle_blocks", 0) or cfg.pop("park_dir", None) is not None:
            raise ValueError("the snapshot's engine parked conversations: parking is not "
                             "ported (ROADMAP A8.5)")
        if not lm.paged:
            cfg.pop("host_tier_pages", None)
        cfg.update(overrides)
        if not cfg.get("fused", True):
            cfg.pop("async_loop", None)
        hi, lo = (int(x) for x in snap["rng"])
        eng = cls(lm, seed=(hi << 32) | lo, **cfg)
        for name, (lp, lc) in (adapters or {}).items():
            eng.register_adapter(name, lp, lc)
        for name, spec in (grammars or {}).items():
            eng.register_grammar(name, **spec)
        eng.blocks = int(snap["blocks"])
        eng._next_id = int(snap["next_id"])
        for rd in snap["requests"]:
            eng._validate_tenancy(rd.get("adapter"), rd.get("grammar"),
                                  int(rd["max_new_tokens"]))
            req = Request(request_id=int(rd["request_id"]),
                          prompt=np.asarray(rd["prompt"], np.int32),
                          max_new_tokens=int(rd["max_new_tokens"]),
                          eos_token_id=rd["eos_token_id"],
                          temperature=float(rd["temperature"]), greedy=bool(rd["greedy"]),
                          arrival_block=int(rd["arrival_block"]), submit_block=eng.blocks,
                          ttft_deadline_block=rd.get("ttft_deadline_block"),
                          deadline_block=rd.get("deadline_block"),
                          tenant=rd.get("tenant", "default"), adapter=rd.get("adapter"),
                          grammar=rd.get("grammar"))
            if rd["state"] == "decoding":
                eng._replay_q.append((req, [int(t) for t in rd["generated"]], []))
                eng._replay_tokens += req.max_new_tokens
            else:
                # mid-prefill admissions restart from the queue, ahead of
                # the queued ones (listed first)
                eng.queue.append(req)
            eng.restored_requests += 1
        if eng.tracer.enabled:
            eng.tracer.instant("restore", (eng.lane, "snapshot"), block=eng.blocks,
                               args={"requests": len(snap["requests"])})
        eng._drain_replays()
        return eng

    # --- the block loop --------------------------------------------------

    def step_block(self) -> bool:
        """One scheduling round (JAX ``engine.py:3573``): re-admit recovery
        replays, admit (expiring and shedding first), expire mid-prefill
        admissions past their deadline, spend the prefill-chunk budget, run
        the page-corruption seam, advance every active slot ``block_steps``
        tokens, record emissions, expire streams past their completion
        deadline, retire finished slots. Returns False when there is
        nothing left to do. With ``async_loop`` the round replays block t
        before it harvests block t - 1 (:meth:`_step_block_async`)."""
        self.queue.advance(self.blocks)
        self._drain_replays()     # recovery work goes in ahead of fresh admissions
        self._admit()
        self._retire_finished()   # a 1-token budget finishes at insert time
        self._admit()             # ... freeing its slot for queued work now
        self._expire_prefilling()
        self._advance_prefill()
        self._retire_finished()   # ... or at the end of its chunked prefill
        if self._injector is not None and self.paged:
            victims = self._injector.pages_to_corrupt(self.session.paged.live_pages())
            if victims:
                self._handle_corrupt_pages(victims)
        self._observe_block()
        if self.async_loop:
            return self._step_block_async()
        if not self._active.any():
            if not self.queue and not self._prefilling and not self._replay_q:
                return False
            self.blocks += 1      # arrivals or chunks pending: advance virtual time
            return True
        t0 = time.perf_counter()
        toks = self._advance_block()
        now = time.perf_counter()
        self._trace_block(t0, now)
        self.decode_blocks += 1
        for i in range(self.block_steps):
            for slot, req in enumerate(self.slots):
                if req is not None and slot not in self._prefilling and not self._done[slot]:
                    self._record(slot, int(toks[i, slot]), now)
            self._gen_counts += 1
        self._tok = toks[-1].astype(np.int32)
        self.blocks += 1
        self._expire_decoding()
        self._retire_finished()
        return True

    def _trace_block(self, t0: float, t1: float) -> None:
        """The round's ``decode_block`` span on the engine's blocks lane."""
        if self.tracer.enabled:
            self.tracer.complete("decode_block", (self.lane, "blocks"), t0, t1,
                                 block=self.blocks,
                                 args={"active": int(self._active.sum()),
                                       "steps": self.block_steps, "fused": self.fused,
                                       "inflight": len(self._inflight)})

    def _sync_slots(self, firsts: Optional[torch.Tensor] = None) -> int:
        """Bring the device's slot state up to the host's changes before a
        block (:meth:`_stage`, then one copy); returns the copies made. A
        sim engine has no device state: it counts the copy the real one
        would make."""
        if self._sim:
            copies = int(bool(self._staged))
            self._staged.clear()
            self._tok_from.clear()
            return copies
        self._stage()
        return self.session.slots.sync(firsts)

    def _sim_block(self) -> torch.Tensor:
        """A sim engine's decode block: the fused block's output layout
        ((K, b) tokens, then a row of finite flags) from the sim token
        function, on the host."""
        rids = [-1 if r is None or i in self._prefilling else r.request_id
                for i, r in enumerate(self.slots)]
        toks = self.lm.sim_decode_block(self.block_steps, self._tok, self._active, self._done,
                                        self._gen_counts, rids)
        self.session.lengths += self.block_steps
        out = np.concatenate([toks, np.ones((1, self.lm.max_batch), np.int64)])
        return torch.from_numpy(out.astype(np.int32))

    def _stage(self) -> None:
        """Write the changed slots' host mirrors into the session's slot
        state and mark them, so the next sync copies and merges those rows
        only (the others keep what the device holds)."""
        if not self._staged:
            return
        rows = np.asarray(sorted(self._staged), np.int64)
        st = self.session.slots
        for name, mirror in (("tok", self._tok), ("key_lo", self._keys[:, 0]),
                             ("key_hi", self._keys[:, 1]), ("count", self._gen_counts),
                             ("active", self._active), ("done", self._done),
                             ("eos", self._eos), ("greedy", self._greedy),
                             ("temperature", self._temp), ("adapter", self._adapter_idx),
                             ("grammar", self._gidx), ("gstate", self._gstate),
                             ("budget", self._gbudget)):
            st.host_field(name)[rows] = mirror[rows]
        if self.paged:
            st.host_table[rows] = self.session.paged.tables[rows]
        st.mark_rows(rows)
        for slot, idx in self._tok_from.items():
            st.take_tok(slot, idx)
        self._tok_from.clear()
        self._staged.clear()

    def _advance_block(self) -> np.ndarray:
        """Advance the pool ``block_steps`` tokens; returns the emitted
        (K, max_batch) token matrix."""
        self.h2d_copies += self._sync_slots()
        K = self.block_steps
        if self.fused or self._sim:
            out = self._dispatch("decode", self._sim_block if self._sim
                                 else lambda: self._fused(self.session))
            self.replays += 1
            self.program_calls += 1
            got = self._fetch(out)
            self.nonfinite_logits += int((got[K] == 0).sum())
            return got[:K].astype(np.int64)
        out = np.zeros((K, self.lm.max_batch), np.int64)
        done = self._done.copy()
        tok = self._tok.copy()
        max_len = self.lm.config.max_seq_len
        b = self.lm.max_batch
        h2d = self.lm._ids
        if self.grammar:
            # the block's grammar math on the device (JAX engine.py:3676-3718):
            # the DFA state rides along, terminal landings come back with
            # each step's fetch
            tables = self.session.grammars.tables
            gidx, gbudget = h2d(self._gidx), h2d(self._gbudget)
            gstate = h2d(self._gstate)
            gactive = (self._gidx > 0) & self._active
        for i in range(K):
            # the direct decode step, not lm.step(): step() raises at the
            # cache edge where the fused block latches done and runs on
            logits = self._dispatch("decode", lambda t=tok: self.lm._decode_step(
                self.session, self.lm._ids(t[:, None])))
            self.program_calls += 1
            allowed = (grammar_allowed(tables, gidx, gstate, gbudget,
                                       h2d(self._gen_counts + i)) if self.grammar else None)
            drawn = self._draw(logits, self._keys, self._gen_counts + i, self._temp,
                               self._greedy, allowed=allowed)
            if self.grammar:
                adv = h2d(gactive & ~done, torch.bool)
                gstate = torch.where(adv, tables["next"][gidx.long(), gstate.long(),
                                                         drawn[:b].long()], gstate)
                term = adv & tables["terminal"][gidx.long(), gstate.long()]
                drawn = torch.cat([drawn, term.to(torch.int32)])
            got = self._fetch(drawn)
            nxt = got[:b]
            self.nonfinite_logits += int((got[b:2 * b] == 0).sum())
            out[i] = np.where(done | ~self._active, self.pad_token_id, nxt)
            done = done | (self._active & (self._eos >= 0) & (nxt == self._eos))
            if self.grammar:
                done = done | (got[2 * b:] != 0)
            done = done | (self._active & (self.session.lengths + 1 >= max_len))
            tok = nxt.astype(np.int32)
        return out

    # --- the pipelined loop ----------------------------------------------

    def _step_block_async(self) -> bool:
        """The rest of a pipelined round (JAX ``engine.py:3742``), after the
        same admission and prefill as the synchronous loop: replay block t,
        then harvest block t - 1 while t runs; with nothing to decode, drain
        the pipeline (its harvest may finish streams) and either end or
        advance virtual time."""
        if not self._active.any():
            self._flush()
            self._retire_finished()
            if (not self.queue and not self._prefilling and not self._replay_q
                    and not self._active.any()):
                return False
            self.blocks += 1
            return True
        t0 = time.perf_counter()
        self._dispatch_block_async()
        self.decode_blocks += 1
        self._harvest_inflight()
        self._trace_block(t0, time.perf_counter())
        self.blocks += 1
        self._expire_decoding()
        self._retire_finished()
        return True

    def _dispatch_block_async(self) -> None:
        """Replay one block without waiting for anything (JAX
        ``engine.py:3832``): the changed slots' state goes in first (first
        tokens still on the device included), the replay's output is copied
        on the device into the ring and from there into a pinned host buffer
        with an event behind it; the fetch is waited for one round later."""
        K, b = self.block_steps, self.lm.max_batch
        reqs = [r if r is not None and i not in self._prefilling else None
                for i, r in enumerate(self.slots)]
        base = (K + 1) * b
        self.h2d_copies += self._sync_slots(self._ring[base: base + self._first_cap])
        out = self._dispatch("decode", self._sim_block if self._sim
                             else lambda: self._fused(self.session))
        self.replays += 1
        self.program_calls += 1
        self._ring[:base].copy_(out.view(-1))
        turn = self._ring_turn
        event = None
        if self._ring.device.type == "cuda":
            self._ring_host[turn].copy_(self._ring, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            self._ring_host[turn].copy_(self._ring)
        self.host_fetches += 1
        self._inflight.append(dict(reqs=reqs, block=self.blocks, turn=turn, event=event,
                                   firsts=[p for p in self._first_pending
                                           if p["seq"] == self._seq]))
        self._first_pending = [p for p in self._first_pending if p["seq"] != self._seq]
        self._seq += 1
        self._first_next = 0
        self._ring_turn ^= 1
        self._gen_counts += K      # the device counts every row

    def _harvest_inflight(self, drain: bool = False, recovery: bool = False) -> None:
        """Harvest dispatched blocks down to one in flight, or all of them
        (``drain``) and the first tokens no block carried (JAX
        ``engine.py:3936``); then complete the retired requests whose last
        tokens came in."""
        keep = 0 if drain else 1
        while len(self._inflight) > keep:
            self._harvest_rec(self._inflight.popleft())
        if drain and self._first_pending:
            self._settle_undispatched(recovery)
        for rid, (comp, block) in list(self._tail.items()):
            if not self._awaiting(rid):
                del self._tail[rid]
                self._complete(comp, block)

    def _harvest_rec(self, rec: dict) -> None:
        """Record one fetched block (JAX ``engine.py:3948-3971``): first
        the first tokens drawn before it, then its K rows, each row
        attributed to the request that held the slot at dispatch."""
        t0 = time.perf_counter()
        if rec["event"] is not None:
            rec["event"].synchronize()
        got = self._ring_host[rec["turn"]].numpy().copy()
        if self.tracer.enabled:
            self.tracer.complete("fetch", (self.lane, "dispatch"), t0, time.perf_counter(),
                                 block=rec["block"])
        K, b, cap = self.block_steps, self.lm.max_batch, self._first_cap
        base = (K + 1) * b
        now = time.perf_counter()
        for p in rec["firsts"]:
            self._settle_first(p, int(got[base + p["idx"]]), int(got[base + cap + p["idx"]]),
                               now)
        self.nonfinite_logits += int((got[K * b: base] == 0).sum())
        toks = got[: K * b].reshape(K, b)
        for i in range(K):
            for slot, req in enumerate(rec["reqs"]):
                if req is not None:
                    self._record(slot, int(toks[i, slot]), now, req, block=rec["block"])
        for slot, req in enumerate(rec["reqs"]):
            if req is not None and self.slots[slot] is req:
                self._tok[slot] = int(toks[-1, slot])

    def _settle_first(self, p: dict, tok: int, finite: int, now: float) -> None:
        """Record a first token that came back from the device (JAX
        ``engine.py:3972``)."""
        self.nonfinite_logits += int(finite == 0)
        slot, req = p["slot"], p["req"]
        if self.slots[slot] is req:
            self._tok[slot] = tok
        self._record(slot, tok, now, req, block=p["block"])

    def _settle_undispatched(self, recovery: bool = False) -> None:
        """First tokens drawn since the last replay, fetched directly (a
        drain with no block to carry them); rows still waiting to go to the
        device take them from the host instead. A recovery drain's fetch
        counts in ``recovery_fetches``, not among the decode blocks'."""
        base = (self.block_steps + 1) * self.lm.max_batch
        if recovery:
            self.recovery_fetches += 1
        else:
            self.host_fetches += 1
        got = self._ring[base:].cpu().numpy()   # no block fetch: no fetch span
        now = time.perf_counter()
        for p in self._first_pending:
            idx = p["idx"]
            tok = int(got[idx])
            if self._tok_from.get(p["slot"]) == idx:
                del self._tok_from[p["slot"]]
            self._settle_first(p, tok, int(got[self._first_cap + idx]), now)
        self._first_pending = []
        self._first_next = 0

    def _flush(self, recovery: bool = False) -> None:
        """Drain the pipeline (JAX ``engine.py:4000``): harvest every block
        in flight and settle every first token still on the device
        (``recovery``: for a snapshot, a corrupted page or a replay)."""
        if self.async_loop:
            self._harvest_inflight(drain=True, recovery=recovery)

    def run(self, max_blocks: Optional[int] = None, snapshot_path: Optional[str] = None,
            snapshot_every_blocks: int = 8) -> List[Completion]:
        """Drive blocks until the queue and every slot drain (or
        ``max_blocks`` elapse); returns completions in finish order.
        ``snapshot_path`` (JAX ``engine.py:4186``) writes :meth:`save_snapshot`
        every ``snapshot_every_blocks`` rounds and removes the file on a
        clean drain: a file there at start-up means the last run died
        mid-trace, and :meth:`from_snapshot` resumes it."""
        every = max(int(snapshot_every_blocks), 1)
        n = 0
        drained = True
        while self.step_block():
            n += 1
            if snapshot_path and n % every == 0:
                self.save_snapshot(snapshot_path)
            if max_blocks is not None and n >= max_blocks:
                drained = False
                break
        if drained and snapshot_path and os.path.exists(snapshot_path):
            os.remove(snapshot_path)
        self._m_dropped.set(self.tracer.dropped)   # retire marks land after the last block's
        return self.completed


# --- the serving report ----------------------------------------------------

def per_tenant_report(completions: List[Completion], tok_ts: Dict[int, np.ndarray],
                      wall_s: float, rejected_tenants: Sequence[str] = ()) -> Dict[str, dict]:
    """Per tenant (JAX ``engine.py:4388``): requests, constrained requests,
    generated tokens, inter-token gap p50/p99 from the delivery stamps,
    TTFT in blocks, goodput (tokens of streams that met their deadlines a
    wall second), and the rejected, expired and missed counts."""
    rej = list(rejected_tenants)
    out: Dict[str, dict] = {}
    for t in sorted({c.tenant for c in completions} | set(rej)):
        comps = [c for c in completions if c.tenant == t]
        gaps: List[float] = []
        for c in comps:
            ts = tok_ts.get(c.request_id, np.zeros((0,)))
            g = np.diff(ts) * 1e3 if ts.size > 1 else np.zeros((0,))
            gaps.extend(g[g > 0.0].tolist())
        ontime = sum(len(c.tokens) for c in comps
                     if not (c.deadline_missed or c.expired or c.cancelled))
        out[t] = {
            "requests": len(comps),
            "constrained_requests": sum(1 for c in comps if c.grammar is not None),
            "generated_tokens": int(sum(len(c.tokens) for c in comps)),
            "itl_p50_ms": round(float(np.percentile(gaps, 50)), 3) if gaps else None,
            "itl_p99_ms": round(float(np.percentile(gaps, 99)), 3) if gaps else None,
            "ttft_blocks_mean": (round(float(np.mean([c.ttft_blocks for c in comps])), 2)
                                 if comps else None),
            "ttft_blocks_p99": (int(np.percentile([c.ttft_blocks for c in comps], 99))
                                if comps else None),
            "goodput_tokens_per_sec": round(ontime / wall_s, 1) if wall_s > 0 else None,
            "rejected": rej.count(t),
            "expired": sum(1 for c in comps if c.expired),
            "deadline_missed": sum(1 for c in comps if c.deadline_missed),
        }
    return out


def interblock_gap_report(tracer: Tracer, lanes: List[Any]) -> dict:
    """The pipeline's two idle surfaces off the dispatch lanes' ``decode``
    and ``fetch`` spans (JAX ``engine.py:4431``): ``interblock_gap_ms_*``,
    from a block's fetch to the next block's launch (the device waits on
    the host; 0 in the pipelined loop), and ``fetch_blocked_ms_*``, the
    host waiting on the device. Empty without such spans."""
    gaps: List[float] = []
    blocked: List[float] = []
    for lane in lanes:
        g, b = interblock_gaps(tracer, lane)
        gaps.extend(g)
        blocked.extend(b)
    out: dict = {}
    if gaps:
        out.update({"interblock_gap_ms_p50": round(float(np.percentile(gaps, 50)), 3),
                    "interblock_gap_ms_p99": round(float(np.percentile(gaps, 99)), 3),
                    "interblock_gap_ms_mean": round(float(np.mean(gaps)), 3)})
    if blocked:
        out.update({"fetch_blocked_ms_p50": round(float(np.percentile(blocked, 50)), 3),
                    "fetch_blocked_ms_mean": round(float(np.mean(blocked)), 3)})
    return out


def _submit_item(submit, item: dict) -> Union[int, Rejected]:
    """Submit one synthetic-trace dict through ``submit`` (JAX
    ``engine.py:4797``): the one place the item's keys are read."""
    return submit(item["prompt"], item["max_new_tokens"], eos_token_id=item.get("eos_token_id"),
                  arrival_block=item.get("arrival_block", 0),
                  ttft_deadline_ms=item.get("ttft_deadline_ms"),
                  deadline_ms=item.get("deadline_ms"), tenant=item.get("tenant", "default"),
                  adapter=item.get("adapter"), grammar=item.get("grammar"))


def _split_report(completions: List[Completion], tok_ts: Dict[int, np.ndarray]) -> dict:
    """Requests, inter-token gap p50/p99 and mean TTFT in blocks of a set
    of completions (the constrained / free-form split)."""
    gaps: List[float] = []
    for c in completions:
        ts = tok_ts.get(c.request_id, np.zeros((0,)))
        g = np.diff(ts) * 1e3 if ts.size > 1 else np.zeros((0,))
        gaps.extend(g[g > 0.0].tolist())
    return {
        "requests": len(completions),
        "itl_p50_ms": round(float(np.percentile(gaps, 50)), 3) if gaps else None,
        "itl_p99_ms": round(float(np.percentile(gaps, 99)), 3) if gaps else None,
        "ttft_blocks_mean": (round(float(np.mean([c.ttft_blocks for c in completions])), 2)
                             if completions else None),
    }


def tenancy_report(engine: "ServeEngine", completions: List[Completion],
                   tok_ts: Dict[int, np.ndarray]) -> dict:
    """``run_trace``'s ``structured`` section and multi-LoRA keys (JAX
    ``engine.py:4679-4741``): the constrained share and its latency beside
    the free-form streams', finish reasons, and each pool's residency,
    loads, evictions, hits, repairs, rejects and load retries."""
    out: dict = {}
    if engine.grammar:
        gpool = engine.session.grammars
        constrained = [c for c in completions if c.grammar is not None]
        out["structured"] = {
            "constrained_requests": len(constrained),
            "constrained_share": (round(len(constrained) / len(completions), 3)
                                  if completions else None),
            "constrained": _split_report(constrained, tok_ts),
            "freeform": _split_report([c for c in completions if c.grammar is None], tok_ts),
            "finish_reasons": {r: sum(1 for c in completions if c.finish_reason == r)
                               for r in sorted({c.finish_reason for c in completions})},
            "grammar_slots": gpool.n_slots,
            "grammars_resident": sorted(gpool.resident),
            "grammar_loads": gpool.loads,
            "grammar_evictions": gpool.evictions,
            "grammar_hits": gpool.hits,
            "grammar_repairs": gpool.repairs,
            "grammar_rejects": engine.grammar_rejects,
            "grammar_load_retries": engine.grammar_load_retries,
            "grammar_bytes_per_slot": gpool.grammar_bytes(),
            "grammar_compile_ms": {n: gpool.compile_ms_of(n) for n in sorted(gpool._registry)},
        }
    if engine.lora:
        pool = engine.session.adapters
        out.update({
            "multilora": True,
            "adapter_slots": pool.n_slots,
            "adapters_resident": sorted(pool.resident),
            "adapter_loads": pool.loads,
            "adapter_evictions": pool.evictions,
            "adapter_hits": pool.hits,
            "adapter_repairs": pool.repairs,
            "adapter_load_failures": pool.load_failures,
            "adapter_rejects": engine.adapter_rejects,
            "adapter_load_retries": engine.adapter_load_retries,
            "adapter_bytes_per_slot": pool.adapter_bytes(),
        })
    return out


def run_trace(engine: ServeEngine, trace: Iterable[dict], max_blocks: Optional[int] = None,
              snapshot_path: Optional[str] = None) -> dict:
    """Submit a synthetic trace (``inference/trace.py``) and drive the
    engine to the end; returns the serving report of JAX ``engine.py:4471``
    under its key names: throughput, blocks, host operations, the pipeline
    gaps, the chunked-prefill counters, TTFT in blocks, inter-token latency
    from the tracer's ``tok`` stamps (tracing is turned on; measure the
    untraced engine with ``engine.run()``), the overload surface (rejected,
    expired, evictions, deadline-miss rate over every submission, goodput:
    tokens of streams that met their deadlines), ``per_tenant`` when the
    trace labels tenants, and the page pool.

    Tenants: the ``structured`` section and the multi-LoRA keys of
    :func:`tenancy_report`.

    The recovery surface: ``dispatch_retries`` (launches retried),
    ``corrupt_page_replays``, ``restored_requests``, ``fault_stats`` (the
    injector's counts) when faults are armed, and with a host tier its
    pages, bytes, spills, restores, hits, failures, repairs and
    ``tier_restore_ms_p99``; the port adds its page I/O counts
    (``tier_d2h_copies``, ``tier_h2d_copies``, ``tier_blocking_spills``,
    ``recovery_fetches``). ``snapshot_path`` arms ``run``'s crash-safe
    snapshots.

    ``keep_completions=False`` engines take the streaming report (JAX
    ``engine.py:4810``): ``trace`` may be a generator, each request is
    submitted when the clock reaches its arrival, and the report is built
    from the engine's counters and histograms alone.

    Left out with the features they read (ROADMAP A8): parking and
    ``tp_degree``. The port's ``host_ops_per_block`` counts its
    slot-state copies beside program calls and fetches (``h2d_copies``,
    also reported)."""
    if not engine.keep_completions:
        return _run_trace_streaming(engine, trace, max_blocks=max_blocks,
                                    snapshot_path=snapshot_path)
    trace = list(trace)
    engine.tracer.enabled = True
    tenant_of: Dict[int, str] = {}
    for item in trace:
        out = _submit_item(engine.submit, item)
        rid = out.request_id if isinstance(out, Rejected) else out
        tenant_of[rid] = item.get("tenant", "default")
    t0 = time.perf_counter()
    completions = engine.run(max_blocks=max_blocks, snapshot_path=snapshot_path)
    wall_s = time.perf_counter() - t0
    total_tokens = int(sum(len(c.tokens) for c in completions))
    decode_blocks = max(engine.decode_blocks, 1)
    # inter-token latency from the tracer's delivery stamps: the tokens of
    # one fetch share a stamp, so only gaps between deliveries count
    tok_ts = {rid: np.asarray([ev["ts"] for ev in evs if ev["name"] == "tok"], np.float64)
              for rid, evs in engine.tracer.by_request().items()}
    per_request = []
    gaps_ms: List[float] = []
    for c in completions:
        ts = tok_ts.get(c.request_id, np.zeros((0,)))
        g = np.diff(ts) * 1e3 if ts.size > 1 else np.zeros((0,))
        g = g[g > 0.0]
        gaps_ms.extend(g.tolist())
        per_request.append({"request_id": c.request_id, "prompt_len": c.prompt_len,
                            "generated": int(len(c.tokens)), "ttft_blocks": c.ttft_blocks,
                            "max_itl_gap_ms": round(float(g.max()), 2) if g.size else 0.0})
    mean = lambda xs: round(float(np.mean(xs)), 2) if completions else None  # noqa: E731
    report = {
        "requests_completed": len(completions),
        "total_generated_tokens": total_tokens,
        "wall_s": round(wall_s, 4),
        "tokens_per_sec": round(total_tokens / wall_s, 1) if wall_s > 0 else None,
        "blocks": engine.blocks,
        "decode_blocks": engine.decode_blocks,
        "block_steps": engine.block_steps,
        "fused": engine.fused,
        "inserts": engine.inserts,
        "inserted_requests": engine.inserted_requests,
        "program_calls": engine.program_calls,
        "host_fetches": engine.host_fetches,
        "h2d_copies": engine.h2d_copies,
        "host_ops_per_block": round(
            (engine.program_calls + engine.host_fetches + engine.h2d_copies) / decode_blocks, 2),
        "async_loop": engine.async_loop,
        **interblock_gap_report(engine.tracer, [engine.lane]),
        "queue_blocks_mean": mean([c.queue_blocks for c in completions]),
        "decode_blocks_mean": mean([c.decode_blocks for c in completions]),
        "prefill_chunk_tokens": engine.prefill_chunk_tokens,
        "chunk_program_calls": engine.chunk_program_calls,
        "prefill_chunk_tokens_done": engine.prefill_chunk_tokens_done,
        "prefill_aborts": engine.prefill_aborts,
        "ttft_blocks_mean": mean([c.ttft_blocks for c in completions]),
        "ttft_blocks_max": (int(max(c.ttft_blocks for c in completions))
                            if completions else None),
        "itl_p50_ms": round(float(np.percentile(gaps_ms, 50)), 3) if gaps_ms else None,
        "itl_p99_ms": round(float(np.percentile(gaps_ms, 99)), 3) if gaps_ms else None,
        "max_itl_gap_ms": round(float(np.max(gaps_ms)), 2) if gaps_ms else None,
        "per_request": per_request,
    }
    # overload: a shed request counts as a miss (its client got nothing);
    # goodput counts only the tokens of streams that met their deadlines
    submitted = len(trace)
    rejected = len(engine.rejected)
    missed = sum(1 for c in completions if c.deadline_missed)
    has_deadlines = any(item.get("deadline_ms") or item.get("ttft_deadline_ms")
                        for item in trace)
    ontime_tokens = sum(len(c.tokens) for c in completions
                        if not (c.deadline_missed or c.expired or c.cancelled))
    report.update({
        "rejected": rejected,
        "expired": sum(1 for c in completions if c.expired),
        "shed_evictions": engine.shed_evictions,
        "max_queue": engine.max_queue,
        "shed_policy": engine.shed_policy,
        "deadline_miss_rate": (round((rejected + missed) / submitted, 4)
                               if has_deadlines and submitted else None),
        "goodput_tokens_per_sec": round(ontime_tokens / wall_s, 1) if wall_s > 0 else None,
        "dispatch_retries": engine.dispatch_retry_count,
        "corrupt_page_replays": engine.corrupt_page_replays,
        "restored_requests": engine.restored_requests,
        "recovery_fetches": engine.recovery_fetches,
        "trace_events": len(engine.tracer.events()),
        "trace_events_dropped": engine.tracer.dropped,
    })
    if any(t != "default" for t in tenant_of.values()):
        report["per_tenant"] = per_tenant_report(
            completions, tok_ts, wall_s,
            [tenant_of.get(r.request_id, "default") for r in engine.rejected])
    report.update(tenancy_report(engine, completions, tok_ts))
    if engine._injector is not None:
        report["fault_stats"] = dict(engine._injector.stats)
    if engine.paged:
        pkv = engine.session.paged
        cfg = engine.lm.config
        kv = engine.lm.kv_cache_bytes()
        if engine._sim:
            slab = engine.lm.kv_slab_bytes()
        else:
            slab = (2 * cfg.num_layers * engine.lm.max_batch * cfg.max_seq_len
                    * cfg.num_kv_heads * cfg.head_dim_
                    * torch.empty((), dtype=cfg.dtype).element_size())
        report.update({
            "paged": True,
            "page_size": pkv.page_size,
            "page_pool_pages": pkv.num_pages,
            "page_dtype": engine._page_dtype(),
            "paged_attn_kernel": bool(getattr(cfg, "paged_attn_kernel", False)),
            "prefix_queries": pkv.prefix_queries,
            "prefix_hits": pkv.prefix_hits,
            "prefix_hit_tokens": pkv.prefix_hit_tokens,
            "pages_in_use_peak": pkv.pages_in_use_peak,
            "evicted_pages": pkv.evicted_pages,
            "deferred_admissions": engine.deferred_admissions,
            "kv_hbm_bytes": kv,
            "kv_slab_hbm_bytes": slab,
            "kv_hbm_vs_slab": round(kv / slab, 3),
        })
        if pkv.tier is not None:
            report.update({
                "host_tier_pages": pkv.tier.max_pages,
                "tier_pages_resident": pkv.tier_pages(),
                "tier_bytes_resident": pkv.tier_bytes(),
                "tier_spilled_pages": pkv.tier_spilled_pages,
                "tier_restored_pages": pkv.tier_restored_pages,
                "tier_hits": pkv.tier_hits,
                "tier_restore_failures": pkv.tier_restore_failures,
                "tier_repaired_pages": pkv.tier_repaired_pages,
                "tier_restore_ms_p99": (round(float(np.percentile(pkv._restore_ms, 99)), 3)
                                        if pkv._restore_ms else None),
                "tier_d2h_copies": engine.tier_d2h_copies,
                "tier_h2d_copies": engine.tier_h2d_copies,
                "tier_blocking_spills": engine.tier_blocking_spills,
            })
    return report


def _run_trace_streaming(engine: ServeEngine, trace: Iterable[dict],
                         max_blocks: Optional[int] = None,
                         snapshot_path: Optional[str] = None) -> dict:
    """``run_trace`` for ``keep_completions=False`` (JAX ``engine.py:4810``):
    each request is submitted when the clock reaches its arrival block, off
    a possibly endless iterator, and the report comes from the engine's
    counters and log-bucket histograms (percentiles are bucket upper
    edges), with no per-request record and no tracer: host memory stays
    the requests in flight's."""
    if snapshot_path is not None:
        raise ValueError("streaming runs do not snapshot (keep_completions=False drops the "
                         "per-request record the snapshot would serialize)")
    it = iter(trace)
    nxt = next(it, None)
    submitted = 0
    has_deadlines = False
    t0 = time.perf_counter()
    n = 0
    while True:
        while nxt is not None and int(nxt.get("arrival_block", 0)) <= engine.blocks:
            _submit_item(engine.submit, nxt)
            submitted += 1
            has_deadlines = has_deadlines or bool(nxt.get("deadline_ms")
                                                  or nxt.get("ttft_deadline_ms"))
            nxt = next(it, None)
        more = engine.step_block()
        n += 1
        if max_blocks is not None and n >= max_blocks:
            break
        if not more and nxt is None:
            break
    engine._m_dropped.set(engine.tracer.dropped)
    wall_s = time.perf_counter() - t0
    completed = engine.completed_count
    total_tokens = engine.generated_tokens
    decode_blocks = max(engine.decode_blocks, 1)
    itl = engine._m_itl
    rejected = len(engine.rejected)
    return {
        "streaming": True,
        "percentile_basis": "log-bucket histogram upper edges",
        "requests_submitted": submitted,
        "requests_completed": completed,
        "total_generated_tokens": total_tokens,
        "wall_s": round(wall_s, 4),
        "tokens_per_sec": round(total_tokens / wall_s, 1) if wall_s > 0 else None,
        "goodput_tokens_per_sec": (round(engine.ontime_tokens / wall_s, 1)
                                   if wall_s > 0 else None),
        "sched_overhead_us_per_request": (round(wall_s * 1e6 / completed, 2)
                                          if completed else None),
        "blocks": engine.blocks,
        "decode_blocks": engine.decode_blocks,
        "block_steps": engine.block_steps,
        "fused": engine.fused,
        "inserts": engine.inserts,
        "inserted_requests": engine.inserted_requests,
        "host_ops_per_block": round(
            (engine.program_calls + engine.host_fetches + engine.h2d_copies) / decode_blocks, 2),
        "queue_blocks_mean": round(engine.queue_blocks_sum / completed, 2) if completed else None,
        "ttft_blocks_mean": round(engine.ttft_blocks_sum / completed, 2) if completed else None,
        "itl_p50_ms": round(itl.percentile(50), 3) if itl.count else None,
        "itl_p99_ms": round(itl.percentile(99), 3) if itl.count else None,
        "rejected": rejected,
        "expired": engine.expired,
        "shed_evictions": engine.shed_evictions,
        "deadline_miss_rate": (round((rejected + engine.deadline_misses) / submitted, 4)
                               if has_deadlines and submitted else None),
        "deferred_admissions": engine.deferred_admissions,
        "dispatch_retries": engine.dispatch_retry_count,
    }
