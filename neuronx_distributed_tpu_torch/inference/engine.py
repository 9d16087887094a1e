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

Still to port: load shedding (``max_queue`` and ``Rejected``), deadlines
and EDF, faults, the host tier, parking, disaggregation, the router,
grammars, adapters, snapshots and the observability layer.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.paged_cache import ChunkedPrefill, PagePoolExhausted
from neuronx_distributed_tpu_torch.inference.sampling import (
    Sampler,
    SlotSampler,
    draw_rows,
    request_seed,
    split_key,
)


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
    finish_reason: str = "budget"           # "eos" | "budget" | "cancelled"


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
    the requests :meth:`cancel` took."""

    def __init__(self, lm: CausalLM, block_steps: int = 8, fused: bool = True,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 pad_token_id: int = 0, seed: int = 0, prefill_chunk_tokens: int = 0,
                 async_loop: bool = False):
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
        self.lm = lm
        self.block_steps = int(block_steps)
        self.fused = bool(fused)
        self.async_loop = bool(async_loop)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.slot_sampler = SlotSampler(top_k=top_k, top_p=top_p)
        self.pad_token_id = int(pad_token_id)
        self.seed = int(seed)
        self.paged = lm.paged
        self.session = lm.start_session()
        b = lm.max_batch
        self.queue: deque = deque()
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
            dev = lm.device
            # [block out (K + 1, b) | first tokens (cap) | their finite flags (cap)]
            self._ring = torch.zeros((n,), dtype=torch.int32, device=dev)
            self._ring_host = [torch.zeros((n,), dtype=torch.int32,
                                           pin_memory=dev.type == "cuda") for _ in range(2)]
            self._ring_turn = 0
        self._fused = None
        t0 = time.perf_counter()
        if self.fused:
            self._fused = lm.compile_session_decode_fused(self.block_steps, self.slot_sampler,
                                                          self.pad_token_id)
        self.capture_s = time.perf_counter() - t0

    # --- submission ------------------------------------------------------

    def _reserve_slack(self) -> int:
        """Decode-overrun page reserve (JAX ``engine.py:1279-1289``): a
        finished row writes at most ``block_steps - 1`` positions past its
        last delivered token, and one block more in the pipelined loop."""
        return 2 * self.block_steps if self.async_loop else self.block_steps

    def _is_chunked(self, req: Request) -> bool:
        return bool(self.prefill_chunk_tokens and req.prompt.size > self.prefill_chunk_tokens)

    def submit(self, prompt, max_new_tokens: int, sampler: Optional[Sampler] = None,
               eos_token_id: Optional[int] = None, arrival_block: int = 0,
               request_id: Optional[int] = None) -> int:
        """Queue a request; returns its id. A prompt longer than the largest
        bucket is accepted when it will be chunked (JAX ``engine.py:834``)."""
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
            need = pkv.pages_needed(prompt.size, max_new_tokens + self._reserve_slack())
            if need > pkv.capacity_pages():
                raise ValueError(f"request needs {need} pages, pool holds at most "
                                 f"{pkv.capacity_pages()}")
        sampler = sampler or Sampler(greedy=True)
        if (sampler.top_k, sampler.top_p) != (self.slot_sampler.top_k, self.slot_sampler.top_p):
            raise ValueError(f"request sampler top_k/top_p {sampler.top_k}/{sampler.top_p} "
                             f"differ from the engine's {self.slot_sampler.top_k}/"
                             f"{self.slot_sampler.top_p}")
        greedy = bool(sampler.greedy or sampler.temperature == 0.0)
        rid = self._next_id if request_id is None else int(request_id)
        req = Request(request_id=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      temperature=0.0 if greedy else float(sampler.temperature),
                      greedy=greedy, arrival_block=int(arrival_block),
                      submit_block=self.blocks)
        self._next_id = max(self._next_id, rid + 1)
        self._submit_ts[rid] = time.perf_counter()
        self.queue.append(req)
        return rid

    def cancel(self, request_id: int) -> bool:
        """Retire a request in whatever state it is in (JAX
        ``engine.py:970``): queued, it is dropped; mid-chunked-prefill, its
        slot is freed and its pages rolled back, with no completion;
        decoding, it retires now with a partial completion
        (``finish_reason="cancelled"``; the pipelined loop first drains,
        and a stream the drain finishes completes normally). Returns False
        when the id is unknown or already completed."""
        for r in self.queue:
            if r.request_id == request_id:
                self.queue.remove(r)
                self._submit_ts.pop(request_id, None)
                self.cancelled += 1
                return True
        for slot, st in list(self._prefilling.items()):
            if st.req.request_id == request_id:
                self._abort_prefill(slot, requeue=False)
                self._submit_ts.pop(request_id, None)
                self.cancelled += 1
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

    def _draw(self, logits: torch.Tensor, keys: np.ndarray, counts, temps: np.ndarray,
              greedy: np.ndarray) -> torch.Tensor:
        """Rows' tokens under their keys at their token counters, then one
        flag a row (1 where its logits are all finite), as one int32 tensor
        ``(2 * rows,)`` on the device: the fused block's sampling math."""
        h2d = self.lm._ids
        tok = draw_rows(logits, h2d(keys[:, 0]), h2d(keys[:, 1]), h2d(counts),
                        h2d(temps, torch.float32), h2d(greedy, torch.bool), self.slot_sampler)
        return torch.cat([tok, torch.isfinite(logits).all(-1).to(torch.int32)])

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        self.host_fetches += 1
        return t.cpu().numpy()

    def _admit(self) -> None:
        """Admit arrived requests into free slots, FIFO (JAX
        ``engine.py:1685-1754``): a long prompt takes the chunked path
        alone; otherwise the head request's bucket defines a group, which
        grows until a request of another bucket or a long one; each group
        is one right-sized insert."""
        while True:
            free = self._free_slots()
            if not free:
                return
            order = [r for r in self.queue if r.arrival_block <= self.blocks][: len(free)]
            if not order:
                return
            head = order[0]
            if self._is_chunked(head):
                self.queue.remove(head)
                self._begin_chunked(head, free[0])
                continue
            bucket = self.lm._bucket_for(head.prompt.size)
            group = []
            for r in order:
                if self._is_chunked(r) or self.lm._bucket_for(r.prompt.size) != bucket:
                    break
                group.append(r)
            for r in group:
                self.queue.remove(r)
            try:
                self._insert_group(group, free[: len(group)])
            except PagePoolExhausted:
                # no device work ran: requeue, retry the head alone first
                self.deferred_admissions += 1
                self.queue.extendleft(reversed(group[1:]))
                try:
                    self._insert_group(group[:1], free[:1])
                except PagePoolExhausted:
                    self.queue.appendleft(group[0])
                    return

    def _start_stream(self, slot: int, req: Request, temp: float, greedy: bool,
                      tok: Optional[int], first_idx: Optional[int], now: float) -> None:
        """Hand ``slot`` to the decode pool with its first token: ``tok``,
        fetched, or, in the pipelined loop, entry ``first_idx`` of the first
        tokens left on the device."""
        rid = req.request_id
        req.first_token_block = self.blocks
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
        self._staged.add(slot)
        if tok is None:
            self._tok[slot] = 0
            self._tok_from[slot] = first_idx
            self._first_pending.append(dict(slot=slot, req=req, idx=first_idx, seq=self._seq))
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
        reserve = np.asarray([r.max_new_tokens + self._reserve_slack() for r in group],
                             np.int64)
        logits = self.lm.insert(self.session, np.asarray(slot_ids, np.int32), ids,
                                lengths=lens, pad_token_id=self.pad_token_id,
                                reserve_tokens=reserve if self.paged else None)
        self.inserts += 1
        temps = np.asarray([r.temperature for r in group], np.float32)
        greedy = np.asarray([r.greedy for r in group], bool)
        keys = np.asarray([split_key(request_seed(self.seed, r.request_id)) for r in group],
                          np.int32)
        # token index 0 of each request's key stream
        first, i0 = self._first_tokens(
            self._draw(logits, keys, np.zeros((rows,), np.int32), temps, greedy), rows)
        now = time.perf_counter()
        for i, (r, slot) in enumerate(zip(group, slot_ids)):
            r.start_block = self.blocks
            if first is None:
                self._start_stream(slot, r, temps[i], greedy[i], None, i0 + i, now)
            else:
                self._start_stream(slot, r, temps[i], greedy[i], int(first[i]), None, now)

    # --- chunked prefill -------------------------------------------------

    def _begin_chunked(self, req: Request, slot: int) -> None:
        """Claim ``slot`` for a chunked admission (JAX ``engine.py:1898``):
        it leaves the free pool now but stays decode-inactive; a prefix hit
        starts the prefill at the page-aligned reused length."""
        chunk, written = None, 0
        if self.paged:
            reserve = req.max_new_tokens + self._reserve_slack()
            chunk = self.session.paged.begin_chunked(req.prompt.tolist(),
                                                     req.prompt.size + reserve)
            written = chunk.start
        req.start_block = self.blocks
        self.slots[slot] = req
        self._active[slot] = False
        self._done[slot] = False
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
            logits = self.lm.extend(self.session, [slot], req.prompt[st.written: st.written + n][None],
                                    [n], [st.written], tables=tables)
            self.chunk_program_calls += 1
            self.prefill_chunk_tokens_done += n
            st.written += n
            budget -= n
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
        key = np.asarray([split_key(request_seed(self.seed, req.request_id))], np.int32)
        first, i0 = self._first_tokens(
            self._draw(logits, key, np.zeros((1,), np.int32),
                       np.asarray([req.temperature], np.float32), np.asarray([req.greedy])), 1)
        self._start_stream(slot, req, req.temperature, req.greedy,
                           None if first is None else int(first[0]), i0, time.perf_counter())

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
        self.session.lengths[slot] = 0
        self.session.active[slot] = False
        self._staged.add(slot)
        self.prefill_aborts += 1
        if requeue:
            st.req.start_block = None
            self.queue.appendleft(st.req)

    # --- emissions and retirement ----------------------------------------

    def _deliver(self, req: Request, token: int, ts: float) -> bool:
        """Append one emitted token to ``req``'s stream unless it already
        ended; returns whether the stream has ended (EOS or budget)."""
        rid = req.request_id
        if rid in self._ended or rid not in self._out:
            return True
        out = self._out[rid]
        out.append(token)
        self._out_ts[rid].append(ts)
        if req.eos_token_id is not None and token == req.eos_token_id:
            self._ended.add(rid)
            self._finish_reason.setdefault(rid, "eos")
        if len(out) >= req.max_new_tokens:
            self._ended.add(rid)
            self._finish_reason.setdefault(rid, "budget")
        return rid in self._ended

    def _record(self, slot: int, token: int, ts: float, req: Optional[Request] = None) -> None:
        """Deliver a token of ``req`` (by default the slot's request) and
        latch the slot's done when the stream ended."""
        req = self.slots[slot] if req is None else req
        if req is not None and self._deliver(req, token, ts) and self.slots[slot] is req:
            self._done[slot] = True

    def _awaiting(self, rid: int) -> bool:
        """Whether a token of ``rid`` is still in flight (pipelined loop)."""
        return (any(r is not None and r.request_id == rid for rec in self._inflight
                    for r in rec["reqs"])
                or any(p["req"].request_id == rid for p in self._first_pending))

    def _retire(self, slots: List[int], reason: Optional[str] = None) -> None:
        """Free ``slots`` and complete their requests; a request whose last
        tokens are in flight completes when they are harvested."""
        self.lm.retire(self.session, np.asarray(slots, np.int32))
        for slot in slots:
            req = self.slots[slot]
            rid = req.request_id
            comp = Completion(
                request_id=rid, tokens=np.zeros((0,), np.int64), prompt_len=req.prompt.size,
                queue_blocks=max(req.start_block - req.arrival_block, 0),
                decode_blocks=self.blocks - req.start_block,
                ttft_blocks=max(req.first_token_block - req.arrival_block, 0),
                submit_ts=self._submit_ts.pop(rid, None),
                finish_reason=reason or "")
            self.slots[slot] = None
            self._active[slot] = False
            self._done[slot] = False
            self._tok_from.pop(slot, None)
            self._staged.add(slot)
            if reason is None and self._awaiting(rid):
                self._tail[rid] = comp
            else:
                self._complete(comp)

    def _complete(self, comp: Completion) -> None:
        rid = comp.request_id
        comp.tokens = np.asarray(self._out.pop(rid), np.int64)
        comp.token_ts = np.asarray(self._out_ts.pop(rid), np.float64)
        reason = self._finish_reason.pop(rid, "budget")
        comp.finish_reason = comp.finish_reason or reason
        self._ended.discard(rid)
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

    # --- the block loop --------------------------------------------------

    def step_block(self) -> bool:
        """One scheduling round: admit, spend the prefill-chunk budget,
        advance every active slot ``block_steps`` tokens, record emissions,
        retire finished slots. Returns False when there is nothing left to
        do. With ``async_loop`` the round replays block t before it
        harvests block t - 1 (:meth:`_step_block_async`)."""
        self._admit()
        self._retire_finished()   # a 1-token budget finishes at insert time
        self._admit()             # ... freeing its slot for queued work now
        self._advance_prefill()
        self._retire_finished()   # ... or at the end of its chunked prefill
        if self.async_loop:
            return self._step_block_async()
        if not self._active.any():
            if not self.queue and not self._prefilling:
                return False
            self.blocks += 1      # arrivals or chunks pending: advance virtual time
            return True
        toks = self._advance_block()
        now = time.perf_counter()
        self.decode_blocks += 1
        for i in range(self.block_steps):
            for slot, req in enumerate(self.slots):
                if req is not None and slot not in self._prefilling and not self._done[slot]:
                    self._record(slot, int(toks[i, slot]), now)
            self._gen_counts += 1
        self._tok = toks[-1].astype(np.int32)
        self.blocks += 1
        self._retire_finished()
        return True

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
                             ("temperature", self._temp)):
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
        self._stage()
        self.h2d_copies += self.session.slots.sync()
        K = self.block_steps
        if self.fused:
            out = self._fused(self.session)
            self.replays += 1
            got = self._fetch(out)
            self.nonfinite_logits += int((got[K] == 0).sum())
            return got[:K].astype(np.int64)
        out = np.zeros((K, self.lm.max_batch), np.int64)
        done = self._done.copy()
        tok = self._tok.copy()
        max_len = self.lm.config.max_seq_len
        b = self.lm.max_batch
        for i in range(K):
            # the direct decode step, not lm.step(): step() raises at the
            # cache edge where the fused block latches done and runs on
            logits = self.lm._decode_step(self.session, self.lm._ids(tok[:, None]))
            got = self._fetch(self._draw(logits, self._keys, self._gen_counts + i, self._temp,
                                         self._greedy))
            nxt = got[:b]
            self.nonfinite_logits += int((got[b:] == 0).sum())
            out[i] = np.where(done | ~self._active, self.pad_token_id, nxt)
            done = done | (self._active & (self._eos >= 0) & (nxt == self._eos))
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
            if not self.queue and not self._prefilling and not self._active.any():
                return False
            self.blocks += 1
            return True
        self._dispatch_block_async()
        self.decode_blocks += 1
        self._harvest_inflight()
        self.blocks += 1
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
        self._stage()
        base = (K + 1) * b
        self.h2d_copies += self.session.slots.sync(self._ring[base: base + self._first_cap])
        out = self._fused(self.session)
        self.replays += 1
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

    def _harvest_inflight(self, drain: bool = False) -> None:
        """Harvest dispatched blocks down to one in flight, or all of them
        (``drain``) and the first tokens no block carried (JAX
        ``engine.py:3936``); then complete the retired requests whose last
        tokens came in."""
        keep = 0 if drain else 1
        while len(self._inflight) > keep:
            self._harvest_rec(self._inflight.popleft())
        if drain and self._first_pending:
            self._settle_undispatched()
        for rid, comp in list(self._tail.items()):
            if not self._awaiting(rid):
                del self._tail[rid]
                self._complete(comp)

    def _harvest_rec(self, rec: dict) -> None:
        """Record one fetched block (JAX ``engine.py:3948-3971``): first
        the first tokens drawn before it, then its K rows, each row
        attributed to the request that held the slot at dispatch."""
        if rec["event"] is not None:
            rec["event"].synchronize()
        got = self._ring_host[rec["turn"]].numpy().copy()
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
                    self._record(slot, int(toks[i, slot]), now, req)
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
        self._record(slot, tok, now, req)

    def _settle_undispatched(self) -> None:
        """First tokens drawn since the last replay, fetched directly (a
        drain with no block to carry them); rows still waiting to go to the
        device take them from the host instead."""
        base = (self.block_steps + 1) * self.lm.max_batch
        got = self._fetch(self._ring[base:])
        now = time.perf_counter()
        for p in self._first_pending:
            idx = p["idx"]
            tok = int(got[idx])
            if self._tok_from.get(p["slot"]) == idx:
                del self._tok_from[p["slot"]]
            self._settle_first(p, tok, int(got[self._first_cap + idx]), now)
        self._first_pending = []
        self._first_next = 0

    def _flush(self) -> None:
        """Drain the pipeline (JAX ``engine.py:4000``): harvest every block
        in flight and settle every first token still on the device."""
        if self.async_loop:
            self._harvest_inflight(drain=True)

    def run(self, max_blocks: Optional[int] = None) -> List[Completion]:
        """Drive blocks until the queue and every slot drain (or
        ``max_blocks`` elapse); returns completions in finish order."""
        n = 0
        while self.step_block():
            n += 1
            if max_blocks is not None and n >= max_blocks:
                break
        return self.completed
