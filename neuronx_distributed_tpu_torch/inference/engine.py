"""Continuous-batching serving engine, synchronous loop.

Counterpart of the core of ``neuronx_distributed_tpu/inference/engine.py``:
a host-side scheduler that admits queued requests into free slots (prompts
that share a prefill bucket ride one right-sized insert), advances every
live slot ``block_steps`` tokens per scheduling round, and retires streams
on EOS or budget at block boundaries.

``fused=True`` advances a block through the captured K-step program of
:meth:`CausalLM.compile_session_decode_fused` (built with the engine): a
steady-state block is one replay and one fetch of the (K + 1, slots)
result, and a block after an admission or a retirement adds one packed
copy of the slot state to the device. ``fused=False`` runs the same
schedule step by step with a fetch per token, the reference route. Both
emit identical streams: request r's t-th token is a pure function of its
logits and, when sampled, of ``counter_gumbel`` noise keyed by
``request_seed(seed, r)`` at counter t.

Still to port: load shedding (``max_queue`` and ``Rejected``), deadlines
and EDF, chunked prefill, faults, the host tier, parking, the async loop,
disaggregation, the router, grammars, adapters, snapshots and the
observability layer.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.paged_cache import PagePoolExhausted
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
    finish_reason: str = "budget"           # "eos" | "budget"


class ServeEngine:
    """Continuous-batching scheduler over one :class:`CausalLM` session.
    ``block_steps`` is the K knob: each round advances every live slot K
    tokens. Building a fused engine captures its decode block on CUDA,
    outside :meth:`run` (``capture_s``: the wall seconds that took, about 0
    when the ``CausalLM`` had captured it already).

    Host operations of the decode blocks, as plain counters: ``replays``
    (fused block programs run), ``host_fetches`` (device-to-host reads) and
    ``h2d_copies`` (slot-state copies to the device). ``nonfinite_logits``
    counts the rows of an insert, of a stepwise step or of a fused block
    whose logits held a non-finite value."""

    def __init__(self, lm: CausalLM, block_steps: int = 8, fused: bool = True,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 pad_token_id: int = 0, seed: int = 0):
        if block_steps < 1:
            raise ValueError(f"block_steps must be >= 1, got {block_steps}")
        self.lm = lm
        self.block_steps = int(block_steps)
        self.fused = bool(fused)
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
        self.completed: List[Completion] = []
        # host mirrors of the per-slot decode state, packed into the
        # session's slot state when an admission or retirement changes them
        self._active = np.zeros((b,), bool)
        self._done = np.zeros((b,), bool)
        self._eos = np.full((b,), -1, np.int32)
        self._temp = np.zeros((b,), np.float32)
        self._greedy = np.ones((b,), bool)
        self._tok = np.zeros((b,), np.int32)
        self._gen_counts = np.zeros((b,), np.int32)
        self._keys = np.zeros((b, 2), np.int32)
        self._changed = True
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
        self._fused = None
        t0 = time.perf_counter()
        if self.fused:
            self._fused = lm.compile_session_decode_fused(self.block_steps, self.slot_sampler,
                                                          self.pad_token_id)
        self.capture_s = time.perf_counter() - t0

    # --- submission ------------------------------------------------------

    def _reserve_slack(self) -> int:
        """Decode-overrun page reserve: a finished row writes at most
        ``block_steps - 1`` positions past its last delivered token."""
        return self.block_steps

    def submit(self, prompt, max_new_tokens: int, sampler: Optional[Sampler] = None,
               eos_token_id: Optional[int] = None, arrival_block: int = 0,
               request_id: Optional[int] = None) -> int:
        """Queue a request; returns its id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        room = self.lm.config.max_seq_len - 1
        if prompt.size + max_new_tokens > room:
            raise ValueError(f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds serveable cache room {room}")
        if prompt.size > self.lm.buckets[-1]:
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

    # --- scheduling internals -------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _draw(self, logits: torch.Tensor, keys: np.ndarray, counts, temps: np.ndarray,
              greedy: np.ndarray) -> torch.Tensor:
        """Rows' tokens under their keys at their token counters, then one
        flag a row (1 where its logits are all finite), as one int32 tensor
        ``(2 * rows,)`` on the device: the fused block's sampling math."""
        dev = self.lm.device
        as_dev = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
        tok = draw_rows(logits, as_dev(keys[:, 0], torch.int32), as_dev(keys[:, 1], torch.int32),
                        as_dev(counts, torch.int32), as_dev(temps, torch.float32),
                        as_dev(greedy, torch.bool), self.slot_sampler)
        return torch.cat([tok, torch.isfinite(logits).all(-1).to(torch.int32)])

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        self.host_fetches += 1
        return t.cpu().numpy()

    def _admit(self) -> None:
        """Admit arrived requests into free slots, FIFO: the head request's
        bucket defines a group, which grows until a request of another
        bucket; each group is one right-sized insert."""
        while True:
            free = self._free_slots()
            if not free:
                return
            order = [r for r in self.queue if r.arrival_block <= self.blocks][: len(free)]
            if not order:
                return
            bucket = self.lm._bucket_for(order[0].prompt.size)
            group = []
            for r in order:
                if self.lm._bucket_for(r.prompt.size) != bucket:
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
        drawn = self._draw(logits, keys, np.zeros((rows,), np.int32), temps, greedy)
        drawn = drawn.cpu().numpy()
        first = drawn[:rows]
        self.nonfinite_logits += int((drawn[rows:] == 0).sum())
        now = time.perf_counter()
        self._changed = True
        for i, (r, slot) in enumerate(zip(group, slot_ids)):
            r.start_block = r.first_token_block = self.blocks
            self.slots[slot] = r
            self._out[r.request_id] = []
            self._out_ts[r.request_id] = []
            self._keys[slot] = keys[i]
            self._active[slot] = True
            self._done[slot] = False
            self._eos[slot] = -1 if r.eos_token_id is None else r.eos_token_id
            self._temp[slot] = temps[i]
            self._greedy[slot] = greedy[i]
            self._gen_counts[slot] = 1
            self._tok[slot] = int(first[i])
            self._record(slot, int(first[i]), now)

    def _record(self, slot: int, token: int, ts: float) -> None:
        """Append one emitted token; latch done on EOS or exhausted budget."""
        req = self.slots[slot]
        if req is None or self._done[slot]:
            return
        out = self._out[req.request_id]
        out.append(token)
        self._out_ts[req.request_id].append(ts)
        if req.eos_token_id is not None and token == req.eos_token_id:
            self._done[slot] = True
            self._finish_reason.setdefault(req.request_id, "eos")
        if len(out) >= req.max_new_tokens:
            self._done[slot] = True
            self._finish_reason.setdefault(req.request_id, "budget")

    def _retire_finished(self) -> None:
        finished = [i for i, r in enumerate(self.slots) if r is not None and self._done[i]]
        if not finished:
            return
        self.lm.retire(self.session, np.asarray(finished, np.int32))
        self._changed = True
        for slot in finished:
            req = self.slots[slot]
            rid = req.request_id
            self.completed.append(Completion(
                request_id=rid, tokens=np.asarray(self._out.pop(rid), np.int64),
                prompt_len=req.prompt.size,
                queue_blocks=max(req.start_block - req.arrival_block, 0),
                decode_blocks=self.blocks - req.start_block,
                ttft_blocks=max(req.first_token_block - req.arrival_block, 0),
                token_ts=np.asarray(self._out_ts.pop(rid), np.float64),
                submit_ts=self._submit_ts.pop(rid, None),
                finish_reason=self._finish_reason.pop(rid, "budget")))
            self.slots[slot] = None
            self._active[slot] = False
            self._done[slot] = False

    # --- the block loop --------------------------------------------------

    def step_block(self) -> bool:
        """One scheduling round: admit, advance every active slot
        ``block_steps`` tokens, record emissions, retire finished slots.
        Returns False when there is nothing left to do."""
        self._admit()
        self._retire_finished()   # a 1-token budget finishes at insert time
        self._admit()             # ... freeing its slot for queued work now
        if not self._active.any():
            if not self.queue:
                return False
            self.blocks += 1      # arrivals pending: advance virtual time
            return True
        toks = self._advance_block()
        now = time.perf_counter()
        self.decode_blocks += 1
        for i in range(self.block_steps):
            for slot, req in enumerate(self.slots):
                if req is not None and not self._done[slot]:
                    self._record(slot, int(toks[i, slot]), now)
            self._gen_counts += 1
        self._tok = toks[-1].astype(np.int32)
        self.blocks += 1
        self._retire_finished()
        return True

    def _stage(self) -> None:
        """Pack the host mirrors into the session's slot state (copied to
        the device by the next sync): the rows an admission or retirement
        changed, and the rest as the device already holds them."""
        st = self.session.slots
        st.host_field("tok")[:] = self._tok
        st.host_field("key_lo")[:] = self._keys[:, 0]
        st.host_field("key_hi")[:] = self._keys[:, 1]
        st.host_field("count")[:] = self._gen_counts
        st.host_field("active")[:] = self._active
        st.host_field("done")[:] = self._done
        st.host_field("eos")[:] = self._eos
        st.host_field("greedy")[:] = self._greedy
        st.host_field("temperature")[:] = self._temp
        st.dirty = True

    def _advance_block(self) -> np.ndarray:
        """Advance the pool ``block_steps`` tokens; returns the emitted
        (K, max_batch) token matrix."""
        if self._changed:
            self._stage()
            self._changed = False
        self.h2d_copies += self.session.slots.sync()
        K = self.block_steps
        if self.fused:
            out = self._fused(self.session)
            self.replays += 1
            got = self._fetch(out)
            self.nonfinite_logits += int((got[K] == 0).sum())
            return got[:K].astype(np.int64)
        dev = self.lm.device
        out = np.zeros((K, self.lm.max_batch), np.int64)
        done = self._done.copy()
        tok = self._tok.copy()
        max_len = self.lm.config.max_seq_len
        b = self.lm.max_batch
        for i in range(K):
            # the direct decode step, not lm.step(): step() raises at the
            # cache edge where the fused block latches done and runs on
            logits = self.lm._decode_step(self.session, torch.as_tensor(tok[:, None], device=dev))
            got = self._fetch(self._draw(logits, self._keys, self._gen_counts + i, self._temp,
                                         self._greedy))
            nxt = got[:b]
            self.nonfinite_logits += int((got[b:] == 0).sum())
            out[i] = np.where(done | ~self._active, self.pad_token_id, nxt)
            done = done | (self._active & (self._eos >= 0) & (nxt == self._eos))
            done = done | (self._active & (self.session.lengths + 1 >= max_len))
            tok = nxt.astype(np.int32)
        return out

    def run(self, max_blocks: Optional[int] = None) -> List[Completion]:
        """Drive blocks until the queue and every slot drain (or
        ``max_blocks`` elapse); returns completions in finish order."""
        n = 0
        while self.step_block():
            n += 1
            if max_blocks is not None and n >= max_blocks:
                break
        return self.completed
