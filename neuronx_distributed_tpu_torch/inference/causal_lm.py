"""Causal-LM serving runtime: bucketed prefill into a slot pool, per-slot
decode, and generation.

Counterpart of ``neuronx_distributed_tpu/inference/causal_lm.py``. The KV
cache is a fixed pool of ``max_batch`` slots with per-slot lengths;
``insert`` prefills chosen slots while the others keep decoding. In paged
mode (``page_size``) the slots resolve through block tables into a shared
page pool, with radix prefix reuse: a prefix hit prefills only the suffix.

Where the JAX package compiles programs (prefill per bucket, a donated
decode step, a K-step fused ``lax.scan``), this runtime runs eagerly and
updates the cache in place. :meth:`CausalLM.session_decode` is the K-step
fused decode as a plain loop that keeps the per-slot lengths, active, done
and EOS-freeze state on the device and hands back the (K, b) token matrix
for one host fetch; CUDA graphs come later.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from neuronx_distributed_tpu_torch._device import DeviceLike, resolve_device
from neuronx_distributed_tpu_torch.inference.paged_cache import PagedKVCache
from neuronx_distributed_tpu_torch.inference.sampling import Sampler, SlotSampler
from neuronx_distributed_tpu_torch.models.llama import KVCache


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


@dataclasses.dataclass
class DecodeSession:
    """Continuous-batching session: the KV cache plus host-side per-slot
    accounting; ``paged`` is the host half of the page pool (None on a
    contiguous slab)."""

    cache: KVCache
    lengths: np.ndarray         # (max_batch,) tokens written per slot
    active: np.ndarray          # (max_batch,) slot in use
    paged: Optional[PagedKVCache] = None


class CausalLM:
    """Bucketed, KV-cached, continuous-batching generation over a decoder
    model class with the :class:`LlamaForCausalLM` interface.

    ``params`` is a state dict (tensors or numpy arrays) in the model's
    naming; it is moved to ``device`` in the config's ``param_dtype``.
    ``device`` defaults to ``cuda`` and must be given as ``"cpu"`` to run
    on the CPU."""

    def __init__(self, config, params: Mapping[str, Any], model_cls,
                 buckets=(128, 512, 2048), max_batch: int = 4,
                 page_size: Optional[int] = None, page_pool_pages: Optional[int] = None,
                 paged_attn_kernel: bool = False, prefix_cache: bool = True,
                 device: DeviceLike = None):
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
                paged_attn_kernel=bool(paged_attn_kernel))
        elif paged_attn_kernel:
            raise ValueError("paged_attn_kernel requires paged mode (pass page_size)")
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
        self.model = model.eval().requires_grad_(False)

    # --- helpers ---------------------------------------------------------

    def _bucket_for(self, s: int) -> int:
        for b in self.buckets:
            if s <= b:
                return b
        raise ValueError(f"prompt length {s} exceeds largest bucket {self.buckets[-1]}")

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=self.device)

    def _forward(self, ids: torch.Tensor, cache: KVCache) -> torch.Tensor:
        # no_grad rather than inference_mode: the cache tensors made here
        # are updated in place by later calls outside any such mode
        with torch.no_grad():
            return self.model(ids, cache)

    def kv_cache_bytes(self) -> int:
        """Bytes of the session KV pools (every layer, K and V)."""
        cfg = self.config
        hd, n_kv = cfg.head_dim_, cfg.num_kv_heads
        if self.paged:
            elems = cfg.page_pool_pages * cfg.page_size * n_kv * hd
        else:
            elems = self.max_batch * cfg.max_seq_len * n_kv * hd
        return 2 * cfg.num_layers * elems * torch.empty((), dtype=cfg.dtype).element_size()

    # --- continuous batching (slot-level session API) --------------------

    def start_session(self) -> DecodeSession:
        """Fresh decode session (all slots free)."""
        session = DecodeSession(
            cache=self.model.new_cache(self.max_batch, self.device),
            lengths=np.zeros((self.max_batch,), np.int64),
            active=np.zeros((self.max_batch,), bool))
        if self.paged:
            session.paged = PagedKVCache(
                self.config.page_size, self.config.page_pool_pages, self.max_batch,
                self.config.max_seq_len, prefix_cache=self.prefix_cache)
            self._set_block_tables(session)
        return session

    def _set_block_tables(self, session: DecodeSession) -> None:
        session.cache.block_table.copy_(
            torch.as_tensor(session.paged.tables, dtype=torch.int32))

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
               ns: Optional[Sequence[Optional[str]]] = None) -> torch.Tensor:
        """Prefill ``slot_ids`` with new prompts; every other slot's cache
        rows and lengths are preserved. Right-sized: only the inserted rows
        are prefilled, at their own batch width. Returns the next-token
        logits ``(len(slot_ids), vocab)``."""
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
        if self.paged:
            return self._insert_paged(session, slot_ids, prompt_ids, lengths,
                                      reserve_tokens, ns=ns)
        bucket = self._bucket_for(s)
        rows = len(slot_ids)
        ids = np.zeros((rows, bucket), np.int32)
        ids[:, :s] = prompt_ids
        # prefill into a fresh zero slab at the rows' own width, then copy the
        # whole rows into the session slab (stale tails of the slots' earlier
        # requests are overwritten, as the JAX scatter does)
        fresh = self.model.new_cache(rows, self.device)
        fresh.max_index = 0
        logits = self._forward(self._ids(ids), fresh)
        dst = torch.as_tensor(slot_ids, dtype=torch.long, device=self.device)
        cache = session.cache
        for layer in range(self.config.num_layers):
            cache.keys[layer].index_copy_(0, dst, fresh.keys[layer])
            cache.values[layer].index_copy_(0, dst, fresh.values[layer])
        cache.cache_index.index_copy_(0, dst, self._ids(lengths))
        session.lengths[slot_ids] = lengths
        session.active[slot_ids] = True
        last = torch.as_tensor(np.maximum(lengths - 1, 0), dtype=torch.long, device=self.device)
        return logits[torch.arange(rows, device=self.device), last]

    def _insert_paged(self, session: DecodeSession, slot_ids: np.ndarray,
                      prompt_ids: np.ndarray, lengths: np.ndarray, reserve_tokens,
                      ns: Optional[Sequence[Optional[str]]] = None) -> torch.Tensor:
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
        view = session.cache.rows(self._ids(starts), self._ids(tables),
                                  max_index=int(starts.max()))
        try:
            logits = self._forward(self._ids(ids), view)
        except Exception:
            for p in plans:
                pkv.rollback(p)
            raise
        for i in range(rows):
            pkv.commit(int(slot_ids[i]), plans[i], prompt_ids[i, : lengths[i]].tolist(),
                       ns=nss[i])
        dst = torch.as_tensor(slot_ids, dtype=torch.long, device=self.device)
        session.cache.cache_index.index_copy_(0, dst, self._ids(lengths))
        session.cache.block_table.index_copy_(0, dst, self._ids(tables))
        session.lengths[slot_ids] = lengths
        session.active[slot_ids] = True
        last = torch.as_tensor(np.maximum(suffix - 1, 0), dtype=torch.long, device=self.device)
        return logits[torch.arange(rows, device=self.device), last]

    def _decode_step(self, session: DecodeSession, tok: torch.Tensor) -> torch.Tensor:
        """One single-token forward for every slot (inactive slots advance
        harmlessly); ``tok`` (max_batch, 1) int32 on the device."""
        cache = session.cache
        cache.max_index = int(session.lengths.max())
        logits = self._forward(tok, cache)
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

    def session_decode(self, session: DecodeSession, steps: int, tok: torch.Tensor,
                       active: torch.Tensor, done: torch.Tensor, eos_ids: torch.Tensor,
                       temperature: torch.Tensor, greedy: torch.Tensor,
                       slot_sampler: Optional[SlotSampler] = None,
                       noise: Optional[Callable[[int], Optional[torch.Tensor]]] = None,
                       pad_token_id: int = 0):
        """``steps`` continuous-batching decode iterations with the per-slot
        state on the device (the JAX package's fused session program, as a
        loop). Row j's step-i emission is frozen to ``pad_token_id`` when
        the row was done or inactive before step i; ``done`` latches on the
        row's own ``eos_ids`` entry (−1 disables) and when its next write
        would pass ``max_seq_len``. ``noise(i)`` gives step i's (b, vocab)
        Gumbel noise, or None when every row is greedy.

        Returns ``(tokens (steps, b), next_tok (b, 1), done (b,))`` on the
        device: the caller fetches once per call."""
        slot_sampler = slot_sampler or SlotSampler()
        max_len = self.config.max_seq_len
        lengths = torch.as_tensor(session.lengths, dtype=torch.int32, device=self.device)
        toks = []
        pad = torch.tensor(pad_token_id, dtype=torch.int32, device=self.device)
        for i in range(steps):
            logits = self._decode_step(session, tok)
            nxt = slot_sampler(logits, temperature, greedy, noise(i) if noise else None)
            toks.append(torch.where(done | ~active, pad, nxt))
            done = done | (active & (eos_ids >= 0) & (nxt == eos_ids))
            lengths = lengths + 1
            done = done | (active & (lengths + 1 >= max_len))
            tok = nxt[:, None]
        return torch.stack(toks), tok, done

    def retire(self, session: DecodeSession, slot_ids) -> None:
        """Mark slots idle; in paged mode return their pages and point their
        device tables back at scratch. Idempotent and empty-safe."""
        slot_ids = np.asarray(slot_ids, np.int32).reshape(-1)
        if len(slot_ids) == 0:
            return
        if (slot_ids < 0).any() or (slot_ids >= self.max_batch).any():
            raise ValueError(f"slot ids {slot_ids.tolist()} out of range [0, {self.max_batch})")
        session.active[slot_ids] = False
        if self.paged and session.paged is not None:
            for slot in slot_ids:
                session.paged.release(int(slot))
            self._set_block_tables(session)

    # --- generation ------------------------------------------------------

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 sampler: Optional[Sampler] = None, eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 lengths: Optional[np.ndarray] = None,
                 pad_token_id: int = 0) -> GenerationResult:
        """Batched generate on the contiguous slot path: prefill the prompts
        into slots 0..b-1, then decode step by step. ``prompt_ids`` (b, s)
        right-padded with ``pad_token_id``."""
        if self.paged:
            raise ValueError("generate() runs the contiguous-slot path; a paged CausalLM "
                             "serves through sessions (insert/step) or ServeEngine")
        sampler = sampler or Sampler(greedy=True)
        b, s = prompt_ids.shape
        if b > self.max_batch:
            raise ValueError(f"batch {b} exceeds max_batch {self.max_batch}")
        if lengths is None:
            lengths = infer_prompt_lengths(prompt_ids, pad_token_id)
        lengths = np.maximum(np.asarray(lengths, np.int32), 1)
        if int(lengths.max()) + max_new_tokens > self.config.max_seq_len:
            raise ValueError(f"prompt ({int(lengths.max())}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds max_seq_len "
                             f"{self.config.max_seq_len}")
        session = self.start_session()
        logits = self.insert(session, np.arange(b), prompt_ids, lengths=lengths)
        out = np.zeros((b, max_new_tokens), np.int64)
        gen_len = np.zeros((b,), np.int32)
        done = np.zeros((b,), bool)
        tok = np.zeros((self.max_batch,), np.int32)
        for t in range(max_new_tokens):
            nxt = sampler(logits, generator).cpu().numpy()
            out[:, t] = np.where(done, pad_token_id, nxt)
            gen_len = np.where(done, gen_len, gen_len + 1)
            if eos_token_id is not None:
                done = done | (nxt == eos_token_id)
            if done.all() or t + 1 == max_new_tokens:
                break
            tok[:b] = nxt
            logits = self.step(session, tok)[:b]
        return GenerationResult(tokens=out, lengths=gen_len)
