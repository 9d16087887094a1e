"""Host-only model for scheduler runs: a stand-in for :class:`CausalLM`
whose insert, extend and decode do the same slot and page accounting with
no device work.

The port's own copy of ``neuronx_distributed_tpu/inference/simlm.py``
(numpy only). ``insert`` runs the paged admission lifecycle of
:class:`PagedKVCache` (plan, commit, prefix registration, the same
:class:`PagePoolExhausted`, atomic rollback) and writes no KV bytes;
tokens come from :meth:`SimCausalLM.sim_token`, a fixed function of
(request id, token index), the same numbers the reference's sim gives.
``ServeEngine`` sees ``lm.sim`` and routes its sampling sites and its
decode block here: a sim engine captures no graph, allocates no device
tensor and launches no kernel, so long fault storms run on the CPU in
seconds. Page corruption works (there are no bytes to garble); the host
tier raises, as in the reference. Unlike the reference's, a sim engine
snapshots (its scheduler state; there is no device state), so a sim fleet
drains, parks and restores as a card fleet does: a router's counts on a
trace are predicted over it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from neuronx_distributed_tpu_torch.inference.paged_cache import PagedKVCache


@dataclasses.dataclass
class SimConfig:
    vocab_size: int = 32000
    max_seq_len: int = 64
    page_size: int = 0
    page_pool_pages: int = 0


@dataclasses.dataclass
class SimSession:
    """Host mirror of a decode session: no device cache or slot state,
    the real :class:`PagedKVCache` accounting in paged mode."""

    lengths: np.ndarray
    active: np.ndarray
    paged: Optional[PagedKVCache] = None


class SimCausalLM:
    """The :class:`CausalLM` surface ``ServeEngine`` drives, every device
    program replaced by host accounting."""

    sim = True

    def __init__(self, max_batch: int = 4, buckets: Sequence[int] = (8, 16),
                 max_seq_len: int = 64, vocab_size: int = 32000, page_size: int = 0,
                 page_pool_pages: int = 0, prefix_cache: bool = True,
                 kv_token_bytes: int = 1024):
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.paged = page_size > 0
        self.prefix_cache = bool(prefix_cache)
        self.config = SimConfig(vocab_size=int(vocab_size), max_seq_len=int(max_seq_len),
                                page_size=int(page_size), page_pool_pages=int(page_pool_pages))
        self._kv_token_bytes = int(kv_token_bytes)
        self._vocab_mod = max(self.config.vocab_size - 1, 1)

    def start_session(self) -> SimSession:
        session = SimSession(lengths=np.zeros((self.max_batch,), np.int64),
                             active=np.zeros((self.max_batch,), bool))
        if self.paged:
            session.paged = PagedKVCache(self.config.page_size, self.config.page_pool_pages,
                                         self.max_batch, self.config.max_seq_len,
                                         prefix_cache=self.prefix_cache)
        return session

    def _bucket_for(self, s: int) -> int:
        for b in self.buckets:
            if s <= b:
                return b
        raise ValueError(f"prompt length {s} exceeds largest bucket {self.buckets[-1]}")

    def kv_cache_bytes(self) -> dict:
        """:meth:`CausalLM.kv_cache_bytes`'s keys for a pool of
        ``kv_token_bytes`` a token (one rank: per-rank = global)."""
        tokens = (self.config.page_pool_pages * self.config.page_size if self.paged
                  else self.max_batch * self.config.max_seq_len)
        kv = tokens * self._kv_token_bytes
        return {"kv_bytes": kv, "kv_bytes_global": kv,
                "kv_slab_bytes": self.max_batch * self.config.max_seq_len * self._kv_token_bytes}

    # --- the token function ------------------------------------------------

    def sim_token(self, rid: int, t: int) -> int:
        """Token ``t`` of request ``rid``: a fixed mix into [1, vocab),
        never the pad token, independent of placement and batching."""
        return 1 + (rid * 1000003 + t * 7919) % self._vocab_mod

    def sim_first_tokens(self, rids: Sequence[int], counts: Sequence[int]) -> List[int]:
        return [self.sim_token(int(r), int(c)) for r, c in zip(rids, counts)]

    def sim_decode_block(self, steps: int, tok, active, done, counts, rids) -> np.ndarray:
        """One ``steps``-token block for the whole pool: the emitted
        (steps, max_batch) token matrix, pad (0) for rows inactive or done
        at the block's start."""
        out = np.zeros((int(steps), self.max_batch), np.int64)
        idx = np.arange(int(steps), dtype=np.int64)
        for s in range(self.max_batch):
            if active[s] and not done[s]:
                out[:, s] = 1 + ((int(rids[s]) * 1000003 + (int(counts[s]) + idx) * 7919)
                                 % self._vocab_mod)
        return out

    # --- insert / extend / retire: host accounting only ---------------------

    def insert(self, session: SimSession, slot_ids, prompt_ids, lengths=None,
               pad_token_id: int = 0, reserve_tokens=None, ns=None, adapter_slots=None):
        """Paged admission through the real plan/commit lifecycle with no
        device work (the slab: length bookkeeping). Returns None: the
        engine draws sim tokens instead of reading logits."""
        slot_ids = np.asarray(slot_ids, np.int32).reshape(-1)
        rows = len(slot_ids)
        if lengths is None:
            lengths = np.asarray([int(np.max(np.nonzero(prompt_ids[i])[0], initial=0)) + 1
                                  for i in range(rows)], np.int32)
        lengths = np.maximum(np.asarray(lengths, np.int32), 1)
        if session.paged is not None:
            pkv = session.paged
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
            for i in range(rows):
                pkv.commit(int(slot_ids[i]), plans[i], prompt_ids[i, : lengths[i]].tolist(),
                           ns=nss[i])
        session.lengths[slot_ids] = lengths
        session.active[slot_ids] = True
        return None

    def extend(self, session: SimSession, slot_ids, ids, new_len, starts, tables=None,
               adapter_slots=None):
        """A chunk extend: its pages were allocated by
        ``PagedKVCache.extend_chunked`` already; nothing else to do."""
        slot_ids = np.asarray(slot_ids, np.int32).reshape(-1)
        session.lengths[slot_ids] = np.asarray(starts) + np.asarray(new_len)
        return None

    def retire(self, session: SimSession, slot_ids) -> None:
        slot_ids = np.asarray(slot_ids, np.int32).reshape(-1)
        if len(slot_ids) == 0:
            return
        session.active[slot_ids] = False
        if session.paged is not None:
            for slot in slot_ids:
                session.paged.release(int(slot))
