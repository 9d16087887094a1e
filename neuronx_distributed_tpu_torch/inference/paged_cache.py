"""Paged KV cache, host side: page allocator, radix prefix index, and the
per-session plan/commit/rollback/release lifecycle.

The port's own copy of the device-independent core of
``neuronx_distributed_tpu/inference/paged_cache.py`` (PagedAttention,
Kwon et al. 2023; RadixAttention, Zheng et al. 2024). Decisions are the
same as there for the same call sequence — free-list order, refcounts, LRU
victims, block tables — so the two can be held against each other. Chunked
prefill allocates a long prompt's pages chunk by chunk
(:class:`ChunkedPrefill`, ``begin/extend/finish/abort_chunked``). The host
tier, page adoption and conversation purge come with later slices.

Device layout (``models/llama.py``): each layer holds a K and a V page pool
of ``num_pages`` pages x ``page_size`` tokens; slot ``i``'s block table row
maps its logical pages to physical ones. Page ``i < max_batch`` is slot
``i``'s scratch page, the target of every unowned table entry, so overrun
and padding writes never touch a live page. Shared prefix pages cover only
full pages strictly below a request's last prompt token, so every write
lands in privately owned or scratch pages and a shared page is immutable
until its refcount drains.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """Not enough free pages for an admission, even after evicting
    cache-only prefix pages; the scheduler defers the request."""


class PageAllocator:
    """Free-list page allocator with per-page refcounts. ``reserved`` pages
    at the front of the id space never enter the free list."""

    def __init__(self, num_pages: int, reserved: int = 0):
        if num_pages <= reserved:
            raise ValueError(f"pool of {num_pages} pages <= {reserved} reserved")
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        self._free = deque(range(reserved, num_pages))
        self.refcount = np.zeros((num_pages,), np.int32)

    def available(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.num_pages - self.reserved - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None when the pool can't cover."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            if self.refcount[p] <= 0:
                raise ValueError(f"retain of free page {p}")
            self.refcount[p] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one hold per page; returns the pages that went free."""
        freed = []
        for p in pages:
            if self.refcount[p] <= 0:
                raise ValueError(f"release of free page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed


def _ns_tokens(tokens: Sequence[int], ns: Optional[str]) -> list:
    """Namespaced radix key stream: a prefix's KV depends on (tokens,
    adapter), so tokens are salted with the adapter name; ``ns=None`` is
    the plain token stream."""
    if ns is None:
        return list(tokens)
    return [(ns, int(t)) for t in tokens]


class _Node:
    """One cached prompt page (``page >= 0`` while device-resident)."""

    __slots__ = ("children", "page", "parent", "key", "last_used", "dead")

    def __init__(self, key, page, parent):
        self.children: Dict[tuple, _Node] = {}
        self.key = key
        self.page = page
        self.parent = parent
        self.last_used = 0
        self.dead = False


class RadixPrefixIndex:
    """Page-granular prompt prefix trie. Each cached page holds one
    allocator refcount; under pool pressure cache-only leaves are dropped,
    least recently used first."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = int(page_size)
        self.allocator = allocator
        self.root = _Node(None, -1, None)
        self._clock = 0
        self.cached_pages = 0
        self._lru: List[Tuple[int, int, _Node]] = []   # lazy-deleted min-heap
        self._lru_seq = 0

    def _touch(self, node: _Node) -> None:
        node.last_used = self._clock
        self._lru_seq += 1
        heapq.heappush(self._lru, (node.last_used, self._lru_seq, node))
        if len(self._lru) > 64 + 4 * max(self.cached_pages, 1):
            self._compact_lru()

    def _compact_lru(self) -> None:
        seen, keep = set(), []
        for stamp, seq, node in sorted(self._lru, key=lambda e: e[:2]):
            if node.dead or node.last_used != stamp or id(node) in seen:
                continue
            seen.add(id(node))
            keep.append((stamp, seq, node))
        self._lru = keep
        heapq.heapify(self._lru)

    def _pop_lru_victim(self, candidate) -> Optional[_Node]:
        side, found = [], None
        while self._lru:
            item = heapq.heappop(self._lru)
            stamp, _seq, node = item
            if node.dead or node.last_used != stamp:
                continue
            side.append(item)
            if candidate(node):
                found = node
                break
        for item in side:
            heapq.heappush(self._lru, item)
        return found

    def lookup_nodes(self, tokens: Sequence[int]) -> List[_Node]:
        """Trie nodes of the longest cached page-aligned prefix, LRU-touched."""
        ps = self.page_size
        self._clock += 1
        node, out = self.root, []
        for i in range(len(tokens) // ps):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            self._touch(child)
            out.append(child)
            node = child
        return out

    def lookup(self, tokens: Sequence[int]) -> List[int]:
        """Physical page ids of the longest cached page-aligned prefix."""
        return [n.page for n in self.lookup_nodes(tokens)]

    def peek(self, tokens: Sequence[int]) -> List[int]:
        """:meth:`lookup` without touching the LRU clock or taking holds."""
        ps = self.page_size
        node, pages = self.root, []
        for i in range(len(tokens) // ps):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            pages.append(child.page)
            node = child
        return pages

    def register(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Record prompt pages after their K/V were written. An existing
        entry keeps its page (the new copy stays request-private); new
        entries take one cache hold."""
        ps = self.page_size
        if len(pages) * ps > len(tokens):
            raise ValueError("register: pages exceed token coverage")
        self._clock += 1
        node = self.root
        for i, page in enumerate(pages):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(page), node)
                node.children[key] = child
                self.allocator.retain([int(page)])
                self.cached_pages += 1
            self._touch(child)
            node = child

    def evict(self, n_pages: int) -> int:
        """Drop LRU leaf entries held only by the cache until ``n_pages``
        pages went free (or no candidate is left). Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victim = self._pop_lru_victim(
                lambda c: not c.children and self.allocator.refcount[c.page] == 1)
            if victim is None:
                return freed
            del victim.parent.children[victim.key]
            freed += self._drop_subtree(victim)
        return freed

    def reclaimable_pages(self) -> int:
        """Pages :meth:`evict` could free right now (JAX
        ``paged_cache.py:453-476`` without a host tier): cache-only pages
        (refcount 1) whose whole subtree is cache-only too, since eviction
        drops leaves first."""
        def count(node) -> Tuple[int, bool]:
            total, all_free = 0, True
            for c in node.children.values():
                t, free = count(c)
                total += t
                all_free = all_free and free
            if all_free and self.allocator.refcount[node.page] == 1:
                return total + 1, True
            return total, False

        return sum(count(c)[0] for c in self.root.children.values())

    def _drop_subtree(self, node) -> int:
        freed = 0
        self.cached_pages -= 1
        freed += len(self.allocator.release([node.page]))
        node.page = -1
        node.dead = True
        for child in node.children.values():
            freed += self._drop_subtree(child)
        return freed


@dataclasses.dataclass
class ChunkedPrefill:
    """In-flight chunked-prefill page state of one request (JAX
    ``paged_cache.py:682``): pages are allocated as chunks extend coverage,
    so a long prompt never needs its whole footprint free at once, and an
    abort rolls every hold back in one step. ``start`` is the page-aligned
    reused prefix length (the prefill begins there); ``owned`` grows with
    each :meth:`PagedKVCache.extend_chunked`."""

    tokens: list
    reserve_total: int
    start: int
    shared: List[int]
    owned: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class InsertPlan:
    """One admission's page layout: ``table`` is the block-table row
    (shared pages, owned pages, -1 for scratch), ``start`` the page-aligned
    length of the reused prefix (suffix prefill begins there)."""

    table: np.ndarray
    start: int
    prompt_len: int
    shared: List[int]
    owned: List[int]


class PagedKVCache:
    """Per-session host state for the paged pool: block tables, scratch
    pages, allocator, prefix index, and the insert/retire lifecycle."""

    def __init__(self, page_size: int, num_pages: int, max_batch: int,
                 max_seq_len: int, prefix_cache: bool = True):
        if max_seq_len % page_size:
            raise ValueError(f"page_size {page_size} must divide max_seq_len {max_seq_len}")
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.pages_per_slot = max_seq_len // page_size
        if num_pages < max_batch + 1:
            raise ValueError(f"pool of {num_pages} pages cannot hold {max_batch} scratch "
                             f"pages + one allocatable page")
        self.scratch = np.arange(max_batch, dtype=np.int32)
        self.allocator = PageAllocator(num_pages, reserved=max_batch)
        self.prefix: Optional[RadixPrefixIndex] = (
            RadixPrefixIndex(page_size, self.allocator) if prefix_cache else None)
        self.tables = np.tile(self.scratch[:, None], (1, self.pages_per_slot)).astype(np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        # plain host counters, read as attributes
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.evicted_pages = 0
        self.pages_in_use_peak = 0

    def _alloc_with_reclaim(self, n: int) -> Optional[List[int]]:
        pages = self.allocator.alloc(n)
        if pages is None and self.prefix is not None:
            self.evicted_pages += self.prefix.evict(n - self.allocator.available())
            pages = self.allocator.alloc(n)
        return pages

    def _resolve_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Cached prefix pages, clamped below the last prompt token; each
        returned page carries one admission hold (released on rollback)."""
        if self.prefix is None:
            return []
        nodes = self.prefix.lookup_nodes(tokens)[: (len(tokens) - 1) // self.page_size]
        shared = [n.page for n in nodes]
        self.allocator.retain(shared)
        return shared

    def plan(self, tokens: Sequence[int], reserve_total: int,
             ns: Optional[str] = None) -> InsertPlan:
        """Plan one admission: longest cached prefix plus fresh pages
        covering ``reserve_total`` logical tokens (LRU eviction of cache-only
        pages first, then :class:`PagePoolExhausted`). Pair every plan with
        :meth:`commit` or :meth:`rollback`."""
        ps = self.page_size
        tokens = _ns_tokens(tokens, ns)
        plen = len(tokens)
        if plen < 1:
            raise ValueError("empty prompt")
        shared: List[int] = []
        if self.prefix is not None:
            self.prefix_queries += 1
            shared = self._resolve_prefix(tokens)
            if shared:
                self.prefix_hits += 1
                self.prefix_hit_tokens += len(shared) * ps
        start = len(shared) * ps
        total = min(max(int(reserve_total), plen), self.max_seq_len)
        n_owned = -(-total // ps) - len(shared)
        owned = self._alloc_with_reclaim(n_owned)
        if owned is None:
            self.allocator.release(shared)
            raise PagePoolExhausted(f"need {n_owned} pages, "
                                    f"{self.allocator.available()} free")
        table = np.empty((self.pages_per_slot,), np.int32)
        table[: len(shared)] = shared
        table[len(shared): len(shared) + n_owned] = owned
        table[len(shared) + n_owned:] = -1   # scratch fill, set at commit
        return InsertPlan(table=table, start=start, prompt_len=plen,
                          shared=list(shared), owned=list(owned))

    def rollback(self, plan: InsertPlan) -> None:
        self.allocator.release(plan.shared)
        self.allocator.release(plan.owned)

    def table_for(self, slot: int, plan: InsertPlan) -> np.ndarray:
        t = plan.table.copy()
        t[t < 0] = self.scratch[slot]
        return t

    def commit(self, slot: int, plan: InsertPlan, tokens: Sequence[int],
               ns: Optional[str] = None) -> None:
        """Install the plan on ``slot`` (releasing what it held) and register
        the prompt's fully covered pages in the prefix index."""
        self.release(slot)
        self.tables[slot] = self.table_for(slot, plan)
        self._slot_pages[slot] = plan.shared + plan.owned
        if self.prefix is not None:
            n_full = plan.prompt_len // self.page_size
            self.prefix.register(_ns_tokens(tokens, ns)[: n_full * self.page_size],
                                 [int(p) for p in self.tables[slot, :n_full]])
        self.pages_in_use_peak = max(self.pages_in_use_peak, self.allocator.in_use())

    def release(self, slot: int) -> None:
        """Drop the slot's page holds (prefix-cached pages stay resident
        until evicted) and point its table back at scratch."""
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.allocator.release(pages)
        self.tables[slot] = self.scratch[slot]

    # --- chunked-prefill lifecycle: begin -> extend* -> finish | abort ------

    def begin_chunked(self, tokens: Sequence[int], reserve_total: int,
                      ns: Optional[str] = None) -> ChunkedPrefill:
        """Open a chunked admission (JAX ``paged_cache.py:1124``): the
        prefix walk takes a hold on the reused pages, and no page is owned
        yet. Cannot raise :class:`PagePoolExhausted`."""
        tokens = _ns_tokens(tokens, ns)
        if len(tokens) < 1:
            raise ValueError("empty prompt")
        shared: List[int] = []
        if self.prefix is not None:
            self.prefix_queries += 1
            shared = self._resolve_prefix(tokens)
            if shared:
                self.prefix_hits += 1
                self.prefix_hit_tokens += len(shared) * self.page_size
        return ChunkedPrefill(tokens=list(tokens), reserve_total=int(reserve_total),
                              start=len(shared) * self.page_size, shared=list(shared))

    def extend_chunked(self, state: ChunkedPrefill, covered_tokens: int,
                       final: bool = False) -> None:
        """Allocate the pages a chunk needs before it runs (JAX ``:1152``):
        coverage grows to ``covered_tokens``, and the final chunk also covers
        the decode reserve. Evicts cache-only prefix pages first; raises
        :class:`PagePoolExhausted` with ``state`` untouched."""
        ps = self.page_size
        total = min(int(covered_tokens), self.max_seq_len)
        if final:
            total = min(max(state.reserve_total, len(state.tokens)), self.max_seq_len)
        need = -(-total // ps) - len(state.shared) - len(state.owned)
        if need <= 0:
            return
        pages = self._alloc_with_reclaim(need)
        if pages is None:
            raise PagePoolExhausted(f"chunked prefill needs {need} pages, "
                                    f"{self.allocator.available()} free")
        state.owned.extend(pages)

    def chunk_table(self, slot: int, state: ChunkedPrefill) -> np.ndarray:
        """Block-table row for the next chunk (JAX ``:1177``): the pages
        held so far, scratch beyond. Not installed in :attr:`tables` until
        :meth:`finish_chunked`."""
        t = np.full((self.pages_per_slot,), self.scratch[slot], np.int32)
        pages = state.shared + state.owned
        t[: len(pages)] = pages
        return t

    def finish_chunked(self, slot: int, state: ChunkedPrefill) -> None:
        """Install the completed prefill on ``slot`` and register the
        prompt's fully covered pages (JAX ``:1190``); allocates nothing."""
        self.release(slot)
        self.tables[slot] = self.chunk_table(slot, state)
        self._slot_pages[slot] = state.shared + state.owned
        if self.prefix is not None:
            n_full = len(state.tokens) // self.page_size
            self.prefix.register(state.tokens[: n_full * self.page_size],
                                 [int(p) for p in self.tables[slot, :n_full]])
        self.pages_in_use_peak = max(self.pages_in_use_peak, self.allocator.in_use())

    def abort_chunked(self, slot: int, state: ChunkedPrefill) -> None:
        """Roll an in-flight chunked prefill back (JAX ``:1207``): every
        hold it took is released and the slot's table row points at scratch.
        Idempotent."""
        self.allocator.release(state.shared)
        self.allocator.release(state.owned)
        state.shared, state.owned = [], []
        self.tables[slot] = self.scratch[slot]

    def live_pages(self) -> List[int]:
        pages = set()
        for held in self._slot_pages.values():
            pages.update(int(p) for p in held)
        return sorted(pages)

    def pages_needed(self, prompt_len: int, new_tokens: int) -> int:
        total = min(prompt_len + new_tokens, self.max_seq_len)
        return -(-total // self.page_size)

    def capacity_pages(self) -> int:
        return self.num_pages - self.max_batch
