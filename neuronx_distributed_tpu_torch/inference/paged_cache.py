"""Paged KV cache, host side: page allocator, radix prefix index, and the
per-session plan/commit/rollback/release lifecycle.

The port's own copy of the device-independent core of
``neuronx_distributed_tpu/inference/paged_cache.py`` (PagedAttention,
Kwon et al. 2023; RadixAttention, Zheng et al. 2024). Decisions are the
same as there for the same call sequence — free-list order, refcounts, LRU
victims, block tables — so the two can be held against each other. Chunked
prefill allocates a long prompt's pages chunk by chunk
(:class:`ChunkedPrefill`, ``begin/extend/finish/abort_chunked``).

The host tier (:class:`HostPageTier`, :meth:`PagedKVCache.enable_tier`,
JAX ``paged_cache.py:75-178, 312-680, 766-907``): under pool pressure,
cache-only prefix pages are spilled into host copies with a crc32 each
(the radix entry kept, marked tiered) before any entry is dropped, and a
prefix hit on a tiered path restores them into fresh device pages. The
ladder is spill, then restore what the pool affords, then re-prefill, then
:class:`PagePoolExhausted`. A restore that fails or fails its checksum
drops the subtree and the admission re-prefills the suffix. The tier is
inclusive: a restored page keeps its host copy, from which a corrupted
device page is repaired in place. Page adoption and conversation purge come
with later slices.

Device layout (``models/llama.py``): each layer holds a K and a V page pool
of ``num_pages`` pages x ``page_size`` tokens; slot ``i``'s block table row
maps its logical pages to physical ones. Page ``i < max_batch`` is slot
``i``'s scratch page, the target of every unowned table entry, so overrun
and padding writes never touch a live page. Shared prefix pages cover only
full pages strictly below a request's last prompt token, so every write
lands in privately owned or scratch pages and a shared page is immutable
until its refcount drains.

Tensor parallelism (JAX ``paged_cache.py:50-60``): everything here is
shard-agnostic. Each rank's pools hold its own KV heads, but one logical
page id names the same page on every rank, so tables, refcounts, the radix
index and the plan/commit lifecycle never see a shard. Host-tier pages
are full width (the engine's page reads gather every rank's heads) and are
sized with ``CausalLM.kv_page_bytes_host()``; the device pool with the
per-rank ``kv_page_bytes()``.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """Not enough free pages for an admission, even after evicting
    cache-only prefix pages; the scheduler defers the request."""


class TierRestoreError(RuntimeError):
    """A host-tier page read failed (an injected IO fault): the entry is
    dropped and the admission re-prefills the suffix."""


class TierCorruption(RuntimeError):
    """A host-tier page's bytes no longer match their crc32: the copy is
    dropped and the admission re-prefills the suffix."""


class HostPageTier:
    """Host-memory store of spilled KV pages (JAX ``paged_cache.py:93``):
    one entry per radix node, the page's named leaf arrays with a crc32
    over them in name order, taken at spill time and checked on every
    read. Capacity is in pages; a put past it drops the least recently
    used entries and returns their ids so the index can clear their radix
    entries. ``fault_hook`` is the ``tier`` seam of ``faults.py``: asked
    once per :meth:`get`, it may fail the read or garble the entry (a
    copy of it: the array handed out earlier stays as it was), which the
    checksum then catches. Counters: ``puts``, ``gets``,
    ``restore_failures``, ``checksum_failures``, ``lru_drops``."""

    def __init__(self, max_pages: int):
        if max_pages < 1:
            raise ValueError(f"host tier needs >= 1 page, got {max_pages}")
        self.max_pages = int(max_pages)
        self._entries: Dict[int, dict] = {}
        self._next = 0
        self._clock = 0
        self.fault_hook: Optional[Callable[[], Optional[str]]] = None
        self.puts = 0
        self.gets = 0
        self.restore_failures = 0
        self.checksum_failures = 0
        self.lru_drops = 0

    def __len__(self) -> int:
        return len(self._entries)

    def bytes_used(self) -> int:
        return sum(e["nbytes"] for e in self._entries.values())

    @staticmethod
    def _crc(data: Dict[str, np.ndarray]) -> int:
        crc = 0
        for k in sorted(data):
            crc = zlib.crc32(np.ascontiguousarray(data[k]).tobytes(), crc)
        return crc

    def put(self, data: Dict[str, np.ndarray]) -> Tuple[int, List[int]]:
        """Store one page's leaf arrays; returns (tier id, ids the LRU
        dropped), whose radix entries the caller clears."""
        data = {k: np.ascontiguousarray(v) for k, v in data.items()}
        tid = self._next
        self._next += 1
        self._clock += 1
        self._entries[tid] = {"data": data, "crc": self._crc(data),
                              "nbytes": sum(v.nbytes for v in data.values()),
                              "last_used": self._clock}
        self.puts += 1
        evicted: List[int] = []
        while len(self._entries) > self.max_pages:
            victim = min((t for t in self._entries if t != tid),
                         key=lambda t: self._entries[t]["last_used"])
            del self._entries[victim]
            evicted.append(victim)
            self.lru_drops += 1
        return tid, evicted

    def get(self, tid: int) -> Dict[str, np.ndarray]:
        """Checksum-verified read. Raises :class:`TierRestoreError` or
        :class:`TierCorruption`, the entry dropped either way."""
        entry = self._entries[tid]
        self._clock += 1
        entry["last_used"] = self._clock
        self.gets += 1
        verdict = self.fault_hook() if self.fault_hook is not None else None
        if verdict == "fail":
            del self._entries[tid]
            self.restore_failures += 1
            raise TierRestoreError(f"injected tier read failure (tid {tid})")
        if verdict == "corrupt":
            first = next(iter(sorted(entry["data"])))
            entry["data"][first] = entry["data"][first].copy()
            entry["data"][first].view(np.uint8).reshape(-1)[0] ^= 0xFF
        if self._crc(entry["data"]) != entry["crc"]:
            del self._entries[tid]
            self.checksum_failures += 1
            raise TierCorruption(f"tier page {tid} failed checksum")
        return entry["data"]

    def drop(self, tid: Optional[int]) -> None:
        if tid is not None:
            self._entries.pop(tid, None)


class PageAllocator:
    """Free-list page allocator with per-page refcounts. ``reserved`` pages
    at the front of the id space never enter the free list. ``fault_hook``
    (the ``alloc`` seam of ``faults.py``) may fail an allocation that would
    have succeeded."""

    def __init__(self, num_pages: int, reserved: int = 0):
        if num_pages <= reserved:
            raise ValueError(f"pool of {num_pages} pages <= {reserved} reserved")
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        self._free = deque(range(reserved, num_pages))
        self.refcount = np.zeros((num_pages,), np.int32)
        self.fault_hook: Optional[Callable[[int], bool]] = None

    def available(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.num_pages - self.reserved - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None when the pool can't cover."""
        if n > len(self._free):
            return None
        if self.fault_hook is not None and self.fault_hook(n):
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
    """One cached prompt page: device-resident while ``page >= 0``, spilled
    while ``page < 0`` with a ``tier_id``, dead (out of the trie) with
    neither. A node may be both resident and tiered (the tier is
    inclusive)."""

    __slots__ = ("children", "page", "parent", "key", "last_used", "tier_id", "dead")

    def __init__(self, key, page, parent):
        self.children: Dict[tuple, _Node] = {}
        self.key = key
        self.page = page
        self.parent = parent
        self.last_used = 0
        self.tier_id: Optional[int] = None
        self.dead = False


class RadixPrefixIndex:
    """Page-granular prompt prefix trie. Each cached device page holds one
    allocator refcount; under pool pressure cache-only pages are spilled to
    the host tier when one is attached (entry kept, marked tiered), and
    dropped otherwise, least recently used first (leaves only)."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = int(page_size)
        self.allocator = allocator
        self.root = _Node(None, -1, None)
        self._clock = 0
        self.cached_pages = 0
        self._lru: List[Tuple[int, int, _Node]] = []   # lazy-deleted min-heap
        self._lru_seq = 0
        # host tier (attach_tier): None keeps the drop-on-evict behaviour
        self.tier: Optional[HostPageTier] = None
        self._read_page: Optional[Callable[[int], Dict[str, np.ndarray]]] = None
        self._tier_nodes: Dict[int, _Node] = {}
        self._page_node: Dict[int, _Node] = {}   # device page -> the node holding it

    def attach_tier(self, tier: HostPageTier,
                    read_page: Callable[[int], Dict[str, np.ndarray]]) -> None:
        """Spill into ``tier``, reading a device page's bytes through
        ``read_page``."""
        self.tier = tier
        self._read_page = read_page

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

    def _set_page(self, node: _Node, page: int) -> None:
        """A node's device residency, with the page -> node map kept in
        step."""
        if node.page >= 0 and self._page_node.get(node.page) is node:
            del self._page_node[node.page]
        node.page = int(page)
        if page >= 0:
            self._page_node[int(page)] = node

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
        """Trie nodes of the longest cached page-aligned prefix, resident
        and tiered alike, LRU-touched."""
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
        """Physical page ids of the longest device-resident cached
        page-aligned prefix (it stops at the first tiered entry)."""
        pages = []
        for node in self.lookup_nodes(tokens):
            if node.page < 0:
                break
            pages.append(node.page)
        return pages

    def peek(self, tokens: Sequence[int]) -> List[int]:
        """Read-only walk of the cached prefix: no LRU touch, no hold, no
        restore. A tiered entry reads as page ``-1`` (a hit all the same)."""
        ps = self.page_size
        node, pages = self.root, []
        for i in range(len(tokens) // ps):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            pages.append(child.page if child.page >= 0 else -1)
            node = child
        return pages

    def register(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Record prompt pages after their K/V were written. An existing
        resident entry keeps its page (the new copy stays request-private);
        a tiered entry adopts the freshly written page (same content); new
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
                child = _Node(key, -1, node)
                node.children[key] = child
                self._set_page(child, int(page))
                self.allocator.retain([int(page)])
                self.cached_pages += 1
            elif child.page < 0:
                self._set_page(child, int(page))
                self.allocator.retain([int(page)])
            self._touch(child)
            node = child

    def _counts(self) -> Tuple[int, int]:
        """(evictable, spillable) device pages (JAX ``paged_cache.py:422``).
        A tiered-only node holds no device page: it counts 0 and pins no
        ancestor."""
        def count(node) -> Tuple[int, bool]:
            total, all_free = 0, True
            for c in node.children.values():
                t, free = count(c)
                total += t
                all_free = all_free and free
            if node.page < 0:
                return total, all_free
            if all_free and self.allocator.refcount[node.page] == 1:
                return total + 1, True
            return total, False

        ev = sum(count(c)[0] for c in self.root.children.values())
        sp = 0
        if self.tier is not None:
            sp = sum(1 for n in self._iter_nodes()
                     if n.page >= 0 and self.allocator.refcount[n.page] == 1)
        return ev, sp

    def evictable_pages(self) -> int:
        """Device pages LRU eviction could free now: cache-only pages whose
        whole subtree is cache-only too (eviction drops leaves first)."""
        return self._counts()[0]

    def spillable_pages(self) -> int:
        """Device pages a spill could move to the tier now: every cache-only
        page, interior ones included (a spill keeps the entry). 0 without a
        tier."""
        return 0 if self.tier is None else self._counts()[1]

    def reclaimable_pages(self) -> int:
        """Device pages reclaim could free now (JAX ``paged_cache.py:471``):
        spillable with a tier (a superset of evictable), else evictable."""
        return self.spillable_pages() if self.tier is not None else self.evictable_pages()

    def spill(self, n_pages: int) -> int:
        """Spill up to ``n_pages`` cold cache-only device pages into the
        tier, LRU first, interior nodes included: bytes copied out with a
        checksum, the device page released, the entry kept and marked
        tiered. A node that holds a tier copy already skips the copy.
        Returns the pages freed."""
        if self.tier is None or self._read_page is None:
            return 0
        freed = 0
        while freed < n_pages:
            node = self._pop_lru_victim(
                lambda n: n.page >= 0 and self.allocator.refcount[n.page] == 1)
            if node is None:
                return freed
            if node.tier_id is None:
                tid, dropped = self.tier.put(self._read_page(node.page))
                node.tier_id = tid
                self._tier_nodes[tid] = node
                for d in dropped:
                    self._on_tier_drop(d)
            if node.page >= 0:
                page = node.page
                self._set_page(node, -1)
                freed += len(self.allocator.release([page]))
            else:
                # a tier-LRU drop took an ancestor and this node with it:
                # its device page was freed there
                freed += 1
        return freed

    def _on_tier_drop(self, tid: int) -> None:
        """The tier's LRU dropped ``tid``: a tiered-only node loses its last
        copy and leaves the trie with its subtree."""
        node = self._tier_nodes.pop(tid, None)
        if node is None:
            return
        node.tier_id = None
        if node.page < 0 and node.key in getattr(node.parent, "children", {}):
            self._drop_subtree(node)
            del node.parent.children[node.key]

    def node_for_page(self, page: int) -> Optional[_Node]:
        """The node holding device page ``page``, None for a
        request-private page."""
        return self._page_node.get(int(page))

    def evict(self, n_pages: int) -> int:
        """Drop LRU device-resident leaf entries held only by the cache until
        ``n_pages`` pages went free (or no candidate is left); a tiered-only
        leaf frees nothing and is never a victim. Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victim = self._pop_lru_victim(
                lambda c: not c.children and c.page >= 0
                and self.allocator.refcount[c.page] == 1)
            if victim is None:
                return freed
            del victim.parent.children[victim.key]
            freed += self._drop_subtree(victim)
        return freed

    def drop_tiered(self) -> int:
        """Drop every tiered-only subtree, host copies included (call it
        before ``evict(10**6)`` to drain the cache: a tiered-only leaf
        shields its resident ancestors from leaf-first eviction). Returns
        the entries dropped."""
        dropped = 0

        def scrub(node):
            nonlocal dropped
            for key, child in list(node.children.items()):
                if child.page < 0:
                    before = self.cached_pages
                    self._drop_subtree(child)
                    dropped += before - self.cached_pages
                    del node.children[key]
                else:
                    scrub(child)

        scrub(self.root)
        return dropped

    def invalidate_pages(self, pages: Sequence[int]) -> int:
        """Drop every entry whose device page is in ``pages`` with its
        subtree (a descendant's prefix runs through the bad page): cache
        holds released, tier copies dropped. Returns the entries removed."""
        bad = {int(p) for p in pages}
        removed = 0

        def scrub(node):
            nonlocal removed
            for key, child in list(node.children.items()):
                if child.page in bad:
                    before = self.cached_pages
                    self._drop_subtree(child)
                    removed += before - self.cached_pages
                    del node.children[key]
                else:
                    scrub(child)

        scrub(self.root)
        return removed

    def invalidate_tokens(self, tokens: Sequence) -> int:
        """Drop the trie path of ``tokens`` from its first page on, subtree
        included (JAX ``paged_cache.py:623``): device holds released, tier
        copies dropped, tiered-only entries too. ``tokens`` is keyed as
        :meth:`register` keys it: an adapter-namespaced stream holds
        ``(ns, token)`` pairs (``_ns_tokens``). Returns entries removed."""
        ps = self.page_size
        if len(tokens) < ps:
            return 0
        key = tuple(t if isinstance(t, tuple) else int(t) for t in tokens[:ps])
        child = self.root.children.get(key)
        if child is None:
            return 0
        before = self.cached_pages
        self._drop_subtree(child)
        del self.root.children[key]
        return before - self.cached_pages

    def _drop_subtree(self, node) -> int:
        """Remove ``node`` and its descendants from every account: device
        holds released, tier copies dropped, marked dead. Returns the
        device pages freed."""
        freed = 0
        self.cached_pages -= 1
        if node.page >= 0:
            page = node.page
            self._set_page(node, -1)
            freed += len(self.allocator.release([page]))
        if node.tier_id is not None:
            if self.tier is not None:
                self.tier.drop(node.tier_id)
            self._tier_nodes.pop(node.tier_id, None)
        node.page = -1
        node.tier_id = None
        node.dead = True
        for child in node.children.values():
            freed += self._drop_subtree(child)
        return freed

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())


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
    pages, allocator, prefix index, the insert/retire lifecycle and the
    optional host tier. Counters (attributes): ``prefix_queries``,
    ``prefix_hits``, ``prefix_hit_tokens``, ``evicted_pages`` (entries
    dropped, spills not included), ``pages_in_use_peak`` and the tier's
    ``tier_spilled_pages``, ``tier_restored_pages``, ``tier_hits``
    (admissions that restored), ``tier_restore_failures`` and
    ``tier_repaired_pages``, and ``adopted_pages`` (pages written from a
    park record, :meth:`adopt_pages`); ``_restore_ms`` holds the wall ms of
    each restore and repair (checksum, page allocation, device write).
    :meth:`attach_observability` wires the engine's tracer and metrics into
    the cache's seams (JAX ``paged_cache.py:909``)."""

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
        self.tier_spilled_pages = 0
        self.tier_restored_pages = 0
        self.tier_hits = 0
        self.tier_restore_failures = 0
        self.tier_repaired_pages = 0
        self.adopted_pages = 0
        # host tier (enable_tier) and the device write restores go through
        self.tier: Optional[HostPageTier] = None
        self._write_page: Optional[Callable[[int, Dict[str, np.ndarray]], None]] = None
        self._restore_ms: List[float] = []
        # observability (attach_observability); None: no-ops
        self._tracer = None
        self._block_fn: Optional[Callable[[], int]] = None
        self._m_prefix = None
        self._m_restore = None
        self._m_tier_bytes = None

    # --- host tier -------------------------------------------------------

    def enable_tier(self, max_pages: int, read_page: Callable[[int], Dict[str, np.ndarray]],
                    write_page: Callable[[int, Dict[str, np.ndarray]], None]) -> None:
        """Attach a host tier of ``max_pages`` pages (JAX
        ``paged_cache.py:766``): ``read_page`` (page -> named host arrays)
        and ``write_page`` (page, arrays -> device write) are the session's
        page I/O. Needs the prefix index."""
        if self.prefix is None:
            raise ValueError("host tier requires prefix_cache=True")
        self.tier = HostPageTier(max_pages)
        self._write_page = write_page
        self.prefix.attach_tier(self.tier, read_page)

    def tier_pages(self) -> int:
        return 0 if self.tier is None else len(self.tier)

    def tier_bytes(self) -> int:
        return 0 if self.tier is None else self.tier.bytes_used()

    def _reclaim(self, n: int) -> int:
        """Free ``n`` device pages by the ladder: spill, then drop."""
        if self.prefix is None:
            return 0
        spilled = self.prefix.spill(n)
        if spilled:
            self.tier_spilled_pages += spilled
            self._note_tier("tier:spill", pages=spilled)
        dropped = 0
        if spilled < n:
            dropped = self.prefix.evict(n - spilled)
            self.evicted_pages += dropped
            self._note_evict(dropped)
        return spilled + dropped

    def _alloc_with_reclaim(self, n: int) -> Optional[List[int]]:
        """``n`` pages, reclaiming from the prefix cache on a miss; None
        only when the pool cannot cover them."""
        pages = self.allocator.alloc(n)
        if pages is None and self.prefix is not None:
            self._reclaim(n - self.allocator.available())
            pages = self.allocator.alloc(n)
        return pages

    def _restore_node(self, node) -> Optional[int]:
        """Restore a tiered entry into a fresh device page (JAX
        ``paged_cache.py:812``); the page's refcount of 1 is the cache hold.
        Returns the page, or None to shorten the prefix: no page even after
        reclaim (the entry stays tiered), or a failed or corrupt read (the
        entry's subtree is dropped and the admission re-prefills)."""
        if self.tier is None or node.tier_id is None:
            return None
        t0 = time.perf_counter()
        try:
            data = self.tier.get(node.tier_id)
        except (TierRestoreError, TierCorruption) as e:
            self.tier_restore_failures += 1
            self._note_tier("tier:corrupt", error=type(e).__name__)
            self.prefix._tier_nodes.pop(node.tier_id, None)
            node.tier_id = None
            if node.key in getattr(node.parent, "children", {}):
                self.prefix._drop_subtree(node)
                del node.parent.children[node.key]
            return None
        pages = self._alloc_with_reclaim(1)
        if pages is None:
            self._note_exhausted(1)
            return None
        self._write_page(pages[0], data)
        self.prefix._set_page(node, pages[0])
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._restore_ms.append(dt_ms)
        self.tier_restored_pages += 1
        if self._m_restore is not None:
            self._m_restore.observe(dt_ms)
        self._note_tier("tier:restore", page=pages[0], ms=round(dt_ms, 3))
        return pages[0]

    def _resolve_prefix(self, tokens: Sequence[int]) -> List[int]:
        """The cached prefix, clamped below the last prompt token: resident
        pages taken as they come, tiered ones restored as the pool affords
        (a restore that gets no page shortens the prefix). Each returned
        page carries one admission hold (released on rollback)."""
        if self.prefix is None:
            return []
        nodes = self.prefix.lookup_nodes(tokens)[: (len(tokens) - 1) // self.page_size]
        shared: List[int] = []
        tiered_used = False
        for node in nodes:
            if node.page < 0:
                if self._restore_node(node) is None:
                    break
                tiered_used = True
            self.allocator.retain([node.page])
            shared.append(node.page)
        if tiered_used:
            self.tier_hits += 1
        return shared

    def repair_page_from_tier(self, page: int) -> bool:
        """Write a corrupted device page back from its entry's inclusive
        host copy, checksum first (JAX ``paged_cache.py:877``): the subtree
        stays valid and no stream replays. False (no tier, no copy, or a
        copy that failed) sends the caller down invalidate and replay."""
        if self.tier is None or self.prefix is None:
            return False
        node = self.prefix.node_for_page(int(page))
        if node is None or node.tier_id is None:
            return False
        t0 = time.perf_counter()
        try:
            data = self.tier.get(node.tier_id)
        except (TierRestoreError, TierCorruption) as e:
            self.tier_restore_failures += 1
            self._note_tier("tier:corrupt", error=type(e).__name__)
            self.prefix._tier_nodes.pop(node.tier_id, None)
            node.tier_id = None
            return False
        self._write_page(int(page), data)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._restore_ms.append(dt_ms)
        self.tier_repaired_pages += 1
        if self._m_restore is not None:
            self._m_restore.observe(dt_ms)
        self._note_tier("tier:restore", page=int(page), repair=True, ms=round(dt_ms, 3))
        return True

    # --- observability ---------------------------------------------------

    def attach_observability(self, tracer, metrics, block_fn: Optional[Callable[[], int]] = None
                             ) -> None:
        """Wire the engine's tracer and registry into the cache's seams (JAX
        ``paged_cache.py:909``): prefix-hit lengths (``serve_prefix_hit_tokens``
        and ``prefix_hit`` instants), evictions and pool exhaustion on the
        ``("cache", "pool")`` lane, the tier's spill, restore and corrupt
        instants on ``("cache", "tier")`` with ``serve_tier_restore_ms`` and
        ``serve_tier_bytes``. ``block_fn`` stamps each instant with the
        engine's virtual block. Host side only."""
        self._tracer = tracer
        self._block_fn = block_fn
        self._m_prefix = metrics.histogram(
            "serve_prefix_hit_tokens",
            help="page-aligned prefix tokens reused per admission query", lo=1.0)
        self._m_restore = metrics.histogram(
            "serve_tier_restore_ms",
            help="host-tier page restore wall ms (checksum + alloc + copy)", lo=0.01)
        self._m_tier_bytes = metrics.gauge("serve_tier_bytes", help="host-tier KV bytes resident")

    def _block(self) -> Optional[int]:
        return None if self._block_fn is None else int(self._block_fn())

    def _traced(self) -> bool:
        return self._tracer is not None and self._tracer.enabled

    def _note_prefix(self, shared: List[int]) -> None:
        if self._m_prefix is not None:
            self._m_prefix.observe(len(shared) * self.page_size)
        if self._traced() and shared:
            self._tracer.instant("prefix_hit", ("cache", "pool"), block=self._block(),
                                 args={"tokens": len(shared) * self.page_size,
                                       "pages": len(shared)})

    def _note_evict(self, freed: int) -> None:
        if freed and self._traced():
            self._tracer.instant("evict", ("cache", "pool"), block=self._block(),
                                 args={"pages": int(freed)})

    def _note_exhausted(self, need: int) -> None:
        if self._traced():
            self._tracer.instant("pool_exhausted", ("cache", "pool"), block=self._block(),
                                 args={"need": int(need),
                                       "free": int(self.allocator.available())})

    def _note_tier(self, name: str, **args) -> None:
        if self._m_tier_bytes is not None:
            self._m_tier_bytes.set(self.tier_bytes())
        if self._traced():
            self._tracer.instant(name, ("cache", "tier"), block=self._block(),
                                 args={**args, "tier_pages": self.tier_pages()})

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
            self._note_prefix(shared)
        start = len(shared) * ps
        total = min(max(int(reserve_total), plen), self.max_seq_len)
        n_owned = -(-total // ps) - len(shared)
        owned = self._alloc_with_reclaim(n_owned)
        if owned is None:
            self.allocator.release(shared)
            self._note_exhausted(n_owned)
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

    def purge_conversation(self, slot: int, tokens: Optional[Sequence[int]] = None,
                           ns: Optional[str] = None) -> int:
        """The park path's residency scrub (JAX ``paged_cache.py:1045``):
        release the slot's holds and remove every prefix entry reachable
        through its pages or its token path (``tokens`` under adapter
        namespace ``ns``), device copies freed and host-tier copies dropped,
        so a parked conversation holds 0 device and 0 host pages. Returns the
        prefix entries removed."""
        pages = [int(p) for p in self._slot_pages.get(slot, ())]
        self.release(slot)
        removed = 0
        if self.prefix is not None:
            if pages:
                removed += self.prefix.invalidate_pages(pages)
            if tokens is not None:
                removed += self.prefix.invalidate_tokens(_ns_tokens(tokens, ns))
        return removed

    def adopt_pages(self, slot: int, tokens: Sequence[int],
                    payloads: Sequence[Dict[str, np.ndarray]],
                    write_pages: Callable[[List[int], List[Dict[str, np.ndarray]]], None],
                    reserve_total: int, ns: Optional[str] = None) -> List[int]:
        """Adopt a parked conversation's KV pages (JAX ``paged_cache.py:1067``):
        allocate the slot's whole footprint (``reserve_total`` tokens,
        reclaim first), write the payloads into the pages covering
        ``tokens`` through the engine's batched ``write_pages``, install the
        slot's table and register the fully covered pages in the prefix
        index. Raises :class:`PagePoolExhausted` with nothing allocated."""
        ps = self.page_size
        tokens = _ns_tokens(tokens, ns)
        plen = len(tokens)
        if plen < 1:
            raise ValueError("empty prompt")
        n_copy = -(-plen // ps)
        if len(payloads) != n_copy:
            raise ValueError(f"{len(payloads)} page payloads for {n_copy} prompt pages")
        total = min(max(int(reserve_total), plen), self.max_seq_len)
        n_pages = -(-total // ps)
        pages = self._alloc_with_reclaim(n_pages)
        if pages is None:
            self._note_exhausted(n_pages)
            raise PagePoolExhausted(f"adoption needs {n_pages} pages, "
                                    f"{self.allocator.available()} free")
        write_pages([int(p) for p in pages[:n_copy]], list(payloads))
        self.release(slot)
        table = np.full((self.pages_per_slot,), self.scratch[slot], np.int32)
        table[:n_pages] = pages
        self.tables[slot] = table
        self._slot_pages[slot] = [int(p) for p in pages]
        if self.prefix is not None:
            n_full = plen // ps
            if n_full:
                self.prefix.register(list(tokens)[: n_full * ps], [int(p) for p in pages[:n_full]])
        self.pages_in_use_peak = max(self.pages_in_use_peak, self.allocator.in_use())
        self.adopted_pages += n_copy
        return [int(p) for p in pages]

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
            self._note_prefix(shared)
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
            self._note_exhausted(need)
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

    def prefix_peek(self, tokens: Sequence[int], ns: Optional[str] = None) -> int:
        """Tokens of cached prefix an admission of ``tokens`` would reuse,
        tiered entries included, without admitting (no hold, no counter, no
        LRU touch); clamped below the last token as :meth:`plan` is."""
        if self.prefix is None or len(tokens) < 1:
            return 0
        hit = self.prefix.peek(_ns_tokens(tokens, ns))[: (len(tokens) - 1) // self.page_size]
        return len(hit) * self.page_size

    def live_pages(self) -> List[int]:
        """Sorted pages a live slot holds: the corruption seam's victims."""
        pages = set()
        for held in self._slot_pages.values():
            pages.update(int(p) for p in held)
        return sorted(pages)

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages.get(slot, []))

    def pages_needed(self, prompt_len: int, new_tokens: int) -> int:
        total = min(prompt_len + new_tokens, self.max_seq_len)
        return -(-total // self.page_size)

    def capacity_pages(self) -> int:
        return self.num_pages - self.max_batch
