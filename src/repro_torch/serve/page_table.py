"""Paged KV-cache bookkeeping: global page pool + per-request page tables.

A copy of ``pages_needed``, ``PagePool``, ``PageTable``, ``PrefixCache``,
``page_checksums`` and ``PageSnapshot`` from ``repro.serve.page_table``
(pure Python but for the snapshot's host tensors; the port keeps its own
copy so that it never imports ``repro``).  The serving engine's paged mode keeps a global
pool of ``page_size``-token pages instead of a dense per-slot ``max_seq``
cache: page ownership, allocation and the (num_slots, max_pages) int32
indirection table the paged kernels dereference live here; the engine owns
the page tensors.  Page 0 (more generally, the first ``reserved`` pages) is
never allocated: idle batch rows point their table entries at it, so their
decode writes land in a scratch page instead of a live request's memory.
Pages are refcounted so that the prefix cache can map one physical page
into many tables: :class:`PrefixCache` hash-chains full ``page_size``-token
prompt blocks to the physical page that holds their K/V and holds one
reference of its own per cached page.  A page whose count drops to that one
reference stays cached, unreferenced, until :meth:`PrefixCache.evict`
reclaims it; any write into a page someone else still references is
copy-on-write in the engine.

A :class:`PageSnapshot` is a request's in-flight KV state as a transferable
artifact (live KV migration): the exact stored bytes of its pages as host
tensors, the tokens it emitted, and one CRC32 a page that a restore checks
before it serves a byte of it.
"""
from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PagePool", "PageSnapshot", "PageTable", "PrefixCache", "page_checksums",
           "pages_needed"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` tokens (ceil division)."""
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    return max((tokens + page_size - 1) // page_size, 0)


def _page_rows(t: torch.Tensor) -> np.ndarray:
    """A snapshot tensor ``(L, n, ...)`` as one host ``uint8`` row a page,
    the page's bytes in the order the reference hashes them (layer by
    layer).  bf16 and fp8 have no numpy dtype, so they are hashed as they
    lie in memory, never through ``.numpy()``.  A tensor stored page-major
    (as the engine stores its snapshots) is read in place."""
    rows = t.detach().transpose(0, 1).contiguous().view(torch.uint8).cpu().numpy()
    return rows.reshape(rows.shape[0], -1)


def page_checksums(k: torch.Tensor, v: torch.Tensor, k_scales: Optional[torch.Tensor] = None,
                   v_scales: Optional[torch.Tensor] = None) -> List[int]:
    """CRC32 per page over the exact stored bytes: K then V (then the scale
    rows of a quantized pool), all layers of one page chained into one word,
    over snapshot tensors shaped ``(L, n, page_size, ...)`` (page axis 1).
    A quantized pool checksums its int8/fp8 codes and float32 scales, never
    a dequantized view.  Equal bytes give the reference's checksums.  Pages
    are hashed in threads (``zlib`` releases the GIL on large buffers)."""
    rows = [_page_rows(t) for t in (k, v, k_scales, v_scales) if t is not None]

    def crc(j: int) -> int:
        c = 0
        for r in rows:
            c = zlib.crc32(r[j], c)
        return c & 0xFFFFFFFF

    n = int(k.shape[1])
    if n < 2:
        return [crc(j) for j in range(n)]
    with ThreadPoolExecutor(max_workers=min(n, 8)) as ex:
        return list(ex.map(crc, range(n)))


@dataclass
class PageSnapshot:
    """A request's in-flight KV state: its pages' stored bytes
    (``ops.export_pages``, copied to host tensors in the pool's dtype:
    float32, bf16, or int8/fp8 codes with float32 scales), the length and
    tokens a restore resumes from, and a per-page checksum ledger.

    ``length`` counts the KV positions the pages hold (the engine's
    ``lengths[slot]`` at the checkpoint: the prompt and every emitted token
    but the latest, ``tokens[-1]``, whose K/V the next step appends).  A
    restore scatters the pages into fresh pages of the destination pool,
    rebuilds the slot from ``tokens``/``length`` and decodes on, as an
    undisturbed run would, because the pages are the exact stored bytes."""

    request_id: int
    prompt_len: int
    length: int                 # KV positions held by the pages
    tokens: np.ndarray          # emitted tokens so far (np.int32)
    k: torch.Tensor             # (L, n, page_size, kvh, d) page bytes, on the host
    v: torch.Tensor
    k_scales: Optional[torch.Tensor] = None   # (L, n, page_size, kvh) float32
    v_scales: Optional[torch.Tensor] = None
    checksums: List[int] = field(default_factory=list)
    step: int = 0               # engine decode step of the checkpoint
    kv_dtype: str = "float32"

    @property
    def num_pages(self) -> int:
        return int(self.k.shape[1])

    @property
    def nbytes(self) -> int:
        """Bytes a migration of this snapshot moves (pages and scales)."""
        tensors = [self.k, self.v] + ([self.k_scales, self.v_scales]
                                      if self.k_scales is not None else [])
        return sum(t.numel() * t.element_size() for t in tensors)

    def verify(self) -> bool:
        """Recompute the per-page checksums against the ledger: a mismatch
        means the bytes changed between checkpoint and restore, and the
        request must replay from its prompt."""
        return page_checksums(self.k, self.v, self.k_scales, self.v_scales) == self.checksums

    def corrupt(self, page: int = 0) -> None:
        """Flip every byte of one page of K, leaving the checksum ledger as
        it is (the ``corrupt@W:S`` fault).  The flip goes into a copy, so a
        tensor that another holder (or a pool) shares is never written."""
        k = self.k.clone()
        k.view(torch.uint8)[:, page] ^= 0xFF
        self.k = k


class PagePool:
    """Free-list allocator over the global KV page pool, with per-page
    refcounts so prefix caching can share one physical page across many
    requests (and the cache itself)."""

    def __init__(self, num_pages: int, page_size: int, reserved: int = 1) -> None:
        if num_pages <= reserved:
            raise ValueError(
                f"num_pages {num_pages} must exceed reserved scratch pages {reserved}"
            )
        self.num_pages = num_pages
        self.page_size = page_size
        self.reserved = reserved
        # pop() hands out low page ids first
        self._free: List[int] = list(range(num_pages - 1, reserved - 1, -1))
        self._ref: Dict[int, int] = {}      # page -> reference count (>= 1)
        self.peak_in_use = 0
        self.allocs = 0
        self.frees = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the reserved scratch pages)."""
        return self.num_pages - self.reserved

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def num_shared(self) -> int:
        """Pages referenced more than once (mapped by several requests, or
        by a request and the prefix cache) — the pages admission must count
        once globally rather than per request."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, page: int) -> int:
        """Current reference count of ``page`` (0 when free)."""
        return self._ref.get(page, 0)

    def pages_needed(self, tokens: int) -> int:
        return pages_needed(tokens, self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages atomically (each at refcount 1); None when
        the pool can't supply all of them (the caller then evicts cached
        pages, queues, or preempts)."""
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        return pages

    def incref(self, pages: List[int]) -> None:
        """Add one reference per page (a request mapping cached pages into
        its table, or the prefix cache registering a page)."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"page {p} is not allocated (incref on free page)")
            self._ref[p] += 1

    def free(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; pages whose count reaches zero go
        back to the free list.  Returns the pages actually released (shared
        pages survive their other holders).  Freeing an unallocated page —
        or more times than it was referenced — raises (double-free guard).
        """
        released: List[int] = []
        for p in pages:
            c = self._ref.get(p, 0)
            if c <= 0:
                raise ValueError(f"page {p} is not allocated (double free?)")
            if c == 1:
                del self._ref[p]
                self._free.append(p)
                self.frees += 1
                released.append(p)
            else:
                self._ref[p] = c - 1
        return released


class PageTable:
    """(num_slots, max_pages) indirection table mapping a slot's logical page
    index to its physical page id.  Unassigned entries stay at the scratch
    page (0) so every row is always safe to hand to the paged kernel."""

    def __init__(self, num_slots: int, max_pages: int, scratch_page: int = 0) -> None:
        if num_slots < 1 or max_pages < 1:
            raise ValueError("num_slots and max_pages must be >= 1")
        self.max_pages = max_pages
        self.scratch_page = scratch_page
        self.table = np.full((num_slots, max_pages), scratch_page, np.int32)
        self._pages: Dict[int, List[int]] = {}

    def pages_of(self, slot: int) -> List[int]:
        return list(self._pages.get(slot, []))

    def num_pages_of(self, slot: int) -> int:
        return len(self._pages.get(slot, []))

    def assign(self, slot: int, pages: List[int]) -> None:
        """Give ``slot`` a fresh run of pages (admission)."""
        if slot in self._pages:
            raise ValueError(f"slot {slot} already holds pages")
        if len(pages) > self.max_pages:
            raise ValueError(f"{len(pages)} pages > max_pages {self.max_pages}")
        self.table[slot, :] = self.scratch_page
        self.table[slot, : len(pages)] = pages
        self._pages[slot] = list(pages)

    def append(self, slot: int, page: int) -> None:
        """Grow ``slot`` by one page (decode crossing a page boundary)."""
        held = self._pages.setdefault(slot, [])
        if len(held) >= self.max_pages:
            raise ValueError(f"slot {slot} already holds max_pages pages")
        self.table[slot, len(held)] = page
        held.append(page)

    def replace(self, slot: int, index: int, page: int) -> int:
        """Swap the physical page behind logical page ``index`` (copy-on-
        write: the slot is about to append into a shared page, so it remaps
        that logical page to a private copy).  Returns the old physical
        page so the caller can drop its reference."""
        held = self._pages.get(slot, [])
        if not 0 <= index < len(held):
            raise ValueError(f"slot {slot} holds no logical page {index}")
        old = held[index]
        held[index] = page
        self.table[slot, index] = page
        return old

    def truncate(self, slot: int, keep: int) -> List[int]:
        """Drop every page past the first ``keep`` (speculative-decoding
        rollback: a rejected draft suffix may have opened a fresh page past
        the committed length).  Returns the freed pages so the caller can
        hand them back to the pool."""
        if keep < 0:
            raise ValueError("cannot keep a negative page count")
        held = self._pages.get(slot, [])
        if keep >= len(held):
            return []
        freed = held[keep:]
        del held[keep:]
        self.table[slot, keep:] = self.scratch_page
        return freed

    def clear(self, slot: int) -> List[int]:
        """Drop the slot's mapping (completion/preemption); returns the pages
        so the caller can return them to the pool."""
        pages = self._pages.pop(slot, [])
        self.table[slot, :] = self.scratch_page
        return pages

    def rows_for(self, mask: np.ndarray) -> np.ndarray:
        """Table snapshot with non-``mask`` rows pointed at the scratch page
        (idle/prefilling rows must not let the batched decode write into
        their live pages)."""
        return np.where(mask[:, None], self.table, np.int32(self.scratch_page))


class _CacheEntry:
    """One cached full prompt page: the physical page holding the K/V of a
    ``page_size``-token block reached through a specific prefix chain."""

    __slots__ = ("page", "parent", "children", "last_use")

    def __init__(self, page: int, parent: Optional[tuple], last_use: int) -> None:
        self.page = page
        self.parent = parent        # key of the previous block in the chain
        self.children = 0           # cached blocks extending this prefix
        self.last_use = last_use


class PrefixCache:
    """Automatic prefix cache: hash chain of full prompt pages -> physical
    page ids, sharing committed K/V across requests.

    Keys chain ``(parent_key, token_block_bytes)``, so two prompts share
    page ``i`` iff their first ``(i + 1) * page_size`` tokens are equal.
    The cache holds ONE pool reference per cached page: a page shared by
    the cache and ``r`` requests has refcount ``r + 1``, and at refcount 1
    it is cached but unreferenced until :meth:`evict` reclaims it.
    Eviction goes leaf first in LRU order and never frees a referenced
    page (requests map a cached run from block 0, so a referenced child
    implies a referenced parent).  Only full prompt pages are cached."""

    def __init__(self, pool: PagePool) -> None:
        self.pool = pool
        self._entries: Dict[tuple, _CacheEntry] = {}
        self._tick = 0
        # counters (surface through stats() -> PagedStats.prefix_stats)
        self.lookups = 0
        self.hits = 0
        self.full_hits = 0
        self.hit_pages = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.evicted_pages = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def evictable(self) -> int:
        """Cached pages reclaimable on demand (refcount 1: no request maps
        them); leaf-first eviction reaches every one of them."""
        return sum(1 for e in self._entries.values() if self.pool.refcount(e.page) == 1)

    def _blocks(self, prompt: np.ndarray):
        ps = self.pool.page_size
        toks = np.asarray(prompt, np.int32)
        for i in range(len(toks) // ps):
            yield toks[i * ps : (i + 1) * ps].tobytes()

    def match(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of ``prompt``: its physical
        pages (block 0 first) and the tokens they cover.  Bumps recency but
        counts nothing: an admission probe (a queued request is probed every
        boundary); :meth:`record` counts the request once it enters."""
        self._tick += 1
        pages: List[int] = []
        parent: Optional[tuple] = None
        for blk in self._blocks(prompt):
            key = (parent, blk)
            e = self._entries.get(key)
            if e is None:
                break
            e.last_use = self._tick
            pages.append(e.page)
            parent = key
        return pages, len(pages) * self.pool.page_size

    def record(self, prompt_tokens: int, pages: List[int]) -> None:
        """Count one admitted request's lookup outcome."""
        self.lookups += 1
        if pages:
            cached = len(pages) * self.pool.page_size
            self.hits += 1
            self.hit_pages += len(pages)
            self.hit_tokens += cached
            if cached >= prompt_tokens:
                self.full_hits += 1

    def lookup(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """:meth:`match` and :meth:`record` in one call."""
        pages, cached = self.match(prompt)
        self.record(len(np.asarray(prompt)), pages)
        return pages, cached

    def insert(self, prompt: np.ndarray, slot_pages: List[int]) -> int:
        """Register a just-prefilled request's full prompt pages.  A block
        already cached (under any page) is left alone: the first writer
        wins and the newcomer keeps its private copy.  Each newly cached
        page gains the cache's own reference.  Returns the pages added."""
        self._tick += 1
        parent: Optional[tuple] = None
        added = 0
        for i, blk in enumerate(self._blocks(prompt)):
            key = (parent, blk)
            e = self._entries.get(key)
            if e is None:
                page = slot_pages[i]
                self.pool.incref([page])
                e = _CacheEntry(page, parent, self._tick)
                self._entries[key] = e
                if parent is not None:
                    self._entries[parent].children += 1
                added += 1
            else:
                e.last_use = self._tick
            parent = key
        self.inserts += added
        return added

    def evict(self, need: int) -> int:
        """Reclaim up to ``need`` cached-but-unreferenced pages (back to the
        pool's free list), least recently used leaves first.  Returns the
        pages freed."""
        freed = 0
        while freed < need:
            # one LRU-sorted pass over the unreferenced tier; evicting a leaf
            # exposes its parent, which may sort earlier: repeat until dry
            candidates = sorted(
                ((key, e) for key, e in self._entries.items()
                 if self.pool.refcount(e.page) == 1),
                key=lambda kv: kv[1].last_use,
            )
            progressed = False
            for key, e in candidates:
                if freed >= need:
                    break
                if e.children:
                    continue
                del self._entries[key]
                if e.parent is not None:
                    self._entries[e.parent].children -= 1
                self.pool.free([e.page])
                freed += 1
                progressed = True
            if not progressed:
                break
        self.evicted_pages += freed
        return freed

    def stats(self) -> Dict[str, float]:
        """Scalar summary of the cache over one run."""
        return {
            "lookups": float(self.lookups),
            "hits": float(self.hits),
            "full_hits": float(self.full_hits),
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "hit_pages": float(self.hit_pages),
            "hit_tokens": float(self.hit_tokens),
            "inserts": float(self.inserts),
            "evicted_pages": float(self.evicted_pages),
            "cached_pages": float(len(self._entries)),
            "unreferenced_pages": float(self.evictable),
        }
