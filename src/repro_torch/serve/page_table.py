"""Paged KV-cache bookkeeping: global page pool + per-request page tables.

A copy of ``pages_needed``, ``PagePool`` and ``PageTable`` from
``repro.serve.page_table`` (pure Python; the port keeps its own copy so that
it never imports ``repro``).  The serving engine's paged mode keeps a global
pool of ``page_size``-token pages instead of a dense per-slot ``max_seq``
cache: page ownership, allocation and the (num_slots, max_pages) int32
indirection table the paged kernels dereference live here; the engine owns
the page tensors.  Page 0 (more generally, the first ``reserved`` pages) is
never allocated: idle batch rows point their table entries at it, so their
decode writes land in a scratch page instead of a live request's memory.
Pages are refcounted so that a later prefix cache can map one physical page
into many tables.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["PagePool", "PageTable", "pages_needed"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` tokens (ceil division)."""
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    return max((tokens + page_size - 1) // page_size, 0)


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
