"""Paged KV-cache allocator (host-side copy of
`mxnet_tpu/serve/kv_pages.py`; reference capability: vLLM-style block
tables, arXiv:2604.15464's page pools). Pages are reference counted so
the prefix cache can share them across requests.

The device-side KV store is a FIXED pool of pages — per decoder layer a
`(num_pages, page_size, H, dh)` K array and V array that never change
shape (`serve.decode.DecodeRuntime` holds them on the card). This module
owns the HOST side: which page ids are free, which belong to which
request, and the accounting that proves no request ever leaks device
memory.

Conventions:

  * page id 0 is the RESERVED null page: never allocated, absorbs the
    writes of inactive decode slots and the reads of unused page-table
    entries (tables are padded with 0), so the decode step needs no
    branches on slot occupancy. Usable capacity is therefore
    ``num_pages - 1``.
  * `alloc` is all-or-nothing: a request that needs k pages either gets
    all k or `PageAllocError` (the scheduler turns that into admission
    backpressure / preemption) — no partial grants to roll back.
  * pages are REFCOUNTED: `alloc` hands a page out at refcount 1,
    `share` adds an owner, `free` removes one — the page returns to the
    free list only when its LAST owner releases it. A request that
    adopts another request's cached prefix pages therefore never copies
    them, and the leak gauge stays exact: `kv_pages_in_use` counts pages
    with refcount >= 1.
  * `free` is atomic like `alloc`: the WHOLE page list is validated
    (null page, double free, over-release) BEFORE any accounting
    mutates, so a bad list leaves the pool untouched instead of
    half-freed.
  * `defrag()` renumbers live pages down into the low indices and returns
    the old->new mapping; the caller (serve.scheduler) applies the same
    permutation to the device pools, page tables AND the prefix cache's
    node index. Useful when a long-running server wants to shrink its
    pool watermark.

Accounting rides the metrics registry: `kv_pages_in_use` (gauge, MUST
return to 0 after every request completes AND the prefix cache is
cleared), `kv_page_refs` (gauge: total outstanding references across
all pages), `kv_page_allocs` / `kv_page_shares` / `kv_page_frees` /
`kv_page_alloc_failures` counters and `kv_pool_defrags`. `page_bytes`
(passed by the Server from `serve.quant.kv_page_bytes`) records what
one page costs in device memory (`kv_pool_bytes`).
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from ..observability import registry as _obs_registry

__all__ = ["PagePool", "PageAllocError", "NULL_PAGE"]

NULL_PAGE = 0


class PageAllocError(MXNetError):
    """The pool cannot serve the requested number of pages."""


class PagePool:
    """Host-side refcounted page allocator over a fixed device page pool."""

    def __init__(self, num_pages, page_size, registry=None,
                 page_bytes=None):
        if num_pages < 2:
            raise MXNetError("PagePool needs num_pages >= 2 (page 0 is "
                             "the reserved null page)")
        if page_size < 1:
            raise MXNetError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # device bytes one page costs (the Server passes the
        # runtime's dtype-aware figure) — None
        # when the caller doesn't account bytes
        self.page_bytes = None if page_bytes is None else int(page_bytes)
        self._lock = threading.Lock()
        # LIFO free stack: hot pages get reused while still cache/TLB warm
        self._free = list(range(self.num_pages - 1, NULL_PAGE, -1))
        self._refs = {}                 # page id -> owner count (>= 1)
        reg = registry if registry is not None else _obs_registry()
        reg.gauge("kv_pages_total").set(self.capacity)
        if self.page_bytes is not None:
            reg.gauge("kv_pool_bytes").set(
                self.num_pages * self.page_bytes)
        self._in_use_gauge = reg.gauge("kv_pages_in_use")
        self._in_use_gauge.set(0)
        self._refs_gauge = reg.gauge("kv_page_refs")
        self._refs_gauge.set(0)
        self._allocs = reg.counter("kv_page_allocs")
        self._shares = reg.counter("kv_page_shares")
        self._frees = reg.counter("kv_page_frees")
        self._failures = reg.counter("kv_page_alloc_failures")
        self._defrags = reg.counter("kv_pool_defrags")

    # ------------------------------------------------------------- info
    @property
    def capacity(self):
        """Usable pages (the null page is not allocatable)."""
        return self.num_pages - 1

    def available(self):
        with self._lock:
            return len(self._free)

    def in_use(self):
        """Pages with at least one owner (the leak gauge)."""
        with self._lock:
            return len(self._refs)

    def ref_count(self, page):
        """Outstanding owners of `page` (0 = free)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    def total_refs(self):
        """Sum of refcounts across all live pages (== `kv_page_refs`)."""
        with self._lock:
            return sum(self._refs.values())

    def pages_for(self, tokens):
        """Pages needed to cache `tokens` positions."""
        return max(1, -(-int(tokens) // self.page_size))

    # ------------------------------------------------------------ alloc
    def alloc(self, n=1):
        """Allocate `n` pages atomically at refcount 1; returns the
        page-id list. Raises `PageAllocError` (and counts
        `kv_page_alloc_failures`) when fewer than `n` pages are free —
        nothing is granted."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                self._failures.inc()
                raise PageAllocError(
                    f"page pool exhausted: want {n}, "
                    f"{len(self._free)}/{self.capacity} free")
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self._allocs.inc(n)
            self._publish_locked()
        return pages

    def share(self, pages):
        """Add one owner to each page (cross-request prefix adoption /
        the cache's own hold). Atomic: the whole list is validated before
        any refcount moves — sharing a free or null page is an error and
        grants nothing."""
        want = [int(p) for p in pages]
        with self._lock:
            for p in want:
                if p == NULL_PAGE:
                    raise MXNetError("cannot share the reserved null page")
                if p not in self._refs:
                    raise MXNetError(f"cannot share free page {p}")
            for p in want:
                self._refs[p] += 1
            self._shares.inc(len(want))
            self._publish_locked()

    def free(self, pages):
        """Release ONE reference per listed page; a page returns to the
        free list when its last owner releases it. Atomic: the whole
        list (including duplicates within it) is validated against the
        current refcounts BEFORE any accounting mutates — a double-free
        mid-list can no longer leave earlier pages already freed and the
        leak accounting corrupted."""
        want = [int(p) for p in pages]
        with self._lock:
            need = {}
            for p in want:
                if p == NULL_PAGE:
                    raise MXNetError("cannot free the reserved null page")
                need[p] = need.get(p, 0) + 1
            for p, k in need.items():
                have = self._refs.get(p, 0)
                if k > have:
                    raise MXNetError(
                        f"double free of page {p} ({k} release(s) for "
                        f"{have} outstanding reference(s)); nothing was "
                        f"freed")
            for p, k in need.items():
                left = self._refs[p] - k
                if left:
                    self._refs[p] = left
                else:
                    del self._refs[p]
                    self._free.append(p)
            self._frees.inc(len(want))
            self._publish_locked()

    # ----------------------------------------------------------- defrag
    def defrag(self):
        """Compact live pages into the lowest ids. Returns {old: new} for
        every page that moved (possibly empty); the caller must apply the
        same renumbering to its device pools, page tables and prefix
        cache BEFORE the next decode step. Refcounts ride along with
        their pages. Counts `kv_pool_defrags`."""
        with self._lock:
            live = sorted(self._refs)
            mapping = {}
            for new_id, old_id in enumerate(live, start=NULL_PAGE + 1):
                if old_id != new_id:
                    mapping[old_id] = new_id
            if mapping:
                self._refs = {mapping.get(p, p): c
                              for p, c in self._refs.items()}
                self._free = list(range(self.num_pages - 1,
                                        NULL_PAGE + len(live), -1))
            self._defrags.inc()
            return mapping

    # -------------------------------------------------------- internals
    def _publish_locked(self):
        self._in_use_gauge.set(len(self._refs))
        self._refs_gauge.set(sum(self._refs.values()))
