"""Content-hashed radix prefix index over the paged KV cache.

Real serving traffic is dominated by shared decoder-side prefixes
(system prompts, few-shot templates): two requests whose source AND
prompt prefix match produce IDENTICAL decoder K/V for those positions,
so the second request can adopt the first one's pages instead of
re-prefilling them. This module is the host-side index that makes the
match: a radix tree keyed first by a content hash of the encoder source
(cross-attention makes every decoder position depend on the source, so
pages are only shareable under the same source), then by one
page-size-sized chunk of the decoder token sequence (``[BOS] + prompt``)
per tree level. Each node owns exactly one page.

Sharing mechanics (see `kv_pages.PagePool`):

  * the cache holds its OWN reference on every indexed page, taken at
    `insert` time — a request completing drops only its reference, so
    the page stays resident for future adopters;
  * `lookup` returns the longest cached chain of FULL pages; the
    scheduler `share()`s them for the adopting request. Adopted pages
    are never written: sharing is page-aligned, so the adopter's first
    write lands in a fresh private page;
  * under page pressure the scheduler asks `evict()` to drop
    least-recently-used leaves whose only owner is the cache itself
    (pool refcount 1) — pages some in-flight request adopted are never
    evicted, and interior nodes only become evictable once their
    subtree is gone (children always pin their ancestors through the
    adopters' references or their own cache entries).

Telemetry: `serve_prefix_hits` / `serve_prefix_misses` /
`serve_prefix_tokens_saved` / `serve_prefix_evictions` counters and the
`serve_prefix_pages` gauge (pages the cache currently holds).
"""
from __future__ import annotations

import hashlib
import threading

from ..observability import registry as _obs_registry

__all__ = ["PrefixCache", "content_key"]


def content_key(tokens):
    """Stable content hash of a token sequence (the per-source radix
    root key). Collision-safe for any practical vocabulary: blake2b over
    the canonical int repr."""
    h = hashlib.blake2b(digest_size=16)
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "stamp",
                 "root_key")

    def __init__(self, chunk, page, parent, root_key):
        self.chunk = chunk          # tuple of page_size token ids
        self.page = int(page)
        self.parent = parent        # _Node, or None for root-level nodes
        self.children = {}          # chunk tuple -> _Node
        self.stamp = 0              # logical LRU clock at last touch
        self.root_key = root_key    # owning source hash (root pruning)


class PrefixCache:
    """Radix/trie index of cached full prompt pages, one tree per source
    hash. All methods are thread-safe, though in practice the scheduler
    serialises access under its step lock."""

    def __init__(self, pool, registry=None):
        self._pool = pool
        self._lock = threading.Lock()
        self._roots = {}            # src key -> {chunk: _Node}
        self._nodes = []            # every live node (eviction scan)
        self._clock = 0
        reg = registry if registry is not None else _obs_registry()
        self._m_hits = reg.counter("serve_prefix_hits")
        self._m_misses = reg.counter("serve_prefix_misses")
        self._m_saved = reg.counter("serve_prefix_tokens_saved")
        self._m_evict = reg.counter("serve_prefix_evictions")
        self._m_pages = reg.gauge("serve_prefix_pages")
        self._m_pages.set(0)
        # per-instance tallies (the registry counters are process-global;
        # bench/tests read these for per-server rates)
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evictions = 0

    # ------------------------------------------------------------- info
    def pages_held(self):
        """Pages the cache itself holds a reference on."""
        with self._lock:
            return len(self._nodes)

    # ----------------------------------------------------------- lookup
    def lookup(self, src_key, seq, max_pages):
        """Longest cached page chain matching the head of `seq` (the
        decoder token sequence, ``[BOS] + prompt``) under `src_key`, at
        most `max_pages` deep. Returns the page-id list (possibly
        empty). Counts a hit (+ tokens saved) or a miss; the CALLER must
        `pool.share()` the returned pages before using them."""
        psize = self._pool.page_size
        pages = []
        with self._lock:
            self._clock += 1
            level = self._roots.get(src_key)
            while level is not None and len(pages) < max_pages:
                chunk = tuple(int(t) for t in
                              seq[len(pages) * psize:(len(pages) + 1)
                                  * psize])
                if len(chunk) < psize:
                    break
                node = level.get(chunk)
                if node is None:
                    break
                node.stamp = self._clock
                pages.append(node.page)
                level = node.children
        if pages:
            self.hits += 1
            self._m_hits.inc()
            saved = len(pages) * psize
            self.tokens_saved += saved
            self._m_saved.inc(saved)
        else:
            self.misses += 1
            self._m_misses.inc()
        return pages

    def peek(self, src_key, seq, max_pages):
        """Length in PAGES of the cached chain matching the head of
        `seq` — no metrics, no LRU touch. The scheduler's cache-aware
        admission policy probes queued requests with this when pages are
        tight (warm requests admit at a smaller fresh-page cost)."""
        psize = self._pool.page_size
        n = 0
        with self._lock:
            level = self._roots.get(src_key)
            while level is not None and n < max_pages:
                chunk = tuple(int(t) for t in
                              seq[n * psize:(n + 1) * psize])
                if len(chunk) < psize:
                    break
                node = level.get(chunk)
                if node is None:
                    break
                n += 1
                level = node.children
        return n

    # ----------------------------------------------------------- insert
    def insert(self, src_key, seq, pages):
        """Index `pages[i]` as holding the K/V of `seq`'s i-th full
        page-size chunk under `src_key`. Chunks already present keep
        their existing page (the duplicate page stays privately owned by
        the inserting request and is freed with it); each NEW node takes
        the cache's own `pool.share()` reference. Returns the number of
        nodes added."""
        psize = self._pool.page_size
        added = 0
        with self._lock:
            self._clock += 1
            level = self._roots.setdefault(src_key, {})
            parent = None
            for i, page in enumerate(pages):
                chunk = tuple(int(t) for t in seq[i * psize:(i + 1) * psize])
                if len(chunk) < psize:
                    break               # only FULL pages are shareable
                node = level.get(chunk)
                if node is None:
                    self._pool.share([page])
                    node = _Node(chunk, page, parent, src_key)
                    level[chunk] = node
                    self._nodes.append(node)
                    added += 1
                node.stamp = self._clock
                parent = node
                level = node.children
            if added:
                self._m_pages.set(len(self._nodes))
        return added

    # --------------------------------------------------------- eviction
    def evict(self, need=1):
        """Free least-recently-used cache-only pages until `need` pages
        have returned to the pool (or nothing evictable remains). A node
        is evictable when it has no children AND the cache holds the
        page's only reference (pool refcount 1 — nothing in flight
        adopted it). Returns the number of pages freed."""
        freed = 0
        with self._lock:
            while freed < need:
                victim = None
                for node in self._nodes:
                    if node.children:
                        continue
                    if self._pool.ref_count(node.page) != 1:
                        continue
                    if victim is None or node.stamp < victim.stamp:
                        victim = node
                if victim is None:
                    break
                self._detach_locked(victim)
                self._pool.free([victim.page])
                freed += 1
                self.evictions += 1
                self._m_evict.inc()
            self._m_pages.set(len(self._nodes))
        return freed

    def clear(self):
        """Drop the whole index and release every cache-held reference
        (server shutdown, or a decode-executable failure that made page
        CONTENTS untrustworthy). Returns the number of pages released."""
        with self._lock:
            nodes, self._nodes = self._nodes, []
            self._roots = {}
            for node in nodes:
                self._pool.free([node.page])
            self._m_pages.set(0)
            return len(nodes)

    # ----------------------------------------------------------- defrag
    def remap(self, mapping):
        """Apply a `PagePool.defrag()` renumbering to the indexed page
        ids (the scheduler calls this alongside the device remap)."""
        if not mapping:
            return
        with self._lock:
            for node in self._nodes:
                node.page = mapping.get(node.page, node.page)

    # -------------------------------------------------------- internals
    def _detach_locked(self, node):
        self._nodes.remove(node)
        if node.parent is not None:
            siblings = node.parent.children
            if siblings.get(node.chunk) is node:
                del siblings[node.chunk]
            return
        # root-level node: drop the entry, and prune the per-source
        # root dict itself once its tree is empty — a long-running
        # server over millions of distinct sources must not accumulate
        # dead root entries
        level = self._roots.get(node.root_key)
        if level is not None and level.get(node.chunk) is node:
            del level[node.chunk]
            if not level:
                del self._roots[node.root_key]
