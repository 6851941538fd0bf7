"""Dispatch counters and their text summary (counterpart of
`mxnet_tpu/profiler.py:154-285`).

The always-on dispatch telemetry is ported: the serving runtime counts
each prefill, decode step and page remap here (`serve_prefill`,
`serve_decode`, `serve_page_remap`), and `dumps()` prints those counts
and the speculative-decoding acceptance row. The counters live in the
labelled metrics registry, so `mx.observability.summary()` sees the same
numbers. Device traces come from `torch.profiler`; the JAX package's
`start`/`stop`/`dump` recorders are not ported yet.

The fused Trainer path adds its own telemetry here, as in the JAX
package: kernel-cache lookups of the bucketed update and of captured
steps (`record_jit_cache`; a miss is a new cache entry), the byte sizes
of the gradient buckets (`record_buckets`), and the replays of captured
CUDA graphs (`cudagraph_replays`, counted by `cachedop.py`).
"""
from __future__ import annotations

from .observability import registry as _registry

__all__ = ["record_dispatch", "dispatch_count", "reset_dispatches",
           "record_jit_cache", "jit_cache_stats", "record_buckets",
           "bucket_sizes", "dumps"]

_reg = _registry()
_dispatch = {}                          # site -> Counter
_jit_hit = _reg.counter("jit_cache", result="hit")
_jit_miss = _reg.counter("jit_cache", result="miss")
_buckets_gauge = _reg.gauge("fused_bucket_sizes_bytes")
_replays = _reg.counter("cudagraph_replays")


def record_dispatch(name="dispatch", n=1):
    """Count a device dispatch issued from a hot path (one prefill or
    decode step of the serving runtime)."""
    c = _dispatch.get(name)
    if c is None:
        c = _dispatch[name] = _reg.counter("dispatch", site=name)
    c.inc(n)


def dispatch_count(name=None):
    """Total dispatches recorded since the last registry reset, or the
    count for one named dispatch site."""
    if name is not None:
        c = _dispatch.get(name)
        return c.value if c is not None else 0
    return sum(c.value for c in _dispatch.values())


def reset_dispatches():
    """Zero the dispatch counters and the kernel-cache tallies as a unit
    (a dispatch window starts with a fresh cache picture)."""
    for c in _dispatch.values():
        c.reset()
    _jit_hit.reset()
    _jit_miss.reset()


def record_jit_cache(hit):
    """Tally a fused-update or captured-step cache lookup: a hit, or a
    miss (a new entry was built)."""
    (_jit_hit if hit else _jit_miss).inc()


def jit_cache_stats():
    """(hits, misses) of the fused-update and captured-step caches."""
    return (_jit_hit.value, _jit_miss.value)


def record_buckets(sizes_bytes):
    """Record the gradient byte sizes of the fused path's buckets."""
    _buckets_gauge.set([int(s) for s in sizes_bytes])


def bucket_sizes():
    return list(_buckets_gauge.value or [])


def dumps(reset=False):
    """A text summary: a `[dispatch]` row per dispatch site, the
    `[jit-cache]` hits and misses, the `[buckets]` byte sizes, the
    `[cudagraph]` replays, and a `[serve-spec]` row with the
    distribution of accepted drafts per speculative turn (a falling mean
    means more turns per committed token). `reset=True` zeroes the
    dispatch counters, the cache tallies and the bucket sizes
    afterwards."""
    lines = []
    if dispatch_count():
        lines.append(f"[dispatch] total={dispatch_count()}")
        for name in sorted(_dispatch):
            if _dispatch[name].value:
                lines.append(f"[dispatch] {name}={_dispatch[name].value}")
    hits, misses = jit_cache_stats()
    if hits or misses:
        lines.append(f"[jit-cache] hits={hits} misses={misses}")
    if bucket_sizes():
        lines.append(f"[buckets] sizes_bytes={bucket_sizes()}")
    if _replays.value:
        lines.append(f"[cudagraph] replays={_replays.value}")
    for h in _reg.series("serve_spec_accepted_tokens"):
        snap = h.snapshot()
        if snap["count"]:
            lines.append(
                f"[serve-spec] accepted/turn: n={snap['count']} "
                f"mean={snap['mean']:.3f} p95={snap['p95']:.3g} "
                f"max={snap['max']:.3g}")
    if reset:
        reset_dispatches()
        _buckets_gauge.reset()
    return "\n".join(lines)
