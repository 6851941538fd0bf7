"""Dispatch counters and their text summary (counterpart of
`mxnet_tpu/profiler.py:154-285`).

The always-on dispatch telemetry is ported: the serving runtime counts
each prefill, decode step and page remap here (`serve_prefill`,
`serve_decode`, `serve_page_remap`), and `dumps()` prints those counts
and the speculative-decoding acceptance row. The counters live in the
labelled metrics registry, so `mx.observability.summary()` sees the same
numbers. Device traces come from `torch.profiler`; the JAX package's
`start`/`stop`/`dump` recorders are not ported yet.
"""
from __future__ import annotations

from .observability import registry as _registry

__all__ = ["record_dispatch", "dispatch_count", "reset_dispatches",
           "dumps"]

_reg = _registry()
_dispatch = {}                          # site -> Counter


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
    """Zero the dispatch counters."""
    for c in _dispatch.values():
        c.reset()


def dumps(reset=False):
    """A text summary: a `[dispatch]` row per dispatch site and a
    `[serve-spec]` row with the distribution of accepted drafts per
    speculative turn (a falling mean means more turns per committed
    token). `reset=True` zeroes the dispatch counters afterwards."""
    lines = []
    if dispatch_count():
        lines.append(f"[dispatch] total={dispatch_count()}")
        for name in sorted(_dispatch):
            if _dispatch[name].value:
                lines.append(f"[dispatch] {name}={_dispatch[name].value}")
    for h in _reg.series("serve_spec_accepted_tokens"):
        snap = h.snapshot()
        if snap["count"]:
            lines.append(
                f"[serve-spec] accepted/turn: n={snap['count']} "
                f"mean={snap['mean']:.3f} p95={snap['p95']:.3g} "
                f"max={snap['max']:.3g}")
    if reset:
        reset_dispatches()
    return "\n".join(lines)
