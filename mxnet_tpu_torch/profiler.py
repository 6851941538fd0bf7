"""Dispatch counters (counterpart of `mxnet_tpu/profiler.py:154-170`).

Only the always-on dispatch telemetry is ported: the serving runtime
counts each prefill and decode step here (`serve_prefill`,
`serve_decode`, `serve_page_remap`). The counters live in the labelled
metrics registry, so `mx.observability.summary()` sees the same numbers.
Device traces come from `torch.profiler`; the JAX package's
`start`/`stop`/`dump` recorders are not ported yet.
"""
from __future__ import annotations

from .observability import registry as _registry

__all__ = ["record_dispatch", "dispatch_count"]

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
