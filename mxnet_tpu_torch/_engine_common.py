"""Shared leaf helpers for the two dependency-engine implementations
(counterpart of `mxnet_tpu/_engine_common.py`).

`_PyEngine` (engine.py) and `NativeEngine` (_native.py) are a parity
pair: the failure-report shape, the cancelled-future tolerance of their
wait paths, and the raced-cancel guard around `set_exception` must stay
byte-identical between them. Each helper here exists so that contract is
defined ONCE instead of drifting across hand-kept copies.

Leaf module on purpose: `_native.py` must stay importable without
pulling in `engine.py` (which falls back to `_PyEngine` when the native
build fails).
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import CancelledError, InvalidStateError

FAILURE_LOG_CAP = 64


def set_exc(fut, exc):
    """`fut.set_exception(exc)` tolerating a raced external cancel."""
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


def reraise_unless_cancelled(fut):
    """Re-raise a settled future's failure. Externally cancelled ops
    drain CLEAN — both engines' wait_for_var / wait_for_all contract."""
    if fut.cancelled():
        return
    try:
        fut.result()
    except CancelledError:
        pass


def failure_site(fn, fallback=None):
    """Name the USER dispatch site of a pushed fn: the facade stamps
    `_mxtpu_site` on its wrapper so instance logs show `io.task`, not
    `engine._task`; direct pushes fall back to the fn's own name (or a
    caller-supplied resolver)."""
    site = getattr(fn, "_mxtpu_site", None)
    if site:
        return site
    if fallback is not None:
        return fallback(fn)
    return getattr(fn, "__qualname__", None) or type(fn).__name__


class FailureLog:
    """Sticky, bounded, thread-safe record of root-cause task failures
    (site + repr + wall time, newest last). Root causes only: dependency
    re-raises are recorded once at the source; cancelled / shed /
    expired tasks never run fn, so they appear nowhere."""

    __slots__ = ("_dq", "_lock")

    def __init__(self, cap=FAILURE_LOG_CAP):
        self._dq = collections.deque(maxlen=cap)
        self._lock = threading.Lock()

    def record(self, site, exc):
        with self._lock:
            self._dq.append({"site": site, "error": repr(exc),
                             "time": time.time()})

    def list(self):
        with self._lock:
            return list(self._dq)

    def clear(self):
        with self._lock:
            self._dq.clear()
