"""Preemption: SIGTERM -> emergency callbacks -> cooperative stop
(counterpart of `mxnet_tpu/fault/preemption.py`).

Spot and maintenance preemptions deliver SIGTERM with a grace window.
The handler runs the registered emergency callbacks (the
`CheckpointManager`'s emergency save registers itself through
`on_preemption`) inside the handler: Python delivers signals on the main
thread at a bytecode boundary, between two training steps' host code,
so a synchronous checkpoint save is safe there. Then it sets a sticky
flag; training loops poll `check_preempted()` (once a step) and unwind
through `Preempted`.

The ``preempt.sigterm`` fault point (action ``sigterm``) delivers a real
SIGTERM to this process, so the path runs without a real preemption.
"""
from __future__ import annotations

import signal
import threading
import traceback

from ..base import MXNetError
from ..observability import registry as _obs_registry

__all__ = ["Preempted", "install_preemption_handler",
           "uninstall_preemption_handler", "on_preemption",
           "remove_on_preemption", "preempted", "check_preempted",
           "reset_preemption"]

_reg = _obs_registry()
_preempt_counter = _reg.counter("preemptions")

# RLock: the handler runs ON the main thread and may interrupt one of
# this module's own critical sections; a plain Lock would deadlock there
# and burn the grace window
_lock = threading.RLock()
_flag = False
_callbacks = []            # [(handle, fn)], run in registration order
_prev_handlers = {}        # signum -> previous handler (for uninstall)
_next_handle = 0


class Preempted(MXNetError):
    """Raised by `check_preempted()` after a SIGTERM was delivered.
    Retry policies never swallow it (`fault.retry`)."""


def _handler(signum, frame):
    global _flag
    with _lock:
        already = _flag
        _flag = True
        cbs = [fn for _, fn in _callbacks]
    if not already:
        _preempt_counter.inc()
        for fn in cbs:
            try:
                fn()
            except Exception:
                # an emergency callback must never mask the preemption
                # itself, nor stop the callbacks after it
                traceback.print_exc()
    prev = _prev_handlers.get(signum)
    if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
        prev(signum, frame)


def install_preemption_handler(signals=(signal.SIGTERM,)):
    """Install the handler (idempotent; main thread only, as CPython
    allows `signal.signal` nowhere else). Previous handlers are chained
    and restored by `uninstall_preemption_handler`."""
    for signum in signals:
        with _lock:
            if signum in _prev_handlers:
                continue
        prev = signal.signal(signum, _handler)
        with _lock:
            _prev_handlers[signum] = prev


def uninstall_preemption_handler():
    """Restore the handlers from before the install."""
    with _lock:
        items = list(_prev_handlers.items())
        _prev_handlers.clear()
    for signum, prev in items:
        signal.signal(signum, prev)


def on_preemption(fn):
    """Register an emergency callback, run at the first SIGTERM in
    registration order. Usable as a decorator; remove it with
    `remove_on_preemption(fn)` or the integer handle stamped on `fn`
    where it takes attributes."""
    global _next_handle
    with _lock:
        _next_handle += 1
        handle = _next_handle
        _callbacks.append((handle, fn))
    try:
        fn._preemption_handle = handle
    except AttributeError:
        pass    # bound methods: remove by identity
    return fn


def remove_on_preemption(fn_or_handle):
    """Deregister a callback by the callable (equality: bound methods
    compare equal across accesses) or its integer handle."""
    with _lock:
        _callbacks[:] = [(h, f) for h, f in _callbacks
                         if h != fn_or_handle and f != fn_or_handle]


def preempted():
    """Sticky: True once a SIGTERM was delivered (until reset)."""
    return _flag


def check_preempted():
    """Raise `Preempted` if a SIGTERM was delivered. Call once a step, or
    wherever unwinding is safe."""
    if _flag:
        raise Preempted("preemption signal received; emergency "
                        "checkpoint (if registered) has been written")


def reset_preemption(clear_callbacks=False):
    """Clear the sticky flag (after a handled preemption, in tests)."""
    global _flag
    with _lock:
        _flag = False
        if clear_callbacks:
            _callbacks.clear()
