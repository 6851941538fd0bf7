"""Dependency-engine drive for the serving scheduler (counterpart of
`mxnet_tpu/serve/engine_bridge.py`).

The serving crank is host-side async work, which the dependency engine
(`mxnet_tpu_torch/engine.py`) schedules, so the decode loop runs as
engine tasks rather than a dedicated thread:

  * ONE loop task at a time, serialised on a private engine `Var` (the
    write-var discipline of every engine user, so the race detector
    covers the serving loop too);
  * `kick()` arms the loop when work arrives and is a no-op while a loop
    task is already scheduled — submits never pile up tasks;
  * the task cranks `scheduler.step()` until the scheduler is idle
    (bounded per-task burst, then re-pushes itself, so other engine work
    interleaves with decoding instead of starving behind an unbounded
    serving task).

Loop tasks are PRIORITY_HIGH members of a `TaskGroup`: they preempt
queued background work (the DataLoader's batchify tasks) at dispatch
time, and `close()` cancels any queued loop task through the group
instead of waiting it out.

The card: a loop task runs on an engine worker thread, and PyTorch's
current device and stream are per thread, so the task enters the
server's device (`torch.cuda.device`) and the kernels launch on that
thread's current stream; `serve/decode.py` enters `torch.no_grad()`
itself (grad mode is per thread too). At interpreter exit every live
loop is closed before the engine drains (`engine._exit_hooks`), so a
queued loop task never launches once shutdown has begun.

Fault discipline: a loop-task failure (e.g. an injected `engine.task`
fault) surfaces through the engine's sticky failure report
(`engine.failures()`) like every other engine task — AND the loop
re-arms itself on a FRESH var (the native engine poisons a failed
task's vars permanently) so serving survives the fault instead of
silently wedging every later kick. Restarts count into
`serve_loop_restarts`.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref

import torch

from .. import engine
from ..observability import registry as _obs_registry

__all__ = ["EngineLoop"]

# steps one engine task cranks before re-pushing itself: long enough to
# amortise the push, short enough that other engine users interleave
_BURST = 64

# every loop not yet closed: closed at interpreter exit, before the
# engine drains
_LIVE = weakref.WeakSet()


def _close_live_loops():
    for loop in list(_LIVE):
        loop.close(drain=False)


engine._exit_hooks.append(_close_live_loops)


class EngineLoop:
    """The engine-driven crank of one scheduler. `device`: the server's
    `torch.device`; a CUDA device is entered around each loop task."""

    def __init__(self, scheduler, device=None):
        self._sched = scheduler
        self._device = device if device is not None \
            and device.type == "cuda" else None
        self._var = engine.Var()
        self._lock = threading.Lock()
        self._armed = False
        self._closed = False
        self._group = engine.TaskGroup("serve.loop")
        self.restarts = 0
        self._consec_failures = 0
        self._m_restarts = _obs_registry().counter("serve_loop_restarts")
        _LIVE.add(self)

    def kick(self):
        """Ensure a loop task is scheduled (no-op when one already is)."""
        with self._lock:
            if self._armed or self._closed:
                return
            self._armed = True
        self._push()

    def _retry_push_later(self, delay):
        """Re-attempt _push off-worker after `delay` (one timer at a
        time: _armed stays set, so kick() no-ops while it is pending)."""
        timer = threading.Timer(delay, self._push)
        timer.daemon = True
        timer.start()

    def _push(self):
        with self._lock:
            if self._closed:           # a backoff timer may outlive close
                self._armed = False
                return
            var = self._var
        try:
            fut = engine.push(self._loop_task, write_vars=[var],
                              priority=engine.PRIORITY_HIGH,
                              group=self._group)
        except engine.EngineQueueFull:
            # a bounded HIGH-class queue rejected the loop task: stay
            # armed and retry off-worker shortly — clients parked in
            # Request.result(timeout) never call kick(), so disarming
            # here would strand mid-decode requests until some external
            # submit happened to land.
            self._retry_push_later(0.05)
            return
        except BaseException:   # noqa: BLE001
            # any OTHER push failure (engine closed under a shutdown
            # race, inner-engine error): swallowing it in a Timer/done-
            # callback thread would leave _armed stuck True with no loop
            # task — kick() no-ops forever and every queued request
            # strands. Stay armed and retry with bounded exponential
            # backoff instead; serve_loop_restarts makes it visible
            # (restarts counts it too, so counter and attribute agree).
            with self._lock:
                if self._closed:
                    self._armed = False
                    return
                self.restarts += 1
                self._consec_failures += 1
                streak = self._consec_failures
            self._m_restarts.inc()
            self._retry_push_later(min(2.0, 0.05 * (2 ** min(streak, 6))))
            return
        fut.add_done_callback(self._task_done)

    def _task_done(self, fut):
        try:
            exc = fut.exception()
            res = fut.result() if exc is None else None
        except BaseException:          # externally cancelled future
            with self._lock:
                if self._closed:       # close() cancels the group: done
                    self._armed = False
                    return
            # cancelled OUTSIDE close (a stray Future.cancel): armed
            # with no loop task would wedge serving forever — re-push,
            # exactly like a shed loop task
            self._push()
            return
        if exc is None and not engine.skipped(res):
            with self._lock:
                self._consec_failures = 0
            return
        with self._lock:
            if self._closed:
                self._armed = False
                return
            if exc is not None:
                # the loop task itself died (injected engine.task fault,
                # scheduler bug): its var is poisoned on the native
                # engine — re-arm on a FRESH var and keep cranking; the
                # error stays visible in engine.failures()
                self._var = engine.Var()
                self.restarts += 1
                self._consec_failures += 1
            streak = self._consec_failures
        if exc is not None:
            self._m_restarts.inc()
        # exc None + skipped(res): the queued loop task was SHED by a
        # bounded high-class queue (close() cancels set _closed first,
        # handled above) — re-push so serving resumes when the queue
        # drains rather than wedging armed-but-taskless
        if streak > 1:
            # a PERSISTENTLY failing loop (deterministic scheduler bug,
            # prob=1.0 fault left armed) must not hot-spin a worker:
            # re-arm off-worker with bounded exponential backoff
            self._retry_push_later(
                min(0.05 * (2 ** min(streak - 2, 5)), 2.0))
            return
        self._push()

    def _loop_task(self):
        ctx = torch.cuda.device(self._device) if self._device is not None \
            else contextlib.nullcontext()
        with ctx:
            self._crank()

    def _crank(self):
        for _ in range(_BURST):
            if self._closed:
                break
            if not self._sched.step():
                # no progress: either drained, or queued work is waiting
                # on pages that only in-flight decodes can free — the
                # truthiness of step() guarantees actives keep making
                # progress, so "no progress + pending" means drained-race
                with self._lock:
                    if self._closed or not self._sched.pending_work():
                        self._armed = False
                        return
                continue
        # burst spent (or closing): yield the worker, keep the loop armed
        with self._lock:
            if self._closed or not self._sched.pending_work():
                self._armed = False
                return
        self._push()

    def wait_idle(self, timeout=None):
        """Block until the scheduler drains (engine-task completion plus a
        pending-work poll, since a new submit can re-arm the loop)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                var = self._var
            try:
                engine.wait_for_var(var)
            except (KeyboardInterrupt, SystemExit):
                raise   # an operator's Ctrl-C must break a wedged drain
            except BaseException:   # noqa: BLE001 — the engines store and
                pass    # re-raise BaseExceptions too; a failed loop task
                        # re-arms on a fresh var either way (parity with
                        # _task_done's own except BaseException)
            if not self._sched.pending_work():
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            self.kick()
            time.sleep(0.001)

    def close(self, drain=True):
        """Stop the loop: cancel any queued-not-started loop task through
        the task group (its future resolves to engine.CANCELLED) and, with
        `drain`, wait for the in-flight one — close never blocks behind a
        poisoned var."""
        with self._lock:
            self._closed = True
        _LIVE.discard(self)
        self._group.cancel()
        if drain:
            self._group.drain()
