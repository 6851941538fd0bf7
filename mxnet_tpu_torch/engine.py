"""Execution engine facade (counterpart of `mxnet_tpu/engine.py`;
reference: src/engine/threaded_engine.cc).

Two layers:
  * Device-side op scheduling is owned by the CUDA streams: a launch
    enqueues on the current stream and Python returns at once, which is
    the role MXNet's ThreadedEngine plays for kernels. `wait_for_all`
    also synchronizes the card.
  * Host-side async work (the DataLoader's batchify, the serving decode
    loop) runs on the native C++ dependency engine, `csrc/engine.cc`,
    built with g++ at first use (`_native.py`), with a pure-Python
    fallback of identical semantics: push(fn, read_vars, write_vars)
    with read/write dependency ordering per variable, wait_for_var,
    wait_for_all. `native_engine_loaded()` says which one runs.

QoS — the engine is a multi-tenant scheduler, not a FIFO:

  * **Priority classes** — `push(..., priority=PRIORITY_HIGH | NORMAL |
    BACKGROUND)`. Ready tasks dispatch best-class-first, so a serve decode
    turn (high) preempts QUEUED batchify work (background) at dispatch
    time; running tasks are never interrupted. **Aging** bounds
    starvation: a ready task's effective class drops by one per
    `set_aging_ms` interval waited, FLOORED at the high class — promoted
    background work beats fresh normal work and ties among promoted
    classes go to the longest waiter, but the native high class wins its
    ties, so a decode turn's dispatch wait stays bounded by one running
    task no matter how stale the backlog.
  * **Task groups** — `TaskGroup` is the cancellation handle:
    `cancel()` atomically skips every member task that has not started
    (futures resolve to `engine.CANCELLED` in dependency order — nothing
    is poisoned, no failure is recorded, the race detector stays quiet),
    `drain()` waits for in-flight members to settle.
  * **Bounded queues** — `set_queue_limit(class, limit, policy)` bounds
    queued-not-started tasks per class with a backpressure policy: `reject`
    (push raises `EngineQueueFull`), `block` (push waits for room), or
    `shed_oldest` (the class's oldest queued task is cancelled to make
    room). Surfaced via `engine_queue_rejections{class}` and the
    `engine_queue_high_water{class}` gauge.
  * **Deadlines** — `push(..., deadline_ms=)` bounds a task's QUEUED
    lifetime: not started in time -> skipped (future resolves to
    `engine.EXPIRED`, `engine_deadline_expired` counts it). Tasks running
    past their deadline show as `overdue` in `pending_report()`.

Engine-var users in the port: the gluon DataLoader and the device
prefetcher (`prefetch.py`; background class), the serving decode loop
(`serve/engine_bridge.py`, high class), and the IO on `file_var`:
`nd.save` / `load`, `recordio`'s appends and async checkpoint saves
(`checkpoint.py`, background class).

Tasks run on the engine's worker threads. A task that launches CUDA work
does so on that thread's current device and stream (both are per
thread in PyTorch), so a task that touches the card enters its device
itself (`serve/engine_bridge.py` does). At interpreter exit the hooks in
`_exit_hooks` run first (the serving loops cancel their queued tasks, so
no decode turn launches once shutdown has begun), then the engine
drains.

Debug mode (MXTPU_ENGINE_DEBUG=1 or `set_debug(True)`) turns on the race /
deadlock detector: write-write and read-write hazard checks on every
release, self-dependency (deadlock-cycle) detection at push, and a bounded
`wait_for_all_timeout` for stall watchdogs. Errors are reported via
`last_error()` / raised by `debug_check_raise()`.

The bulk size is the fused Trainer path's gradient-bucket byte cap
(`optimizer/multi_tensor.py`); see `set_bulk_size`.
"""
from __future__ import annotations

import atexit as _atexit
import collections as _collections
import os as _os
import threading
import time as _time
from concurrent.futures import Future, InvalidStateError

import torch

from ._env import env_int as _env_int
from ._engine_common import FailureLog as _FailureLog
from ._engine_common import failure_site as _failure_site
from ._engine_common import reraise_unless_cancelled as _reraise_unless_cancelled
from ._engine_common import set_exc as _set_exc
from .base import MXNetError
from .observability import registry as _obs_registry
from .observability import tracer as _tracer
from .fault import injection as _finj

__all__ = ["Var", "push", "wait_for_var", "wait_for_all", "set_bulk_size",
           "get_bulk_size", "bulk", "num_workers", "native_engine_loaded", "file_var",
           "set_debug", "debug_enabled", "debug_check", "debug_check_raise",
           "last_error", "clear_error", "wait_for_all_timeout",
           "failures", "clear_failures", "pending_tasks", "tasks_completed",
           "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_BACKGROUND",
           "PRIORITY_NAMES", "NUM_PRIORITIES", "TaskGroup", "EngineQueueFull",
           "CANCELLED", "EXPIRED", "skipped", "skipped_future",
           "inline_future", "failed_future", "set_queue_limit",
           "get_queue_limit", "set_aging_ms", "get_aging_ms", "set_qos",
           "qos_enabled", "active_groups", "pending_report"]

# ------------------------------------------------------ priority classes
NUM_PRIORITIES = 3
PRIORITY_HIGH = 0         # serve decode turns — latency-critical
PRIORITY_NORMAL = 1       # default: user pushes
PRIORITY_BACKGROUND = 2   # DataLoader batchify, other bulk host work
PRIORITY_NAMES = ("high", "normal", "background")

_DEFAULT_AGING_MS = 100


def _clamp_pri(priority):
    return min(max(int(priority), 0), NUM_PRIORITIES - 1)


class EngineQueueFull(MXNetError):
    """Bounded-queue backpressure: the priority class's queue is at its
    limit and the policy is `reject` — retry later or shed load."""


class _SkipResult:
    """Result sentinel of a task whose fn was skipped (cancelled task
    group, shed-oldest victim, or expired deadline). Falsy, identity-
    compared; dependents see a CLEAN completion — nothing is poisoned."""
    __slots__ = ("reason",)

    def __init__(self, reason):
        self.reason = reason

    def __repr__(self):
        return f"<engine.{self.reason.upper()}>"

    def __bool__(self):
        return False


CANCELLED = _SkipResult("cancelled")
EXPIRED = _SkipResult("expired")


def skipped(result):
    """True when an engine-task result is a skip sentinel (the task's fn
    never ran: cancelled group / shed / expired deadline)."""
    return isinstance(result, _SkipResult)


def skipped_future():
    """An already-done future resolved to `engine.CANCELLED`. Framework
    push sites (DataLoader batchify, PrefetchingIter fetch) substitute
    it when a bounded class under the `reject` policy raises
    EngineQueueFull: the consumer's existing shed fallback (inline
    recompute) then absorbs the rejection instead of the exception
    crashing the caller's loop mid-epoch."""
    f = Future()
    f.set_result(CANCELLED)
    return f


def inline_future(fn, site=None, write_vars=()):
    """Run fn synchronously NOW and return an already-done future holding
    its result (or exception). The other half of the reject-policy
    degradation story: framework push sites whose work cannot simply be
    skipped (DevicePrefetcher staging, async checkpoint saves) substitute
    this for `push` when a bounded class raises EngineQueueFull —
    backpressure slows the caller by one task instead of dropping work,
    and errors keep riding the future's `result()` contract. A failure
    is recorded into `failures()` / `engine_task_failures` exactly like
    an engine-task failure, so fire-and-forget callers (an async save
    whose future nobody waits on) don't lose the report to the
    degradation path.

    With `write_vars` (AT MOST ONE var), the inline task takes the var's
    write slot ATOMICALLY (under the var lock) before waiting on the
    displaced writer/readers, so two degraded pushers of the same var
    serialize instead of both passing a wait-then-run window and
    interleaving. Single-var only: per-var slot-taking across several
    vars could interleave with a concurrent push of the same vars and
    form a dependency cycle (inline waits on the pushed task, whose dep
    is the inline future) — a permanent hang, so multi-var is rejected
    outright. A poisoned predecessor rides the returned future as a
    dependency re-raise (fn never runs, not recorded as a root cause) —
    parity with a queued dependent. Residual window (documented): the
    native engine's dependency tracking cannot see an inline writer, so
    a task PUSHED while the inline fn runs orders after it only on
    _PyEngine."""
    if len(write_vars) > 1:
        raise MXNetError("inline_future supports at most one write var "
                         "(multi-var slot-taking can deadlock against a "
                         "concurrent push of the same vars)")
    f = Future()
    deps = []
    for v in write_vars:
        with v._lock:
            if v._last_write is not None:
                deps.append(v._last_write)
            deps.extend(v._reads)
            v._last_write = f
            v._reads = []
    for d in deps:
        try:
            _reraise_unless_cancelled(d)   # blocks behind in-flight writers
        except BaseException as exc:
            f.set_exception(exc)
            return f
    try:
        f.set_result(fn())
    except BaseException as exc:
        _record_failure(site or _dispatch_site(fn), exc)
        f.set_exception(exc)
    return f


def failed_future(exc):
    """An already-done future carrying `exc`. Degraded push sites that
    find their ordering var POISONED substitute this for running the
    work inline: the error rides the future exactly as a queued
    dependent's re-raise would, and the work (which would be discarded
    by the caller's failure recovery anyway) never runs."""
    f = Future()
    f.set_exception(exc)
    return f


class Var:
    """A dependency variable (reference: engine::Var). Ops that write a var
    are serialised; readers wait for the last writer."""
    __slots__ = ("_lock", "_last_write", "_reads", "_native_id")

    def __init__(self):
        self._lock = threading.Lock()
        self._last_write = None       # Future of last writer
        self._reads = []              # Futures of readers since last write


class _PyTask:
    __slots__ = ("fn", "fut", "deps", "pri", "_nwait", "_nlock", "_t_ready")

    def __init__(self, fn, fut, deps, pri):
        self.fn = fn
        self.fut = fut
        self.deps = deps
        self.pri = pri
        self._nwait = len(deps) + 1    # +1 guard dropped by push()
        self._nlock = threading.Lock()
        self._t_ready = 0.0


class _PyEngine:
    """Pure-Python fallback engine, the same ready-queue design as
    csrc/engine.cc: a task
    enters a per-priority-class READY queue only once every dependency
    future has settled (dep waits no longer park workers), and workers
    drain the queues best-effective-class-first with aging — identical
    dispatch semantics to the native engine."""

    NUM_CLASSES = NUM_PRIORITIES

    def __init__(self, workers=4, aging_ms=None):
        if aging_ms is None:
            # Mirror the C++ engine's strtol+endptr parse exactly
            # (engine.cc: ms >= 0 and <= INT32_MAX, else default) — the
            # shared `_env` parser IS that discipline, so the parity
            # pair cannot run with different starvation bounds.
            aging_ms = _env_int("MXTPU_ENGINE_AGING_MS",
                                _DEFAULT_AGING_MS, minimum=0,
                                maximum=2**31 - 1)
        self._aging_ms = max(0, int(aging_ms))
        self._aging_s = self._aging_ms / 1000.0
        self.workers = workers
        self._ready = [_collections.deque() for _ in range(self.NUM_CLASSES)]
        self._rcv = threading.Condition(threading.Lock())
        self._pending = set()
        self._plock = threading.Lock()
        self._debug = bool(_os.environ.get("MXTPU_ENGINE_DEBUG"))
        self._last_error = ""
        self._hazard = False
        self._failures = _FailureLog()
        self._admit_lock = threading.Lock()
        self._stopped = False
        for i in range(workers):
            threading.Thread(target=self._worker, daemon=True,
                             name=f"mxtpu-engine-{i}").start()

    def close(self):
        """Stop the worker threads once the ready queues drain (call
        after `wait_for_all`; push nothing afterwards). The workers hold
        a strong ref to the engine, so a discarded instance that is
        never closed leaks its threads for the process lifetime — the
        global facade engine deliberately never closes, but transient
        instances (tools, tests, benches) must."""
        with self._rcv:
            self._stopped = True
            self._rcv.notify_all()

    # debug surface mirroring NativeEngine (the Python engine admits in
    # program order under per-var locks so bypass-injection does not
    # apply; self-dep and stall detection are the meaningful checks here)
    def set_debug(self, on):
        self._debug = bool(on)

    def debug_enabled(self):
        return self._debug

    def debug_check(self):
        # invariant violations only — a recorded stall is informational,
        # matching the native engine's per-var invariant scan
        return 1 if self._hazard else 0

    def last_error(self):
        return self._last_error

    def clear_error(self):
        self._last_error = ""
        self._hazard = False

    def _record(self, msg, hazard=False):
        if hazard:
            self._hazard = True
        if len(self._last_error) > 4096:
            return  # bounded: keep the earliest messages
        self._last_error = (self._last_error + "; " if self._last_error
                            else "") + msg

    def set_aging_ms(self, ms):
        """Starvation-aging interval: a READY task's effective priority
        class drops by one per `ms` waited (0 disables aging; negative
        values are IGNORED, matching the native SetAgingMs — disabling
        the starvation bound must be an explicit 0)."""
        ms = int(ms)
        if ms >= 0:
            self._aging_ms = ms
            self._aging_s = ms / 1000.0

    def get_aging_ms(self):
        # the stored int, NOT int(_aging_s * 1000): float truncation would
        # return ms-1 for values like 1001 while the native engine returns
        # the exact int — a save/restore round-trip must not decay
        return self._aging_ms

    def wait_for_all_timeout(self, timeout_ms):
        import time
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._plock:
            futs = list(self._pending)
        for f in futs:
            rem = deadline - time.monotonic()
            if rem <= 0 or not _done_within(f, rem):
                self._record(f"stall: engine did not drain within "
                             f"{timeout_ms}ms")
                return 1
        return 0

    def push(self, fn, read_vars=(), write_vars=(), priority=PRIORITY_NORMAL):
        if self._stopped:
            # parity with NativeEngine's _live() guard: a push onto a
            # closed engine must RAISE, not enqueue onto worker-less
            # ready queues where the future silently never settles
            raise MXNetError("engine is closed")
        if self._debug:
            overlap = [v for v in read_vars if v in write_vars]
            for _v in overlap:
                self._record("deadlock: op reads AND writes the same var "
                             "(self-dependency cycle; read dep dropped)",
                             hazard=True)
            if overlap:
                read_vars = [v for v in read_vars if v not in write_vars]
        # dedup (identity): a var repeated in a list, or present in both
        # lists, must not make the task depend on its OWN future now that
        # collection and registration share one lock hold below
        read_vars = list(dict.fromkeys(read_vars))
        write_vars = list(dict.fromkeys(write_vars))
        read_vars = [v for v in read_vars if v not in write_vars]
        deps = []
        fut = Future()
        # dep COLLECTION and var REGISTRATION must be one atomic admission
        # (program order, like engine.cc's Push under its global mutex):
        # two threads pushing writes on the same var could otherwise both
        # snapshot the old last_write — neither depends on the other and
        # the writes run concurrently on two workers. Per var, collect
        # and register under ONE v._lock hold: inline_future takes only
        # the var lock (not _admit_lock), so a gap between the two would
        # let an inline writer swap its slot in unseen — the queued and
        # inline writer would then run concurrently
        with self._admit_lock:
            for v in read_vars:
                with v._lock:
                    if v._last_write is not None:
                        deps.append(v._last_write)
                    v._reads.append(fut)
            for v in write_vars:
                with v._lock:
                    if v._last_write is not None:
                        deps.append(v._last_write)
                    deps.extend(v._reads)
                    v._last_write = fut
                    v._reads = []
            task = _PyTask(fn, fut, deps, _clamp_pri(priority))
            with self._plock:
                self._pending.add(fut)
        fut.add_done_callback(self._discard)
        for d in deps:
            d.add_done_callback(lambda _f, t=task: self._dep_done(t))
        self._dep_done(task)          # drop the +1 guard
        return fut

    def _discard(self, fut):
        with self._plock:
            self._pending.discard(fut)

    def _dep_done(self, task):
        with task._nlock:
            task._nwait -= 1
            if task._nwait:
                return
        task._t_ready = _time.monotonic()
        with self._rcv:
            self._ready[task.pri].append(task)
            self._rcv.notify()

    # _rcv must be held. Effective class of a queue head = its class minus
    # one per aging interval waited, FLOORED at class 0: promoted work can
    # tie the high class but never outrank it — a decode turn's dispatch
    # wait stays bounded by one running task no matter how stale the
    # backlog, while promoted background beats fresh normal work. Ties go
    # to the NATIVE high class first, then to the longest-waiting head
    # (fairness among promoted classes). Per-class queues are FIFO, so
    # each head is its class's oldest — the candidate aging promoted
    # furthest. Mirrors csrc/engine.cc PopBestLocked exactly.
    def _pop_best_locked(self):
        now = _time.monotonic()
        best = None
        best_key = None
        for c, q in enumerate(self._ready):
            if not q:
                continue
            eff = c
            if self._aging_s > 0:
                eff = max(0, eff - int((now - q[0]._t_ready)
                                       / self._aging_s))
            key = (eff, c != 0, q[0]._t_ready)
            if best is None or key < best_key:
                best, best_key = c, key
        return self._ready[best].popleft() if best is not None else None

    def _worker(self):
        while True:
            with self._rcv:
                task = self._pop_best_locked()
                while task is None:
                    if self._stopped:
                        return         # close(): drained, nothing to do
                    self._rcv.wait()
                    task = self._pop_best_locked()
            self._run_task(task)

    def _run_task(self, task):
        fut = task.fut
        if fut.cancelled():
            return                     # externally cancelled: skip cleanly
        dep_exc = None
        for d in task.deps:            # all settled once the task is ready
            if d.cancelled():
                continue               # a cancelled dep poisons nothing
            e = d.exception()
            if e is not None:
                dep_exc = e
                break
        if dep_exc is not None:        # dependency re-raise: NOT a root cause
            _set_exc(fut, dep_exc)
            return
        try:
            res = task.fn()
        except BaseException as exc:   # noqa: BLE001 — stored, not swallowed
            self._record_task_failure(task.fn, exc)
            _set_exc(fut, exc)
        else:
            try:
                fut.set_result(res)
            except InvalidStateError:
                pass

    # sticky per-instance failure report: ROOT-CAUSE task errors only
    # (dependency re-raises excluded by construction above; cancelled /
    # skipped tasks never run fn so they cannot appear) — parity with
    # NativeEngine.failures()
    def _record_task_failure(self, fn, exc):
        self._failures.record(_failure_site(fn, _dispatch_site), exc)

    def failures(self):
        return self._failures.list()

    def clear_failures(self):
        return self._failures.clear()

    def wait_for_var(self, var):
        with var._lock:
            futs = list(var._reads)
            if var._last_write is not None:
                futs.append(var._last_write)
        for f in futs:
            _reraise_unless_cancelled(f)

    def wait_for_all(self):
        with self._plock:
            futs = list(self._pending)
        for f in futs:
            _reraise_unless_cancelled(f)


def _done_within(fut, seconds):
    from concurrent.futures import TimeoutError as _FTimeout
    try:
        fut.exception(timeout=seconds)
        return True
    except _FTimeout:
        return False
    except Exception:
        return True  # completed (with error) counts as done


_engine = None
_native = None


# callables run at interpreter exit BEFORE the engine drains (the
# serving loops cancel their queued tasks there)
_exit_hooks = []


def _drain_at_exit():
    """Run the exit hooks, then drain: UNBOUNDED, matching
    NativeEngine._shutdown's WaitAll. Task errors were already surfaced
    through failures(); they are not re-raised at exit. Registered after
    the engine is made, so it runs before NativeEngine's own atexit."""
    for hook in list(_exit_hooks):
        try:
            hook()
        # mxtpu: disable=E04 interpreter exit: nothing left to report to
        except BaseException:
            pass
    try:
        _engine.wait_for_all()
    # mxtpu: disable=E04 interpreter exit: errors already in failures()
    except BaseException:
        pass


def _get():
    global _engine, _native
    if _engine is None:
        try:
            from ._native import NativeEngine
            _engine = NativeEngine()
            _native = True
        except Exception:
            _engine = _PyEngine()
            _native = False
        _atexit.register(_drain_at_exit)
        # idle time is derivable: elapsed * workers - engine_busy_seconds
        _reg.gauge("engine_workers").set(getattr(_engine, "workers", 1))
    return _engine


def native_engine_loaded():
    """True when the C++ engine (`csrc/engine.cc`) built and runs; False
    when the engine fell back to `_PyEngine`."""
    _get()
    return bool(_native)


# ------------------------------------------------- observability hooks
# Always-on metrics (queue depth, worker busy time, task/var-wait latency)
# plus per-task tracer spans named by dispatch site when a trace is being
# captured. Instrumentation lives in the module facade so the native C++
# engine and the Python fallback are measured identically. Engine pushes
# are IO-scale (batchify tasks, decode bursts), so one clock pair + a
# gauge store per task is noise; op-scale dispatch goes to the CUDA
# streams, not here.
_queue_depth = 0
_qlock = threading.Lock()
_reg = _obs_registry()
_q_gauge = _reg.gauge("engine_queue_depth")
_q_gauge.set(0)
_busy_counter = _reg.counter("engine_busy_seconds")
_task_hist = _reg.histogram("engine_task_seconds")
_wait_hist = _reg.histogram("engine_var_wait_seconds")

# ------------------------------------------------ sticky failure report
# A task that raises poisons its vars (dependents re-raise), but the only
# carrier used to be the Future — callers that never call .result() (fire
# and forget pushes) would lose the
# error entirely. Every ROOT-CAUSE task failure (fn itself raised, not a
# dependency re-raise) is recorded here and counted, so supervisors can
# poll `failures()` / the `engine_task_failures` counter. The engine
# INSTANCES additionally keep their own bounded failure deques
# (`_PyEngine.failures()` / `NativeEngine.failures()` — parity pair) so
# direct-engine users get the same report. Cancelled / shed / expired
# tasks never run fn and are recorded NOWHERE as failures.
_failures = _FailureLog()
_fail_counter = _reg.counter("engine_task_failures")


def _record_failure(site, exc):
    _fail_counter.inc()
    _failures.record(site, exc)


def failures():
    """Sticky engine-task failure report: the most recent root-cause task
    errors (site + repr, newest last; bounded). Dependency re-raises are
    not double-counted; cancelled tasks never appear."""
    return _failures.list()


def clear_failures():
    return _failures.clear()


def _dispatch_site(fn):
    """Span name for an engine task: module.qualname of the pushed fn —
    e.g. `io.task`, `utils.do_save` — the dispatch site, not the worker."""
    qn = getattr(fn, "__qualname__", None) or \
        getattr(fn, "__name__", None) or type(fn).__name__
    mod = getattr(fn, "__module__", None) or ""
    return f"{mod.rsplit('.', 1)[-1]}.{qn}" if mod else qn


def _queue_delta(d):
    global _queue_depth
    with _qlock:
        _queue_depth += d
        depth = _queue_depth
    _q_gauge.set(depth)
    if _tracer.ACTIVE:
        _tracer.counter("engine_queue_depth", depth)
    return depth


# ------------------------------------------------------ QoS bookkeeping
# Admission control (bounded per-class queues), task-group membership,
# deadlines and cancellation all live HERE in the facade so the native
# and Python engines share one policy; the inner engines only order the
# ready queue by priority class.
_qos_lock = threading.Lock()
_admission_cv = threading.Condition(_qos_lock)
_queued_count = [0] * NUM_PRIORITIES
_deadline_queued = [0] * NUM_PRIORITIES   # queued recs carrying a deadline
_queued_records = [_collections.deque() for _ in range(NUM_PRIORITIES)]
_deadline_records = [_collections.deque() for _ in range(NUM_PRIORITIES)]
_queue_limits = [None] * NUM_PRIORITIES
_queue_policies = ["reject"] * NUM_PRIORITIES
_queue_high_water = [0] * NUM_PRIORITIES
_live_records = set()
_active_group_count = 0
_qos_on = True

_rej_counters = [_reg.counter("engine_queue_rejections", **{"class": n})
                 for n in PRIORITY_NAMES]
_hw_gauges = [_reg.gauge("engine_queue_high_water", **{"class": n})
              for n in PRIORITY_NAMES]
_dispatch_wait_hists = [
    _reg.histogram("engine_dispatch_wait_seconds", **{"class": n})
    for n in PRIORITY_NAMES]
_cancel_counter = _reg.counter("engine_tasks_cancelled")
_expired_counter = _reg.counter("engine_deadline_expired")
_groups_gauge = _reg.gauge("engine_task_groups")
_groups_gauge.set(0)
for _g in _hw_gauges:
    _g.set(0)


class _TaskRecord:
    """Facade-side lifecycle record of one pushed task: admission class,
    group membership, deadline, and the queued->running->done transition
    that cancellation races against."""
    __slots__ = ("site", "pri", "group", "deadline", "t_push", "state",
                 "skip_reason", "fut", "_lock", "_left_queue", "_done_evt")

    def __init__(self, site, pri, group, deadline):
        self.site = site
        self.pri = pri
        self.group = group
        self.deadline = deadline
        self.t_push = _time.monotonic()
        self.state = "queued"          # queued -> running -> done
        self.skip_reason = None        # "cancelled" | "shed" | "expired"
        self.fut = None
        self._lock = threading.Lock()
        self._left_queue = False
        self._done_evt = threading.Event()

    def _try_start(self):
        with self._lock:
            if self.state != "queued" or self.skip_reason:
                return False
            self.state = "running"
        self._leave_queue()
        return True

    def _try_cancel(self, reason="cancelled"):
        with self._lock:
            if self.state != "queued" or self.skip_reason:
                return False
            self.skip_reason = reason
        self._leave_queue()
        return True

    def _leave_queue(self):
        with self._lock:
            if self._left_queue:
                return
            self._left_queue = True
        with _admission_cv:
            _queued_count[self.pri] -= 1
            if self.deadline is not None:
                _deadline_queued[self.pri] -= 1
            _admission_cv.notify_all()

    def _on_done(self, _fut=None):
        with self._lock:
            # under the lock, BEFORE _leave_queue: a racing _try_cancel
            # must not observe "queued" on an already-settled record and
            # report a cancellation (inflating cancel counts / shedding
            # a slot that was never freed)
            self.state = "done"
        self._leave_queue()            # dep-failed tasks never start
        self.fut = None    # settled records may linger in bookkeeping
                           # deques until compaction — don't pin results
        if self.group is not None:
            self.group._remove(self)
        with _qos_lock:
            _live_records.discard(self)
        self._done_evt.set()


def _append_bounded(q, rec, live_hint):
    """Append rec to a bookkeeping deque of queued records (shed order /
    deadline carriers): drop settled HEADS cheaply, and when settled
    records accumulate behind a head pinned queued by a slow dependency,
    compact — at most ~live_hint survive, so the deque tracks live
    queued tasks (O(1) amortised per append), not history. Settled
    records pin nothing heavy either way (_on_done drops rec.fut)."""
    while q and (q[0].state != "queued" or q[0].skip_reason):
        q.popleft()
    q.append(rec)
    if len(q) > 4 * max(1, live_hint) + 16:
        live = [r for r in q if r.state == "queued" and not r.skip_reason]
        q.clear()
        q.extend(live)


def _admit(rec):
    """Bounded-queue admission for one record. Returns after the record
    is accounted into its class's queued count; raises EngineQueueFull
    (reject policy), blocks (block policy), or cancels the class's
    oldest queued task to make room (shed_oldest policy). A full class
    first sweeps queued occupants whose DEADLINE already passed —
    an expired task waiting on a wedged dependency must not hold an
    admission slot against live work (its future still resolves to
    engine.EXPIRED, in dependency order)."""
    pri = rec.pri
    while True:
        victim = None
        expired = None
        with _admission_cv:
            limit = _queue_limits[pri]
            if limit is not None and _queued_count[pri] >= limit \
                    and _deadline_queued[pri]:
                # sweep gated on the per-class deadline count and scoped
                # to the per-class deadline-carrier deque, so deadline-
                # free workloads (the common flood) never pay it and the
                # cost scales with deadline carriers, not engine load
                now = _time.monotonic()
                expired = [r for r in _deadline_records[pri]
                           if r.state == "queued" and not r.skip_reason
                           and now > r.deadline]
            if limit is None or _queued_count[pri] < limit:
                _queued_count[pri] += 1
                if rec.deadline is not None:
                    _deadline_queued[pri] += 1
                    _append_bounded(_deadline_records[pri], rec,
                                    _deadline_queued[pri])
                if limit is not None and \
                        _queue_policies[pri] == "shed_oldest":
                    # shed bookkeeping only when the policy needs it —
                    # an unbounded class must not accumulate records
                    _append_bounded(_queued_records[pri], rec, limit)
                if _queued_count[pri] > _queue_high_water[pri]:
                    _queue_high_water[pri] = _queued_count[pri]
                    _hw_gauges[pri].set(_queue_high_water[pri])
                _live_records.add(rec)
                return
            policy = _queue_policies[pri]
            if policy == "reject":
                if not expired:
                    _rej_counters[pri].inc()
                    raise EngineQueueFull(
                        f"engine {PRIORITY_NAMES[pri]!r} queue full "
                        f"(limit {limit}, policy=reject); retry later")
            elif policy == "shed_oldest":
                if not expired:
                    q = _queued_records[pri]
                    while q:
                        cand = q.popleft()
                        if cand.state == "queued" and not cand.skip_reason:
                            victim = cand
                            break
                    if victim is None:
                        # nothing sheddable (everything at the limit is
                        # already running): briefly wait for room
                        _admission_cv.wait(0.05)
                        continue
            else:                      # block
                if not expired:
                    # bounded wait, not wait(): a slot-holder's deadline
                    # may pass with no notify — wake and re-sweep
                    _admission_cv.wait(0.05)
                    continue
        # cancel OUTSIDE the admission lock: _try_cancel re-enters it via
        # _leave_queue, which frees the slot(s) this loop then claims
        if expired:
            for r in expired:
                r._try_cancel("expired")
            continue
        if victim._try_cancel("shed"):
            _rej_counters[pri].inc()


def _resolve_priority(priority):
    if priority is None:
        return PRIORITY_NORMAL
    pri = _clamp_pri(priority)
    return pri if _qos_on else PRIORITY_NORMAL


class TaskGroup:
    """First-class cancellable group of engine tasks (the DataLoader's
    batchify tasks and the serve loop each push through one):
    `cancel()` atomically flags every member task that has not STARTED —
    their user fn never runs and their futures resolve to
    `engine.CANCELLED` in dependency order, so var release stays
    race-free and nothing is poisoned — while in-flight members run to
    completion; `drain()` blocks until everything settles. One edge is
    deliberate: a cancelled member queued behind an ALREADY-FAILED
    dependency resolves to that dependency's error, like any other
    dependent — cancellation skips the member's own work, it does not
    mask an upstream failure (consumers using
    `engine.skipped(f.result())` should expect the re-raise there). Cancelled
    tasks are NOT failures: they appear in no failure report, do not
    count into `engine_task_failures`, and cannot trip the race
    detector. Groups are reusable (new pushes after `cancel()` run
    normally) and leak-free: settled tasks drop out of the group, and a
    group with no live tasks stops counting into `active_groups()` /
    the `engine_task_groups` gauge.

        g = engine.TaskGroup("prefetch")
        g.push(stage, write_vars=[slot], priority=engine.PRIORITY_BACKGROUND)
        ...
        g.cancel_and_drain()    # or: with engine.TaskGroup("x") as g: ...
    """

    def __init__(self, name="group"):
        self.name = str(name)
        self._lock = threading.Lock()
        self._records = set()

    def push(self, fn, read_vars=(), write_vars=(), priority=None,
             deadline_ms=None):
        return push(fn, read_vars, write_vars, priority=priority,
                    group=self, deadline_ms=deadline_ms)

    def _add(self, rec):
        # the live delta is applied INSIDE the group lock (lock order:
        # group._lock -> _qos_lock, nothing takes them reversed): applied
        # outside, a member completing on a worker could land its -1
        # before this +1 and a concurrent poller would read
        # active_groups() == -1
        with self._lock:
            if not self._records:
                _group_live_delta(+1)
            self._records.add(rec)

    def _remove(self, rec):
        with self._lock:
            self._records.discard(rec)
            if not self._records:
                _group_live_delta(-1)

    def cancel(self):
        """Cancel every member task that has not started; returns how
        many were cancelled. In-flight members keep running — `drain()`
        waits for them. New pushes into the group remain allowed."""
        with self._lock:
            recs = list(self._records)
        n = 0
        for r in recs:
            if r._try_cancel():
                n += 1
        return n

    def drain(self, timeout=None):
        """Block until every member task settles (completed, failed, or
        resolved cancelled). True when drained, False on timeout."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            with self._lock:
                rec = next(iter(self._records), None)
            if rec is None:
                return True
            rem = None
            if deadline is not None:
                rem = deadline - _time.monotonic()
                if rem <= 0:
                    return False
            rec._done_evt.wait(rem)
            if not rec._done_evt.is_set():
                return False

    def cancel_and_drain(self, timeout=None):
        self.cancel()
        return self.drain(timeout)

    def pending(self):
        """Member tasks queued-not-started (cancellable)."""
        with self._lock:
            return sum(1 for r in self._records
                       if r.state == "queued" and not r.skip_reason)

    def inflight(self):
        """Member tasks currently running (cancel cannot stop these)."""
        with self._lock:
            return sum(1 for r in self._records if r.state == "running")

    def live(self):
        """Member tasks not yet settled (queued + running + cancelled-
        but-not-yet-resolved)."""
        with self._lock:
            return len(self._records)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cancel_and_drain()
        return False


def _group_live_delta(delta):
    global _active_group_count
    with _qos_lock:
        _active_group_count += delta
        # publish under the lock: two racing deltas could otherwise set
        # the gauge out of order and leave engine_task_groups stale
        _groups_gauge.set(_active_group_count)


def active_groups():
    """Number of TaskGroups that currently have live (unsettled) member
    tasks — zero once every group has drained (tools/check_qos.py's
    group-leak gate)."""
    with _qos_lock:
        return _active_group_count


def push(fn, read_vars=(), write_vars=(), priority=None, group=None,
         deadline_ms=None):
    """Schedule fn after its dependencies (reference: Engine::PushAsync).

    QoS: `priority` is PRIORITY_HIGH / PRIORITY_NORMAL
    (default) / PRIORITY_BACKGROUND — ready tasks dispatch
    best-class-first with aging (`set_aging_ms`), so background floods
    cannot starve serve turns and vice versa. `group` attaches the task
    to a `TaskGroup` (cancellable as a unit). `deadline_ms` bounds the
    QUEUED lifetime: a task that has not started in time is skipped —
    its future resolves to `engine.EXPIRED`, nothing is poisoned, and
    `engine_deadline_expired` counts it."""
    pri = _resolve_priority(priority)
    site0 = _dispatch_site(fn)
    rec = _TaskRecord(site0, pri, group,
                      None if deadline_ms is None
                      else _time.monotonic() + deadline_ms / 1000.0)
    _admit(rec)
    # group membership only AFTER admission: a concurrent group.cancel()
    # must never cancel a record the bounded-queue accounting has not
    # admitted yet — its _leave_queue would decrement a count that was
    # never incremented (and a reject-policy raise would leave the class
    # permanently under-counted). The cost is that a push parked at a
    # full `block`-policy class is not group-cancellable until admitted.
    if group is not None:
        group._add(rec)
    _queue_delta(+1)
    # one-shot: the normal decrement runs in _task's finally, but a task
    # whose DEPENDENCY failed never runs fn (the engine re-raises the dep
    # error before entering it) — the done-callback below catches that
    # path so the depth gauge cannot leak upward
    dec_once = threading.Lock()

    def _dec():
        if dec_once.acquire(blocking=False):
            _queue_delta(-1)

    def _run_fn():
        # fault point + sticky failure report wrap the USER fn only:
        # dependency re-raises happen in the inner engines before _task's
        # fn runs, so a recorded failure is always the root cause
        try:
            if _finj.ENABLED:
                _finj.check("engine.task", context=site0)
            return fn()
        except BaseException as exc:
            _record_failure(site0, exc)
            raise

    def _task():
        if not rec._try_start():
            # cancelled (TaskGroup) or shed while queued: skip the user
            # fn and resolve CLEAN, in dependency order — dependents and
            # var release proceed as if the task ran and did nothing
            (_expired_counter if rec.skip_reason == "expired"
             else _cancel_counter).inc()
            _dec()
            return EXPIRED if rec.skip_reason == "expired" else CANCELLED
        now = _time.monotonic()
        if rec.deadline is not None and now > rec.deadline:
            rec.skip_reason = "expired"
            _expired_counter.inc()
            _dec()
            return EXPIRED
        _dispatch_wait_hists[rec.pri].observe(now - rec.t_push)
        t0 = _time.perf_counter()
        try:
            if _tracer.ACTIVE:
                with _tracer.span(f"engine:{site0}", cat="engine"):
                    return _run_fn()
            return _run_fn()
        finally:
            dt = _time.perf_counter() - t0
            _busy_counter.inc(dt)
            _task_hist.observe(dt)
            _dec()

    _task._mxtpu_site = site0      # instance failure logs name the USER fn
    try:
        fut = _get().push(_task, read_vars, write_vars, priority=pri)
    except BaseException:
        # inner-engine push failed AFTER admission (bad var object, a
        # closed native engine): roll the admission back or the class
        # permanently loses a bounded-queue slot, the group never drains
        # and pending_report() carries a phantom queued entry forever
        _queue_delta(-1)
        rec._on_done()
        raise
    rec.fut = fut
    if hasattr(fut, "add_done_callback"):
        fut.add_done_callback(lambda _f: _dec())
        fut.add_done_callback(rec._on_done)
    return fut


def set_queue_limit(priority, limit, policy="reject"):
    """Bound the number of queued-not-started tasks of one priority
    class (None removes the bound — the default). Backpressure policy:

      * ``reject``      — an over-limit push raises `EngineQueueFull`;
      * ``block``       — an over-limit push blocks until the class
                          drains below the limit (do NOT use from code
                          that itself runs on an engine worker);
      * ``shed_oldest`` — the class's OLDEST queued task is cancelled to
                          make room (its future resolves to
                          engine.CANCELLED).

    Rejected and shed tasks count into `engine_queue_rejections{class}`;
    the deepest queue each class ever reached is the
    `engine_queue_high_water{class}` gauge. Shed candidacy starts at the
    moment the shed_oldest policy is set — tasks already queued before
    that are waited out, not shed. Returns the previous (limit, policy)
    pair so scopes can restore it."""
    pri = _clamp_pri(priority)
    if policy not in ("reject", "block", "shed_oldest"):
        raise MXNetError(f"unknown queue policy {policy!r}; use 'reject', "
                         "'block' or 'shed_oldest'")
    with _admission_cv:
        prev = (_queue_limits[pri], _queue_policies[pri])
        _queue_limits[pri] = None if limit is None else max(1, int(limit))
        _queue_policies[pri] = policy
        if _queue_limits[pri] is None or policy != "shed_oldest":
            # shed bookkeeping holds strong record refs (futures +
            # closures); a class leaving shed_oldest must drop them or
            # every record admitted during the shed window leaks
            _queued_records[pri].clear()
        _admission_cv.notify_all()
    return prev


def get_queue_limit(priority):
    """The (limit, policy) pair of a priority class (limit None =
    unbounded)."""
    pri = _clamp_pri(priority)
    with _qos_lock:
        return (_queue_limits[pri], _queue_policies[pri])


def set_aging_ms(ms):
    """Starvation-aging interval shared by both engine implementations:
    every `ms` milliseconds a READY task waits promotes it one priority
    class, floored at the high class (promoted work ties but never
    outranks native high-class tasks; ties among promoted classes go to
    the longest waiter). Background work therefore overtakes fresh
    normal work after ~NUM_PRIORITIES * ms, while high-class dispatch
    latency stays bounded by the running tasks' duration (0 disables
    aging; env default MXTPU_ENGINE_AGING_MS, 100). Returns the
    previous value."""
    eng = _get()
    prev = eng.get_aging_ms() if hasattr(eng, "get_aging_ms") else 0
    if hasattr(eng, "set_aging_ms"):
        eng.set_aging_ms(int(ms))
    return prev


def get_aging_ms():
    eng = _get()
    return eng.get_aging_ms() if hasattr(eng, "get_aging_ms") else 0


def set_qos(on):
    """Enable/disable priority scheduling at the facade. Disabled maps
    every push to PRIORITY_NORMAL — pure FIFO, the `bench_serve.py
    --background-train` baseline. Returns the previous setting."""
    global _qos_on
    prev = _qos_on
    _qos_on = bool(on)
    return prev


def qos_enabled():
    return _qos_on


def pending_report():
    """Snapshot of facade-pushed tasks that have not settled: site,
    priority class, group, state (queued/running), age, and whether the
    task is past its deadline (`overdue`) — oldest first. The step
    watchdog embeds this in its stall post-mortem so a wedged queue
    names its offender (e.g. a stuck background task ahead of queued
    high-priority work)."""
    now = _time.monotonic()
    with _qos_lock:
        recs = list(_live_records)
    out = []
    for r in recs:
        if r.state == "done":
            continue
        out.append({
            "site": r.site,
            "class": PRIORITY_NAMES[r.pri],
            "group": r.group.name if r.group is not None else None,
            "state": r.state,
            "age_s": round(now - r.t_push, 3),
            "overdue": bool(r.deadline is not None and now > r.deadline),
        })
    out.sort(key=lambda d: -d["age_s"])
    return out


def pending_tasks():
    """Engine tasks currently queued or running (the queue-depth gauge's
    instantaneous value — what the watchdog polls before deciding
    whether a bounded drain is warranted)."""
    with _qlock:
        return _queue_depth


def tasks_completed():
    """Monotonic count of engine tasks that have finished (success or
    failure) since process start — the watchdog's progress signal."""
    return _task_hist.count


def wait_for_var(var):
    t0 = _time.perf_counter()
    with _tracer.span("engine.wait_for_var", cat="engine"):
        _get().wait_for_var(var)
    _wait_hist.observe(_time.perf_counter() - t0)


def wait_for_all():
    """Wait for every pushed task, then for the card's queued work (the
    counterpart of the JAX package's device-array readiness)."""
    with _tracer.span("engine.wait_for_all", cat="engine"):
        _get().wait_for_all()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


# Bulk size = the fused Trainer path's gradient-bucket byte cap
# (`optimizer/multi_tensor.py`).
_DEFAULT_BULK_BYTES = 64 << 20
_OP_COUNT_SCALE = 4096   # below this, `size` is a reference op count
_bulk_size = _DEFAULT_BULK_BYTES


def set_bulk_size(size):
    """Set the fused-update bucket byte cap (reference:
    Engine::SetBulkSize); 0 means one parameter a bucket. The reference
    counts ops (typical values 4-15), so op-count sizes (0 < size < 4096)
    mean the default byte cap. Returns the previous value."""
    global _bulk_size
    prev = _bulk_size
    size = max(0, int(size))
    if 0 < size < _OP_COUNT_SCALE:
        size = _DEFAULT_BULK_BYTES
    _bulk_size = size
    return prev


def get_bulk_size():
    """The current fused-update bucket byte cap (0 = per-parameter)."""
    return _bulk_size


def num_workers():
    return getattr(_get(), "workers", 1)


# ---------------------------------------------------------- file vars
_file_vars = {}
_file_vars_lock = threading.Lock()


def file_var(path):
    """The dependency Var for a filesystem path (one Var per absolute
    path). Host IO pushes write ops on this var and readers wait on it —
    the discipline the reference engine applies to NDArray save/load
    (reference: NDArray::Save pushed with the array + output vars): the
    port's `nd.save` / `load`, `recordio` and `checkpoint`."""
    p = _os.path.abspath(str(path))
    with _file_vars_lock:
        v = _file_vars.get(p)
        if v is None:
            if len(_file_vars) > 256:
                _evict_drained_file_vars_locked()
            v = _file_vars[p] = Var()
        return v


def _evict_drained_file_vars_locked():
    """Drop file vars whose ops have all completed (step-stamped checkpoint
    runs would otherwise leak one Var + native var id per path)."""
    eng = _get()
    for p, v in list(_file_vars.items()):
        with v._lock:
            done = (v._last_write is None or v._last_write.done()) and \
                all(f.done() for f in v._reads)
        if done:
            nid = getattr(v, "_native_id", None)
            if nid is not None and hasattr(eng, "del_var"):
                eng.del_var(nid)   # refcount-guarded against a racing close
            del _file_vars[p]


# ---------------------------------------------------------- debug facade
def set_debug(on):
    """Toggle the engine race/deadlock detector (env: MXTPU_ENGINE_DEBUG)."""
    _get().set_debug(on)


def debug_enabled():
    return _get().debug_enabled()


def debug_check():
    """0 = per-var scheduling invariants hold; 1 = hazard recorded."""
    return _get().debug_check()


def debug_check_raise():
    """Raise MXNetError when the detector has recorded a hazard."""
    if _get().debug_check():
        raise MXNetError(f"engine hazard: {last_error()}")


def last_error():
    return _get().last_error()


def clear_error():
    _get().clear_error()


def wait_for_all_timeout(timeout_ms):
    """Bounded drain: 0 = drained, 1 = stall/deadlock suspected."""
    return _get().wait_for_all_timeout(timeout_ms)


class bulk:
    """Scope that sets `set_bulk_size(size)` for its extent and restores
    the previous cap on exit; it never synchronizes."""

    def __init__(self, size=_DEFAULT_BULK_BYTES):
        self.size = int(size)
        self._prev = None

    def __enter__(self):
        self._prev = set_bulk_size(self.size)
        return self

    def __exit__(self, *exc):
        set_bulk_size(self._prev)
        return False
