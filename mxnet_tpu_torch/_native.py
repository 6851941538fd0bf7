"""ctypes binding for the native C++ dependency engine
(`csrc/engine.cc`; counterpart of `mxnet_tpu/_native.py`).

Builds the shared library at first use with g++ (`-O2 -std=c++17 -shared
-fPIC -pthread`) into the gitignored `mxnet_tpu_torch/_build/`, under a
name that carries a hash of the source and the flags, so an edited
source is never served by a stale build; raises on any failure so
`engine` can fall back to the pure-Python engine with identical
semantics. Exception propagation matches _PyEngine: once an op touching
a var raises, every later op depending on that var re-raises the same
error (var poisoning — the C++ side schedules but does not know about
Python exceptions; MXNet's ThreadedEngine likewise rethrows stored
exception_ptrs on WaitForVar/WaitAll).
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import hashlib
import itertools
import os
import subprocess
import threading
from concurrent.futures import Future, InvalidStateError
from pathlib import Path

from ._engine_common import (FailureLog, failure_site,
                             reraise_unless_cancelled, set_exc as _set_exc)
from .base import MXNetError

__all__ = ["NativeEngine"]

_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_U64A = ctypes.POINTER(ctypes.c_uint64)


_SRC = Path(__file__).resolve().parent / "csrc" / "engine.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _build_lib():
    """The engine's shared library, compiled on the first call; a failed
    compile raises `MXNetError` with g++'s output."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode()
                            + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmxtt_engine_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise MXNetError(f"g++ failed to build the engine:\n{proc.stdout}"
                         f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    lib = ctypes.CDLL(str(_build_lib()))
    lib.MXTPUEngineCreate.restype = ctypes.c_void_p
    lib.MXTPUEngineCreate.argtypes = [ctypes.c_int]
    lib.MXTPUEngineDelete.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineNewVar.restype = ctypes.c_uint64
    lib.MXTPUEngineNewVar.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineDelVar.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.MXTPUEnginePush.argtypes = [ctypes.c_void_p, _CB, ctypes.c_void_p,
                                    _U64A, ctypes.c_int, _U64A, ctypes.c_int]
    lib.MXTPUEnginePushPri.argtypes = [ctypes.c_void_p, _CB, ctypes.c_void_p,
                                       _U64A, ctypes.c_int, _U64A,
                                       ctypes.c_int, ctypes.c_int]
    lib.MXTPUEngineSetAgingMs.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.MXTPUEngineGetAgingMs.restype = ctypes.c_int
    lib.MXTPUEngineGetAgingMs.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineWaitForVar.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.MXTPUEngineWaitAll.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineWaitAllFor.restype = ctypes.c_int
    lib.MXTPUEngineWaitAllFor.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.MXTPUEngineNumWorkers.restype = ctypes.c_int
    lib.MXTPUEngineNumWorkers.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineSetDebug.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.MXTPUEngineDebugEnabled.restype = ctypes.c_int
    lib.MXTPUEngineDebugEnabled.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineDebugCheck.restype = ctypes.c_int
    lib.MXTPUEngineDebugCheck.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineLastError.restype = ctypes.c_char_p
    lib.MXTPUEngineLastError.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineClearError.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineDebugBypassPush.argtypes = [
        ctypes.c_void_p, _CB, ctypes.c_void_p, _U64A, ctypes.c_int, _U64A,
        ctypes.c_int]
    return lib


class NativeEngine:
    def __init__(self, workers=None):
        if workers is None:
            # floor at the _PyEngine default (4): engine tasks are host-
            # side and frequently BLOCK (gate waits, checkpoint IO, a
            # prefetch stage waiting on its source) — sizing purely by
            # cpu_count gave a 1-worker engine on 1-CPU machines, where
            # one blocking task wedges every other push (the watchdog's
            # "slow but moving queue" contract, DevicePrefetcher's
            # depth<=workers-1 clamp, and async saves all assume a second
            # worker exists)
            workers = min(8, max(4, os.cpu_count() or 4))
        self._lib = _load()
        self._h = self._lib.MXTPUEngineCreate(workers)
        self.workers = workers
        self._tasks = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._poisoned = {}          # native var id -> exception
        self._pending = set()        # futures not yet completed
        self._failures = FailureLog()
        self._hcv = threading.Condition(threading.Lock())
        self._inflight = 0           # C calls currently holding the handle
        self._trampoline = _CB(self._run)  # must outlive all pushes
        atexit.register(self._shutdown)

    # -- C++ worker thread enters Python here (ctypes grabs the GIL) --------
    def _run(self, key):
        with self._lock:
            fn, fut, read_ids, write_ids = self._tasks.pop(key)
        if fut.cancelled():
            return  # externally cancelled before running: skip, no poison
        try:
            with self._lock:
                for v in read_ids + write_ids:
                    if v in self._poisoned:
                        raise self._poisoned[v]
        except BaseException as exc:   # dependency re-raise: NOT a root cause
            with self._lock:
                for v in write_ids:
                    self._poisoned[v] = exc
            _set_exc(fut, exc)
            return
        try:
            res = fn()
        except BaseException as exc:  # noqa: BLE001 — stored, not swallowed
            self._record_failure(fn, exc)
            with self._lock:
                for v in write_ids:
                    self._poisoned[v] = exc
            _set_exc(fut, exc)
        else:
            try:
                fut.set_result(res)
            except InvalidStateError:
                pass                   # raced an external cancel

    # sticky per-instance failure report: ROOT-CAUSE task errors only
    # (dependency re-raises recorded once at the source; cancelled /
    # skipped tasks never run fn, so they cannot appear here) — parity
    # with engine._PyEngine.failures()
    def _record_failure(self, fn, exc):
        self._failures.record(failure_site(fn), exc)

    def failures(self):
        return self._failures.list()

    def clear_failures(self):
        return self._failures.clear()

    @contextlib.contextmanager
    def _live(self):
        """Hold the native handle across ONE C call. close()/_shutdown
        null `_h` and then WAIT for in-flight holders before deleting the
        engine, so use-after-close raises MXNetError instead of handing a
        freed (or null) Engine* to native code — including the race where
        close() lands between the handle read and the C call."""
        with self._hcv:
            h = self._h
            if not h:
                raise MXNetError("NativeEngine is closed")
            self._inflight += 1
        try:
            yield h
        finally:
            with self._hcv:
                self._inflight -= 1
                if not self._inflight:
                    self._hcv.notify_all()

    def _var_id(self, var):
        vid = getattr(var, "_native_id", None)
        if vid is None:
            with self._live() as h:
                vid = self._lib.MXTPUEngineNewVar(h)
            var._native_id = vid
        return vid

    def del_var(self, nid):
        """Release one native var id (facade file-var eviction). A closed
        engine already freed every native var — soft no-op."""
        try:
            with self._live() as h:
                self._lib.MXTPUEngineDelVar(h, nid)
        except MXNetError:
            pass

    def _push_impl(self, fn, read_vars, write_vars, dedup, native_push,
                   priority=None):
        """Shared body of push and the debug push variants: task + future
        bookkeeping, per-var future mirroring (so wait_* rethrow semantics
        match _PyEngine — failed readers included), then the C call."""
        with self._live() as h:   # held across the bookkeeping + C call:
            # a concurrent close() cannot delete the engine mid-push
            read_ids = list(dict.fromkeys(self._var_id(v)
                                          for v in read_vars))
            write_ids = list(dict.fromkeys(self._var_id(v)
                                           for v in write_vars))
            if dedup:
                read_ids = [v for v in read_ids if v not in write_ids]
            fut = Future()
            key = next(self._ids)
            with self._lock:
                self._tasks[key] = (fn, fut, read_ids, write_ids)
                self._pending.add(fut)
            fut.add_done_callback(self._discard)
            for v in read_vars:
                with v._lock:
                    v._reads.append(fut)
            for v in write_vars:
                with v._lock:
                    v._last_write = fut
                    v._reads = []
            ra = (ctypes.c_uint64 * len(read_ids))(*read_ids)
            wa = (ctypes.c_uint64 * len(write_ids))(*write_ids)
            if priority is None:
                native_push(h, self._trampoline, ctypes.c_void_p(key),
                            ra, len(read_ids), wa, len(write_ids))
            else:
                native_push(h, self._trampoline, ctypes.c_void_p(key),
                            ra, len(read_ids), wa, len(write_ids),
                            int(priority))
        return fut

    def push(self, fn, read_vars=(), write_vars=(), priority=1):
        return self._push_impl(fn, read_vars, write_vars, dedup=True,
                               native_push=self._lib.MXTPUEnginePushPri,
                               priority=priority)

    def set_aging_ms(self, ms):
        """Starvation-aging interval: a queued op's effective priority
        class drops by one per `ms` waited (0 disables aging)."""
        with self._live() as h:
            self._lib.MXTPUEngineSetAgingMs(h, int(ms))

    def get_aging_ms(self):
        with self._live() as h:
            return int(self._lib.MXTPUEngineGetAgingMs(h))

    def _discard(self, fut):
        with self._lock:
            self._pending.discard(fut)

    def wait_for_var(self, var):
        vid = getattr(var, "_native_id", None)
        if vid is not None:
            try:
                with self._live() as h:
                    self._lib.MXTPUEngineWaitForVar(h, vid)
            except MXNetError:
                pass   # closed: _shutdown's WaitAll already drained
        with var._lock:
            futs = list(var._reads)
            if var._last_write is not None:
                futs.append(var._last_write)
        for f in futs:
            reraise_unless_cancelled(f)

    def wait_for_all(self):
        # Snapshot before the native wait, exactly like _PyEngine snapshots
        # _pending: failures in flight at call time are rethrown.
        with self._lock:
            futs = list(self._pending)
        try:
            with self._live() as h:
                self._lib.MXTPUEngineWaitAll(h)
        except MXNetError:
            pass       # closed: _shutdown's WaitAll already drained
        for f in futs:
            reraise_unless_cancelled(f)

    # -- debug / race-detector surface (MXTPU_ENGINE_DEBUG=1) ---------------
    def set_debug(self, on):
        with self._live() as h:
            self._lib.MXTPUEngineSetDebug(h, 1 if on else 0)

    def debug_enabled(self):
        with self._live() as h:
            return bool(self._lib.MXTPUEngineDebugEnabled(h))

    def debug_check(self):
        """Returns 0 if per-var invariants hold, 1 if a hazard was found
        (details in last_error)."""
        with self._live() as h:
            return int(self._lib.MXTPUEngineDebugCheck(h))

    def last_error(self):
        with self._live() as h:
            return (self._lib.MXTPUEngineLastError(h) or b"").decode()

    def clear_error(self):
        with self._live() as h:
            self._lib.MXTPUEngineClearError(h)

    def wait_for_all_timeout(self, timeout_ms):
        """0 = drained; 1 = stall/deadlock suspected (work still pending)."""
        with self._live() as h:
            return int(self._lib.MXTPUEngineWaitAllFor(h, timeout_ms))

    def _debug_push_raw(self, fn, read_vars=(), write_vars=()):
        """TEST ONLY: push without the Python-side reads/writes dedup so
        the native self-dependency (deadlock) detector can be exercised."""
        return self._push_impl(fn, read_vars, write_vars, dedup=False,
                               native_push=self._lib.MXTPUEnginePush)

    def _debug_bypass_push(self, fn, read_vars=(), write_vars=()):
        """TEST ONLY: schedule fn WITHOUT dependency admission — simulates
        a scheduler bug so the hazard detector can be provoked."""
        return self._push_impl(
            fn, read_vars, write_vars, dedup=False,
            native_push=self._lib.MXTPUEngineDebugBypassPush)

    def _shutdown(self):
        with self._hcv:
            h, self._h = self._h, None
            while self._inflight:      # wait out in-flight C calls: the
                self._hcv.wait()       # handle must not be freed under them
        if h:
            self._lib.MXTPUEngineWaitAll(h)
            self._lib.MXTPUEngineDelete(h)

    def close(self):
        """Drain and stop the native worker threads (parity with
        _PyEngine.close for transient instances; also runs at exit)."""
        self._shutdown()
