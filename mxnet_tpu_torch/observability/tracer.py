"""Host-side span tracer (copy of `mxnet_tpu/observability/tracer.py`;
reference: src/profiler/profiler.cc aggregate + chrome tracing writer).

A low-overhead recorder for *host* time — where a serving turn's wall
clock goes between Python dispatch, the scheduler and the kernel
launches that `torch.profiler` covers on the device side. Spans recorded
here export as standard Chrome-trace JSON (`{"traceEvents": [...]}`)
loadable in Perfetto / chrome://tracing, so a host trace opens
side-by-side with (or instead of) a device trace.

Design constraints, in order:
  1. Disabled cost ~zero. Hot paths gate on the module-level `ACTIVE`
     bool before calling anything here; `span()` itself returns a shared
     no-op object when inactive.
  2. Enabled cost is two ring-buffer appends per span (`deque.append` is
     GIL-atomic — no lock on the record path) and one
     `time.perf_counter_ns()` call per edge. The buffer is bounded
     (`MXTPU_TRACE_BUFFER`, default 65536 events): a forgotten-running
     tracer degrades to "last N events", never to unbounded memory.
  3. Per-thread tracks: events carry the recording thread; export maps
     each thread to its own Chrome `tid` with a `thread_name` metadata
     event, so worker-thread spans land on their own rows.

Clock: `time.perf_counter_ns()` — monotonic, ns resolution; exported `ts`
is microseconds relative to the tracer epoch (Chrome-trace convention).
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from time import perf_counter_ns

from .. import _env

__all__ = ["start", "stop", "clear", "enabled", "span", "instant",
           "counter", "complete", "to_chrome_trace", "dump",
           "events_recorded", "sample_op",
           "set_op_sample_rate"]

# Module-level fast-path flag. Hot call sites read `tracer.ACTIVE`
# directly (one module-attribute load) before touching any API below.
ACTIVE = False

def _env_int(name, default, minimum=1):
    """Env knob parse that can never break `import mxnet_tpu_torch` (the
    shared strtol-parity parser; values below `minimum` degrade to the
    default with a one-time warning)."""
    return _env.env_int(name, default, minimum=minimum)


_DEFAULT_CAP = _env_int("MXTPU_TRACE_BUFFER", 65536)

# ring buffer of event tuples:
#   ("B", ts_ns, ident, name, cat, args)
#   ("E", ts_ns, ident)
#   ("X", ts_ns, ident, name, cat, args, dur_ns)
#   ("i", ts_ns, ident, name, cat, args)
#   ("C", ts_ns, ident, name, value)
_buf = deque(maxlen=_DEFAULT_CAP)
_thread_names = {}    # ident -> name, captured at record time (threads
                      # may exit before export)
_epoch_ns = 0
_lock = threading.Lock()   # guards start/stop/clear, not the record path

# imperative-op sampling (ndarray._apply): record every Nth op dispatch
_op_sample_rate = _env_int("MXTPU_TRACE_OP_SAMPLE", 16)
_op_counter = 0


class _NullSpan:
    """Shared no-op context manager returned when tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_name", "_cat", "_args", "_ident")

    def __init__(self, name, cat, args):
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._ident = threading.get_ident()
        if self._ident not in _thread_names:
            _thread_names[self._ident] = threading.current_thread().name
        _buf.append(("B", perf_counter_ns(), self._ident, self._name,
                     self._cat, self._args))
        return self

    def __exit__(self, *exc):
        if ACTIVE:
            # after stop(): skip the append (export repair closes the
            # orphan B); keeps the post-stop mutation window tiny
            _buf.append(("E", perf_counter_ns(), self._ident))
        return False


def start(buffer_size=None):
    """Begin recording. Clears the buffer and re-anchors the epoch."""
    global ACTIVE, _buf, _epoch_ns
    with _lock:
        cap = int(buffer_size) if buffer_size else _buf.maxlen
        _buf = deque(maxlen=cap)
        _epoch_ns = perf_counter_ns()
        ACTIVE = True


def stop():
    """Stop recording; the buffer is kept for export until the next
    start()/clear()."""
    global ACTIVE
    with _lock:
        ACTIVE = False


def pause():
    """Suspend recording without touching the buffer (profiler.pause)."""
    global ACTIVE
    ACTIVE = False


def resume():
    """Resume recording into the existing buffer (profiler.resume)."""
    global ACTIVE
    if _epoch_ns:        # never start()ed: nothing to resume into
        ACTIVE = True


def clear():
    with _lock:
        _buf.clear()


def enabled():
    return ACTIVE


def events_recorded():
    return len(_buf)


def set_op_sample_rate(n):
    """Record one in every `n` imperative op dispatches (ndarray._apply).
    n=1 traces every op; higher keeps always-on cost negligible."""
    global _op_sample_rate
    _op_sample_rate = max(1, int(n))
    return _op_sample_rate


def sample_op():
    """True when the current imperative op dispatch should be traced.
    Callers check `tracer.ACTIVE` first; the counter races benignly under
    threads (sampling, not accounting)."""
    global _op_counter
    _op_counter += 1
    return _op_counter % _op_sample_rate == 0


def span(name, cat="host", args=None):
    """Nestable span context manager. `with tracer.span("Trainer.step"):`.
    Returns a shared no-op when tracing is off."""
    if not ACTIVE:
        return _NULL
    return _Span(name, cat, args)


def _ident():
    ident = threading.get_ident()
    if ident not in _thread_names:
        _thread_names[ident] = threading.current_thread().name
    return ident


def instant(name, cat="host", args=None):
    """A point-in-time marker (Chrome 'i' event)."""
    if not ACTIVE:
        return
    _buf.append(("i", perf_counter_ns(), _ident(), name, cat, args))


def counter(name, value):
    """A Chrome counter-track sample ('C' event) — renders as a stacked
    area chart in Perfetto (e.g. engine queue depth over time)."""
    if not ACTIVE:
        return
    _buf.append(("C", perf_counter_ns(), _ident(), name, float(value)))


def complete(name, t0_ns, t1_ns, cat="host", args=None):
    """Record a span retroactively from measured edges ('X' complete
    event) — the sampled-op path times the dispatch first, then records
    only if the sample fired."""
    if not ACTIVE:
        return
    _buf.append(("X", t0_ns, _ident(), name, cat, args,
                 max(0, t1_ns - t0_ns)))


# ---------------------------------------------------------------- export
def _repair(events):
    """Balance B/E per thread: the ring buffer may have evicted a span's
    B while keeping its E (or recording stopped mid-span). Orphan E events
    are dropped; unclosed B events get a synthetic E at the last seen
    timestamp, so the exported trace is always well-formed."""
    out = []
    stacks = {}
    last_ts = {}
    for ev in events:
        ident = ev[2]
        last_ts[ident] = max(last_ts.get(ident, 0), ev[1])
        if ev[0] == "B":
            stacks.setdefault(ident, []).append(ev)
            out.append(ev)
        elif ev[0] == "E":
            if stacks.get(ident):
                stacks[ident].pop()
                out.append(ev)
            # else: orphan E (its B was evicted) — drop
        else:
            out.append(ev)
    for ident, stack in stacks.items():
        for _ in stack:
            out.append(("E", last_ts[ident], ident))
    return out


def to_chrome_trace():
    """Render the buffer as a Chrome-trace dict:
    {"traceEvents": [...], "displayTimeUnit": "ms"}. Events are sorted by
    timestamp; B/E balance is repaired (ring eviction, still-open spans);
    per-thread tracks get thread_name metadata."""
    with _lock:
        # the record path is deliberately lock-free, so a straggler span
        # exiting on a worker thread can append mid-snapshot; deque
        # iteration raises on concurrent mutation — retry, then fall back
        # to draining element-wise (popleft is atomic)
        for _ in range(3):
            try:
                events = list(_buf)
                break
            except RuntimeError:
                continue
        else:
            events = []
            while True:
                try:
                    events.append(_buf.popleft())
                except IndexError:
                    break
            _buf.extend(events)
    # a full ring means the oldest events were (probably) evicted — flag
    # it so a truncated capture is distinguishable from a complete one
    truncated = len(events) >= (_buf.maxlen or 1)
    events.sort(key=lambda ev: ev[1])
    events = _repair(events)
    # a stable ts sort again: synthetic E events appended by repair
    events.sort(key=lambda ev: ev[1])
    pid = os.getpid()
    epoch = _epoch_ns or (events[0][1] if events else 0)
    tids = {}
    names = {t.ident: (t.name or f"thread-{t.ident}")
             for t in threading.enumerate()}
    names.update(_thread_names)
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0,
            "args": {"name": "mxnet_tpu_torch host"
                     + (" [ring truncated]" if truncated else "")}}]

    def tid_of(ident):
        tid = tids.get(ident)
        if tid is None:
            tid = tids[ident] = len(tids)
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "ts": 0,
                        "args": {"name": names.get(ident,
                                                   f"thread-{ident}")}})
        return tid

    for ev in events:
        ph, ts_ns, ident = ev[0], ev[1], ev[2]
        e = {"ph": ph, "ts": (ts_ns - epoch) / 1e3, "pid": pid,
             "tid": tid_of(ident)}
        if ph == "E":
            e["name"] = ""      # Chrome allows nameless E; keep the key
        elif ph == "C":
            e["name"] = ev[3]
            e["args"] = {"value": ev[4]}
        else:
            e["name"] = ev[3]
            e["cat"] = ev[4]
            if ev[5]:
                e["args"] = dict(ev[5])
            if ph == "X":
                e["dur"] = ev[6] / 1e3
            if ph == "i":
                e["s"] = "t"    # instant scope: thread
        out.append(e)
    # metadata first, then by ts — keeps `ts` monotonic for validators
    out.sort(key=lambda e: (e["ph"] != "M", e["ts"]))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def dump(path):
    """Write the Chrome-trace JSON file; returns the path."""
    trace = to_chrome_trace()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
