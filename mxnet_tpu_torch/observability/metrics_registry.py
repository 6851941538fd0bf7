"""Pluggable metrics registry (reference: the profiler's aggregate stats +
src/profiler counters, re-designed as a labelled metric store).

Three instrument kinds, all label-aware:

  * Counter   — monotonically increasing (`inc`); resettable as a unit.
  * Gauge     — last-write-wins value (`set`/`add`); value may be any
                JSON-serialisable object (e.g. a bucket-size list).
  * Histogram — `observe(v)` into log2 buckets plus count/sum/min/max,
                giving cheap percentilish summaries without reservoirs.

A metric handle is identified by (name, sorted labels); `counter("x",
site="kv")` and `counter("x", site="opt")` are distinct series of the same
family. Handles are cached — hot paths call `.inc()` on a stored handle,
not the registry lookup. `reset()` zeroes values but keeps handles alive,
so cached references in profiler/engine/kvstore stay valid across resets.

Sinks: `snapshot()` (nested dict for tests/summary), `dump_jsonl(path)`
(one JSON line per series, append-mode — tail it during training).

The default registry is process-global (`registry()`); subsystems may
instantiate private `MetricsRegistry()` objects (pluggable — nothing here
touches module state except the default instance).
"""
from __future__ import annotations

import json
import math
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry"]


def _label_key(labels):
    return tuple(sorted(labels.items()))


class _Metric:
    __slots__ = ("name", "labels")
    kind = "metric"

    def describe(self):
        d = {"name": self.name, "kind": self.kind}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class Counter(_Metric):
    """Monotonic counter. `inc()` is unlocked — a bare float += under the
    GIL; these are telemetry tallies, and the hot dispatch paths cannot
    afford a lock acquire per op. Tests that need exactness drive them
    single-threaded (as the fused-Trainer dispatch tests do)."""
    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def reset(self):
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge(_Metric):
    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = None

    def set(self, v):
        self.value = v

    def add(self, n=1):
        self.value = (self.value or 0) + n

    def reset(self):
        self.value = None

    def snapshot(self):
        # a gauge may hold a pending 0-d device scalar (e.g. the Trainer's
        # grad-norm is set WITHOUT forcing a host sync on the step path);
        # coerce to a python float only when the value is actually read
        v = self.value
        if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
            try:
                return v.item()
            except Exception:
                return v
        return v


class Histogram(_Metric):
    """log2-bucketed histogram: bucket index = ceil(log2(v / base)),
    clamped to [0, nbuckets). Covers ~9 orders of magnitude in 32 buckets
    at 2x resolution — plenty for latencies in seconds or sizes in
    bytes."""
    __slots__ = ("count", "sum", "min", "max", "buckets", "_base", "_lock")
    kind = "histogram"
    NBUCKETS = 32

    def __init__(self, name, labels, base=1e-6):
        self.name = name
        self.labels = labels
        self._base = float(base)
        self._lock = threading.Lock()
        self.reset()

    def observe(self, v):
        v = float(v)
        if v <= 0 or not math.isfinite(v):
            idx = 0
        else:
            idx = min(self.NBUCKETS - 1,
                      max(0, int(math.ceil(math.log2(v / self._base)))))
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self.buckets[idx] += 1

    def reset(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = [0] * self.NBUCKETS

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q):
        """Upper bucket edge at quantile q — a 2x-resolution estimate."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                return self._base * (2.0 ** i)
        return self.max

    def quantiles(self, qs=(0.5, 0.95, 0.99)):
        """Several quantiles in ONE bucket walk: {q: estimate}. The
        serving latency reporters (serve.Server, bench_serve) read
        p50/p95/p99 per snapshot — walking the buckets once instead of
        len(qs) times keeps the per-step reporting cost flat."""
        if not self.count:
            return {q: 0.0 for q in qs}
        order = sorted(qs)
        out = {}
        targets = [(q, q * self.count) for q in order]
        seen = 0
        ti = 0
        for i, n in enumerate(self.buckets):
            seen += n
            while ti < len(targets) and seen >= targets[ti][1]:
                out[targets[ti][0]] = self._base * (2.0 ** i)
                ti += 1
            if ti == len(targets):
                break
        for q, _ in targets[ti:]:
            out[q] = self.max
        return out

    def snapshot(self):
        qs = self.quantiles((0.5, 0.95, 0.99))
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": self.mean,
                "p50": qs[0.5], "p95": qs[0.95], "p99": qs[0.99]}


class MetricsRegistry:
    def __init__(self):
        self._metrics = {}        # (name, labelkey) -> metric
        self._lock = threading.Lock()

    def _get(self, cls, name, labels, **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = self._metrics[key] = cls(name, _label_key(labels),
                                                 **kw)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r}{dict(labels)} already "
                            f"registered as {m.kind}")
        return m

    def counter(self, name, **labels):
        return self._get(Counter, name, labels)

    def gauge(self, name, **labels):
        return self._get(Gauge, name, labels)

    def histogram(self, name, base=1e-6, **labels):
        return self._get(Histogram, name, labels, base=base)

    def series(self, name):
        """All metric handles of one family, in registration order."""
        with self._lock:
            return [m for (n, _), m in self._metrics.items() if n == name]

    def reset(self, name=None):
        """Zero values (all families, or one) — handles stay registered."""
        with self._lock:
            for (n, _), m in self._metrics.items():
                if name is None or n == name:
                    m.reset()

    def snapshot(self):
        """{family: [{labels..., value|stats}, ...]} for tests/summary."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
        for (name, labelkey), m in items:
            out.setdefault(name, []).append(
                {"labels": dict(labelkey), "kind": m.kind,
                 "value": m.snapshot()})
        return out

    def dump_jsonl(self, path, reset=False):
        """Append one JSON line per series: {"ts", "name", "kind",
        "labels", "value"}. A training loop calling this per epoch gets a
        tailable metrics log; `reset=True` makes each line a delta."""
        now = time.time()
        with self._lock:
            items = list(self._metrics.items())
        with open(path, "a") as f:
            for (name, labelkey), m in items:
                rec = {"ts": round(now, 3), "name": name, "kind": m.kind,
                       "labels": dict(labelkey), "value": m.snapshot()}
                f.write(json.dumps(rec) + "\n")
        if reset:
            self.reset()
        return path


_default = MetricsRegistry()


def registry():
    """The process-global default registry (what profiler/engine/kvstore/
    Trainer instrumentation records into)."""
    return _default
