"""mx.observability — tracing & metrics (counterpart of
`mxnet_tpu/observability`).

  * `tracer` — host-side Chrome-trace span recorder (nestable spans,
    instants, counter tracks, per-thread rows, ring-buffer bounded).
  * `metrics_registry` — labelled counters/gauges/histograms with
    snapshot/reset and a JSONL sink. The serving scheduler, page pool
    and prefix cache record here.

`summary()` renders a human-readable breakdown from both. The JAX
package's `compilex` (compile telemetry of jitted executables) has no
counterpart: the port runs eagerly.

Env knobs: MXTPU_TRACE_BUFFER (ring capacity, events, default 65536),
MXTPU_TRACE_OP_SAMPLE (sampling rate of `tracer.sample_op`, default 16).
"""
from __future__ import annotations

from . import tracer
from . import metrics_registry
from .metrics_registry import MetricsRegistry, registry

__all__ = ["tracer", "metrics_registry", "MetricsRegistry", "registry",
           "summary"]


def _fmt_labels(labels):
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def summary(max_rows=25):
    """Human-readable breakdown of the captured trace + current metrics:
    per-span-name total/avg host time (from the tracer buffer) and every
    registered metric series. Returns the report as a string."""
    lines = []
    trace = tracer.to_chrome_trace()["traceEvents"]
    # fold B/E and X events into per-name (count, total_us) using a
    # per-tid stack for B/E pairing
    agg = {}
    stacks = {}
    for ev in trace:
        ph = ev["ph"]
        if ph == "B":
            stacks.setdefault(ev["tid"], []).append((ev["name"], ev["ts"]))
        elif ph == "E":
            stack = stacks.get(ev["tid"])
            if stack:
                name, t0 = stack.pop()
                c, tot = agg.get(name, (0, 0.0))
                agg[name] = (c + 1, tot + ev["ts"] - t0)
        elif ph == "X":
            c, tot = agg.get(ev["name"], (0, 0.0))
            agg[ev["name"]] = (c + 1, tot + ev.get("dur", 0.0))
    if agg:
        lines.append(f"{'span':<44}{'count':>8}{'total_ms':>12}"
                     f"{'avg_us':>10}")
        ranked = sorted(agg.items(), key=lambda kv: -kv[1][1])
        for name, (count, total_us) in ranked[:max_rows]:
            lines.append(f"{name[:43]:<44}{count:>8}{total_us / 1e3:>12.3f}"
                         f"{total_us / count:>10.1f}")
        if len(ranked) > max_rows:
            lines.append(f"... {len(ranked) - max_rows} more span names")
    else:
        lines.append("(no spans captured — tracer.start() first)")
    snap = registry().snapshot()
    if snap:
        lines.append("")
        lines.append(f"{'metric':<44}{'value':>26}")
        for name in sorted(snap):
            for series in snap[name]:
                label = name
                if series["labels"]:
                    label += "{" + _fmt_labels(series["labels"]) + "}"
                val = series["value"]
                if series["kind"] == "histogram":
                    val = (f"n={val['count']} mean={val['mean']:.3g} "
                           f"p95={val['p95']:.3g} p99={val['p99']:.3g}")
                lines.append(f"{label[:43]:<44}{str(val)[:26]:>26}")
    return "\n".join(lines)
