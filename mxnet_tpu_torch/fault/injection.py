"""Deterministic fault injection (copy of `mxnet_tpu/fault/injection.py`):
a seeded registry of named failure points (reference capability:
chaos-testing the dmlc tracker / tolerant iter paths without real
hardware failures).

A failure point is a string name checked at a specific code site
(`engine.task` inside every engine task, `io.decode` per record decode,
...). A *spec* attached to the point decides, deterministically, which
hits fire:

  * ``at=3+7``   — fire on exactly the 3rd and 7th hit (1-based);
  * ``n=2``      — fire at most 2 times total;
  * ``p=0.25``   — fire each hit with probability 0.25 drawn from a
                   ``seed``-ed RNG (so a schedule is random *but
                   reproducible*);
  * ``action``   — ``raise`` (default, raises `FaultInjected`),
                   ``stall`` (sleeps ``delay`` seconds — a stuck
                   collective / hung engine task), or ``sigterm``
                   (``os.kill(getpid(), SIGTERM)`` — simulated
                   preemption, caught by `fault.preemption`).

Specs come from the API (`inject()`) or the ``MXTPU_FAULTS`` env var —
comma-separated ``point[:key=val]*`` items, e.g.::

    MXTPU_FAULTS="io.read:p=0.1:seed=7,preempt.sigterm:at=12:action=sigterm"

Hot paths guard on the module-level `ENABLED` flag (False whenever no
spec is registered), so the disabled cost is one attribute load.
"""
from __future__ import annotations

import os
import random
import threading
import time

from ..base import MXNetError
from ..observability import registry as _obs_registry

__all__ = ["FaultInjected", "DeviceLost", "HostLost", "POINTS", "ENABLED",
           "inject", "clear", "configure", "active", "should_fire", "check",
           "hits", "fires", "points", "check_device_loss", "lost_devices",
           "reset_lost_devices", "check_host_loss", "lost_hosts",
           "reset_lost_hosts"]

# the failure points wired through the framework (a spec may name any
# string — new sites don't need registration here — but these are the
# ones the subsystems check)
POINTS = ("io.read", "io.decode", "engine.task", "kv.collective",
          "kv.timeout", "kv.init", "grad.nan", "preempt.sigterm",
          "checkpoint.save", "checkpoint.load", "serve.admit",
          "serve.decode", "serve.prefix", "serve.speculate",
          "serve.quant", "device.lost", "host.lost", "kv.heartbeat")

ENABLED = False            # fast-path guard; True iff any spec registered

_reg = _obs_registry()
_lock = threading.Lock()
_specs = {}                # point -> _Spec
_injected_counters = {}    # point -> Counter handle
_lost_devices = set()      # device ids masked by fired device.lost points
_lost_hosts = set()        # worker ranks masked by fired host.lost points


class FaultInjected(MXNetError):
    """Raised at an armed failure point (action="raise")."""

    def __init__(self, point, context=""):
        self.point = point
        self.context = context
        msg = f"injected fault at {point!r}"
        if context:
            msg += f" ({context})"
        super().__init__(msg)


class DeviceLost(MXNetError):
    """Raised by `check_device_loss` when the ``device.lost`` fault point
    fires: the named device drops out of the active set (a simulated
    chip/host loss). The lost ids accumulate in `lost_devices()` so a
    recovery supervisor can build a survivor mesh."""

    def __init__(self, device, context=""):
        self.device = int(device)
        msg = f"injected device loss: device {device} left the active set"
        if context:
            msg += f" ({context})"
        super().__init__(msg)


class HostLost(MXNetError):
    """Raised by `check_host_loss` when the ``host.lost`` fault point
    fires for this worker's rank: the whole host (its process, not just
    a chip) drops out of the fleet. Lost ranks accumulate in
    `lost_hosts()` so peer supervisors see the member as dead even when
    its heartbeat file would otherwise look fresh."""

    def __init__(self, rank, context=""):
        self.rank = int(rank)
        msg = f"injected host loss: worker rank {rank} left the fleet"
        if context:
            msg += f" ({context})"
        super().__init__(msg)


class _Spec:
    __slots__ = ("point", "prob", "times", "at", "action", "delay",
                 "message", "device", "rank", "_rng", "hits", "fires")

    def __init__(self, point, prob=1.0, times=None, at=None, seed=0,
                 action="raise", delay=0.5, message="", device=None,
                 rank=None):
        if action not in ("raise", "stall", "sigterm"):
            raise MXNetError(f"unknown fault action {action!r}; use "
                             "'raise', 'stall' or 'sigterm'")
        self.point = point
        self.prob = float(prob)
        self.times = None if times is None else int(times)
        self.at = None if at is None else frozenset(int(a) for a in at)
        self.action = action
        self.delay = float(delay)
        self.message = message
        self.device = None if device is None else int(device)
        self.rank = None if rank is None else int(rank)
        self._rng = random.Random(seed)
        self.hits = 0       # times the point was reached
        self.fires = 0      # times the fault actually triggered

    def rank_matches(self, rank):
        """Rank-keyed specs (``rank=N``) fire only at the worker that
        owns rank N. A non-matching hit returns False WITHOUT consuming
        a hit, so the target rank's ``at=``/``n=`` schedule stays
        deterministic no matter how often other ranks pass the point."""
        return self.rank is None or (rank is not None
                                     and int(rank) == self.rank)

    def decide(self):
        """One hit: returns True when the fault fires. Caller holds _lock."""
        self.hits += 1
        if self.times is not None and self.fires >= self.times:
            return False
        if self.at is not None:
            fire = self.hits in self.at
        elif self.prob >= 1.0:
            fire = True
        else:
            fire = self._rng.random() < self.prob
        if fire:
            self.fires += 1
        return fire


def _counter(point):
    c = _injected_counters.get(point)
    if c is None:
        c = _injected_counters[point] = _reg.counter("fault_injected",
                                                     point=point)
    return c


def inject(point, prob=1.0, times=None, at=None, seed=0, action="raise",
           delay=0.5, message="", device=None, rank=None):
    """Arm a failure point. Replaces any existing spec for `point`.

    at: iterable of 1-based hit indices that fire (overrides prob);
    times: max total fires; seed: RNG seed for probabilistic schedules;
    action: 'raise' | 'stall' (sleep `delay` s) | 'sigterm';
    device: the device id a firing ``device.lost`` point masks (see
    `check_device_loss`); rank: key the spec to one worker rank — only
    hits carrying that rank count (see `_Spec.rank_matches`)."""
    global ENABLED
    spec = _Spec(point, prob=prob, times=times, at=at, seed=seed,
                 action=action, delay=delay, message=message, device=device,
                 rank=rank)
    with _lock:
        _specs[point] = spec
        ENABLED = True
    return spec


def clear(point=None):
    """Disarm one failure point, or all of them (point=None). Clearing
    the ``device.lost`` point (or everything) also unmasks any devices a
    previous fire removed from the active set."""
    global ENABLED
    with _lock:
        if point is None:
            _specs.clear()
            _lost_devices.clear()
            _lost_hosts.clear()
        else:
            _specs.pop(point, None)
            if point == "device.lost":
                _lost_devices.clear()
            elif point == "host.lost":
                _lost_hosts.clear()
        ENABLED = bool(_specs)


def configure(spec_string):
    """Arm failure points from an ``MXTPU_FAULTS``-style string:
    comma-separated ``point[:key=val]*`` items. Returns the spec list."""
    out = []
    for item in (spec_string or "").split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        point, kw = parts[0], {}
        for p in parts[1:]:
            if "=" not in p:
                raise MXNetError(f"malformed MXTPU_FAULTS item {item!r}: "
                                 f"expected key=val, got {p!r}")
            k, v = p.split("=", 1)
            k = {"p": "prob", "n": "times"}.get(k, k)
            if k == "at":
                kw["at"] = [int(x) for x in v.split("+")]
            elif k == "prob":
                kw["prob"] = float(v)
            elif k in ("times", "seed", "device", "rank"):
                kw[k] = int(v)
            elif k == "delay":
                kw["delay"] = float(v)
            elif k in ("action", "message"):
                kw[k] = v
            else:
                raise MXNetError(f"unknown MXTPU_FAULTS key {k!r} in "
                                 f"{item!r}")
        out.append(inject(point, **kw))
    return out


def active(point=None):
    """Whether a spec is armed for `point` (or any point, point=None)."""
    with _lock:
        return bool(_specs) if point is None else point in _specs


def points():
    """Currently armed point names."""
    with _lock:
        return sorted(_specs)


def hits(point):
    """How many times `point` was reached (armed specs only)."""
    with _lock:
        s = _specs.get(point)
        return s.hits if s is not None else 0


def fires(point):
    """How many times `point` actually fired."""
    with _lock:
        s = _specs.get(point)
        return s.fires if s is not None else 0


def should_fire(point, rank=None):
    """One hit at `point`: True when the armed schedule says fire (the
    caller then applies its own failure semantics — e.g. the Trainer
    poisons gradients for `grad.nan`). Counts into
    ``fault_injected{point=}`` when firing. `rank` identifies the
    calling worker for rank-keyed specs."""
    if not ENABLED:
        return False
    with _lock:
        spec = _specs.get(point)
        if spec is None or not spec.rank_matches(rank):
            return False
        fire = spec.decide()
    if fire:
        _counter(point).inc()
    return fire


def check(point, context="", rank=None):
    """One hit at `point`, applying the spec's action when it fires:
    raise `FaultInjected`, stall (sleep), or deliver SIGTERM to this
    process. Returns True when the fault fired with a non-raise action,
    False when nothing fired. `rank` identifies the calling worker for
    rank-keyed specs."""
    if not ENABLED:
        return False
    with _lock:
        spec = _specs.get(point)
        if spec is None or not spec.rank_matches(rank):
            return False
        fire = spec.decide()
        action, delay, msg = spec.action, spec.delay, spec.message
    if not fire:
        return False
    _counter(point).inc()
    if action == "stall":
        time.sleep(delay)
        return True
    if action == "sigterm":
        import signal
        os.kill(os.getpid(), signal.SIGTERM)
        return True
    raise FaultInjected(point, msg or context)


def check_device_loss(context=""):
    """One hit at the ``device.lost`` point. When the schedule fires, the
    spec's `device` id (default: the highest-id device not yet lost) is
    masked from the active set — it joins `lost_devices()` — and
    `DeviceLost` raises so a supervisor can shrink the mesh to the
    survivors (`Trainer.resize_mesh`). The action key is ignored: device
    loss always raises; real hardware does not sleep politely. Returns
    False when nothing fired."""
    if not ENABLED:
        return False
    with _lock:
        spec = _specs.get("device.lost")
        if spec is None:
            return False
        fire = spec.decide()
        device = spec.device
        if fire and device is None:
            import torch
            for d in range(torch.cuda.device_count() - 1, -1, -1):
                if d not in _lost_devices:
                    device = d
                    break
            else:
                device = 0
        if fire:
            _lost_devices.add(int(device))
    if not fire:
        return False
    _counter("device.lost").inc()
    raise DeviceLost(device, context)


def lost_devices():
    """Device ids masked by fired ``device.lost`` points (sorted)."""
    with _lock:
        return sorted(_lost_devices)


def reset_lost_devices():
    """Unmask every lost device (recovery complete / test hygiene)."""
    with _lock:
        _lost_devices.clear()


def check_host_loss(rank, context=""):
    """One hit at the ``host.lost`` point for the worker that owns
    `rank`. A rank-keyed spec (``rank=N``) fires only at that worker —
    other ranks pass through without consuming a hit. When the schedule
    fires, the caller's rank is masked into `lost_hosts()` and
    `HostLost` raises: the fleet member treats its own process as gone
    (peers see the masked rank as dead regardless of heartbeat
    freshness). Like device loss, the action key is ignored — host loss
    always raises. Returns False when nothing fired."""
    if not ENABLED:
        return False
    with _lock:
        spec = _specs.get("host.lost")
        if spec is None or not spec.rank_matches(rank):
            return False
        fire = spec.decide()
        if fire:
            _lost_hosts.add(int(rank))
    if not fire:
        return False
    _counter("host.lost").inc()
    raise HostLost(rank, context)


def lost_hosts():
    """Worker ranks masked by fired ``host.lost`` points (sorted)."""
    with _lock:
        return sorted(_lost_hosts)


def reset_lost_hosts(rank=None):
    """Unmask lost hosts: all of them (default — fleet recovery
    complete / test hygiene) or one `rank` (a member recovering from its
    OWN injected death unmasks itself without resurrecting genuinely
    dead peers)."""
    with _lock:
        if rank is None:
            _lost_hosts.clear()
        else:
            _lost_hosts.discard(int(rank))


# env arming: parsed once at import — the chaos harness and users arm
# via API; MXTPU_FAULTS covers launcher-driven runs
_env = os.environ.get("MXTPU_FAULTS")
if _env:
    configure(_env)
