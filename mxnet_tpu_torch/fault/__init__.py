"""mx.fault — fault injection (counterpart of `mxnet_tpu/fault`).

Only `injection` is ported: the deterministic, seeded registry of named
failure points that the serving scheduler checks (`serve.admit`,
`serve.decode`, `serve.prefix`, `serve.speculate`). Specs come from
`fault.inject(...)` or ``MXTPU_FAULTS=point:key=val:...,point2:...``.
The JAX package's retry, watchdog, preemption, supervisor and fleet
pieces belong to the training slice.
"""
from __future__ import annotations

from . import injection
from .injection import (FaultInjected, DeviceLost, HostLost, inject, clear,
                        configure, active, should_fire, check, hits,
                        fires, points, check_device_loss, lost_devices,
                        reset_lost_devices, check_host_loss, lost_hosts,
                        reset_lost_hosts)

__all__ = [
    "injection", "FaultInjected", "DeviceLost", "HostLost", "inject",
    "clear", "configure", "active", "should_fire", "check", "hits",
    "fires", "points", "check_device_loss", "lost_devices",
    "reset_lost_devices", "check_host_loss", "lost_hosts",
    "reset_lost_hosts",
]
