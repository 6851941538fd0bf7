"""mx.fault — fault injection, retry and preemption (counterpart of
`mxnet_tpu/fault`).

  * `injection` — the deterministic, seeded registry of named failure
    points: the serving scheduler checks `serve.admit`, `serve.decode`,
    `serve.prefix`, `serve.speculate`; the checkpoints
    `checkpoint.save` / `checkpoint.load`; the Trainer `grad.nan`; and
    `preempt.sigterm` delivers a real SIGTERM. Specs come from
    `fault.inject(...)` or ``MXTPU_FAULTS=point:key=val:...,point2:...``.
  * `retry` — the exponential-backoff-with-jitter-and-deadline policy
    (`RetryPolicy`, `policy_from_env`) that checkpoint save and load use.
  * `preemption` — the SIGTERM handler with emergency callbacks (the
    `CheckpointManager`'s emergency save registers itself there);
    training loops poll `check_preempted()` and catch `Preempted`.

The JAX package's watchdog, supervisor and fleet pieces are still to
port (ROADMAP.md, Queue 1 [7]).
"""
from __future__ import annotations

from . import injection
from . import retry
from . import preemption
from .injection import (FaultInjected, DeviceLost, HostLost, inject, clear,
                        configure, active, should_fire, check, hits,
                        fires, points, check_device_loss, lost_devices,
                        reset_lost_devices, check_host_loss, lost_hosts,
                        reset_lost_hosts)
from .retry import RetryPolicy, retry_call, policy_from_env
from .preemption import (Preempted, install_preemption_handler,
                         uninstall_preemption_handler, on_preemption,
                         remove_on_preemption, preempted, check_preempted,
                         reset_preemption)

__all__ = [
    "injection", "retry", "preemption", "FaultInjected", "DeviceLost",
    "HostLost", "inject", "clear", "configure", "active", "should_fire",
    "check", "hits", "fires", "points", "check_device_loss",
    "lost_devices", "reset_lost_devices", "check_host_loss", "lost_hosts",
    "reset_lost_hosts", "RetryPolicy", "retry_call", "policy_from_env",
    "Preempted", "install_preemption_handler",
    "uninstall_preemption_handler", "on_preemption",
    "remove_on_preemption", "preempted", "check_preempted",
    "reset_preemption",
]
