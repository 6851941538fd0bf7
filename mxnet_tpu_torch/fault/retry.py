"""Retry with exponential backoff, jitter and a deadline (counterpart of
`mxnet_tpu/fault/retry.py`; reference capability: the ps-lite van's
resend / timeout loop and dmlc-core's retrying IO streams, as one
policy object).

`RetryPolicy.call(fn)` retries `fn` on the configured exception types
with ``delay = min(max_delay, base_delay * multiplier**attempt)`` scaled
by a uniform jitter factor in ``[1-jitter, 1+jitter]``; a total
wall-clock `deadline` bounds the whole train of attempts (a retry that
would overrun it is not slept for: the last error re-raises instead).

Jitter draws from a ``seed``-able RNG, so schedules are deterministic in
tests. `Preempted` / `KeyboardInterrupt` / `SystemExit` never retry: a
preemption must win over any retry loop.

Each retry counts into ``fault_retries{site=<name>}``; giving up after
the last one counts into ``fault_retry_giveups{site=}``.

`policy_from_env(prefix)` reads the site's knobs from
``<PREFIX>_RETRIES`` / ``<PREFIX>_RETRY_BASE`` / ``<PREFIX>_RETRY_MAX`` /
``<PREFIX>_RETRY_DEADLINE`` (e.g. ``MXTPU_CKPT_RETRIES=5``), the same
names as the JAX package's.
"""
from __future__ import annotations

import functools
import random
import time

from .._env import env_float as _env_float_knob
from .._env import env_int as _env_int_knob
from ..observability import registry as _obs_registry

__all__ = ["RetryPolicy", "retry_call", "policy_from_env"]

_reg = _obs_registry()


def _never_retry():
    from .preemption import Preempted
    return (Preempted, KeyboardInterrupt, SystemExit)


class RetryPolicy:
    def __init__(self, max_retries=4, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.5, deadline=None,
                 retry_on=(Exception,), seed=None, name="retry",
                 sleep=time.sleep):
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = None if deadline is None else float(deadline)
        self.retry_on = tuple(retry_on)
        self.name = name
        self._rng = random.Random(seed) if seed is not None else random
        self._sleep = sleep
        self._retries = _reg.counter("fault_retries", site=name)
        self._giveups = _reg.counter("fault_retry_giveups", site=name)

    def delay(self, attempt):
        """Backoff before retry number `attempt` (1-based), jittered."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn, *args, **kwargs):
        """Run fn(*args, **kwargs), retrying per the policy. Re-raises the
        last error when the retries or the deadline run out."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except _never_retry():
                raise
            except self.retry_on:
                attempt += 1
                if attempt > self.max_retries:
                    self._giveups.inc()
                    raise
                d = self.delay(attempt)
                if self.deadline is not None and \
                        time.monotonic() - t0 + d > self.deadline:
                    self._giveups.inc()
                    raise
                self._retries.inc()
                if d:
                    self._sleep(d)

    def wrap(self, fn):
        """Decorator form: `policy.wrap(fn)` retries every call."""
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        return wrapped


def retry_call(fn, *args, policy=None, **kwargs):
    """`retry_call(fn, a, b, policy=RetryPolicy(...))`."""
    return (policy or RetryPolicy()).call(fn, *args, **kwargs)


def policy_from_env(prefix, max_retries=4, base_delay=0.05, max_delay=2.0,
                    deadline=30.0, name=None, **kw):
    """A RetryPolicy whose knobs read ``<prefix>_RETRIES`` /
    ``_RETRY_BASE`` / ``_RETRY_MAX`` / ``_RETRY_DEADLINE`` overrides.
    ``<prefix>_RETRIES=0`` disables retrying at that site. Malformed
    values fall back to the defaults with a one-time warning
    (`mxnet_tpu_torch._env`)."""
    def knob(suffix, default):
        return _env_float_knob(f"{prefix}_{suffix}", default, minimum=0.0)
    return RetryPolicy(
        max_retries=_env_int_knob(f"{prefix}_RETRIES", int(max_retries),
                                  minimum=0),
        base_delay=knob("RETRY_BASE", base_delay),
        max_delay=knob("RETRY_MAX", max_delay),
        deadline=knob("RETRY_DEADLINE", deadline),
        name=name or prefix.lower().replace("mxtpu_", ""), **kw)
