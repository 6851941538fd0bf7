"""The engine's bulk size (counterpart of `mxnet_tpu/engine.py:1174-1211,
1290-1308`).

Only the bulk-size knob is ported: it is the byte cap of the fused
Trainer path's gradient buckets (`optimizer/multi_tensor.py` groups
parameters into dtype-homogeneous buckets of at most this many bytes,
one fused update per bucket). 0 keeps the reference's "unbulked"
meaning, one parameter a bucket. A captured step (`Trainer.capture`,
`cachedop.py`) runs one CUDA graph and applies every bucket inside it,
so the cap shapes its update's launches and not its dispatches.

The dependency engine itself (`push`, variables, task groups, QoS) is
ROADMAP.md Queue 1 [9]: every other name of the JAX engine raises
`MXNetError` naming that item.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["set_bulk_size", "get_bulk_size", "bulk"]

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


class _EngineUnported(MXNetError, AttributeError):
    """A name of the dependency engine, which is not ported yet (an
    AttributeError too, so `hasattr` answers False)."""


_UNPORTED = frozenset((
    "Var", "push", "wait_for_var", "wait_for_all", "num_workers",
    "native_engine_loaded", "file_var", "set_debug", "debug_enabled",
    "debug_check", "debug_check_raise", "last_error", "clear_error",
    "wait_for_all_timeout", "failures", "clear_failures", "pending_tasks",
    "tasks_completed", "PRIORITY_HIGH", "PRIORITY_NORMAL",
    "PRIORITY_BACKGROUND", "PRIORITY_NAMES", "NUM_PRIORITIES", "TaskGroup",
    "EngineQueueFull", "CANCELLED", "EXPIRED", "skipped", "skipped_future",
    "inline_future", "failed_future", "set_queue_limit", "get_queue_limit",
    "set_aging_ms", "get_aging_ms", "set_qos", "qos_enabled",
    "active_groups", "pending_report"))


def __getattr__(name):
    if name in _UNPORTED:
        raise _EngineUnported(
            f"engine.{name} is not ported yet (ROADMAP.md, Queue 1 [9]: "
            f"dependency engine)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
