"""Device input pipeline: engine-driven prefetch with the host-to-device
copies on a side stream (counterpart of `mxnet_tpu/prefetch.py`;
reference capability: src/io/'s prefetcher threads and gluon's worker
loaders, on the dependency engine).

`DevicePrefetcher` wraps any batch iterable and keeps `depth` staging
slots in flight. Each slot is an engine task at PRIORITY_BACKGROUND
(`engine.push` with a per-slot write var plus a shared source var, in
one cancellable `TaskGroup`) that pulls the next host batch, turns its
leaves into CPU tensors and, on a card, copies them into pinned host
buffers. The task is host work only: a worker that launched CUDA work
on its own thread would break a CUDA graph being captured meanwhile
(`Trainer.capture`), so no engine thread allocates, copies to, frees or
queries anything of the card.

The copies to the card are issued from the consuming thread, in
`__next__`: from the batch's pinned buffers, non-blocking, on the
prefetcher's side stream; an event recorded there is what the
consumer's current stream waits on, so the step's kernels order after
the copy without a host wait, and each tensor handed out is recorded on
that stream (`record_stream`) so that its memory is not reused before
the step that reads it has run. Since the host runs ahead of the card,
the copy for batch N+1 overlaps step N's kernels. The buffers are
allocated (at the first batch of each signature, the shapes and dtypes
of its host leaves) and freed on the consuming thread too. The free sets
are kept per signature, each list at most `depth` long, and a staging
task is offered the oldest free set of each signature whose last copy
has completed; it fills the one that fits its batch, and the others go
back. At most `2 * depth` sets live at once: past that a batch whose
signature has no free set takes an idle set of a signature no batch of
the last `2 * depth` had, or, with none, is copied from its host tensors
unpinned. So the sets made depend on the batches' signatures, not on how
fast the card runs. A leaf already on a card is not staged: it passes
through as it is, and the pinned sets hold no slot for it.

`capture_spec=` takes a Trainer or a CachedStep (the card its
parameters live on), a device, or a placement over a mesh: a `Mesh`
(its first axis), a (mesh, axis, n) capture spec or a store (its
`batch_sharding()`); each batch is then this rank's block of rows
(`parallel.mesh.Sharding`: cut on the host by the staging task), which
a captured step over that store takes as it is. `RowPrefetcher`, the tiered-embedding prefetcher, raises (ROADMAP.md
Queue 1 [5d]). On the CPU (`device=mx.cpu()`) the tasks stage the whole
batch and nothing is pinned.

Telemetry (the JAX package's names):
  prefetch_depth            gauge      batches staged or in flight
  prefetch_batches          counter    batches delivered to the consumer
  prefetch_starved          counter    consumer arrived before the head
                                       slot was ready (input-bound step)
  prefetch_h2d_bytes        histogram  bytes staged a batch
  prefetch_h2d_seconds      histogram  a staging task's convert + pin time
  prefetch_h2d_sync         counter    synchronous host-to-device copies
                                       on a step's critical path,
                                       recorded by the captured step
                                       (`cachedop`) for a batch that
                                       arrives off its device
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque

import numpy as np
import torch

from . import engine
from .base import MXNetError
from .context import resolve_device
from .ndarray.ndarray import NDArray
from .observability import registry as _obs_registry
from .observability import tracer as _tracer

__all__ = ["DevicePrefetcher", "RowPrefetcher", "resolve_placement",
           "place", "record_sync_h2d", "sync_h2d_count",
           "reserve_blocking_slots", "release_blocking_slots",
           "DEFAULT_DEPTH"]

# double-buffered by default: a slot stages batch N+1 while the step
# consumes batch N. The depth is clamped to engine workers - 1 (a staging
# task may block on an engine-backed source, the DataLoader's batchify
# futures on the same pool: one worker must stay free)
DEFAULT_DEPTH = 2

_reg = _obs_registry()
_depth_gauge = _reg.gauge("prefetch_depth")
_starved = _reg.counter("prefetch_starved")
_batches_counter = _reg.counter("prefetch_batches")
_h2d_bytes = _reg.histogram("prefetch_h2d_bytes", base=1.0)
_h2d_seconds = _reg.histogram("prefetch_h2d_seconds")
_sync_h2d = _reg.counter("prefetch_h2d_sync")
_sync_h2d_bytes = _reg.counter("prefetch_h2d_sync_bytes")

# ---- staging slots that may BLOCK on engine work, across every pipeline:
# a staging task whose source is itself engine-backed (the DataLoader's
# pipelined batchify) holds its worker while it waits on that future; if
# such slots covered every worker, the tasks they wait on could never
# run. A pipeline granted 0 slots batchifies inline in its staging task.
_blocking_lock = threading.Lock()
_blocking_slots = 0
_depth_total = 0


def reserve_blocking_slots(want):
    """Reserve up to `want` staging slots for a pipeline whose source
    blocks on engine futures; returns the number granted (possibly 0:
    use an inline source then). Pair with `release_blocking_slots`."""
    global _blocking_slots
    with _blocking_lock:
        avail = max(0, engine.num_workers() - 1 - _blocking_slots)
        got = min(max(0, int(want)), avail)
        _blocking_slots += got
        return got


def release_blocking_slots(n):
    global _blocking_slots
    with _blocking_lock:
        _blocking_slots = max(0, _blocking_slots - max(0, int(n)))


def _depth_delta(d):
    # delta accounting: with several pipelines alive, set() calls of each
    # would overwrite the others' readings
    global _depth_total
    with _blocking_lock:
        _depth_total += d
        n = _depth_total
    _depth_gauge.set(n)
    if _tracer.ACTIVE:
        _tracer.counter("prefetch_depth", n)


def record_sync_h2d(nbytes=0):
    """Count one synchronous host-to-device copy on a step's critical
    path (a batch that reached the step off its device). The captured
    step calls this; it stays 0 when a DevicePrefetcher feeds the loop."""
    _sync_h2d.inc()
    _sync_h2d_bytes.inc(int(nbytes))


def sync_h2d_count():
    """Synchronous critical-path copies since start (or the registry's
    last reset)."""
    return _sync_h2d.value


def _unported(what, item):
    return MXNetError(f"prefetch: {what} is not ported yet (ROADMAP.md, "
                      f"Queue 1 {item})")


def resolve_placement(target):
    """Where a placement target stages batches:

      True                      -> mx.gpu(0)
      torch.device / str        -> that device (`context.resolve_device`)
      CachedStep / Trainer      -> the device its parameters live on
      Mesh                      -> this rank's rows over its first axis
      (mesh, axis, n)           -> this rank's rows over `axis`
      a store                   -> its `batch_sharding()`, or, when that
                                   is None, its device
      a `parallel.mesh.Sharding`-> itself
      None / False              -> None (no device staging)

    A row placement is a `parallel.mesh.Sharding` (its `.device` is this
    rank's device), everything else a `torch.device`."""
    from .parallel.mesh import Mesh, Sharding
    if target is None or target is False:
        return None
    if target is True:
        return resolve_device(None)
    if isinstance(target, (torch.device, str)):
        return resolve_device(target)
    if isinstance(target, Sharding):
        return target
    if isinstance(target, Mesh):
        return Sharding(target, (target.axis_names[0],))
    if isinstance(target, tuple) and len(target) == 3:
        return Sharding(target[0], (target[1],))
    if hasattr(target, "batch_sharding"):
        sh = target.batch_sharding()
        return sh if sh is not None else resolve_device(target.device)
    trainer = getattr(target, "_trainer", target)
    params = getattr(trainer, "_params", None)
    if params is not None:
        for p in params:
            if p._data is not None:
                return resolve_device(p._data._data.device)
        return resolve_device(None)
    raise TypeError(f"cannot resolve a device placement from "
                    f"{type(target).__name__!r}")


# ------------------------------------------------------------ batch trees
def _flatten(batch):
    """(leaves, rebuild): the arrays of a batch nested in tuples and
    lists, and the function that puts new leaves back in its shape."""
    if isinstance(batch, (tuple, list)):
        parts = [_flatten(b) for b in batch]
        sizes = [len(p[0]) for p in parts]

        def rebuild(leaves, parts=parts, sizes=sizes, kind=type(batch)):
            out, i = [], 0
            for (_, rb), n in zip(parts, sizes):
                out.append(rb(leaves[i:i + n]))
                i += n
            return kind(out)
        return [leaf for p in parts for leaf in p[0]], rebuild
    return [batch], lambda leaves: leaves[0]


def _host_tensor(leaf):
    """A leaf as a tensor, without touching the card: NDArrays give their
    tensor, numpy arrays and numbers go through numpy (float64 becomes
    float32, as `nd.array` makes it)."""
    if isinstance(leaf, NDArray):
        return leaf._data
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def place(batch, device):
    """Stage one batch onto `device` (or a row placement,
    `resolve_placement`) now, in the calling thread: the same structure
    with every leaf an NDArray there. To a card, a host leaf goes through
    a pinned buffer and a non-blocking copy on the current stream."""
    t0 = _time.perf_counter()
    rows, device = _split_placement(device)
    leaves, rebuild = _flatten(batch)
    host = [_host_tensor(x) for x in leaves]
    if rows is not None:
        host = [rows.local_rows(h) for h in host]
    out = []
    for t in host:
        if t.device == device:
            out.append(t)
        elif device.type == "cuda" and t.device.type == "cpu":
            out.append(t.pin_memory().to(device, non_blocking=True))
        else:
            out.append(t.to(device))
    _h2d_bytes.observe(_nbytes(host))
    _h2d_seconds.observe(_time.perf_counter() - t0)
    return rebuild([NDArray(t) for t in out])


def _split_placement(placement):
    """(row placement or None, device) of a `resolve_placement` result."""
    if isinstance(placement, torch.device) or placement is None:
        return None, placement
    return placement, placement.device


# sentinels a staging task may return instead of a batch
_EOF = object()       # the source iterator is exhausted
_DROPPED = object()   # the prefetcher was closed before the task ran


class _State:
    """State shared by the consumer and the staging tasks. Not the
    DevicePrefetcher itself: the tasks hold only this, so dropping the
    prefetcher runs its cleanup even while tasks are queued."""
    __slots__ = ("it", "closed", "exhausted")

    def __init__(self, it):
        self.it = it
        self.closed = False
        self.exhausted = False


class _Staged:
    """A staging task's result: the batch's leaves (CPU leaves in the
    pinned buffers of `pinned`, the offered set that fit, or None) and
    its rebuild function."""
    __slots__ = ("leaves", "rebuild", "pinned")

    def __init__(self, leaves, rebuild, pinned):
        self.leaves = leaves
        self.rebuild = rebuild
        self.pinned = pinned


def _signature(leaves):
    """What a pinned set must match: each host leaf's shape and dtype,
    None for a leaf already on a card."""
    return tuple(None if h.device.type != "cpu" else
                 (tuple(h.shape), h.dtype) for h in leaves)


def _matches(pinned, host):
    """Whether a pinned set fits a batch's leaves: a CPU buffer of the
    same shape and dtype for each CPU leaf, None for every other leaf.
    (The sets are allocated pinned by the consumer; `is_pinned()` would
    ask the driver, on an engine thread.)"""
    if pinned is None or len(pinned) != len(host):
        return False
    for p, h in zip(pinned, host):
        if h.device.type != "cpu":
            if p is not None:
                return False
        elif (p is None or p.device.type != "cpu" or p.shape != h.shape
              or p.dtype != h.dtype):
            return False
    return True


class DevicePrefetcher:
    """Iterate `source`, returning batches already on the device (see the
    module docstring).

        pf = DevicePrefetcher(loader, capture_spec=trainer)
        for tok, seg, vl, pos, lab, nsp in pf:
            loss = step(tok, seg, vl, pos, lab, nsp)
        pf.close()                   # (also: context manager / __del__)

    `source` is any iterable of batches (NDArrays, numpy arrays or
    tensors, nested in tuples or lists). A DataLoader handed in directly
    takes its host batches (`_host_iter(to_device=False)`) and joins the
    `reserve_blocking_slots` ledger as in the JAX package; granted no
    slots, its staging tasks batchify inline."""

    def __init__(self, source, depth=None, device=None, capture_spec=None):
        target = capture_spec if capture_spec is not None else device
        self._rows, self._device = _split_placement(resolve_placement(
            True if target is None else target))
        self._cuda = self._device.type == "cuda"
        depth = DEFAULT_DEPTH if depth is None else int(depth)
        self._reserved = 0
        self._group = engine.TaskGroup("prefetch")
        if hasattr(source, "_host_iter") and hasattr(source, "_plain_iter"):
            if getattr(source, "_prefetch", 0):
                self._reserved = reserve_blocking_slots(depth)
            source = source._host_iter(to_device=False) if self._reserved \
                else source._plain_iter(to_device=False)
            depth = self._reserved or depth
        self._depth = max(1, min(depth, max(1, engine.num_workers() - 1)))
        self._state = _State(iter(source))
        self._slot_vars = [engine.Var() for _ in range(self._depth)]
        self._src_var = engine.Var()
        self._pending = deque()
        self._slot = 0
        self._delivered = 0
        # the card's side: the copy stream, and the free pinned sets,
        # each with its signature and the event of its last copy, oldest
        # first (allocated, queried and freed on the consuming thread)
        self._stream = None
        self._pinned = deque()          # [(signature, set, event or None)]
        self._owned = []                # every live set
        self._max_pinned = 2 * self._depth
        self._recent = deque(maxlen=self._max_pinned)  # batch signatures
        for _ in range(self._depth):
            self._submit()

    # ------------------------------------------------------------ produce
    def _free_pinned(self):
        """The offer to the next staging task: of each signature, the
        oldest free set whose last copy has completed (copies complete in
        stream order, so a later one of that signature has not either).
        The task fills the one that fits its batch, or none (it then
        returns plain host tensors and the consumer stages them)."""
        offer, seen = [], set()
        for entry in list(self._pinned):
            sig, pinned, ev = entry
            if sig in seen:
                continue
            seen.add(sig)
            if ev is None or ev.query():
                self._pinned.remove(entry)
                offer.append((sig, pinned))
        return offer

    def _keep_free(self, sig, pinned, ev):
        """A set back on its signature's free list, which keeps at most
        `depth` sets (the oldest beyond that is freed)."""
        self._pinned.append((sig, pinned, ev))
        same = [e for e in self._pinned if e[0] == sig]
        if len(same) > self._depth:
            self._pinned.remove(same[0])
            if same[0][2] is not None:
                same[0][2].synchronize()
            self._drop_set(same[0][1])

    def _drop_set(self, pinned):
        """Free a set whose copies have completed; consuming thread only
        (freeing pinned memory records CUDA events)."""
        self._owned = [s for s in self._owned if s is not pinned]

    def _submit(self):
        st = self._state
        if st.closed or st.exhausted:
            return False
        slot = self._slot
        self._slot = (self._slot + 1) % self._depth
        offer = self._free_pinned() if self._cuda else []
        # the task reaches its offer through `holder`, which the consumer
        # empties: the last reference to a set then lies on the consuming
        # thread, never in a closure an engine worker still holds
        holder = [offer] if offer else []
        on_host = self._cuda
        device = self._device
        rows = self._rows

        def prefetch_stage(st=st, holder=holder):
            # host work only: no CUDA call on an engine thread
            if st.closed:
                return _DROPPED
            try:
                item = next(st.it)
            except StopIteration:
                st.exhausted = True
                return _EOF
            if st.closed:
                return _DROPPED
            t0 = _time.perf_counter()
            leaves, rebuild = _flatten(item)
            host = [_host_tensor(x) for x in leaves]
            if rows is not None:
                # this rank's rows of the global batch: a view, no
                # copy and no CUDA call
                host = [rows.local_rows(h) for h in host]
            if not on_host:
                out = rebuild([NDArray(t if t.device == device
                                       else t.to(device)) for t in host])
            else:
                fit = next((p for _, p in (holder[0] if holder else ())
                            if _matches(p, host)), None)
                out = _Staged(host if fit is None else
                              [h if p is None else p.copy_(h)
                               for p, h in zip(fit, host)], rebuild, fit)
            _h2d_bytes.observe(_nbytes(host))
            _h2d_seconds.observe(_time.perf_counter() - t0)
            return out

        def traced_stage():
            with _tracer.span("prefetch:stage", cat="data"):
                return prefetch_stage()
        fn = traced_stage if _tracer.ACTIVE else prefetch_stage
        try:
            fut = engine.push(fn, write_vars=(self._slot_vars[slot],
                                              self._src_var),
                              priority=engine.PRIORITY_BACKGROUND,
                              group=self._group)
        except engine.EngineQueueFull:
            # a bounded background class under `reject`: stage this slot
            # here instead of raising out of the training loop, after
            # every stage in flight (they serialize on the source var)
            try:
                engine.wait_for_var(self._src_var)
            except BaseException as poison:
                # an earlier stage failed and __next__'s recovery has not
                # run: advancing the source here would lose an item
                fut = engine.failed_future(poison)
            else:
                fut = engine.inline_future(fn)
        self._pending.append((fut, holder))
        _depth_delta(+1)
        return True

    # ------------------------------------------------------------ consume
    def _make_room(self, sig):
        """Whether a new set may be allocated for a batch of signature
        `sig`: under the cap, or after freeing an idle set (its copy
        completed) of a signature none of the recent batches had."""
        if len(self._owned) < self._max_pinned:
            return True
        for entry in self._pinned:
            osig, old, ev = entry
            if osig != sig and osig not in self._recent and \
                    (ev is None or ev.query()):
                self._pinned.remove(entry)
                self._drop_set(old)
                return True
        return False

    def _to_card(self, staged, offer):
        """Issue the copies of one staged batch on the side stream, make
        the current stream wait for them, and keep the pinned set until
        they complete. `offer` is what the staging task was offered
        ([(signature, set)]); the sets it did not fill go back. Consuming
        thread only."""
        dev = self._device
        cur = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        # the engine may hold the task's future (a later task's
        # dependency) past this batch: its result must not keep the set
        leaves, staged.leaves = staged.leaves, None
        pinned, staged.pinned = staged.pinned, None
        self._return_unused([(sg, p) for sg, p in offer or ()
                             if p is not pinned])
        sig = _signature(leaves)
        self._recent.append(sig)
        if pinned is None and any(h.device.type == "cpu" for h in leaves) \
                and self._make_room(sig):
            # first batch of this signature, or no set of it was free:
            # new buffers, allocated here on the consuming thread
            pinned = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                      if h.device.type == "cpu" else None for h in leaves]
            leaves = [h if p is None else p.copy_(h)
                      for p, h in zip(pinned, leaves)]
            self._owned.append(pinned)
        # the copies read the pinned buffers once the step's earlier work
        # is queued, not once it has run: the side stream does not wait
        # for the current one
        with torch.cuda.stream(self._stream):
            out = [h if h.device == dev else h.to(dev, non_blocking=True)
                   for h in leaves]
        ev = torch.cuda.Event()
        ev.record(self._stream)
        cur.wait_event(ev)
        for t, h in zip(out, leaves):
            if t is not h:
                t.record_stream(cur)
        if pinned is not None:
            self._keep_free(sig, pinned, ev)
        return staged.rebuild([NDArray(t) for t in out])

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if not self._pending:
                raise StopIteration
            fut, holder = self._pending.popleft()
            offer = holder.pop() if holder else None
            _depth_delta(-1)
            was_ready = fut.done()
            try:
                res = fut.result()
            except BaseException:
                # a staging failure taints every slot in flight (the vars
                # carry its root cause): drop the queue, re-arm on fresh
                # vars, and raise it once; the next call goes on with the
                # next batch
                self._return_unused(offer)
                self._drop_pending()
                self._slot_vars = [engine.Var() for _ in range(self._depth)]
                self._src_var = engine.Var()
                self._slot = 0
                for _ in range(self._depth):
                    self._submit()
                raise
            if res is _EOF or res is _DROPPED or engine.skipped(res):
                self._return_unused(offer)
                if engine.skipped(res):
                    # shed by a bounded background queue before it ran:
                    # the source did not advance, so stage it again
                    self._submit()
                continue
            if not was_ready and self._delivered >= self._depth:
                # the step got here first with a real batch pending: an
                # input-bound step (the first `depth` fill the pipeline)
                _starved.inc()
            self._delivered += 1
            _batches_counter.inc()
            if isinstance(res, _Staged):
                res = self._to_card(res, offer)
            self._submit()
            return res

    next = __next__

    def _return_unused(self, offer):
        """Offered sets a task did not fill go back as free, at the front
        (their last copies completed before they were offered)."""
        for sig, pinned in reversed(offer or ()):
            self._pinned.appendleft((sig, pinned, None))

    @property
    def depth(self):
        return self._depth

    @property
    def in_flight(self):
        """Slots currently staged or staging (the depth gauge's value)."""
        return len(self._pending)

    # ------------------------------------------------------------ cleanup
    def _drop_pending(self):
        # the dropped tasks will not fill their sets (a failure poisons
        # every later stage; close() drains them first): back to the pool
        while self._pending:
            _, holder = self._pending.popleft()
            if holder:
                self._return_unused(holder.pop())
            _depth_delta(-1)

    def close(self):
        """Drop the pipeline: queued staging tasks are cancelled through
        the TaskGroup, running ones become no-ops through the closed
        flag, and a generator source is closed (an abandoned epoch must
        not go on reading the dataset). Tasks still running are waited
        for, so that their pinned sets are released on this thread and
        no task reads the source once close() has returned."""
        st = self._state
        if st.closed:
            return
        st.closed = True
        self._group.cancel()
        self._group.drain()
        self._drop_pending()
        release_blocking_slots(self._reserved)
        self._reserved = 0
        it_close = getattr(st.it, "close", None)
        if it_close is not None:
            try:
                it_close()
            except Exception:
                pass    # a worker may be inside next() on the generator
        if self._cuda and self._stream is not None:
            # the last copies must complete before their buffers go
            self._stream.synchronize()
        self._pinned.clear()
        self._owned.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RowPrefetcher:
    """Row prefetch for tiered embedding tables (`mxnet_tpu/prefetch.py`
    `RowPrefetcher`): the tiered tables are ROADMAP.md Queue 1 [5d]."""

    def __init__(self, source, trainer, tables, capture_spec=None):
        raise _unported("RowPrefetcher (tiered embedding tables)", "[5d]")
