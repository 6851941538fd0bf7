"""DataLoader (counterpart of `mxnet_tpu/gluon/data/dataloader.py`;
reference: python/mxnet/gluon/data/dataloader.py).

The reference forks worker processes that serialise batches over shared
memory. Here, as in the JAX package, batches are assembled by the
dependency engine's worker threads (`mx.engine`): up to `prefetch`
batchify tasks in a `TaskGroup` at PRIORITY_BACKGROUND run ahead of
consumption, so host batching overlaps the device's compute.

Host first, then the card. A batchify task builds the batch in host
memory (the vision datasets give host samples, and `default_batchify_fn`
stacks them on the CPU); the consuming thread then moves it to the
loader's device (`ctx`, None = `mx.gpu(0)`), so the caller still gets
NDArrays on the device. No engine thread touches the card: a background
task that launched CUDA work on its own thread would break a CUDA graph
being captured meanwhile (`Trainer.capture`).

Device mode (`prefetch_to_device=`, as in the JAX package): the host
batches stage through a `prefetch.DevicePrefetcher`, whose engine tasks
collate each batch into pinned host buffers while the consuming thread
issues the copies to the card on a side stream, so that a step's inputs
are on the card, in flight ahead of it, with no synchronous copy on its
path. Pass True (the loader's `ctx`), a device, or a Trainer /
CachedStep (the card its parameters live on). `pin_memory=True` means
pinned host buffers, and turns this staging on where
`prefetch_to_device` is not given; an explicit `prefetch_to_device=False`
keeps the host path (the JAX package's opt-out). On `ctx=mx.cpu()` the
staging tasks deliver CPU batches and nothing is pinned.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ... import engine
from ...context import cpu, resolve_device
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: default_batchify_fn), in
    host memory: NDArray samples stack into an NDArray on the CPU, tuples
    batchify field by field, anything else goes through numpy (float64
    becomes float32). `DataLoader` moves the result to its device."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d._data.to(cpu()) for d in data]))
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(s)) for s in zip(*data))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return NDArray(torch.from_numpy(np.ascontiguousarray(arr)))


def _to_device(batch, device):
    """`batch` (NDArrays, numpy arrays, tensors, nested in tuples or
    lists) with every array an NDArray on `device`."""
    if isinstance(batch, NDArray):
        return batch if batch._data.device == device \
            else NDArray(batch._data.to(device))
    if isinstance(batch, torch.Tensor):
        return NDArray(batch.to(device))
    if isinstance(batch, np.ndarray):
        arr = batch.astype(np.float32) if batch.dtype == np.float64 \
            else batch
        return NDArray(torch.as_tensor(arr).to(device))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, device) for b in batch)
    return batch


class DataLoader:
    """Loads a dataset in mini-batches. The reference's arguments, plus
    `ctx`: the device the batches are delivered on (None = `mx.gpu(0)`,
    which raises without a card; `ctx=mx.cpu()` for the CPU).
    `prefetch_to_device` and `pin_memory` stage through a
    `DevicePrefetcher` (module docstring).
    `num_workers` sets the default `prefetch` (2 x max(num_workers, 1)
    batches ahead); the engine's threads do the work. `thread_pool` and
    `timeout` are accepted for the reference signature."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, prefetch_to_device=None,
                 ctx=None):
        self._device = resolve_device(ctx)
        if pin_memory and prefetch_to_device is None:
            prefetch_to_device = True
        if prefetch_to_device is True:
            prefetch_to_device = self._device
        self._prefetch_to_device = prefetch_to_device
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with explicit "
                                 "sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(num_workers, 1))

    def __len__(self):
        return len(self._batch_sampler)

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def _host_iter(self, to_device=True):
        """Host-batch pipeline: up to `prefetch` batchify tasks in flight
        on the engine; each batch is moved to the loader's device in the
        consuming thread, or left on the host with `to_device=False` (the
        DevicePrefetcher's source). Abandoning the generator mid-epoch
        (early break / GC) cancels queued tasks and no-ops in-flight ones:
        an abandoned epoch must not keep consuming the dataset."""
        if self._prefetch == 0:
            yield from self._plain_iter(to_device)
            return
        state = {"closed": False}
        pending = deque()
        it = iter(self._batch_sampler)
        group = engine.TaskGroup("dataloader")

        def submit():
            try:
                indices = next(it)
            except StopIteration:
                return False

            def make_batch(idx=indices):
                if state["closed"]:
                    return None
                return self._make_batch(idx)
            try:
                fut = group.push(make_batch,
                                 priority=engine.PRIORITY_BACKGROUND)
            except engine.EngineQueueFull:
                # bounded background class under the `reject` policy:
                # backpressure must not crash the epoch — the skipped
                # path below batchifies inline, same as a shed task
                fut = engine.skipped_future()
            pending.append((fut, indices))
            return True

        try:
            for _ in range(self._prefetch):
                if not submit():
                    break
            while pending:
                fut, indices = pending.popleft()
                submit()
                batch = fut.result()
                if engine.skipped(batch):
                    # the batchify task was SHED by a bounded background
                    # queue (engine.set_queue_limit) before it ran: its
                    # sampler indices are known, so batchify inline —
                    # backpressure must not drop training batches
                    batch = self._make_batch(indices)
                yield _to_device(batch, self._device) if to_device \
                    else batch
        finally:
            state["closed"] = True
            # queued batchify tasks never run (futures resolve to
            # engine.CANCELLED); in-flight ones no-op via the closed flag
            group.cancel()
            pending.clear()

    def _plain_iter(self, to_device=True):
        """Unpipelined batchify (the prefetch=0 path), in whichever thread
        iterates it: the consumer, or a staging task."""
        for indices in self._batch_sampler:
            batch = self._make_batch(indices)
            yield _to_device(batch, self._device) if to_device else batch

    def _device_iter(self):
        """The device pipeline: this loader's host batches feed a
        DevicePrefetcher (which takes slots of the blocking ledger for
        the engine-backed batchify, or batchifies inline in its staging
        tasks when granted none)."""
        from ...prefetch import DevicePrefetcher
        pf = DevicePrefetcher(self, device=self._prefetch_to_device)
        try:
            yield from pf
        finally:
            pf.close()

    def __iter__(self):
        if self._prefetch_to_device not in (None, False):
            return self._device_iter()
        return self._host_iter()

