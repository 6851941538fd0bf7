"""mx.io data iterators (counterpart of `mxnet_tpu/io.py`; reference:
python/mxnet/io/).

NDArrayIter & friends with the reference's DataBatch / DataDesc
protocol. `ImageRecordIter` reads RecordIO packs of JPEG / PNG records
(the .idx sidecar, else the native mmap reader, else a sequential
stream) through the port's codec, or makes a deterministic synthetic
stream when no file is given (offline testing).

Batches are assembled in host memory and delivered on each iterator's
`ctx` (None = `mx.gpu(0)`, which raises without a card; `ctx=mx.cpu()`
for the CPU): `_next_host()` makes a batch on the CPU, `next()` moves it
to `ctx` on the calling thread. `PrefetchingIter` runs `_next_host()`
in an engine task (host work only: no CUDA call on an engine thread)
and stages the batches onto their device through a
`prefetch.DevicePrefetcher`: pinned buffers filled by the task, copies
issued by the consuming thread on a side stream.

`LibSVMIter` (sparse batches) raises: ROADMAP.md Queue 1 [2];
`ImageDetRecordIter` raises: [8].
"""
from __future__ import annotations

import os
from collections import deque, namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _env
from . import engine
from .base import MXNetError
from .context import cpu, resolve_device
from .fault import injection as _finj
from .fault import retry as _retry
from .ndarray.ndarray import NDArray, array
from .observability import registry as _obs_registry

_reg = _obs_registry()
_skipped_counter = _reg.counter("data_records_skipped")

_io_policy = None


def _read_policy():
    global _io_policy
    if _io_policy is None:
        # retry only plausibly-TRANSIENT read errors (OSError, plus the
        # injectable fault for chaos testing); deterministic corruption
        # (bad magic, truncated payload) goes straight to the bounded
        # skip path instead of burning 3 backoff sleeps per bad record
        _io_policy = _retry.policy_from_env(
            "MXTPU_IO", max_retries=3, base_delay=0.02, max_delay=0.5,
            deadline=30.0, name="io_read",
            retry_on=(OSError, _finj.FaultInjected))
    return _io_policy


__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "ImageRecordIter", "CSVIter", "LibSVMIter",
           "MNISTIter", "ImageDetRecordIter"]

DataDesc = namedtuple("DataDesc", ["name", "shape"])


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None, bucket_key=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label
        self.bucket_key = bucket_key  # BucketingModule routing


def _on(arrays, device):
    return None if arrays is None else [
        a if a._data.device == device else NDArray(a._data.to(device))
        for a in arrays]


def _batch_to(batch, device):
    """`batch` with its data and label NDArrays on `device` (moved in
    the calling thread)."""
    batch.data = _on(batch.data, device)
    batch.label = _on(batch.label, device)
    return batch


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        raise NotImplementedError

    def __next__(self):
        return self.next()

    @property
    def provide_data(self):
        raise NotImplementedError

    @property
    def provide_label(self):
        raise NotImplementedError


def _init_data(data, default_name):
    """[(name, NDArray in host memory)]: float64 sources become float32;
    an NDArray on a card is copied to the host here, so that a batch is
    gathered without the card (`_next_host` may run on an engine
    thread)."""
    if data is None:
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{i if i else ''}" if len(data) > 1
                else default_name: d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = NDArray(v._data.detach().cpu())
        else:
            v = np.asarray(v)
            v = array(v.astype(np.float32) if v.dtype == np.float64 else v,
                      ctx=cpu())
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.NDArrayIter), with
    batches on `ctx`. A final partial batch is padded from the start of
    the order ("pad", and "roll_over", as in the JAX package) or dropped
    ("discard")."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None):
        super().__init__(batch_size)
        self._device = resolve_device(ctx)
        self.data = _init_data(data, data_name)
        self.label = _init_data(label, label_name)
        self.num_data = self.data[0][1].shape[0]
        self._shuffle = shuffle
        self._last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._order = np.arange(self.num_data)
        if shuffle:
            np.random.shuffle(self._order)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:])
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:])
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self._shuffle:
            np.random.shuffle(self._order)

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _next_host(self):
        if not self.iter_next():
            raise StopIteration
        lo = self.cursor
        hi = min(lo + self.batch_size, self.num_data)
        idx = self._order[lo:hi]
        pad = 0
        if hi - lo < self.batch_size:
            if self._last_batch_handle == "discard":
                raise StopIteration
            pad = self.batch_size - (hi - lo)
            idx = np.concatenate([idx, self._order[:pad]])

        def take(arrs):
            return [NDArray(v._data[torch.from_numpy(idx)]) for _, v in arrs]
        return DataBatch(take(self.data), take(self.label), pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self):
        return _batch_to(self._next_host(), self._device)

    def getdata(self):
        return [v for _, v in self.data]

    def getlabel(self):
        return [v for _, v in self.label]


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches (reference)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    @property
    def _device(self):
        return getattr(self.data_iter, "_device", None)

    def _advance(self, fetch):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = fetch(self.data_iter)
        except StopIteration:
            self.data_iter.reset()
            batch = fetch(self.data_iter)
        self.cur += 1
        return batch

    def _next_host(self):
        return self._advance(_host_next)

    def next(self):
        return self._advance(lambda it: it.next())


def _host_next(it):
    """The backing iterator's next batch in host memory where it can make
    one (the port's iterators), else its `next()`."""
    fn = getattr(it, "_next_host", None)
    return fn() if fn is not None else it.next()


class _HostBatches:
    """`it`'s host batches as [data, label] for a DevicePrefetcher (read
    in its engine tasks); each batch's other fields go to `meta`, in the
    same order. An error of the backing iterator reaches the consumer
    once, and the next call goes on with its next batch."""

    def __init__(self, it, st, meta):
        self._it, self._st, self._meta = it, st, meta

    def __iter__(self):
        return self

    def __next__(self):
        if self._st["closed"]:
            raise StopIteration
        batch = _host_next(self._it)
        self._meta.append((batch.pad, batch.index, batch.provide_data,
                           batch.provide_label, batch.bucket_key))
        return [list(batch.data), list(batch.label or [])]


class PrefetchingIter(DataIter):
    """Threaded prefetch wrapper (reference: PrefetchingIter) on the
    dependency engine: the next batch is made by an engine task while
    the consumer works on this one.

    The task calls the backing iterator's `_next_host()` (decode and
    augmentation on the CPU), and the batches reach their device through
    a `prefetch.DevicePrefetcher`: `prefetch_to_device=` (True, a device,
    a Trainer / CachedStep; `prefetch.resolve_placement`) or, without
    it, the backing iterator's own `ctx`. On a card the task fills pinned
    buffers and the consuming thread issues the copies on a side stream,
    so no engine thread touches the card. A backing iterator that is not
    the port's (no `ctx`) and no `prefetch_to_device`: its `next()` runs
    in a task of this iterator's own TaskGroup, so it must make host
    batches (a `contrib.io.DataLoaderIter` over a `ctx=mx.cpu()` loader,
    say), which are handed over as they are.

    `close()` (also `__del__`) drops the queued fetch: abandoning the
    iterator mid-epoch must not leave engine work running; `reset()`
    reopens it."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_to_device=None):
        iters = iters if isinstance(iters, (list, tuple)) else [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter supports one backing iter")
        super().__init__(iters[0].batch_size)
        self.iter = iters[0]
        if prefetch_to_device not in (None, False):
            from .prefetch import resolve_placement
            self._placement = resolve_placement(prefetch_to_device)
        else:
            self._placement = getattr(self.iter, "_device", None)
        # the fetch closures must NOT capture self (a queued task would
        # keep the iterator alive and __del__ cleanup could never fire
        # while the very fetch it should drop is pending) — shared
        # mutable state rides in this dict instead, like prefetch._State
        self._fstate = {"closed": False}
        self._pending = None
        self._pf = None
        self._meta = deque()
        self._fetch_group = engine.TaskGroup("prefetch_iter")
        self._start()

    @property
    def _closed(self):
        return self._fstate["closed"]

    def _start(self):
        if self._placement is None:
            self._submit()
            return
        from .prefetch import DevicePrefetcher
        self._meta.clear()
        self._pf = DevicePrefetcher(_HostBatches(self.iter, self._fstate,
                                                 self._meta),
                                    device=self._placement)

    def _submit(self):
        st = self._fstate
        it = self.iter

        def fetch(st=st, it=it):
            if st["closed"]:
                return None
            try:
                return it.next()
            except StopIteration:
                return None
        self._fetch_fn = fetch      # inline fallback for SHED tasks
        try:
            self._pending = self._fetch_group.push(
                fetch, priority=engine.PRIORITY_BACKGROUND)
        except engine.EngineQueueFull:
            # bounded background class (`reject` policy): degrade to the
            # shed path — next() sees the skip sentinel and fetches inline
            self._pending = engine.skipped_future()

    def close(self):
        """Drop the in-flight prefetch: a still-queued fetch never runs
        (TaskGroup cancel), an in-flight one no-ops via the closed flag.
        reset() reopens the iterator."""
        self._fstate["closed"] = True
        if self._pf is not None:
            self._pf.close()
        self._fetch_group.cancel()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def reset(self):
        # drain the in-flight fetch WITHOUT re-raising: reset() is the
        # recovery point, so the iterator must be reusable afterwards
        if self._pf is not None:
            self._pf.close()
            self._pf = None
        if self._pending is not None:
            try:
                self._pending.result()
            except BaseException:
                pass
        self._pending = None
        self._fstate["closed"] = False  # close() is undone by a reset()
        self.iter.reset()
        self._start()

    def next(self):
        if self._closed:
            raise StopIteration         # closed mid-epoch; reset() reopens
        if self._pf is not None:
            data, label = next(self._pf)
            pad, index, pdata, plabel, key = self._meta.popleft()
            return DataBatch(data, label or None, pad=pad, index=index,
                             provide_data=pdata, provide_label=plabel,
                             bucket_key=key)
        if self._pending is None:       # recovering from a surfaced error
            self._submit()
        try:
            # EOF is a None batch (the fetch converts StopIteration);
            # only worker errors re-raise out of the future
            batch = self._pending.result()
            if engine.skipped(batch):
                # shed by a bounded background queue before it ran (the
                # backing iter never advanced): fetch inline
                batch = self._fetch_fn()
        except BaseException:
            # surface the worker error once; the next call prefetches
            # the following batch
            self._pending = None
            raise
        if batch is None:
            raise StopIteration         # EOF: repeated next() re-raises
        self._submit()
        return batch


class ImageRecordIter(DataIter):
    """ImageRecordIter: reads a RecordIO .rec of JPEG / PNG records when
    `path_imgrec` exists (reference: io.ImageRecordIter over
    src/io/iter_image_recordio_2.cc); otherwise produces the deterministic
    synthetic stream (offline testing). Batches on `ctx`.

    Images are decoded (the port's codec), resized to data_shape where
    they differ (PIL's `Image.resize` default, bicubic widened by the
    scale with 8-bit passes: `F.interpolate` bicubic, antialiased, on
    uint8), CHW float32, mean/std-normalised like the reference's
    on-the-fly augmenter. Undecodable or unreadable records are skipped
    and counted (`data_records_skipped`) up to `max_bad_records` an
    epoch (default `MXTPU_MAX_BAD_RECORDS`, 16); reads retry per the
    `MXTPU_IO` policy; fault points `io.read` and `io.decode`."""

    def __init__(self, path_imgrec=None, data_shape=(3, 224, 224),
                 batch_size=32, num_samples=1024, num_classes=1000,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0, mean_g=0, mean_b=0, std_r=1, std_g=1, std_b=1,
                 seed=0, max_bad_records=None, ctx=None, **kwargs):
        super().__init__(batch_size)
        self._device = resolve_device(ctx)
        self.data_shape = tuple(data_shape)
        self.num_samples = num_samples
        self.num_classes = num_classes
        self._seed = seed
        self.cursor = 0
        # bounded bad-record tolerance (reference: the C++ iter logs and
        # skips undecodable records): per-epoch budget, lifetime tally
        if max_bad_records is None:
            max_bad_records = _env.env_int("MXTPU_MAX_BAD_RECORDS", 16,
                                           minimum=0)
        self.max_bad_records = max_bad_records
        self.records_skipped = 0      # lifetime, mirrors the global metric
        self._epoch_skipped = 0
        self._mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self._std = np.array([std_r or 1, std_g or 1, std_b or 1], np.float32)
        # Streaming reader: never load the whole .rec into host memory.
        # With an .idx sidecar, random access via MXIndexedRecordIO;
        # without, the native mmap reader; else sequential reads.
        self._rec = None
        self._keys = None
        if path_imgrec is not None and os.path.exists(path_imgrec):
            from .recordio import (MXRecordIO, MXIndexedRecordIO,
                                   NativeRecordFile)
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self._keys = self._rec.keys
                self.num_samples = len(self._keys)
            else:
                try:
                    # _keys is a range (identity, O(1) memory)
                    native = NativeRecordFile(path_imgrec)
                    self._rec = native
                    self._keys = range(len(native))
                    self.num_samples = len(native)
                except MXNetError:
                    self._rec = MXRecordIO(path_imgrec, "r")
                    self.num_samples = None  # unknown: EOF ends epoch

    def _decode(self, raw):
        from .recordio import unpack_img
        c, h, w = self.data_shape
        header, img = unpack_img(raw, iscolor=0 if c == 1 else 1)
        if img.shape[:2] != (h, w):
            t = torch.from_numpy(img)
            t = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
            t = F.interpolate(t, size=(h, w), mode="bicubic",
                              align_corners=False, antialias=True)[0]
            img = (t[0] if c == 1 else t.permute(1, 2, 0)).numpy()
        x = img.astype(np.float32)
        if c == 1:
            x = (x - self._mean[0]) / self._std[0]
            x = x[None]                              # (1, H, W)
        else:
            x = ((x - self._mean) / self._std).transpose(2, 0, 1)
        label = header.label if np.ndim(header.label) else float(header.label)
        return x, np.float32(label)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self.cursor = 0
        self._epoch_skipped = 0    # the bad-record budget is per epoch
        if self._rec is not None and self._keys is None:
            self._rec.reset()      # sequential stream: rewind the file

    def _next_raw(self, i):
        if self._keys is not None:
            if hasattr(self._rec, "read_idx"):       # .idx sidecar path
                return self._rec.read_idx(self._keys[i])
            return self._rec[self._keys[i]]          # native mmap reader
        return self._rec.read()    # sequential; None at EOF

    def _read_raw(self, i):
        """One record read with the io.read fault point + retry/backoff.
        Random-access reads (idx sidecar / native mmap) are idempotent
        and retry per the MXTPU_IO policy; the sequential stream cannot
        reposition, so its errors propagate after a single attempt."""
        def attempt():
            if _finj.ENABLED:
                _finj.check("io.read", context=f"record {i}")
            return self._next_raw(i)
        if self._keys is not None:
            return _read_policy().call(attempt)
        return attempt()

    def _skip_bad_record(self, i, exc):
        """Bounded skip of an undecodable/unreadable record. Over-budget
        raises: a mostly-corrupt shard is a data outage, not noise."""
        self.records_skipped += 1
        self._epoch_skipped += 1
        _skipped_counter.inc()
        from .log import get_logger
        get_logger("mxnet_tpu_torch.io").warning(
            "skipping corrupt record %s (%s skipped this epoch): %r",
            i, self._epoch_skipped, exc)
        if self._epoch_skipped > self.max_bad_records:
            raise MXNetError(
                f"ImageRecordIter: {self._epoch_skipped} bad records in "
                f"one epoch exceeds max_bad_records={self.max_bad_records}"
            ) from exc

    def _next_host(self):
        if self._rec is not None:
            decoded = []
            while len(decoded) < self.batch_size:
                if self.num_samples is not None and \
                        self.num_samples - self.cursor < \
                        self.batch_size - len(decoded):
                    # epoch end: too few records left to complete this
                    # batch — stop WITHOUT consuming them, so tail records
                    # that can't ship are neither decoded nor charged
                    # against the bad-record budget
                    raise StopIteration
                i = self.cursor
                self.cursor += 1
                try:
                    raw = self._read_raw(i)
                except Exception as e:
                    if self._keys is None:
                        raise             # sequential: cannot reposition
                    self._skip_bad_record(i, e)
                    continue
                if raw is None:
                    raise StopIteration   # sequential EOF mid-batch
                try:
                    if _finj.ENABLED:
                        _finj.check("io.decode", context=f"record {i}")
                    decoded.append(self._decode(raw))
                except Exception as e:
                    self._skip_bad_record(i, e)
            data = np.stack([d for d, _ in decoded])
            label = np.array([l for _, l in decoded], np.float32)
        else:
            if self.num_samples is not None and \
                    self.cursor + self.batch_size > self.num_samples:
                raise StopIteration
            rng = np.random.RandomState(self._seed + self.cursor)
            data = rng.rand(self.batch_size,
                            *self.data_shape).astype(np.float32)
            label = (np.arange(self.cursor, self.cursor + self.batch_size)
                     % self.num_classes).astype(np.float32)
            self.cursor += self.batch_size
        return DataBatch([array(data, ctx=cpu())], [array(label, ctx=cpu())],
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self):
        return _batch_to(self._next_host(), self._device)


class _InnerIter(DataIter):
    """An iterator over arrays loaded at construction (an NDArrayIter
    inside)."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def _next_host(self):
        return self._inner._next_host()

    def next(self):
        return self._inner.next()

    @property
    def _device(self):
        return self._inner._device


class CSVIter(_InnerIter):
    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, ctx=None, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32) \
            if label_csv else np.zeros(len(data), np.float32)
        self._inner = NDArrayIter(data, label, batch_size, ctx=ctx)


class LibSVMIter(DataIter):
    """LibSVM-format reader (reference: io.LibSVMIter, CSR batches):
    sparse arrays are ROADMAP.md Queue 1 [2]."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, **kwargs):
        raise MXNetError("io.LibSVMIter yields sparse (CSR) batches; sparse "
                         "arrays are not ported yet (ROADMAP.md, Queue 1 "
                         "[2])")


class MNISTIter(_InnerIter):
    """idx-format MNIST reader (reference: io.MNISTIter / iter_mnist.cc).

    `image`/`label` point at idx files (idx3-ubyte images, idx1-ubyte
    labels; .gz accepted). flat=True yields (N, 784) instead of
    (N, 1, 28, 28); images scale to [0, 1) like the reference's
    default input_shape path."""

    def __init__(self, image, label, batch_size=128, shuffle=False,
                 flat=False, seed=0, ctx=None, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_idx(image, magic=2051)
        labs = self._read_idx(label, magic=2049)
        if len(imgs) != len(labs):
            raise MXNetError(f"MNISTIter: {len(imgs)} images vs "
                             f"{len(labs)} labels")
        data = imgs.astype(np.float32) / 255.0
        data = data.reshape(len(data), -1) if flat \
            else data.reshape(len(data), 1, *imgs.shape[1:])
        if shuffle:
            order = np.random.RandomState(seed).permutation(len(data))
            data, labs = data[order], labs[order]
        self._inner = NDArrayIter(data, labs.astype(np.float32),
                                  batch_size, ctx=ctx)

    @staticmethod
    def _read_idx(path, magic):
        import gzip
        import struct
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rb") as f:
            raw = f.read()
        try:
            got_magic, = struct.unpack(">i", raw[:4])
        except struct.error as e:
            raise MXNetError(f"MNISTIter: {path} truncated ({e})") from e
        if got_magic != magic:
            raise MXNetError(f"MNISTIter: {path} has magic {got_magic}, "
                             f"expected {magic} (idx format)")
        ndim = got_magic % 256
        try:
            dims = struct.unpack(f">{ndim}i", raw[4:4 + 4 * ndim])
            return np.frombuffer(raw[4 + 4 * ndim:],
                                 np.uint8).reshape(dims)
        except (struct.error, ValueError) as e:
            raise MXNetError(
                f"MNISTIter: {path} inconsistent idx payload ({e})") from e


def ImageDetRecordIter(batch_size, data_shape, path_imgrec=None, **kwargs):
    """Detection record iterator (reference: io.ImageDetRecordIter): the
    detection pipeline is ROADMAP.md Queue 1 [8]."""
    raise MXNetError("io.ImageDetRecordIter belongs to the detection "
                     "pipeline, which is not ported yet (ROADMAP.md, Queue "
                     "1 [8])")
