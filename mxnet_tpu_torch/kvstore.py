"""The key-value store and the distributed bootstrap (counterpart of
`mxnet_tpu/kvstore.py`; reference: python/mxnet/kvstore.py).

`init_distributed` / `reset_distributed` set up the default
`torch.distributed` process group that `parallel.make_mesh` cuts into
named axes: NCCL on the card, the default, or gloo when the caller asks
for the CPU (`device="cpu"`); without a CUDA device and without that
request they raise `MXNetError`, and nothing falls back to gloo when
NCCL fails.

The JAX package is single-controller: one process holds every device and
a gradient computed over a batch sharded on `dp` is already global. The
port runs one process a card, so the store's kinds map so
(`create`, the JAX names and aliases kept):

  * 'local' / 'device' ('nccl' is an alias of 'device'): aggregation in
    one process. Values pushed for a key are summed in the order given,
    a pull broadcasts.
  * 'ici' ('dist', 'dist_sync', 'dist_device_sync', 'dist_async',
    'horovod'): the cross-rank store over the default group, or over
    the `dp` line of a mesh attached with `set_mesh`. A gradient here is
    always this rank's own, so `allreduce_flat` (the Trainer's path,
    one collective a bucket) sums it over the group whether or not a
    mesh is attached; the JAX package skips that sum under a mesh,
    where its gradients are global arrays already.

`allreduce_` keeps the JAX layouts. "replicated": the same value on
every rank, nothing to sum. "stacked": this rank's block of a stack of
replica rows (what `shard_batch` and the prefetcher hand out), summed
and reduced away. "auto", which the JAX package resolves from an array's
`.sharding`, has nothing to read on a tensor, so over a multi-rank mesh
it raises and the caller names the layout. With no mesh, a multi-rank
'ici' store sums across ranks (`allreduce_process_sum`), as the JAX
package's multi-process path does, unless the layout says "replicated".

The captured step (`cachedop.py`) reduces inside its CUDA graph through
`capture_spec` and the `graph_*` helpers: plain NCCL collectives on the
mesh's `dp` group, legal in capture once the group's communicator exists.
Gradient compression ('int8', '2bit') engages on stacked pushes, with
error-feedback residuals; each rank quantizes its own sum and the codes
are all-gathered (a sum of codes means nothing), then dequantized and
summed locally. `MXTPU_COLLECTIVE_TIMEOUT_MS` bounds a host-blocking
collective (`CollectiveTimeout`). `set_shard_plan` (ROADMAP.md Queue 1
[5d]) and the control planes ([7]) raise.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from . import _env, profiler
from .base import MXNetError
from .context import resolve_device
from .fault import injection as _finj
from .ndarray.ndarray import NDArray
from .observability import registry as _obs_registry
from .observability import tracer as _tracer

__all__ = ["init_distributed", "reset_distributed", "create", "KVStore",
           "CollectiveTimeout", "collective_timeout_ms", "ControlPlane",
           "MemoryControlPlane", "FileControlPlane",
           "DistributedControlPlane", "control_plane"]

# bytes entering a cross-rank collective, by kind: push / pull's
# process_sum and psum_stacked, compressed_gather, and the captured
# step's in_graph_psum / in_graph_reduce_scatter
_reg = _obs_registry()
_coll_bytes = {}


def _count_collective(op, nbytes):
    c = _coll_bytes.get(op)
    if c is None:
        c = _coll_bytes[op] = _reg.counter("kv_collective_bytes", op=op)
    c.inc(int(nbytes))


def _nbytes(t):
    return t.numel() * t.element_size()


# ------------------------------------------------- collective deadlines
class CollectiveTimeout(MXNetError):
    """A blocking collective exceeded ``MXTPU_COLLECTIVE_TIMEOUT_MS``. The
    thread running it is abandoned (a daemon): treat the process's
    collective state as poisoned and restart from a checkpoint."""

    def __init__(self, op, timeout_ms, key=None):
        self.op = op
        self.timeout_ms = float(timeout_ms)
        self.key = key
        super().__init__(
            f"collective {op!r}{f' (key={key})' if key else ''} did not "
            f"complete within MXTPU_COLLECTIVE_TIMEOUT_MS={timeout_ms:g}ms"
            f": peer lost or interconnect wedged")


def collective_timeout_ms():
    """The collective deadline in ms (0 = off), read on every call; a
    malformed value warns once and reads 0."""
    return _env.env_ms("MXTPU_COLLECTIVE_TIMEOUT_MS", 0.0)


_deadline_tls = threading.local()


def _deadline_call(fn, op, key=None, timeout=None):
    """Run `fn` under the collective deadline (`timeout` ms; None reads
    the environment): inline when the deadline is off or a bounded call
    is already running on this thread, else on a daemon thread joined
    for `timeout`, raising `CollectiveTimeout` if it is still running."""
    if getattr(_deadline_tls, "active", False):
        return fn()
    if timeout is None:
        timeout = collective_timeout_ms()
    if timeout <= 0:
        return fn()
    box = {}

    def worker():
        _deadline_tls.active = True
        try:
            box["r"] = fn()
        except BaseException as e:     # noqa: BLE001 - re-raised below
            box["e"] = e

    th = threading.Thread(target=worker, daemon=True,
                          name=f"mxtt-collective-{op}")
    th.start()
    th.join(timeout / 1000.0)
    if th.is_alive():
        _reg.counter("kv_collective_timeouts", op=op).inc()
        raise CollectiveTimeout(op, timeout, key)
    if "e" in box:
        raise box["e"]
    return box.get("r")


def _cluster_env():
    """Read the launcher-provided cluster spec from the environment.

    Two spellings are honoured: the reference's ps-lite variables
    (DMLC_PS_ROOT_URI/DMLC_PS_ROOT_PORT/DMLC_NUM_WORKER/DMLC_WORKER_ID)
    and the native MXTPU_* ones (MXTPU_COORDINATOR/MXTPU_NUM_WORKERS/
    MXTPU_WORKER_ID). Returns (coord, n, rank) or (None, None, None).
    The worker count and id parse strictly: a garbled export raises
    `ValueError` rather than joining the wrong collective."""
    coord = os.environ.get("MXTPU_COORDINATOR")
    if coord is None and os.environ.get("DMLC_PS_ROOT_URI"):
        coord = (os.environ["DMLC_PS_ROOT_URI"] + ":"
                 + os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
    n = os.environ.get("MXTPU_NUM_WORKERS", os.environ.get("DMLC_NUM_WORKER"))
    rank = os.environ.get("MXTPU_WORKER_ID", os.environ.get("DMLC_WORKER_ID"))
    if coord and n is not None and rank is not None:
        # strip() first: padding of an env-file export is not garbling
        return (coord,
                _env.parse_int(n.strip(),
                               "MXTPU_NUM_WORKERS/DMLC_NUM_WORKER"),
                _env.parse_int(rank.strip(),
                               "MXTPU_WORKER_ID/DMLC_WORKER_ID"))
    return None, None, None


def _host_port(coord):
    host, sep, port = str(coord).rpartition(":")
    if not sep or not host:
        raise MXNetError(f"coordinator address {coord!r} is not host:port")
    try:
        return host, _env.parse_int(port, "coordinator port")
    except ValueError as e:
        raise MXNetError(str(e)) from e


def _attempt(dev, addr, n, rank, store_timeout):
    """One rendezvous: a TCP store at `addr` = (host, port) (rank 0 serves
    it; the others wait for it up to `store_timeout`), or an in-process
    store for a group of one (`addr` None); then the default group on
    it."""
    if _finj.ENABLED:
        _finj.check("kv.init", context=str(addr))
    if addr is None:
        store = dist.HashStore()
    else:
        store = dist.TCPStore(*addr, n, is_master=rank == 0,
                              timeout=store_timeout, wait_for_workers=False)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank, world_size=n,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=rank, world_size=n)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None):
    """Set up the default process group, once per process (a second
    call returns at once).

    With no arguments the launcher's environment is read first
    (`_cluster_env`: MXTPU_* / DMLC_*); with none there either, the
    process forms a group of one through an in-process store (one card,
    as `jax.devices()` needs no initialize). Otherwise
    `coordinator_address` ("host:port"; rank 0 serves the store there),
    `num_processes` and `process_id` name the group.

    `device`: None (the card of this process, `process_id` modulo the
    cards visible, under NCCL), an explicit `mx.gpu(i)`, or "cpu" /
    `mx.cpu()` for gloo. Without a CUDA device any but the CPU request
    raises `MXNetError`.

    An explicit rendezvous that fails is retried with exponential
    backoff (MXTPU_DIST_RETRIES, default 4; MXTPU_DIST_RETRY_BASE 0.5 s,
    doubling to MXTPU_DIST_RETRY_MAX 8 s; all within
    MXTPU_DIST_RETRY_DEADLINE 120 s), since a worker may come up before
    rank 0 serves the store; when they run out it raises `MXNetError`.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if coordinator_address is None and num_processes is None:
        coordinator_address, num_processes, process_id = _cluster_env()
    if coordinator_address is None and num_processes is None:
        coordinator_address, num_processes, process_id = None, 1, 0
    elif coordinator_address is None or num_processes is None \
            or process_id is None:
        raise MXNetError("init_distributed needs coordinator_address, "
                         "num_processes and process_id together")
    n, rank = int(num_processes), int(process_id)
    if not 0 <= rank < n:
        raise MXNetError(f"process_id {rank} is not in [0, {n})")
    addr = None if coordinator_address is None \
        else _host_port(coordinator_address)
    if dev.type == "cuda" and device is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    retries = _env.env_int("MXTPU_DIST_RETRIES", 4, minimum=0)
    base = _env.env_float("MXTPU_DIST_RETRY_BASE", 0.5, minimum=0.0)
    cap = _env.env_float("MXTPU_DIST_RETRY_MAX", 8.0, minimum=0.0)
    deadline = _env.env_float("MXTPU_DIST_RETRY_DEADLINE", 120.0,
                              minimum=0.0)
    if addr is None:
        retries = 0                  # a group of one waits for nobody
    t0 = time.monotonic()
    attempt = 0
    while True:
        left = max(1.0, deadline - (time.monotonic() - t0))
        try:
            _attempt(dev, addr, n, rank, timedelta(seconds=left))
            return
        except (RuntimeError, ValueError, OSError) as e:
            # RuntimeError covers torch's DistError family and
            # MXNetError, FaultInjected among them
            attempt += 1
            delay = min(cap, base * 2 ** (attempt - 1))
            if attempt > retries or \
                    time.monotonic() - t0 + delay > deadline:
                raise MXNetError(f"distributed init failed after "
                                 f"{attempt} attempt(s): {e}") from e
            time.sleep(delay)


def reset_distributed():
    """Tear down the default process group so that `init_distributed`
    may run again. Safe to call when nothing was initialised."""
    if dist.is_initialized():
        dist.destroy_process_group()



def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _tensor(v):
    return v._data if isinstance(v, NDArray) else v


def create(name="local", device=None):
    """A KVStore of kind `name` ('local', 'device', 'nccl', 'ici',
    'dist', 'dist_sync', 'dist_device_sync', 'dist_async', 'horovod'; a
    KVStore passes through) for tensors on `device` (None = `mx.gpu(0)`,
    which raises `MXNetError` without a card; "cpu" for the CPU)."""
    if isinstance(name, KVStore):
        return name
    dev = resolve_device(device)
    key = str(name).lower()
    if key in ("local", "local_allreduce_cpu", "local_allreduce_device"):
        return KVStore("local", dev)
    if key in ("device", "nccl"):
        return KVStore("device", dev)
    if key in ("ici", "dist", "dist_sync", "dist_device_sync", "dist_async",
               "horovod"):
        return KVStore("ici", dev)
    raise MXNetError(f"unknown kvstore type {name!r}")


class KVStore:
    """A store of one kind (see `create` and the module docstring) whose
    values live on `device`."""

    def __init__(self, kind, device):
        self._kind = kind
        self.device = device
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._mesh = None
        self._compression = None   # {"type": "2bit" | "int8", "threshold"}
        self._residuals = {}       # key -> this rank's error feedback
        self.compression_stats = None

    # ------------------------------------------------------- identity
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return dist.get_rank() if self._kind == "ici" and \
            dist.is_initialized() else 0

    @property
    def num_workers(self):
        return dist.get_world_size() if self._kind == "ici" and \
            dist.is_initialized() else 1

    def set_mesh(self, mesh):
        """Attach a `parallel.Mesh`: the store then reduces over its first
        axis (the `dp` line of this rank). Drops the compression
        residuals, which belong to the old group."""
        self._mesh = mesh
        self._residuals = {}
        return self

    def set_shard_plan(self, plan):
        raise MXNetError("KVStore.set_shard_plan is not ported yet "
                         "(ROADMAP.md, Queue 1 [5d]: rule-driven sharding)")

    def shard_plan(self):
        """The rule-driven shard plan: none in the port ([5d])."""
        return None

    def set_gradient_compression(self, compression_params):
        """Quantize stacked cross-rank pushes with error feedback:
        '2bit' (values to {-threshold, 0, +threshold}, four codes a byte:
        16x fewer bytes than fp32) or 'int8' (one scale, the max over
        ranks of |value| / 127: 4x fewer). Each rank keeps the error of
        its own quantization as a residual added into its next push."""
        p = dict(compression_params or {})
        if p.get("type") not in ("2bit", "int8"):
            raise MXNetError(f"unsupported gradient compression "
                             f"{p.get('type')!r}; use '2bit' or 'int8'")
        p.setdefault("threshold", 0.5)
        self._compression = p
        self._residuals = {}
        return self

    def _group(self, axis=None):
        """(process group, size) of the cross-rank reduction: the mesh's
        line along `axis` (its first axis by default), else the default
        group once `init_distributed` made one (a group of one rank
        included: its collectives run, as identities); (None, 1) for a
        store that is not 'ici' or a process without a group."""
        if self._kind != "ici":
            return None, 1
        if self._mesh is not None:
            axis = axis or self._mesh.axis_names[0]
            return self._mesh.group(axis), int(self._mesh.shape[axis])
        if dist.is_initialized():
            return dist.group.WORLD, dist.get_world_size()
        return None, 1

    @staticmethod
    def _check_backend(group, t):
        """NCCL reduces card tensors and gloo CPU ones; anything else
        raises (no tensor is moved to make it fit)."""
        want = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        if t.device.type != want:
            raise MXNetError(f"a {t.device.type} tensor cannot be reduced "
                             f"over a {dist.get_backend(group)} group")

    # ----------------------------------------------------- push / pull
    def init(self, key, value):
        """Store a copy of each value under its key (str(key))."""
        for k, v in zip(_as_list(key), _as_list(value)):
            self._store[str(k)] = NDArray(_tensor(v).detach().clone())

    def push(self, key, value, priority=0, layout="auto"):
        """Sum the values pushed for each key (a list of towers a key is
        summed in order, then reduced across ranks by `allreduce_`) into
        the store; with an optimizer set, apply it to the stored weight
        instead. `layout` goes to `allreduce_`."""
        if _tracer.ACTIVE:
            with _tracer.span("kv.push", cat="kvstore",
                              args={"key": str(key), "store": self._kind}):
                return self._push_impl(key, value, layout)
        return self._push_impl(key, value, layout)

    def _push_impl(self, key, value, layout):
        keys = _as_list(key)
        if len(keys) == 1 and (not isinstance(value, (list, tuple)) or
                               not isinstance(value[0], (list, tuple))):
            values = [_as_list(value)]
        else:
            values = [_as_list(v) for v in value]
        for k, vals in zip(keys, values):
            k = str(k)
            agg = self.allreduce_([_tensor(v) for v in vals], layout=layout,
                                  key=k)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError(f"key {k} not initialised")
                self._updater(k, NDArray(agg), self._store[k])
            else:
                self._store[k] = NDArray(agg)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """The stored value of each key, or, with `out`, copied into each
        output (a list of outputs a key broadcasts to all of them)."""
        if _tracer.ACTIVE:
            with _tracer.span("kv.pull", cat="kvstore",
                              args={"key": str(key), "store": self._kind}):
                return self._pull_impl(key, out)
        return self._pull_impl(key, out)

    def _pull_impl(self, key, out):
        keys = _as_list(key)
        vals = []
        for k in keys:
            if str(k) not in self._store:
                raise MXNetError(f"key {k} not initialised")
            vals.append(self._store[str(k)])
        if out is None:
            return vals[0] if len(vals) == 1 else vals
        outs = [out] if len(keys) == 1 else _as_list(out)
        with torch.no_grad():
            for o, v in zip(outs, vals):
                for t in (o if isinstance(o, (list, tuple)) else [o]):
                    _tensor(t).copy_(v._data)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("sparse storage is not supported (SURVEY.md §2 "
                         "#49); use a dense pull")

    # ------------------------------------------------------ allreduce
    def allreduce_(self, arrays, axis=None, layout="auto", key=None):
        """The towers in `arrays` summed in order; on an 'ici' store the
        sum is then reduced across ranks by `layout` (module docstring):
        "replicated" as it is, "stacked" this rank's rows reduced away,
        "auto" refused over a multi-rank mesh. A mesh of one rank reduces
        nothing. Bounded
        by `MXTPU_COLLECTIVE_TIMEOUT_MS` when it is set."""
        timeout = collective_timeout_ms()
        if timeout <= 0:
            return self._allreduce_body(arrays, axis, layout, key)
        return _deadline_call(
            lambda: self._allreduce_body(arrays, axis, layout, key),
            "allreduce", key, timeout=timeout)

    def _allreduce_body(self, arrays, axis, layout, key):
        if _finj.ENABLED:
            # 'stall' here simulates a hung collective, 'raise' a lost
            # peer; kv.timeout stalls inside the deadline window
            _finj.check("kv.collective", context=f"key={key}")
            _finj.check("kv.timeout", context=f"key={key}")
        arrays = [_tensor(a) for a in arrays]
        out = arrays[0]
        for a in arrays[1:]:
            out = out + a
        if self._kind != "ici":
            return out
        if self._mesh is None:
            # a multi-rank store without a mesh: a value is this rank's
            # own and sums over the ranks, unless the caller says it is
            # the same everywhere (the Trainer's push of a gradient it
            # has reduced already)
            return out if layout == "replicated" \
                else self.allreduce_process_sum(out)
        axis = axis or self._mesh.axis_names[0]
        if self._mesh.shape[axis] <= 1:
            return out
        if layout == "auto":
            raise MXNetError(
                "allreduce_ over a multi-rank mesh: a tensor does not say "
                "whether it holds this rank's rows of a stack or the same "
                "value as every rank; pass layout='stacked' or "
                "'replicated'")
        if layout == "replicated":
            return out
        if layout != "stacked":
            raise MXNetError(f"unknown allreduce layout {layout!r}")
        if out.dim() == 0:
            raise MXNetError("stacked allreduce needs a leading replica "
                             "dim, got a 0-d value")
        if self._compression is not None and key is not None:
            return self._compressed_psum_stacked(out, axis, key)
        return self._psum_stacked(out, axis)

    def _psum_stacked(self, rows, axis):
        from .parallel import _comm
        group, _ = self._group(axis)
        self._check_backend(group, rows)
        total = rows.sum(0)
        _count_collective("psum_stacked", _nbytes(total))
        return _comm.all_reduce(total, group)

    def allreduce_process_sum(self, a):
        """`a` (this rank's own value) summed over the store's group, as
        a new tensor; `a` itself on a store without a group."""
        if self._group()[0] is None:
            return a
        return self._process_sum_(a.detach().clone())

    def _process_sum_(self, t):
        """`t` summed over the store's group in place (a group there)."""
        group, n = self._group()
        self._check_backend(group, t)
        _count_collective("process_sum", _nbytes(t))
        from .parallel import _comm

        def reduce():
            return _comm.all_reduce(t, group)
        if _tracer.ACTIVE:
            with _tracer.span("kv.allreduce_process_sum", cat="kvstore",
                              args={"bytes": _nbytes(t), "workers": n}):
                return _deadline_call(reduce, "process_sum")
        return _deadline_call(reduce, "process_sum")

    def allreduce_flat(self, arrays, key=None):
        """The Trainer's bucketed reduction: many same-dtype gradients
        (this rank's own) summed over the group as one flat buffer, then
        split back (views of the reduced buffer). One collective a
        bucket; the arrays themselves on a store without a group."""
        if _tracer.ACTIVE:
            with _tracer.span(
                    "kv.allreduce_flat", cat="kvstore",
                    args={"bytes": sum(_nbytes(a) for a in arrays),
                          "arrays": len(arrays), "store": self._kind}):
                return self._allreduce_flat_impl(arrays, key)
        return self._allreduce_flat_impl(arrays, key)

    def _allreduce_flat_impl(self, arrays, key):
        from .optimizer.multi_tensor import split_flat
        group, _ = self._group()
        if group is None or not arrays:
            return list(arrays)
        profiler.record_dispatch("kv_flatten")
        flat = torch.cat([a.detach().reshape(-1) for a in arrays])

        def reduce():
            if _finj.ENABLED:
                _finj.check("kv.collective", context=f"flat key={key}")
                _finj.check("kv.timeout", context=f"flat key={key}")
            return self._process_sum_(flat)

        profiler.record_dispatch("kv_allreduce")
        red = _deadline_call(reduce, "allreduce_flat", key)
        profiler.record_dispatch("kv_split")
        return split_flat(red, [tuple(a.shape) for a in arrays])

    # ------------------------------------- in-graph reduction (capture)
    def capture_spec(self):
        """(mesh, axis, size) when a captured step should reduce its
        gradients in its graph over this store, else None: a store that
        is not 'ici', or no mesh. A one-rank axis takes the same path as
        any other (its collectives are NCCL's one-rank forms), as the
        eager store path runs its collectives on a one-rank group."""
        if self._kind != "ici" or self._mesh is None:
            return None
        axis = self._mesh.axis_names[0]
        return self._mesh, axis, int(self._mesh.shape[axis])

    def batch_sharding(self):
        """The placement a prefetcher stages batches with so that a
        captured step over this store takes them as they are: this rank's
        rows over the capture axis (`parallel.mesh.Sharding`); None when
        `capture_spec` is None."""
        spec = self.capture_spec()
        if spec is None:
            return None
        from .parallel.mesh import Sharding
        mesh, axis, _ = spec
        return Sharding(mesh, (axis,))

    def _axis_group(self, axis):
        return self._mesh.group(axis or self._mesh.axis_names[0])

    def graph_allreduce(self, g, axis, size, mean=False):
        """`g` summed over `axis` in place (`lax.psum`), times 1/size with
        `mean`; returns `g`. One NCCL all-reduce on the card, legal in a
        CUDA graph being captured."""
        from .parallel import _comm
        _comm.all_reduce(g, self._axis_group(axis))
        return g.mul_(1.0 / size) if mean and size > 1 else g

    def graph_reduce_scatter(self, g, axis, size, mean=False, out=None):
        """This rank's block of rows of `g` summed over `axis`
        (`lax.psum_scatter(..., tiled=True)` along dim 0), into `out`."""
        from .parallel import _comm
        out = _comm.reduce_scatter(g, self._axis_group(axis), out)
        return out.mul_(1.0 / size) if mean and size > 1 else out

    def graph_all_gather(self, x, axis, out=None):
        """Every rank's block stacked along dim 0 (`lax.all_gather(...,
        tiled=True)`), into `out`; `x` may be this rank's block of
        `out`."""
        from .parallel import _comm
        return _comm.all_gather(x, self._axis_group(axis), out)

    def graph_constrain(self, x, spec):
        raise MXNetError("KVStore.graph_constrain is not ported yet "
                         "(ROADMAP.md, Queue 1 [5d]: rule-driven sharding)")

    # ------------------------------------------- compressed collectives
    def _wire(self, local, group, n):
        """(total over ranks, this rank's residual after quantization,
        wire tensor) of one compressed exchange of `local` (fp32)."""
        from .parallel import _comm
        thr = float(self._compression["threshold"])
        flat = local.reshape(-1)
        if self._compression["type"] == "2bit":
            size = flat.numel()
            pad = (-size) % 4
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            codes = torch.where(flat >= thr, 1, torch.where(flat <= -thr, 2,
                                                            0)).to(torch.uint8)
            weights = torch.tensor([1, 4, 16, 64], dtype=torch.uint8,
                                   device=flat.device)
            packed = (codes.reshape(-1, 4) * weights).sum(
                1, dtype=torch.uint8)

            def decode(p):
                c = torch.stack([(p >> s) & 3 for s in (0, 2, 4, 6)], 1)
                c = c.reshape(-1)[:size]
                return torch.where(c == 1, thr, torch.where(
                    c == 2, -thr, 0.0)).to(torch.float32)
            gathered = _comm.all_gather(packed[None], group)
            total = decode(gathered[0])
            for r in range(1, n):
                total = total + decode(gathered[r])
            return (total.reshape(local.shape),
                    local - decode(packed).reshape(local.shape), packed)
        absmax = _comm.all_reduce(local.abs().max().reshape(1), group,
                                  op="max")[0]
        scale = torch.clamp(absmax, min=1e-30) / 127.0
        codes = torch.clamp(torch.round(local / scale), -127, 127) \
            .to(torch.int8)
        gathered = _comm.all_gather(codes[None], group)
        total = gathered.to(torch.int32).sum(0).to(torch.float32) * scale
        return total, local - codes.to(torch.float32) * scale, codes

    def _compressed_psum_stacked(self, rows, axis, key):
        group, n = self._group(axis)
        self._check_backend(group, rows)
        local = rows.sum(0)
        res = self._residuals.get(key)
        if res is None or res.shape != local.shape:
            res = torch.zeros_like(local)
        total, new_res, wire = self._wire(
            (local + res).to(torch.float32), group, n)
        self._residuals[key] = new_res.to(local.dtype)
        _count_collective("compressed_gather", _nbytes(wire))
        self.compression_stats = {
            "key": key, "type": self._compression["type"],
            "wire_dtype": str(wire.dtype).split(".")[-1],
            "wire_bytes_per_replica": _nbytes(wire),
            "raw_bytes_per_replica": _nbytes(local)}
        if _tracer.ACTIVE:
            _tracer.instant("kv.compressed_allreduce", cat="kvstore",
                            args=dict(self.compression_stats, ranks=n))
        return total.to(local.dtype)

    # ------------------------------------------------ optimizer offload
    def set_optimizer(self, optimizer):
        """Run `optimizer` on the store: a push updates the stored weight
        with the pushed (reduced) gradient, a pull returns it."""
        from . import optimizer as opt_mod
        self._optimizer = optimizer if hasattr(optimizer, "update") \
            else opt_mod.create(optimizer)
        self._updater = _KVUpdater(self._optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def optimizer_states_bytes(self):
        """The store's optimizer state as one pickled blob: every key's
        state tensors on the host, `num_update` and the per-key counts
        (so that an lr schedule resumes where it was)."""
        states = {}
        if self._updater is not None:
            states = {k: tuple(s._data.detach().cpu() for s in v)
                      for k, v in self._updater.states.items()}
        blob = {"states": states, "num_update": 0, "index_update_count": {}}
        if self._optimizer is not None:
            blob["num_update"] = self._optimizer.num_update
            blob["index_update_count"] = dict(
                self._optimizer._index_update_count)
        return pickle.dumps(blob)

    def load_optimizer_states_bytes(self, blob):
        if self._updater is None:
            raise MXNetError("set_optimizer must be called before "
                             "load_optimizer_states")
        blob = pickle.loads(blob)
        self._optimizer.num_update = blob["num_update"]
        self._optimizer._index_update_count = dict(
            blob.get("index_update_count", {}))
        self._updater.states = {
            k: tuple(NDArray(t.to(self._state_device(k))) for t in v)
            for k, v in blob["states"].items()}

    def _state_device(self, key):
        v = self._store.get(str(key))
        return v._data.device if v is not None else self.device

    def save_optimizer_states(self, fname, dump_optimizer=False):
        with open(fname, "wb") as f:
            f.write(self.optimizer_states_bytes())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("set_optimizer must be called before "
                             "load_optimizer_states")
        with open(fname, "rb") as f:
            self.load_optimizer_states_bytes(f.read())

    def barrier(self):
        """Wait for this rank's queued work, then (an 'ici' store with a
        group) for every rank of the group to arrive."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        group, _ = self._group()
        if group is not None:
            dist.barrier(group=group)


class _KVUpdater:
    """The store's updater: the optimizer applied at push time."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, key, grad, weight):
        if key not in self.states:
            self.states[key] = \
                self.optimizer.create_state_multi_precision(key, weight)
        self.optimizer.update_multi_precision(key, weight, grad,
                                              self.states[key])


# ------------------------------------------------------ control planes
def _fleet(what):
    return MXNetError(f"{what} is not ported yet (ROADMAP.md, Queue 1 [7]: "
                      f"the fleet's control plane, fault/fleet.py)")


class ControlPlane:
    """The fleet's control plane: not ported yet ([7])."""

    def __init__(self, *args, **kwargs):
        raise _fleet(type(self).__name__)


class MemoryControlPlane(ControlPlane):
    pass


class FileControlPlane(ControlPlane):
    pass


class DistributedControlPlane(ControlPlane):
    pass


def control_plane(*args, **kwargs):
    raise _fleet("control_plane")
