"""The distributed bootstrap (counterpart of `mxnet_tpu/kvstore.py`).

Only `init_distributed` / `reset_distributed` are ported
(`kvstore.py:171-296` there): they set up the default
`torch.distributed` process group that `parallel.make_mesh` cuts into
named axes. The group is NCCL on the card, the default, or gloo when the
caller asks for the CPU (`device="cpu"`); without a CUDA device and
without that request `init_distributed` raises `MXNetError`. The store
itself (`create`, `KVStore`) and the Trainer's kvstore path are not
ported yet (ROADMAP.md, Queue 1 [5b]).
"""
from __future__ import annotations

import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from . import _env
from .base import MXNetError
from .context import resolve_device
from .fault import injection as _finj

__all__ = ["init_distributed", "reset_distributed", "create", "KVStore"]


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


def _unported(what):
    return MXNetError(f"{what} is not ported yet (ROADMAP.md, Queue 1 [5b]: "
                      f"distribution and sharding)")


def create(name="local"):
    """`mx.kv.create(name)`: not ported yet."""
    raise _unported(f"kvstore.create({name!r})")


class KVStore:
    """The key-value store: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _unported("KVStore")
