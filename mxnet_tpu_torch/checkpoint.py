"""Checkpointing (counterpart of `mxnet_tpu/checkpoint.py`; reference:
mxnet.model save_checkpoint / load_checkpoint, gluon save / load
parameters), hardened for preemption as the JAX package's is:

  * **atomic save** — a step is written into a hidden temporary directory
    and `os.replace`-d into place (an older copy of the step moved aside
    first, and back if the publish fails), so a torn write (preemption
    mid-save) never shadows a good step;
  * **checksum manifest** — each step directory carries
    ``manifest.json`` (size and sha256 of every file, written last);
    `validate_checkpoint` checks it, and `CheckpointManager.
    restore_latest` falls back to the newest valid step (counted in
    ``checkpoint_fallbacks``);
  * **async save** — `_async=True` copies every leaf to the host before
    it returns (a synchronous device-to-host copy on the current stream,
    so the saved values are those before any later in-place update: the
    fused Trainer update and the captured step write the same tensors),
    then pushes the writing onto the dependency engine on the step
    directory's `file_var` at PRIORITY_BACKGROUND; the engine task
    touches nothing of the card. A bounded background queue that
    rejects the push (`EngineQueueFull`) degrades to a synchronous save;
  * **emergency save** — `CheckpointManager.enable_emergency_save`
    registers a synchronous save with `fault.preemption`, so a SIGTERM
    produces one last checkpoint inside the grace window;
  * **extras** — sidecar blobs (the Trainer's `states_bytes()`, a data
    cursor) ride in the same atomic directory, checksummed by the
    manifest; ``health.json`` is the last-known-good journal.

The payload is the port's own: one ``.npy`` file a leaf under
``state/``, named by the JAX package's `_leaf_name` ("/"-joined dict
keys and list positions, so nested trees nest directories). bfloat16
leaves are stored as their 2-byte patterns (numpy void ``<V2``, as
ml_dtypes' bfloat16 writes itself), float16 as ``<f2``: both restore bit
for bit. The manifest keeps the JAX package's schema (``step``,
``format``, ``complete``, ``files``, ``partition_specs`` — every leaf
``[]``, unsharded — and ``quantization``). A checkpoint the JAX package
wrote does not restore here: its ``state/`` is Orbax's (a tensorstore
layout), and neither Orbax nor tensorstore is on the card's machine;
its manifest, extras and health journal read as usual. A ZeRO leaf
(this rank's block of an optimizer state, `parallel._comm.
sharded_leaf`) is gathered whole, a collective every rank of its group
joins, and written as an unsharded leaf; under a multi-rank default
group only rank 0 writes (and prunes). Restoring into a ZeRO leaf takes
this rank's block of the saved whole, so a step saved at one number of
ranks restores at any other, as the JAX package's global arrays do.
DTensor and tiered leaves raise (ROADMAP.md Queue 1 [5d]).

A restored run goes on as the uninterrupted one would, bit for bit,
only where its steps are themselves repeatable: with dropout 0 (or the
RNG reseeded at the restore step in both runs; the RNG state is not
saved), and on the card under
``torch.use_deterministic_algorithms(True, warn_only=True)``, since
the backward of a gather or an embedding otherwise sums with atomics
in a varying order.

Save / load IO retries per `fault.policy_from_env("MXTPU_CKPT")`; the
``checkpoint.save`` / ``checkpoint.load`` fault points make those paths
testable.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .fault import injection as _finj
from .fault import retry as _retry
from .log import get_logger
from .ndarray.ndarray import NDArray
from .ndarray.utils import _tensor
from .observability import registry as _obs_registry

__all__ = ["save_checkpoint", "load_checkpoint", "save_sharded",
           "load_sharded", "CheckpointManager", "validate_checkpoint",
           "read_extra", "read_health", "is_healthy",
           "derive_partition_specs", "saved_partition_specs",
           "derive_quantization", "saved_quantization",
           "quantization_mismatches", "MANIFEST_NAME", "HEALTH_NAME",
           "CHECKPOINT_FORMAT"]

MANIFEST_NAME = "manifest.json"
HEALTH_NAME = "health.json"
CHECKPOINT_FORMAT = 1
STATE_DIR = "state"
# files Orbax writes at the top of the JAX package's state/
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt", "_METADATA")

_tmp_seq = itertools.count()

_reg = _obs_registry()
_saves_counter = _reg.counter("checkpoint_saves")
_fallback_counter = _reg.counter("checkpoint_fallbacks")
_unhealthy_counter = _reg.counter("checkpoint_unhealthy_skips")
_last_step_gauge = _reg.gauge("checkpoint_last_step")

_ckpt_policy = None


def _log():
    return get_logger("mxnet_tpu_torch.checkpoint")


def _policy():
    global _ckpt_policy
    if _ckpt_policy is None:
        # only plausibly transient IO errors (and the injectable fault):
        # re-running a large save on a deterministic failure would waste
        # the preemption grace window
        _ckpt_policy = _retry.policy_from_env(
            "MXTPU_CKPT", max_retries=3, base_delay=0.1, max_delay=2.0,
            deadline=60.0, name="checkpoint",
            retry_on=(OSError, _finj.FaultInjected))
    return _ckpt_policy


def _unported(what, item):
    return MXNetError(f"checkpoint: {what} is not ported yet (ROADMAP.md, "
                      f"Queue 1 {item})")


# ----------------------------------------------------- reference format
def save_checkpoint(prefix, epoch, symbol=None, arg_params=None,
                    aux_params=None):
    """The reference format's params file, prefix-%04d.params.npz (the
    JAX package's: ``arg:<name>`` / ``aux:<name>`` keys), written
    atomically (tmp + rename). A symbol raises: `symbol` is ROADMAP.md
    Queue 1 [8]."""
    if symbol is not None:
        raise _unported("saving a symbol", "[8]")
    arrays = {}
    for k, v in (arg_params or {}).items():
        arrays[f"arg:{k}"] = v.asnumpy()
    for k, v in (aux_params or {}).items():
        arrays[f"aux:{k}"] = v.asnumpy()
    final = f"{prefix}-{epoch:04d}.params.npz"
    # np.savez appends ".npz" to names without it: keep the suffix
    tmp = f"{prefix}-{epoch:04d}.tmp{os.getpid()}.params.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, final)


def load_checkpoint(prefix, epoch, ctx=None):
    """(None, arg_params, aux_params) from `save_checkpoint`'s file
    (either package's), on `ctx` (None = `mx.gpu(0)`). A saved
    prefix-symbol.json raises: symbols are ROADMAP.md Queue 1 [8]."""
    if os.path.exists(f"{prefix}-symbol.json"):
        raise _unported("loading a symbol", "[8]")
    device = resolve_device(ctx)
    arg_params, aux_params = {}, {}
    with np.load(f"{prefix}-{epoch:04d}.params.npz",
                 allow_pickle=False) as f:
        for k in f.keys():
            kind, name = k.split(":", 1)
            (arg_params if kind == "arg" else aux_params)[name] = NDArray(
                _tensor(f[k]).to(device))
    return None, arg_params, aux_params


# ------------------------------------------------------------- pytrees
def _flatten_with_path(tree, path=()):
    """[(path, leaf)] in the JAX package's order: dict keys sorted, list
    and tuple positions in order; a leaf is anything else."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def _unflatten(tree, leaves):
    """`tree`'s structure (its dicts' key order kept) with its leaves
    replaced by `leaves`, given in `_flatten_with_path` order."""
    by_path = dict(zip((p for p, _ in _flatten_with_path(tree)), leaves))

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (i,))
                              for i, v in enumerate(node))
        return by_path[path]
    return build(tree, ())


def _leaf_name(path):
    """"/"-joined name of one leaf's path (`mxnet_tpu/checkpoint.py`
    `_leaf_name`)."""
    return "/".join(str(k) for k in path)


def _leaf_tensor(leaf):
    """A leaf as a tensor, refusing the layouts this port does not save."""
    if isinstance(leaf, NDArray):
        leaf = leaf._data
    if getattr(leaf, "_tiered_state", None) is not None:
        raise _unported("tiered embedding tables", "[5d]")
    if hasattr(leaf, "placements") and hasattr(leaf, "device_mesh"):
        raise _unported("a DTensor leaf (rule-driven sharding)", "[5d]")
    if isinstance(leaf, torch.Tensor):
        from .parallel import _comm
        mark = _comm.leaf_shard(leaf)
        t = leaf.detach()
        return t if mark is None else _comm.sharded_leaf(t, *mark)
    return torch.as_tensor(np.asarray(leaf))


def derive_partition_specs(params):
    """{leaf name -> JSON-encoded PartitionSpec}: every leaf of the port's
    single-device trees is unsharded, `[]`, as the JAX package records a
    leaf without a NamedSharding."""
    return {_leaf_name(p): [] for p, leaf in _flatten_with_path(params)
            if _leaf_tensor(leaf) is not None}  # (refuses a mesh leaf)


_QUANT_DTYPES = (torch.int8, torch.uint8)


def derive_quantization(params):
    """The quantization scheme of a params tree: {"dtype", "leaves": {leaf
    name -> {"dtype", "shape"}}} over every int8 / uint8 leaf (the
    quantized storage dtypes; int32 counters are not quantization), or
    None for a tree without one."""
    out, dtypes = {}, set()
    for path, leaf in _flatten_with_path(params):
        t = _leaf_tensor(leaf)
        if t.dtype not in _QUANT_DTYPES:
            continue
        dt = str(t.dtype).split(".")[-1]
        out[_leaf_name(path)] = {"dtype": dt,
                                 "shape": [int(s) for s in t.shape]}
        dtypes.add(dt)
    if not out:
        return None
    return {"dtype": dtypes.pop() if len(dtypes) == 1 else "mixed",
            "leaves": out}


# ------------------------------------------------------------- manifest
def _sha256(path, chunk=1 << 22):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _walk_files(root):
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            full = os.path.join(dirpath, name)
            yield os.path.relpath(full, root), full


def _write_manifest(root, step, partition_specs=None, quantization=None):
    """Checksum every file under `root` into manifest.json, written last
    and fsync'd: its presence marks the payload complete before the
    directory rename publishes the step (two commit barriers; either
    catches a tear)."""
    files = {}
    for rel, full in _walk_files(root):
        if rel == MANIFEST_NAME:
            continue
        files[rel] = {"bytes": os.path.getsize(full), "sha256": _sha256(full)}
    manifest = {"step": int(step), "format": CHECKPOINT_FORMAT,
                "complete": True, "files": files}
    if partition_specs:
        manifest["partition_specs"] = dict(partition_specs)
    if quantization:
        manifest["quantization"] = dict(quantization)
    path = os.path.join(root, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return manifest


def _read_manifest(path):
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def _manifest_complete(path):
    """Structural validity only (a readable manifest marked complete):
    the cheap check retention uses; restore runs `validate_checkpoint`."""
    manifest = _read_manifest(path)
    return bool(manifest and manifest.get("complete"))


def validate_checkpoint(path):
    """Validate one step directory against its manifest: a list of
    error strings, empty when the checkpoint is intact. A missing
    manifest (a torn or foreign write) is an error."""
    errors = []
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.isdir(path):
        return [f"{path}: not a checkpoint directory"]
    if not os.path.exists(mpath):
        return [f"{path}: no {MANIFEST_NAME} (torn or foreign write)"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable manifest ({e})"]
    if manifest.get("format", 0) > CHECKPOINT_FORMAT:
        errors.append(f"{path}: manifest format {manifest.get('format')} "
                      f"is newer than supported {CHECKPOINT_FORMAT}")
    if not manifest.get("complete"):
        errors.append(f"{path}: manifest not marked complete")
    for rel, meta in manifest.get("files", {}).items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            errors.append(f"{path}: missing file {rel}")
            continue
        size = os.path.getsize(full)
        if size != meta.get("bytes"):
            errors.append(f"{path}: {rel} is {size} bytes, manifest says "
                          f"{meta.get('bytes')}")
            continue
        if _sha256(full) != meta.get("sha256"):
            errors.append(f"{path}: {rel} checksum mismatch")
    return errors


def _step_path(directory, step):
    return os.path.abspath(os.path.join(directory, str(step)))


def saved_partition_specs(directory, step=None):
    """The partition specs in a checkpoint's manifest ({leaf name ->
    JSON-encoded spec}), or None for a save without them. `directory`
    is the step directory itself (step=None) or the root + `step`."""
    path = directory if step is None else _step_path(directory, step)
    manifest = _read_manifest(path)
    return None if manifest is None else manifest.get("partition_specs")


def saved_quantization(directory, step=None):
    """The quantization scheme in a checkpoint's manifest, or None for a
    save without one."""
    path = directory if step is None else _step_path(directory, step)
    manifest = _read_manifest(path)
    return None if manifest is None else manifest.get("quantization")


def quantization_mismatches(path, template):
    """Saved-against-template quantization differences of one step
    directory (readable lines; empty when the schemes agree, or when the
    manifest recorded none: absence means unknown, never a refusal).
    `load_sharded` refuses a restore with these lines before reading."""
    saved = saved_quantization(path)
    if saved is None:
        return []
    want = derive_quantization(template)
    saved_leaves = saved.get("leaves", {})
    want_leaves = (want or {}).get("leaves", {})
    lines = []
    for name, meta in saved_leaves.items():
        t = want_leaves.get(name)
        if t is None:
            lines.append(f"{name}: saved quantized ({meta['dtype']} "
                         f"{meta['shape']}) but the template leaf is "
                         f"full precision (or absent)")
        elif t != meta:
            lines.append(f"{name}: saved {meta['dtype']} {meta['shape']}, "
                         f"template wants {t['dtype']} {t['shape']}")
    for name, meta in want_leaves.items():
        if name not in saved_leaves:
            lines.append(f"{name}: template is quantized "
                         f"({meta['dtype']} {meta['shape']}) but the "
                         f"checkpoint saved it full precision")
    return lines


# ------------------------------------------------------------ the payload
def _leaf_file(root, name):
    parts = name.split("/")
    if any(p in ("", ".", "..") for p in parts):
        raise MXNetError(f"invalid leaf name {name!r}")
    return os.path.join(root, STATE_DIR, *parts) + ".npy"


def _host_snapshot(params):
    """[(leaf name, host numpy array)] of every leaf, copied now: a
    device leaf by a synchronous copy on the current stream, a host
    leaf by a copy of its own, so that no later in-place update reaches
    the save. bfloat16 becomes its 2-byte patterns (numpy void, V2)."""
    from .parallel import _comm
    out = []
    for path, leaf in _flatten_with_path(params):
        t = _leaf_tensor(leaf)
        if _comm.leaf_shard(t) is not None:
            t = _comm.gather_leaf(t)
        host = t.to("cpu") if t.device.type != "cpu" else t.clone()
        if host.dtype == torch.bfloat16:
            arr = host.contiguous().view(torch.int16).numpy().view("V2")
        else:
            arr = host.numpy()
        out.append((_leaf_name(path), arr))
    return out


def _write_state(root, snapshot):
    for name, arr in snapshot:
        path = _leaf_file(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            np.save(f, arr, allow_pickle=False)


def _writer():
    """Whether this process writes checkpoints: any process outside a
    multi-rank default group, else rank 0 alone."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_sharded(directory, step, params, _async=False, extras=None,
                 _group=None, partition_specs=None, quantization=None):
    """Save `params` (a tree of dicts, lists and tuples whose leaves are
    NDArrays, tensors or numpy arrays) as step `step` of `directory`,
    committed atomically: the payload and `extras` (name -> bytes
    sidecars) go into a hidden temporary directory, the checksum
    manifest is fsync'd, and only then does `os.replace` publish it.

    _async=True takes the host snapshot now, pushes the writing through
    the engine on the step directory's `file_var` (BACKGROUND priority,
    in `_group` where given) and returns its Future; a load of the same
    path orders after it. `partition_specs` / `quantization` record the
    layout and the quantization scheme in the manifest (default: derived
    from the leaves; False omits them)."""
    from . import engine
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = _step_path(directory, step)
    if partition_specs is None:
        partition_specs = derive_partition_specs(params)
    elif partition_specs is False:
        partition_specs = None
    if quantization is None:
        # an explicit empty scheme says "known full precision", where a
        # missing one means unknown
        quantization = derive_quantization(params) or {"dtype": None,
                                                       "leaves": {}}
    elif quantization is False:
        quantization = None
    snapshot = _host_snapshot(params)
    if not _writer():
        # the other ranks joined the gathers; rank 0 writes the step
        return engine.inline_future(lambda: final) if _async else final
    extras = {k: bytes(v) for k, v in (extras or {}).items()}
    for name in extras:
        if os.sep in name or name in (MANIFEST_NAME, STATE_DIR):
            raise MXNetError(f"invalid extra name {name!r}")

    def do_save():
        if _finj.ENABLED:
            _finj.check("checkpoint.save", context=final)
        # a temporary directory of this call's own: a synchronous save
        # (the emergency one) may overlap an async save of the same step
        tmp = os.path.join(directory,
                           f".tmp-{step}-{os.getpid()}-{next(_tmp_seq)}")
        shutil.rmtree(tmp, ignore_errors=True)
        aside = None
        try:
            _write_state(tmp, snapshot)
            for name, blob in extras.items():
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(blob)
            _write_manifest(tmp, step, partition_specs=partition_specs,
                            quantization=quantization)
            if os.path.exists(final):
                # a rename refuses a non-empty target: move the old step
                # aside (atomic), so the last good one survives a crash
                # until the new one is published
                aside = tmp + ".old"
                os.replace(final, aside)
            os.replace(tmp, final)
        except BaseException:
            if aside is not None and os.path.exists(aside) and \
                    not os.path.exists(final):
                os.replace(aside, final)   # roll the old good step back
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        _saves_counter.inc()
        _last_step_gauge.set(int(step))
        return final

    if _async:
        try:
            return engine.push(lambda: _policy().call(do_save),
                               write_vars=[engine.file_var(final)],
                               priority=engine.PRIORITY_BACKGROUND,
                               group=_group)
        except engine.EngineQueueFull:
            # a bounded background class under `reject`: save here, after
            # any queued save of the same step (the inline task takes the
            # var's write slot first, so two degraded savers serialize);
            # errors ride the returned future
            return engine.inline_future(lambda: _policy().call(do_save),
                                        site="checkpoint.do_save",
                                        write_vars=[engine.file_var(final)])
    return _policy().call(do_save)


def _restore_leaf(arr, like, name):
    """One saved array as the template leaf `like`: its dtype, device and
    kind (NDArray, tensor or numpy)."""
    from .parallel import _comm
    t = _tensor(arr)
    want = _leaf_tensor(like)
    mark = _comm.leaf_shard(want)
    if mark is not None:
        import torch.distributed as dist
        group, dim = mark
        n = dist.get_world_size(group)
        k = t.shape[dim] // n if t.dim() > dim else 0
        if k * n != (t.shape[dim] if t.dim() > dim else -1):
            raise MXNetError(f"checkpoint leaf {name!r} of shape "
                             f"{tuple(t.shape)} does not split over {n} "
                             f"ranks on dim {dim}")
        t = t.narrow(dim, dist.get_rank(group) * k, k)
    if tuple(t.shape) != tuple(want.shape):
        raise MXNetError(f"checkpoint leaf {name!r} has shape "
                         f"{tuple(t.shape)}, the template {tuple(want.shape)}")
    if t.dtype != want.dtype:
        t = t.to(want.dtype)
    if isinstance(like, np.ndarray):
        return t.numpy()
    t = t.to(want.device)
    if mark is not None:
        t = _comm.sharded_leaf(t.contiguous(), *mark)
    return NDArray(t) if isinstance(like, NDArray) else t


def load_sharded(directory, step, template, validate=True):
    """Restore one step into `template`'s structure, each leaf with the
    template leaf's dtype, device and kind. validate=True checks the
    manifest first and raises MXNetError on a torn or corrupt step; a
    quantization scheme that differs from the template's is refused
    before anything is read."""
    from . import engine
    final = _step_path(directory, step)
    try:
        engine.wait_for_var(engine.file_var(final))  # after async saves
    except Exception:
        # a failed async save surfaced through its Future already; the
        # manifest check below decides what is on disk
        pass
    if validate:
        errors = validate_checkpoint(final)
        if errors:
            raise MXNetError("invalid checkpoint: " + "; ".join(errors))
    manifest = _read_manifest(final) or {}
    if manifest.get("tiered"):
        raise _unported("restoring tiered embedding tables", "[5d]")
    qdiag = quantization_mismatches(final, template)
    if qdiag:
        raise MXNetError(
            f"restore of {final} refused: quantization scheme mismatch "
            f"(saved vs template): " + "; ".join(qdiag) +
            " — requantize the template (or restore into a matching "
            "quantized tree) before loading")
    leaves = _flatten_with_path(template)

    def do_load():
        if _finj.ENABLED:
            _finj.check("checkpoint.load", context=final)
        state = os.path.join(final, STATE_DIR)
        if leaves and not os.path.isdir(state) or any(
                os.path.exists(os.path.join(state, n))
                for n in _ORBAX_MARKERS):
            raise MXNetError(
                f"{final} holds no {STATE_DIR}/ of .npy leaves: a "
                f"checkpoint of the JAX package (Orbax) does not load in "
                f"the port")
        out = []
        for path, like in leaves:
            name = _leaf_name(path)
            fname = _leaf_file(final, name)
            if not os.path.exists(fname):
                raise MXNetError(f"checkpoint {final} has no leaf {name!r}")
            out.append(_restore_leaf(np.load(fname, allow_pickle=False),
                                     like, name))
        return out

    return _unflatten(template, _policy().call(do_load))


def read_extra(directory, step, name):
    """One extras sidecar of a step (bytes), or None."""
    path = os.path.join(_step_path(directory, step), name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------- last-known-good journal
def read_health(directory, step=None):
    """The health record saved with a step ({"loss", "finite",
    "healthy", ...}), or None where there is none or it is unreadable.
    `directory` is the step directory (step=None) or the root + step."""
    path = directory if step is None else _step_path(directory, step)
    try:
        with open(os.path.join(path, HEALTH_NAME)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def is_healthy(health):
    """A step without a record is trusted; only ``healthy: false``
    disqualifies it."""
    if health is None:
        return True
    return bool(health.get("healthy", True))


class CheckpointManager:
    """Step-stamped rolling checkpoints with resume (reference: the
    epoch-checkpoint callbacks and the kvstore resume path): atomic,
    manifest-validated saves, the newest valid step restored with
    fallback, async saves, and a SIGTERM emergency save."""

    def __init__(self, directory, max_to_keep=3):
        from . import engine
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._pending = []            # async save / prune futures
        self._emergency = None
        # every async save and its prune in one cancellable TaskGroup
        self._group = engine.TaskGroup("checkpoint")
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def valid_steps(self):
        """Steps whose manifest validates, oldest first."""
        return [s for s in self.steps()
                if not validate_checkpoint(_step_path(self.directory, s))]

    def save(self, step, params, _async=False, extras=None, health=None):
        """Save one step atomically, then prune to `max_to_keep` (from the
        listing after the save; the step just written is never pruned).
        _async=True returns a Future (the prune rides behind it on the
        engine); `wait()` drains. `health` (a JSON-able dict, at least
        ``{"healthy": bool}``) lands as ``health.json``, the journal
        `restore_latest_healthy` reads."""
        if extras and HEALTH_NAME in extras:
            # health= is the only door: a forged sidecar smuggled through
            # extras would be trusted by restore_latest_healthy
            raise MXNetError(f"extras may not name {HEALTH_NAME!r}; "
                             f"pass health= instead")
        if health is not None:
            extras = dict(extras or {})
            extras[HEALTH_NAME] = json.dumps(health).encode()
        if not _async:
            path = save_sharded(self.directory, step, params, extras=extras)
            if _writer():
                self._prune(step)
            return path
        if not _writer():
            return save_sharded(self.directory, step, params, _async=True,
                                extras=extras)
        from . import engine
        fut = save_sharded(self.directory, step, params, _async=True,
                           extras=extras, _group=self._group)
        path = _step_path(self.directory, step)

        def prune_after(fut=fut, step=step):
            # a shed or cancelled save wrote nothing (pruning with it as
            # just saved would evict a valid step); a failed one rides
            # `fut` for wait()
            if fut.exception() is not None or engine.skipped(fut.result()):
                return None
            return self._prune(step)

        try:
            done = engine.push(prune_after,
                               read_vars=[engine.file_var(path)],
                               priority=engine.PRIORITY_BACKGROUND,
                               group=self._group)
        except engine.EngineQueueFull:
            done = None       # the next save's prune recomputes from all
        # keep failed futures for wait(); bounded for callers who never
        # wait (each failure is in engine.failures() already)
        self._pending = [f for f in self._pending
                         if not f.done() or f.exception() is not None]
        cap = 2 * self.max_to_keep + 8
        if len(self._pending) > cap:
            live = [f for f in self._pending if not f.done()]
            failed = [f for f in self._pending if f.done()]
            while failed and len(live) + len(failed) > cap:
                _log().warning("dropping unobserved async-save failure: %r",
                               failed.pop(0).exception())
            self._pending = failed + live
        self._pending.append(fut)
        if done is not None:
            self._pending.append(done)
        return fut

    def _prune(self, just_saved):
        steps = self.steps()
        if just_saved not in steps:
            steps = sorted(steps + [int(just_saved)])
        # manifest-less directories are outside the quota (a torn step
        # never evicts a valid one) and never deleted here
        steps = [s for s in steps
                 if s == just_saved or
                 _manifest_complete(_step_path(self.directory, s))]
        # while the step just written is journalled unhealthy, keep the
        # newest healthy step past the quota (the rollback target)
        newest_healthy = None
        if not is_healthy(read_health(_step_path(self.directory,
                                                 just_saved))):
            for s in reversed(steps):
                if s != just_saved and is_healthy(
                        read_health(_step_path(self.directory, s))):
                    newest_healthy = s
                    break
        excess = len(steps) - self.max_to_keep
        for victim in steps:
            if excess <= 0:
                break
            if victim in (just_saved, newest_healthy):
                continue
            shutil.rmtree(_step_path(self.directory, victim),
                          ignore_errors=True)
            excess -= 1

    def wait(self):
        """Drain the async saves, re-raising the first failure."""
        pending, self._pending = self._pending, []
        first_exc = None
        for f in pending:
            try:
                f.result()
            except Exception as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc

    def cancel_pending(self, drain_timeout=None):
        """Cancel queued async saves and prunes (their futures resolve to
        `engine.CANCELLED`; nothing is poisoned or recorded as failed) and
        wait for the running ones. Returns the number cancelled."""
        n = self._group.cancel()
        self._group.drain(drain_timeout)
        return n

    def _restore_scan(self, template, validate=True, want_healthy=False,
                      skipped_unhealthy=None):
        """The newest-first scan of the restore flavours. Every candidate
        tried is validated against its manifest (full sha256), and each
        corrupt one counts into ``checkpoint_fallbacks``; `want_healthy`
        also skips intact steps journalled unhealthy (counted into
        ``checkpoint_unhealthy_skips``, their steps appended to
        `skipped_unhealthy`)."""
        for step in reversed(self.steps()):
            path = _step_path(self.directory, step)
            if validate:
                errors = validate_checkpoint(path)
                if errors:
                    _fallback_counter.inc()
                    _log_fallback(step, errors)
                    continue
            if want_healthy and not is_healthy(read_health(path)):
                _unhealthy_counter.inc()
                if skipped_unhealthy is not None:
                    skipped_unhealthy.append(step)
                _log().warning("rollback skipping step %s: intact but "
                               "journalled unhealthy", step)
                continue
            try:
                return step, load_sharded(self.directory, step, template,
                                          validate=False)
            except Exception as e:
                _fallback_counter.inc()
                _log_fallback(step, [repr(e)])
        return None, None

    def restore_latest(self, template, validate=True):
        """Restore the newest valid step; torn or unreadable steps are
        skipped, each counted into ``checkpoint_fallbacks``. Returns
        (step, params) or (None, None)."""
        return self._restore_scan(template, validate=validate)

    def restore_step(self, step, template, validate=True):
        """Restore one given step, with no fallback: raises on a missing
        or (with `validate`) torn step."""
        path = _step_path(self.directory, int(step))
        if validate:
            errors = validate_checkpoint(path)
            if errors:
                raise MXNetError(f"checkpoint step {step} failed "
                                 f"validation: {errors}")
        return load_sharded(self.directory, int(step), template,
                            validate=False)

    def restore_latest_healthy(self, template, validate=True,
                               strict=False):
        """Restore the newest step that is valid and journalled healthy
        (steps without a journal are trusted). Without one, the newest
        merely valid step, with a warning (`strict=True`: (None, None)
        instead). Returns (step, params) or (None, None)."""
        skipped = []
        step, params = self._restore_scan(template, validate=validate,
                                          want_healthy=True,
                                          skipped_unhealthy=skipped)
        if step is not None or strict:
            return step, params
        # the steps the scan validated and set aside, newest first: no
        # second checksum pass, no double-counted fallbacks
        for step in skipped:
            try:
                params = load_sharded(self.directory, step, template,
                                      validate=False)
            except Exception as e:
                _fallback_counter.inc()
                _log_fallback(step, [repr(e)])
                continue
            _log().warning("no healthy checkpoint found; restoring newest "
                           "intact step %s despite its health journal",
                           step)
            return step, params
        return None, None

    def healthy_steps(self):
        """Steps that are valid and journalled healthy (oldest first)."""
        return [s for s in self.valid_steps()
                if is_healthy(self.read_health(s))]

    def read_extra(self, step, name):
        return read_extra(self.directory, step, name)

    def read_health(self, step):
        return read_health(self.directory, step)

    # ------------------------------------------------- emergency save
    def enable_emergency_save(self, params_fn, step_fn=None,
                              extras_fn=None, health_fn=None):
        """Arm a SIGTERM emergency checkpoint: installs the preemption
        handler and registers a synchronous save of `params_fn()` at step
        `step_fn()` (default: one past the newest step), with
        `extras_fn()` and `health_fn()`'s record. The loop polls
        `mx.fault.check_preempted()` to unwind afterwards. Returns the
        registered callback."""
        from .fault import preemption as _pre

        def emergency():
            # queued async saves must not compete with this one: cancel
            # them, and bound the wait for a running one
            self.cancel_pending(drain_timeout=30.0)
            step = step_fn() if step_fn is not None else \
                (self.steps()[-1] + 1 if self.steps() else 0)
            extras = extras_fn() if extras_fn is not None else None
            params = params_fn()
            health = health_fn() if health_fn is not None else None
            self.save(int(step), params, extras=extras, health=health)

        self.disable_emergency_save()   # re-arming replaces
        _pre.install_preemption_handler()
        _pre.on_preemption(emergency)
        self._emergency = emergency
        return emergency

    def disable_emergency_save(self):
        if self._emergency is not None:
            from .fault import preemption as _pre
            _pre.remove_on_preemption(self._emergency)
            self._emergency = None


def _log_fallback(step, errors):
    _log().warning("skipping invalid checkpoint step %s: %s", step,
                   "; ".join(errors))
