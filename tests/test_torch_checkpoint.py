"""`mxnet_tpu_torch.checkpoint` held against `tests/test_checkpoint.py`'s
cases for the JAX package: atomic saves and torn writes, the checksum
manifest and the fallback to the newest valid step, retention, extras
and the health journal, async saves (ordering against a load, the
snapshot taken before an in-place update, the `EngineQueueFull`
degrade, cancellation), the SIGTERM emergency save, the quantization
scheme, and the manifest against the JAX package's for the same params.
The JAX package is imported only inside the tests that compare with it,
so the `card` test runs on the card's machine (`--noconftest -m card`)."""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, engine, fault
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import registry

CPU = mx.cpu()


def _w(v, n=2):
    return torch.full((n,), float(v))


def _counter(name, **labels):
    return registry().counter(name, **labels).value


def _corrupt_one_payload_byte(step_dir):
    for dirpath, _, files in os.walk(step_dir):
        for f in sorted(files):
            full = os.path.join(dirpath, f)
            if f != checkpoint.MANIFEST_NAME and os.path.getsize(full) > 4:
                blob = open(full, "rb").read()
                with open(full, "wb") as fh:
                    fh.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
                return full
    raise AssertionError("no payload file to corrupt")


def _params(seed=0):
    """A nested tree of every leaf kind and dtype the port saves."""
    g = torch.Generator().manual_seed(seed)
    return {"enc": {"w": mx.nd.NDArray((torch.randn(3, 4, generator=g) * 3)
                                       .to(torch.bfloat16)),
                    "b": (torch.randn(4, generator=g) * 5).half()},
            "layers": [torch.randn(2, 2, generator=g),
                       np.arange(5, dtype=np.int32)],
            "step": np.array(7, np.int64)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    if isinstance(tree, mx.nd.NDArray):
        return mx.nd.NDArray(torch.zeros_like(tree._data))
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.zeros_like(tree)


def _bits(x):
    t = x._data if isinstance(x, mx.nd.NDArray) else torch.as_tensor(x)
    return t.contiguous().view(torch.uint8) if t.dim() else \
        t.reshape(1).view(torch.uint8)


def _same(a, b):
    fa = checkpoint._flatten_with_path(a)
    fb = checkpoint._flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y), p
        assert torch.equal(_bits(x), _bits(y)), p


# ------------------------------------------------ the reference format
def test_save_load_checkpoint_crosses_both_packages(tmp_path):
    """prefix-%04d.params.npz: the port's file loads in the JAX package
    and the JAX package's in the port; a symbol raises ([8])."""
    import mxnet_tpu as jmx
    from mxnet_tpu import checkpoint as jck
    prefix = str(tmp_path / "model")
    arg = {"w": mx.nd.array([1.0, 2.0], ctx=CPU),
           "b": mx.nd.array([0.5], ctx=CPU)}
    aux = {"mean": mx.nd.array([0.1], ctx=CPU)}
    checkpoint.save_checkpoint(prefix, 3, None, arg, aux)
    _, arg2, aux2 = checkpoint.load_checkpoint(prefix, 3, ctx=CPU)
    _, jarg, jaux = jck.load_checkpoint(prefix, 3)
    for got in (arg2["w"], jarg["w"]):
        np.testing.assert_array_equal(got.asnumpy(), [1.0, 2.0])
    np.testing.assert_array_equal(jaux["mean"].asnumpy(),
                                  aux2["mean"].asnumpy())
    jck.save_checkpoint(prefix, 4, None, {"w": jmx.nd.array([3.0])}, {})
    np.testing.assert_array_equal(
        checkpoint.load_checkpoint(prefix, 4, ctx=CPU)[1]["w"].asnumpy(),
        [3.0])
    with pytest.raises(MXNetError, match=r"\[8\]"):
        checkpoint.save_checkpoint(prefix, 5, object(), arg, aux)
    open(prefix + "-symbol.json", "w").write("{}")
    with pytest.raises(MXNetError, match=r"\[8\]"):
        checkpoint.load_checkpoint(prefix, 3, ctx=CPU)


# ------------------------------------------------------- the payload
def test_sharded_roundtrip_keeps_every_bit_and_kind(tmp_path):
    """bf16, fp16, fp32, int leaves, nested dicts and lists: each leaf
    back bit for bit, as the template leaf's kind, dtype and device, the
    template's key order kept; one .npy a leaf under state/."""
    params = _params()
    checkpoint.save_sharded(str(tmp_path), 100, params)
    template = _zeros_like(params)
    restored = checkpoint.load_sharded(str(tmp_path), 100, template)
    _same(restored, params)
    assert list(restored) == list(template)
    files = sorted(checkpoint._walk_files(
        os.path.join(str(tmp_path), "100", "state")))
    assert [r for r, _ in files] == ["enc/b.npy", "enc/w.npy",
                                     "layers/0.npy", "layers/1.npy",
                                     "step.npy"]
    bad = _zeros_like(params)
    bad["layers"][0] = torch.zeros(3, 2)
    with pytest.raises(MXNetError, match="shape"):
        checkpoint.load_sharded(str(tmp_path), 100, bad)
    extra = dict(_zeros_like(params), more=torch.zeros(1))
    with pytest.raises(MXNetError, match="no leaf 'more'"):
        checkpoint.load_sharded(str(tmp_path), 100, extra)


def test_template_dtype_wins(tmp_path):
    """A leaf saved in bf16 restores into an fp32 template as its exact
    values (the template's dtype wins, as the JAX restore's does)."""
    t = (torch.randn(8) * 3).to(torch.bfloat16)
    checkpoint.save_sharded(str(tmp_path), 0, {"w": t})
    got = checkpoint.load_sharded(str(tmp_path), 0,
                                  {"w": torch.zeros(8)})["w"]
    assert got.dtype == torch.float32 and torch.equal(got, t.float())


def test_manager_rolls(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"w": _w(step)})
    assert mgr.steps() == [2, 3]
    step, restored = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 3 and torch.equal(restored["w"], _w(3))


# -------------------------------------------- atomic save, torn writes
def test_atomic_save_writes_manifest_and_validates(tmp_path):
    d = str(tmp_path)
    checkpoint.save_sharded(d, 7, {"w": torch.arange(4.0)},
                            extras={"meta.json": b"{}"})
    step_dir = os.path.join(d, "7")
    assert os.path.exists(os.path.join(step_dir, checkpoint.MANIFEST_NAME))
    assert checkpoint.validate_checkpoint(step_dir) == []
    assert checkpoint.read_extra(d, 7, "meta.json") == b"{}"
    assert checkpoint.read_extra(d, 7, "absent") is None
    assert not [n for n in os.listdir(d) if n.startswith(".tmp")]
    with pytest.raises(MXNetError, match="invalid extra name"):
        checkpoint.save_sharded(d, 8, {"w": _w(1)},
                                extras={checkpoint.MANIFEST_NAME: b""})


def test_torn_write_never_shadows_the_good_step(tmp_path, monkeypatch):
    """A save that dies before its payload (the `checkpoint.save` fault
    past every retry) or after it, before the manifest lands (a failing
    manifest write), leaves no step and no temporary directory, and the
    old step 1 stays whole; a directory without a manifest (torn before
    it landed) is invalid."""
    d = str(tmp_path)
    checkpoint.save_sharded(d, 1, {"w": _w(1)})
    fault.inject("checkpoint.save", times=10)
    try:
        with pytest.raises(fault.FaultInjected):
            checkpoint.save_sharded(d, 1, {"w": _w(9)})
    finally:
        fault.clear()

    def torn(root, *a, **k):
        assert os.path.exists(os.path.join(root, "state", "w.npy"))
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint, "_write_manifest", torn)
    monkeypatch.setattr(checkpoint, "_ckpt_policy", checkpoint._retry.
                        RetryPolicy(max_retries=1, base_delay=0.0))
    for step in (1, 2):
        with pytest.raises(OSError, match="disk full"):
            checkpoint.save_sharded(d, step, {"w": _w(9)})
    assert sorted(os.listdir(d)) == ["1"]
    assert checkpoint.validate_checkpoint(os.path.join(d, "1")) == []
    got = checkpoint.load_sharded(d, 1, {"w": torch.zeros(2)})
    assert torch.equal(got["w"], _w(1))
    os.makedirs(os.path.join(d, "3"))
    assert checkpoint.validate_checkpoint(os.path.join(d, "3"))


def test_validate_detects_corruption(tmp_path):
    d = str(tmp_path)
    checkpoint.save_sharded(d, 1, {"w": torch.arange(8.0)})
    _corrupt_one_payload_byte(os.path.join(d, "1"))
    errs = checkpoint.validate_checkpoint(os.path.join(d, "1"))
    assert errs and "checksum" in " ".join(errs)
    with pytest.raises(MXNetError, match="invalid checkpoint"):
        checkpoint.load_sharded(d, 1, {"w": torch.zeros(8)})


def test_restore_latest_falls_back_to_newest_valid(tmp_path):
    d = str(tmp_path)
    mgr = checkpoint.CheckpointManager(d, max_to_keep=5)
    for s in (1, 2, 3):
        mgr.save(s, {"w": _w(s)})
    _corrupt_one_payload_byte(os.path.join(d, "3"))
    fb0 = _counter("checkpoint_fallbacks")
    step, restored = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 2 and torch.equal(restored["w"], _w(2))
    assert _counter("checkpoint_fallbacks") == fb0 + 1
    assert mgr.valid_steps() == [1, 2]
    with pytest.raises(MXNetError, match="failed validation"):
        mgr.restore_step(3, {"w": torch.zeros(2)})


def test_restore_scan_validates_every_candidate(tmp_path):
    d = str(tmp_path)
    mgr = checkpoint.CheckpointManager(d, max_to_keep=10)
    for s in (1, 2, 3):
        mgr.save(s, {"w": _w(s)}, health={"healthy": True})
    os.remove(os.path.join(d, "3", checkpoint.MANIFEST_NAME))
    with open(os.path.join(d, "2", checkpoint.HEALTH_NAME), "ab") as f:
        f.write(b" ")
    c0 = _counter("checkpoint_fallbacks")
    step, params = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 1 and torch.equal(params["w"], _w(1))
    assert _counter("checkpoint_fallbacks") == c0 + 2
    c1 = _counter("checkpoint_fallbacks")
    step, _ = mgr.restore_latest_healthy({"w": torch.zeros(2)})
    assert step == 1 and _counter("checkpoint_fallbacks") == c1 + 2


# ------------------------------------------------------------ retention
def test_retention_recomputes_after_save_never_deletes_new(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"w": _w(s)})
    assert mgr.steps() == [2, 3]
    mgr.save(3, {"w": _w(3.5)})
    assert mgr.steps() == [2, 3]
    mgr.save(1, {"w": _w(1.5)})
    assert 1 in mgr.steps() and len(mgr.steps()) == 2


def test_retention_never_deletes_pre_manifest_dirs(tmp_path):
    d = str(tmp_path)
    legacy = os.path.join(d, "10")
    os.makedirs(legacy)
    with open(os.path.join(legacy, "payload"), "wb") as f:
        f.write(b"old-format checkpoint")
    mgr = checkpoint.CheckpointManager(d, max_to_keep=2)
    for s in (20, 21, 22):
        mgr.save(s, {"w": _w(s)})
    assert os.path.exists(legacy)
    assert mgr.steps() == [10, 21, 22]


@pytest.mark.parametrize("case", ["pin", "exact"])
def test_retention_and_the_healthy_pin(tmp_path, case):
    """An unhealthy streak keeps the newest healthy step past the quota,
    and a healthy save releases it; healthy saves keep the quota exact."""
    if case == "pin":
        mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
        mgr.save(1, {"w": _w(1)}, health={"healthy": True})
        for s in (2, 3, 4):
            mgr.save(s, {"w": _w(s)}, health={"healthy": False})
        assert 1 in mgr.steps()
        step, params = mgr.restore_latest_healthy({"w": torch.zeros(2)})
        assert step == 1 and torch.equal(params["w"], _w(1))
        mgr.save(5, {"w": _w(5)}, health={"healthy": True})
        mgr.save(6, {"w": _w(6)}, health={"healthy": True})
        assert 1 not in mgr.steps()
    else:
        mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=1)
        for s in range(1, 5):
            mgr.save(s, {"w": _w(s)}, health={"healthy": True})
        assert mgr.steps() == [4]
        mgr.save(5, {"w": _w(5)})
        assert mgr.steps() == [5]


# ----------------------------------------------------- health journal
def test_health_journal_and_extras(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=10)
    mgr.save(1, {"w": _w(1)}, health={"healthy": True, "loss": 0.5},
             extras={"trainer": b"\x00\x01", "cursor": b"12"})
    mgr.save(2, {"w": _w(2)}, health={"healthy": False,
                                      "loss": float("nan")})
    mgr.save(3, {"w": _w(3)})
    assert mgr.read_health(1)["loss"] == 0.5
    assert mgr.read_health(3) is None
    assert checkpoint.is_healthy(mgr.read_health(3))
    assert not checkpoint.is_healthy(mgr.read_health(2))
    assert mgr.healthy_steps() == [1, 3]
    assert mgr.read_extra(1, "trainer") == b"\x00\x01"
    assert mgr.read_extra(1, "cursor") == b"12"
    for kw in (dict(health={"healthy": True}), {}):
        with pytest.raises(MXNetError):
            mgr.save(4, {"w": _w(4)},
                     extras={checkpoint.HEALTH_NAME: b"{}"}, **kw)


def test_restore_latest_healthy_skips_fallbacks_and_strict(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=10)
    mgr.save(1, {"w": _w(1)}, health={"healthy": True})
    mgr.save(2, {"w": _w(2)}, health={"healthy": False})
    u0 = _counter("checkpoint_unhealthy_skips")
    step, params = mgr.restore_latest_healthy({"w": torch.zeros(2)})
    assert step == 1 and _counter("checkpoint_unhealthy_skips") == u0 + 1
    assert mgr.restore_latest({"w": torch.zeros(2)})[0] == 2
    mgr2 = checkpoint.CheckpointManager(str(tmp_path / "b"), max_to_keep=10)
    mgr2.save(4, {"w": _w(4)}, health={"healthy": False})
    assert mgr2.restore_latest_healthy({"w": torch.zeros(2)})[0] == 4
    assert mgr2.restore_latest_healthy({"w": torch.zeros(2)},
                                       strict=True) == (None, None)


# ------------------------------------------------------------ async save
def test_async_save_orders_against_a_load(tmp_path):
    """An async save returns at once; a restore right after it (no wait)
    orders after the write on the step's file var."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in range(3):
        fut = mgr.save(s, {"w": torch.arange(4.0) + s}, _async=True)
        got = checkpoint.load_sharded(str(tmp_path), s,
                                      {"w": torch.zeros(4)})
        assert torch.equal(got["w"], torch.arange(4.0) + s)
    mgr.wait()
    assert fut.done() and fut.exception() is None
    assert mgr.valid_steps() == [1, 2]


def test_async_save_snapshots_before_an_in_place_update(tmp_path):
    """The fused update writes the saved tensors in place: `save` copies
    them before it returns, so the step restores the values from before
    the update, with the write still queued behind a blocked engine."""
    gate = threading.Event()
    blockers = [engine.push(gate.wait) for _ in range(engine.num_workers())]
    try:
        w = mx.nd.NDArray(torch.arange(6.0).to(torch.bfloat16))
        m = torch.full((6,), 0.25, dtype=torch.float16)
        before = (w._data.clone(), m.clone())
        mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
        fut = mgr.save(5, {"w": w, "m": m}, _async=True)
        assert not fut.done()
        w._data.mul_(3).add_(1)
        m.add_(1)
    finally:
        gate.set()
    mgr.wait()
    for b in blockers:
        b.result(timeout=30)
    step, got = mgr.restore_latest({"w": mx.nd.NDArray(torch.zeros(
        6, dtype=torch.bfloat16)), "m": torch.zeros(6, dtype=torch.float16)})
    assert step == 5
    assert torch.equal(got["w"]._data, before[0])
    assert torch.equal(got["m"], before[1])


def test_async_save_failure_surfaces_and_recovers(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    fault.inject("checkpoint.save", times=10)
    try:
        mgr.save(6, {"w": torch.arange(4.0)}, _async=True)
        with pytest.raises(fault.FaultInjected):
            mgr.wait()
    finally:
        fault.clear()
        engine.clear_failures()
    assert mgr.valid_steps() == []
    mgr.save(6, {"w": torch.arange(4.0)})
    assert mgr.valid_steps() == [6]


def test_save_retries_injected_fault(tmp_path):
    r0 = _counter("fault_retries", site="checkpoint")
    fault.inject("checkpoint.save", times=1)
    try:
        checkpoint.save_sharded(str(tmp_path), 4, {"w": torch.arange(4.0)})
    finally:
        fault.clear()
    assert checkpoint.validate_checkpoint(str(tmp_path / "4")) == []
    assert _counter("fault_retries", site="checkpoint") >= r0 + 1


def _wedge_engine():
    gate = threading.Event()
    blockers = [engine.push(gate.wait) for _ in range(engine.num_workers())]
    time.sleep(0.05)
    return gate, blockers


def test_rejected_async_save_degrades_to_a_sync_save(tmp_path):
    """A bounded background class under `reject` (EngineQueueFull): the
    save lands synchronously, wait() stays clean, and the next save's
    prune recomputes retention."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    gate, blockers = _wedge_engine()
    engine.push(lambda: None, priority=engine.PRIORITY_BACKGROUND)
    time.sleep(0.05)
    prev = engine.set_queue_limit(engine.PRIORITY_BACKGROUND, 1, "reject")
    try:
        fut = mgr.save(1, {"w": _w(1)}, _async=True)
        assert fut.done() and not checkpoint.validate_checkpoint(
            str(tmp_path / "1"))
        assert mgr.save(2, {"w": _w(2)}, _async=True).done()
    finally:
        engine.set_queue_limit(engine.PRIORITY_BACKGROUND, *prev)
        gate.set()
        engine.wait_for_all()
    mgr.wait()
    assert mgr.steps() == [1, 2]
    mgr.save(3, {"w": _w(3)})
    assert mgr.steps() == [2, 3]


def test_rejected_save_orders_after_a_queued_save_of_the_same_step(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=4)
    gate, blockers = _wedge_engine()
    first = mgr.save(1, {"w": _w(1)}, _async=True)
    prev = engine.set_queue_limit(engine.PRIORITY_BACKGROUND, 1, "reject")
    results = {}
    t = threading.Thread(target=lambda: results.setdefault(
        "fut", mgr.save(1, {"w": _w(2)}, _async=True)))
    try:
        t.start()
        time.sleep(0.2)
        assert t.is_alive() and not first.done()
    finally:
        engine.set_queue_limit(engine.PRIORITY_BACKGROUND, *prev)
        gate.set()
        t.join(timeout=30)
    first.result(timeout=30)
    results["fut"].result(timeout=30)
    engine.wait_for_all()
    step, restored = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 1 and torch.equal(restored["w"], _w(2))


# ------------------------------------------------------- emergency save
def _sigterm_and_reset(mgr):
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert fault.preempted()
        with pytest.raises(fault.Preempted):
            fault.check_preempted()
    finally:
        mgr.disable_emergency_save()
        fault.reset_preemption(clear_callbacks=True)
        fault.uninstall_preemption_handler()


def test_emergency_save_on_sigterm(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=3)
    state = {"step": 11, "w": _w(11)}
    mgr.enable_emergency_save(
        params_fn=lambda: {"w": state["w"]},
        step_fn=lambda: state["step"],
        extras_fn=lambda: {"meta.json": b'{"emergency": true}'},
        health_fn=lambda: {"healthy": False, "loss": 1e30})
    p0 = _counter("preemptions")
    _sigterm_and_reset(mgr)
    assert _counter("preemptions") == p0 + 1
    assert mgr.valid_steps() == [11]
    assert mgr.read_extra(11, "meta.json") == b'{"emergency": true}'
    assert mgr.read_health(11)["healthy"] is False
    step, restored = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 11 and torch.equal(restored["w"], _w(11))


def test_emergency_save_through_the_fault_point(tmp_path):
    """`preempt.sigterm` with action sigterm delivers a real SIGTERM at
    its hit; the emergency save publishes a valid step."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, {"w": _w(1)})
    mgr.enable_emergency_save(params_fn=lambda: {"w": _w(2)})
    fault.inject("preempt.sigterm", at=[1], action="sigterm")
    try:
        assert fault.check("preempt.sigterm") is True
        assert fault.preempted()
    finally:
        fault.clear()
        mgr.disable_emergency_save()
        fault.reset_preemption(clear_callbacks=True)
        fault.uninstall_preemption_handler()
    assert mgr.valid_steps() == [1, 2]


def test_cancel_pending_and_emergency_save_cancels_queued_saves(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=5)
    cb = mgr.enable_emergency_save(params_fn=lambda: {"w": _w(9)},
                                   step_fn=lambda: 9)
    gate = threading.Event()
    blockers = [engine.push(gate.wait) for _ in range(engine.num_workers())]
    try:
        futs = [mgr.save(s, {"w": _w(s)}, _async=True) for s in (1, 2)]
        threading.Timer(0.3, gate.set).start()
        cb()
        for f in futs:
            assert f.result(timeout=10) is engine.CANCELLED
    finally:
        gate.set()
        mgr.disable_emergency_save()
        fault.reset_preemption(clear_callbacks=True)
        fault.uninstall_preemption_handler()
    engine.wait_for_all()
    assert mgr.valid_steps() == [9]
    assert engine.failures() == []


# ------------------------------------------- manifest and quantization
def test_manifest_matches_the_jax_packages_for_the_same_params(tmp_path):
    """The same tree saved by both packages: the manifest's keys, the
    partition specs (every leaf unsharded) and the quantization scheme
    are equal; the files listed differ (Orbax's payload against one
    .npy a leaf). The JAX package's step validates here, its extras
    read, and its Orbax payload does not restore (MXNetError)."""
    import jax.numpy as jnp
    from mxnet_tpu import checkpoint as jck
    rng = np.random.RandomState(0)
    vals = {"enc": {"w": rng.randn(3, 4).astype(np.float32),
                    "b": rng.randn(4).astype(np.float32)},
            "q": np.arange(12, dtype=np.int8).reshape(3, 4),
            "layers": [rng.randn(2).astype(np.float32)]}
    port = {"enc": {k: torch.from_numpy(v) for k, v in vals["enc"].items()},
            "q": torch.from_numpy(vals["q"]),
            "layers": [torch.from_numpy(vals["layers"][0])]}
    jaxp = {"enc": {k: jnp.asarray(v) for k, v in vals["enc"].items()},
            "q": jnp.asarray(vals["q"]),
            "layers": [jnp.asarray(vals["layers"][0])]}
    checkpoint.save_sharded(str(tmp_path / "port"), 3, port,
                            extras={"x": b"1"})
    jck.save_sharded(str(tmp_path / "jax"), 3, jaxp, extras={"x": b"1"})
    mp = json.load(open(tmp_path / "port" / "3" / checkpoint.MANIFEST_NAME))
    mj = json.load(open(tmp_path / "jax" / "3" / checkpoint.MANIFEST_NAME))
    assert sorted(mp) == sorted(mj)
    for key in ("step", "format", "complete", "partition_specs",
                "quantization"):
        assert mp[key] == mj[key], key
    assert checkpoint.derive_partition_specs(port) == \
        jck.derive_partition_specs(jaxp)
    assert mp["files"]["x"] == mj["files"]["x"]
    jdir = str(tmp_path / "jax")
    assert checkpoint.validate_checkpoint(os.path.join(jdir, "3")) == []
    assert checkpoint.read_extra(jdir, 3, "x") == b"1"
    with pytest.raises(MXNetError, match="Orbax"):
        checkpoint.load_sharded(jdir, 3, port)


def test_quantization_scheme_recorded_and_mismatch_refused(tmp_path):
    d = str(tmp_path)
    params = {"w": torch.arange(12, dtype=torch.int8).reshape(3, 4),
              "w_scale": torch.ones(3), "b": torch.zeros(4)}
    checkpoint.save_sharded(d, 0, params)
    scheme = checkpoint.saved_quantization(d, 0)
    assert scheme == {"dtype": "int8",
                      "leaves": {"w": {"dtype": "int8", "shape": [3, 4]}}}
    out = checkpoint.load_sharded(d, 0, _zeros_like(params))
    assert int(out["w"].sum()) == 66
    checkpoint.save_sharded(d, 1, {"a": torch.zeros(2)})
    assert checkpoint.saved_quantization(d, 1) == {"dtype": None,
                                                   "leaves": {}}
    checkpoint.save_sharded(d, 2, params, quantization=False)
    assert checkpoint.saved_quantization(d, 2) is None
    assert int(checkpoint.load_sharded(d, 2, _zeros_like(params))[
        "w"].sum()) == 66
    fp_t = {"w": torch.zeros(3, 4), "w_scale": torch.zeros(3),
            "b": torch.zeros(4)}
    with pytest.raises(MXNetError, match="quantization"):
        checkpoint.load_sharded(d, 0, fp_t)
    diag = checkpoint.quantization_mismatches(os.path.join(d, "0"), fp_t)
    assert any("full precision" in line for line in diag)
    checkpoint.save_sharded(d, 3, fp_t)
    with pytest.raises(MXNetError, match="quantization"):
        checkpoint.load_sharded(d, 3, params)


def test_sharded_and_tiered_leaves_raise(tmp_path):
    class MeshLeaf:
        placements = ()
        device_mesh = None
    with pytest.raises(MXNetError, match=r"DTensor.*\[5d\]"):
        checkpoint.save_sharded(str(tmp_path), 0, {"w": MeshLeaf()})
    checkpoint.save_sharded(str(tmp_path), 1, {"w": _w(1)})
    mpath = tmp_path / "1" / checkpoint.MANIFEST_NAME
    m = json.load(open(mpath))
    m["tiered"] = {"w": {}}
    json.dump(m, open(mpath, "w"))
    with pytest.raises(MXNetError, match=r"\[5d\]"):
        checkpoint.load_sharded(str(tmp_path), 1, {"w": torch.zeros(2)},
                                validate=False)


# -------------------------------------------------------------- the card
@pytest.mark.card
def test_card_async_save_before_a_replay_restores_the_step_before(tmp_path):
    """On the card: an async save taken right before a captured step's
    replay (which updates the weights and momentum in place) restores
    the values from before that step, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step is a CUDA graph")
    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(64, in_units=32, activation="relu"),
                mx.gluon.nn.Dense(8, in_units=64))
    net.initialize(ctx=ctx)
    net.cast("bfloat16")
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = tr.capture(lambda x, y: ce(net(x).astype("float32"), y).mean())
    g = torch.Generator().manual_seed(1)
    x = mx.nd.NDArray(torch.randn(16, 32, generator=g).to(ctx).bfloat16())
    y = mx.nd.NDArray(torch.randint(0, 8, (16,), generator=g).to(ctx))
    for _ in range(3):
        step(x, y)
    assert step.last_fallback_reason is None
    params = {k: p.data() for k, p in
              net._collect_params_with_prefix().items()}
    moms = {str(i): s[0] for i, s in tr._updater.states.items()}
    want = {k: v._data.clone() for k, v in {**params, **moms}.items()}
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    fut = mgr.save(3, {"params": params, "mom": moms}, _async=True)
    step(x, y)
    mgr.wait()
    assert fut.exception() is None
    _, got = mgr.restore_latest({"params": params, "mom": moms})
    torch.cuda.synchronize()
    for k, v in {**got["params"], **got["mom"]}.items():
        assert torch.equal(v._data.view(torch.int16),
                           want[k].view(torch.int16)), k
    moved = any(not torch.equal(p._data, want[k])
                for k, p in params.items())
    assert moved, "the replay did not update the weights"
