"""The port's key-value store against the JAX package on the CPU: the
cases of `tests/test_kvstore.py`.

One process: the kinds and their aliases, aggregation, `pushpull`,
optimizer offload and its state round trip and resume, the Trainer's
`update_on_kvstore` and `compression_params`, collective deadlines, and
the refusals. Four spawned gloo ranks (numpy and the port only) hold the
cross-rank cases, each against the JAX package over a 4-device mesh of
the conftest's 8: the replicated and stacked layouts (a stack of 8 rows,
two a rank), the int8 and 2-bit wires (their sizes and the dtype
gathered), error feedback, and a regression trained through the
compressed store. Numeric cases take the JAX test's tolerance; integer
and structural ones match exactly."""
import multiprocessing
import os
import socket
import traceback

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, kvstore, nd
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()
WORLD = 4
RANK_TIMEOUT_S = 120


def _kv(name):
    return kvstore.create(name, device="cpu")


def _a(x):
    return nd.array(np.asarray(x, np.float32), ctx=CPU)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def test_create_kinds():
    assert _kv("local").type == "local"
    assert _kv("device").type == "device"
    assert _kv("nccl").type == "device"
    for alias in ("ici", "dist", "dist_sync", "dist_device_sync",
                  "dist_async", "horovod"):
        assert _kv(alias).type == "ici"
    kv = _kv("local")
    assert kvstore.create(kv) is kv
    assert mx.kv is kvstore and mx.KVStore is kvstore.KVStore
    with pytest.raises(MXNetError, match="unknown kvstore"):
        _kv("bogus")


def test_create_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        kvstore.create("local")


def test_init_push_pull_aggregation():
    import mxnet_tpu as mxj
    out = {}
    for pkg, arr in ((mx, _a), (mxj, mxj.nd.array)):
        kv = _kv("local") if pkg is mx else pkg.kvstore.create("local")
        kv.init("w", arr(np.zeros(4)))
        kv.push("w", [arr(np.ones(4)), arr(np.ones(4) * 2)])
        o = arr(np.zeros(4))
        kv.pull("w", out=o)
        out[pkg] = o.asnumpy()
    np.testing.assert_array_equal(out[mx], out[mxj])
    np.testing.assert_array_equal(out[mx], np.full(4, 3.0))


def test_pushpull_and_multiple_keys():
    kv = _kv("device")
    kv.init(["a", "b"], [_a(np.zeros(2)), _a(np.zeros(2))])
    kv.push(["a", "b"], [[_a(np.ones(2))], [_a(np.ones(2) * 5)]])
    outs = kv.pull(["a", "b"])
    np.testing.assert_array_equal(outs[0].asnumpy(), [1, 1])
    np.testing.assert_array_equal(outs[1].asnumpy(), [5, 5])
    g = _a([2.0, 3.0])
    kv.pushpull("a", g)                  # out defaults to the value
    np.testing.assert_array_equal(g.asnumpy(), [2, 3])
    o1, o2 = _a(np.zeros(2)), _a(np.zeros(2))
    kv.pull("b", out=[o1, o2])           # a list of outputs: broadcast
    np.testing.assert_array_equal(o2.asnumpy(), [5, 5])
    with pytest.raises(MXNetError, match="not initialised"):
        kv.pull("c")


def test_optimizer_offload():
    """set_optimizer makes push apply the update instead of overwriting:
    grad 1 at lr 0.5 takes w = 1 to 0.5, as in the JAX package."""
    kv = _kv("local")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
    w0 = _a(np.ones(3))
    kv.init(0, w0)
    kv.push(0, [_a(np.ones(3))])
    out = _a(np.zeros(3))
    kv.pull(0, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full(3, 0.5))
    np.testing.assert_array_equal(w0.asnumpy(), np.ones(3))   # a copy


def test_rank_and_workers_single_process():
    kv = _kv("ici")
    assert kv.rank == 0 and kv.num_workers == 1
    assert kv.capture_spec() is None and kv.batch_sharding() is None


def test_row_sparse_and_the_unported_parts_raise():
    kv = _kv("local")
    with pytest.raises(MXNetError, match="sparse"):
        kv.row_sparse_pull("x")
    with pytest.raises(MXNetError, match=r"\[5d\]"):
        _kv("ici").set_shard_plan(None)
    assert kv.shard_plan() is None
    for cls in (kvstore.ControlPlane, kvstore.MemoryControlPlane,
                kvstore.FileControlPlane, kvstore.DistributedControlPlane):
        with pytest.raises(MXNetError, match=r"\[7\]"):
            cls()
    with pytest.raises(MXNetError, match=r"\[7\]"):
        kvstore.control_plane()


def test_optimizer_states_roundtrip(tmp_path):
    """save / load_optimizer_states restore the momentum: one more push on
    both stores gives the same weights."""
    kv = _kv("local")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                         momentum=0.9))
    kv.init("w", _a(np.ones(3)))
    kv.push("w", [_a(np.ones(3))])
    fname = str(tmp_path / "opt.states")
    kv.save_optimizer_states(fname)
    w1 = _a(kv.pull("w").asnumpy())
    kv2 = _kv("local")
    kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    kv2.init("w", w1)
    kv2.load_optimizer_states(fname)
    kv.push("w", [_a(np.ones(3))])
    kv2.push("w", [_a(np.ones(3))])
    np.testing.assert_array_equal(kv.pull("w").asnumpy(),
                                  kv2.pull("w").asnumpy())


def test_optimizer_states_resume_num_update(tmp_path):
    kv = _kv("local")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
    kv.init("w", _a(np.ones(3)))
    for _ in range(5):
        kv.push("w", [_a(np.ones(3))])
    assert kv._optimizer.num_update == 5
    fname = str(tmp_path / "opt.states")
    kv.save_optimizer_states(fname)
    kv2 = _kv("local")
    kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
    kv2.init("w", _a(np.ones(3)))
    kv2.load_optimizer_states(fname)
    assert kv2._optimizer.num_update == 5
    for _ in range(2):
        kv2.push("w", [_a(np.ones(3))])
    assert kv2._optimizer.num_update == 7


def test_load_optimizer_states_requires_optimizer(tmp_path):
    kv = _kv("local")
    kv.set_optimizer(mx.optimizer.create("sgd"))
    fname = str(tmp_path / "opt.states")
    kv.save_optimizer_states(fname)
    with pytest.raises(MXNetError, match="set_optimizer"):
        _kv("local").load_optimizer_states(fname)


def test_init_distributed_single_host_noop():
    kvstore.init_distributed(device="cpu")
    try:
        kv = _kv("ici")
        assert kv.num_workers == 1 and kv.rank == 0
        mesh = mx.parallel.make_mesh({"dp": 1})
        kv.set_mesh(mesh)
        # a one-rank axis takes the captured step's reduction too
        assert kv.capture_spec()[1:] == ("dp", 1)
        g = torch.arange(4.0)
        # a group of one runs its collective, an identity
        np.testing.assert_array_equal(kv.allreduce_flat([g])[0].numpy(),
                                      g.numpy())
        assert _kv("local").allreduce_flat([g])[0] is g
    finally:
        kvstore.reset_distributed()


def test_one_rank_mesh_capture_reduces_in_graph():
    """A captured step over a store on a one-rank mesh runs the in-graph
    reduction (one group, an identity): the same bits as the captured
    step without a store, `kv_collective_bytes{op=in_graph_psum}` moving
    by the gradients' bytes a step; `sharded_update=True` needs more
    than one rank."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.observability import registry
    rs = np.random.RandomState(3)
    x = _a(rs.randn(8, 5))
    y = _a(rs.randint(0, 3, 8))
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    psum = registry().counter("kv_collective_bytes", op="in_graph_psum")
    kvstore.init_distributed(device="cpu")
    try:
        weights = []
        for store in (None, "dist_sync"):
            mx.random.seed(1)
            net = gluon.nn.Dense(3, in_units=5)
            net.initialize(ctx=CPU)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore=store)
            if store:
                tr._kvstore.set_mesh(mx.parallel.make_mesh({"dp": 1}))
                with pytest.raises(MXNetError, match="sharded_update"):
                    tr.capture(lambda a, b: lossf(net(a), b).mean(),
                               sharded_update=True)(x, y)
            step = tr.capture(lambda a, b: lossf(net(a), b).mean())
            before = psum.value
            for _ in range(3):
                step(x, y)
                assert step.last_fallback_reason is None
            grad_bytes = sum(p.data().size * 4
                             for p in net.collect_params().values())
            assert psum.value - before == (3 * grad_bytes if store else 0)
            weights.append([p.data().asnumpy()
                            for p in net.collect_params().values()])
        for a, b in zip(*weights):
            np.testing.assert_array_equal(a, b)
    finally:
        kvstore.reset_distributed()


def test_compression_rejects_unknown_type():
    with pytest.raises(MXNetError, match="compression"):
        _kv("ici").set_gradient_compression({"type": "4bit"})


def test_trainer_forwards_compression_params():
    net = mx.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=CPU)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore="ici",
                          compression_params={"type": "int8"})
    assert tr._kvstore._compression == {"type": "int8", "threshold": 0.5}
    with pytest.raises(MXNetError):
        mx.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1}, kvstore="ici",
                         compression_params={"type": "bogus"})
    with pytest.raises(MXNetError):
        mx.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1}, kvstore=None,
                         compression_params={"type": "int8"})


def _on_kv_run(pkg, on_kv, ctx=None):
    """tests/test_kvstore.py's flow: Dense(4) on 8 rows of L2 loss, SGD
    with momentum, 3 steps; the weights, by position."""
    rs = np.random.RandomState(0)
    x = rs.randn(8, 6).astype(np.float32)
    y = rs.randn(8, 4).astype(np.float32)
    w0 = np.random.RandomState(5).randn(4, 6).astype(np.float32) * 0.3
    net = pkg.gluon.nn.Dense(4, in_units=6)
    net.initialize(ctx=ctx) if ctx is not None else net.initialize()
    arr = (lambda v: pkg.nd.array(v, ctx=ctx)) if ctx is not None \
        else pkg.nd.array
    net.weight.set_data(arr(w0))
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="local", update_on_kvstore=on_kv)
    lf = pkg.gluon.loss.L2Loss()
    xa, ya = arr(x), arr(y)
    for _ in range(3):
        with pkg.autograd.record():
            loss = lf(net(xa), ya)
        loss.backward()
        tr.step(8)
    return [p.data().asnumpy() for p in net.collect_params().values()]


def test_trainer_update_on_kvstore_matches_local_update():
    """The optimizer on the store (push applies, pull returns) gives the
    local update's weights, and both the JAX package's (rtol 1e-6, the
    JAX test's)."""
    import mxnet_tpu as mxj
    local = _on_kv_run(mx, False, CPU)
    on_kv = _on_kv_run(mx, True, CPU)
    jax_on_kv = _on_kv_run(mxj, True)
    for a, b, c in zip(local, on_kv, jax_on_kv):
        np.testing.assert_allclose(b, a, rtol=1e-6)
        np.testing.assert_allclose(b, c, rtol=1e-6, atol=1e-7)


def test_trainer_update_on_kvstore_requires_store():
    net = mx.gluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="requires a kvstore"):
        mx.gluon.Trainer(net.collect_params(), "sgd", {}, kvstore=None,
                         update_on_kvstore=True)


def test_update_on_kvstore_respects_mults_and_states(tmp_path):
    """lr_mult survives the stringified store keys; save / load_states
    round-trip the store's state; update() is refused."""
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    net.bias.lr_mult = 0.0
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5, "momentum": 0.9},
                          kvstore="local", update_on_kvstore=True)
    assert not tr._fused
    lf = mx.gluon.loss.L2Loss()
    x, y = _a(np.ones((2, 4))), _a(np.zeros((2, 3)))
    b0 = net.bias.data().asnumpy().copy()
    w0 = net.weight.data().asnumpy().copy()
    with autograd.record():
        loss = lf(net(x), y)
    loss.backward()
    tr.step(2)
    np.testing.assert_array_equal(net.bias.data().asnumpy(), b0)
    assert not np.allclose(net.weight.data().asnumpy(), w0)
    f = str(tmp_path / "t.states")
    tr.save_states(f)
    tr.load_states(f)
    assert set(tr._kvstore._updater.states) == {"0", "1"}
    with pytest.raises(MXNetError, match="update_on_kvstore"):
        tr.update(2)


def test_collective_timeout_fires_and_recovers(monkeypatch):
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.observability import registry
    monkeypatch.setenv("MXTPU_COLLECTIVE_TIMEOUT_MS", "100")
    kv = _kv("ici")
    a = torch.ones(4)
    c0 = registry().counter("kv_collective_timeouts", op="allreduce").value
    fault.inject("kv.timeout", at=[1], action="stall", delay=0.6)
    try:
        with pytest.raises(kvstore.CollectiveTimeout) as ei:
            kv.allreduce_([a], layout="replicated", key="w")
        assert ei.value.op == "allreduce" and ei.value.timeout_ms == 100
        assert registry().counter("kv_collective_timeouts",
                                  op="allreduce").value == c0 + 1
        out = kv.allreduce_([a], layout="replicated", key="w")
        np.testing.assert_array_equal(out.numpy(), np.ones(4))
    finally:
        fault.clear()


def test_collective_deadline_propagates_inner_errors(monkeypatch):
    from mxnet_tpu_torch import fault
    monkeypatch.setenv("MXTPU_COLLECTIVE_TIMEOUT_MS", "500")
    kv = _kv("ici")
    fault.inject("kv.collective", at=[1])
    try:
        with pytest.raises(fault.FaultInjected):
            kv.allreduce_([torch.ones(2)], layout="replicated")
    finally:
        fault.clear()


def test_collective_timeout_env_malformed_disables(monkeypatch):
    from mxnet_tpu_torch import _env
    monkeypatch.setenv("MXTPU_COLLECTIVE_TIMEOUT_MS", "soon")
    _env._warned.discard("MXTPU_COLLECTIVE_TIMEOUT_MS")
    assert kvstore.collective_timeout_ms() == 0.0
    out = _kv("ici").allreduce_([torch.ones(3)], layout="replicated")
    np.testing.assert_array_equal(out.numpy(), np.ones(3))


# ---------------------------------------------------------------------------
# four gloo ranks (the stack's 8 rows, 2 a rank)
# ---------------------------------------------------------------------------
def _stack(seed, fill=None, cols=64):
    if fill is not None:
        return np.full((8, cols), fill, np.float32)
    return np.random.RandomState(seed).randn(8, cols).astype(np.float32)


def _regression():
    rs = np.random.RandomState(1)
    w_true = rs.randn(10, 1).astype(np.float32)
    X = rs.randn(256, 10).astype(np.float32)
    return X, X @ w_true


def _port_regression(mx_, mesh, compression):
    """tests/test_kvstore.py's compressed training: 8 towers, each the
    gradient of the mean squared error on its 32 rows, two a rank,
    pushed as a stack; 60 steps at lr 0.05. Returns the final loss."""
    from mxnet_tpu_torch import parallel
    X, y = _regression()
    kv = kvstore.create("ici", device="cpu").set_mesh(mesh)
    if compression:
        kv.set_gradient_compression(compression)
    w = torch.zeros(10, 1)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    me = mesh.axis_index("dp")
    for _ in range(60):
        grads = []
        for i in (2 * me, 2 * me + 1):
            xi, yi = Xt[i * 32:(i + 1) * 32], yt[i * 32:(i + 1) * 32]
            grads.append(2.0 * xi.T @ (xi @ w - yi) / len(xi))
        total = kv.allreduce_([torch.stack(grads)], layout="stacked",
                              key="w")
        w = w - 0.05 * total / 8.0
    return float(((Xt @ w - yt) ** 2).mean())


def _rank_cases(world, rank):
    from mxnet_tpu_torch import parallel
    res = {}
    mesh = parallel.make_mesh({"dp": world})
    sh = parallel.Sharding(mesh, ("dp",))
    kv = kvstore.create("ici", device="cpu").set_mesh(mesh)
    res["rank_workers"] = np.array([kv.rank, kv.num_workers])
    res["batch_sharding_ok"] = np.array(kv.batch_sharding() == sh and
                                        kv.capture_spec()[1:] == ("dp",
                                                                  world))
    # push of two replicated towers: their sum, no cross-rank sum
    kv.init("g", torch.zeros(8, 2))
    kv.push("g", [torch.full((8, 2), float(i)) for i in range(2)],
            layout="replicated")
    res["mesh_push"] = kv.pull("g").asnumpy()
    # stacked: this rank's rows, from shard_batch, also after an op
    stacked = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    local = parallel.shard_batch(mesh, torch.from_numpy(stacked))
    res["stacked"] = kv.allreduce_([local], layout="stacked").numpy()
    res["stacked_cast"] = kv.allreduce_([local.double().float()],
                                        layout="stacked").numpy()
    res["replicated"] = kv.allreduce_([torch.full((8, 2), 3.0)],
                                      layout="replicated").numpy()
    # "auto" has no sharding to read on a tensor: it raises
    try:
        kv.allreduce_([local])
        res["auto"] = np.array("no error")
    except MXNetError as e:
        res["auto"] = np.array(str(e))
    # compression: int8, 2-bit, error feedback
    for ctype, fill in (("int8", None), ("2bit", 0.6)):
        ck = kvstore.create("ici", device="cpu").set_mesh(mesh)
        ck.set_gradient_compression({"type": ctype, "threshold": 0.5})
        a = sh.place(torch.from_numpy(_stack(0, fill)))
        res[f"{ctype}_out"] = ck.allreduce_([a], layout="stacked",
                                            key="w").numpy()
        st = ck.compression_stats
        res[f"{ctype}_wire"] = np.array(
            [st["wire_bytes_per_replica"], st["raw_bytes_per_replica"]])
        res[f"{ctype}_dtype"] = np.array(st["wire_dtype"])
    ck = kvstore.create("ici", device="cpu").set_mesh(mesh)
    ck.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    a = sh.place(torch.from_numpy(_stack(0, 0.2, 16)))
    res["feedback"] = np.array([float(ck.allreduce_(
        [a], layout="stacked", key="g").mean()) for _ in range(10)])
    res["train"] = np.array([_port_regression(mx, mesh, None),
                             _port_regression(mx, mesh, {"type": "int8"})])
    return res


def _rank_main(world, rank, port, out_dir):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        kvstore.init_distributed(f"127.0.0.1:{port}", world, rank,
                                 device="cpu")
        try:
            res = _rank_cases(world, rank)
        finally:
            kvstore.reset_distributed()
        np.savez(path + ".npz", **res)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_refs():
    """The JAX store over a 4-device mesh on the same inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import mxnet_tpu as mxj
    from mxnet_tpu.parallel.mesh import make_mesh
    mesh = make_mesh({"dp": WORLD})

    def stacked(a):
        return jax.device_put(a, NamedSharding(mesh, P("dp")))

    refs = {}
    for ctype, fill in (("int8", None), ("2bit", 0.6)):
        kv = mxj.kvstore.create("ici").set_mesh(mesh)
        kv.set_gradient_compression({"type": ctype, "threshold": 0.5})
        refs[f"{ctype}_out"] = np.asarray(kv.allreduce_(
            [stacked(_stack(0, fill))], layout="stacked", key="w"))
        st = kv.compression_stats
        refs[f"{ctype}_wire"] = [st["wire_bytes_per_replica"],
                                 st["raw_bytes_per_replica"]]
    kv = mxj.kvstore.create("ici").set_mesh(mesh)
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    a = stacked(_stack(0, 0.2, 16))
    refs["feedback"] = np.array([float(np.asarray(kv.allreduce_(
        [a], layout="stacked", key="g")).mean()) for _ in range(10)])
    X, y = _regression()
    losses = []
    for comp in (None, {"type": "int8"}):
        k = mxj.kvstore.create("ici").set_mesh(mesh)
        if comp:
            k.set_gradient_compression(comp)
        w = jnp.zeros((10, 1), jnp.float32)
        grad_fn = jax.jit(jax.grad(lambda w, X, y: jnp.mean((X @ w - y)
                                                             ** 2)))
        for _ in range(60):
            g = np.stack([np.asarray(grad_fn(w, X[i * 32:(i + 1) * 32],
                                             y[i * 32:(i + 1) * 32]))
                          for i in range(8)])
            total = k.allreduce_([stacked(g)], layout="stacked", key="w")
            w = w - 0.05 * jnp.asarray(total) / 8.0
        losses.append(float(jnp.mean((X @ w - y) ** 2)))
    refs["train"] = np.array(losses)
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """([results of rank 0..3], the JAX references, computed while the
    ranks run)."""
    out_dir = str(tmp_path_factory.mktemp("kv_ranks"))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(WORLD, r, port, out_dir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    refs = _jax_refs()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = {f: open(os.path.join(out_dir, f)).read()
              for f in os.listdir(out_dir) if f.endswith(".err")}
    assert not hung and not errors, (len(hung), errors)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(WORLD)], refs


def _same(results, key):
    for r, res in enumerate(results[1:], 1):
        np.testing.assert_array_equal(res[key], results[0][key],
                                      err_msg=f"rank {r}")
    return results[0][key]


def test_ranks_and_batch_sharding(ranks):
    results, _ = ranks
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["rank_workers"], [r, WORLD])
        assert bool(res["batch_sharding_ok"])


def test_ici_mesh_push_of_replicated_towers(ranks):
    """tests/test_kvstore.py::test_ici_mesh_allreduce: towers 0 and 1
    pushed whole sum to 1, with no sum over the ranks."""
    np.testing.assert_array_equal(_same(ranks[0], "mesh_push"),
                                  np.full((8, 2), 1.0))


def test_ici_allreduce_stacked_and_replicated_layouts(ranks):
    """A stack of 8 rows reduces to its row sum from each rank's rows
    ("stacked"), also after an op on them; a replicated value is not
    multiplied by the ranks; "auto", which the JAX package reads from an
    array's sharding, raises over a multi-rank mesh instead of guessing."""
    stacked = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for key in ("stacked", "stacked_cast"):
        np.testing.assert_array_equal(_same(ranks[0], key), stacked.sum(0))
    np.testing.assert_array_equal(_same(ranks[0], "replicated"),
                                  np.full((8, 2), 3.0))
    for res in ranks[0]:
        assert "layout='stacked' or 'replicated'" in str(res["auto"])


def test_int8_compression_close_to_exact_and_wire_is_int8(ranks):
    results, refs = ranks
    got = _same(results, "int8_out")
    exact = _stack(0).sum(0)
    # each rank quantizes the sum of its two rows, with the scale shared
    # over the ranks: the JAX test's bound of one half step a replica
    local = _stack(0).reshape(WORLD, 2, -1).sum(1)
    scale = np.abs(local).max() / 127.0
    assert np.abs(got - exact).max() <= WORLD * scale * 0.51 + 1e-6
    np.testing.assert_allclose(got, refs["int8_out"], rtol=1e-6, atol=1e-6)
    wire, raw = _same(results, "int8_wire")
    assert wire * 4 == raw and [wire, raw] == refs["int8_wire"]
    assert str(results[0]["int8_dtype"]) == "int8"


def test_2bit_compression_wire_is_16x_smaller(ranks):
    results, refs = ranks
    got = _same(results, "2bit_out")
    # every rank's sum of two 0.6 rows is above the threshold: +0.5 each
    np.testing.assert_allclose(got, np.full(64, WORLD * 0.5), rtol=1e-6)
    np.testing.assert_array_equal(got, refs["2bit_out"])
    wire, raw = _same(results, "2bit_wire")
    assert wire * 16 == raw and [wire, raw] == refs["2bit_wire"]
    assert str(results[0]["2bit_dtype"]) == "uint8"


def test_2bit_error_feedback_accumulates(ranks):
    results, refs = ranks
    sums = _same(results, "feedback")
    np.testing.assert_allclose(sums, refs["feedback"], rtol=1e-6)
    assert abs(np.mean(sums) - 8 * 0.2) < 0.25 and sums.max() > 0


def test_compressed_training_matches_uncompressed(ranks):
    results, refs = ranks
    base, comp = _same(results, "train")
    assert base < 1e-3 and comp < 5e-3, (base, comp)
    np.testing.assert_allclose([base, comp], refs["train"], rtol=1e-2,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the card (chip_smoke.py phase 11d (c) and (d); run with --noconftest)
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device store and NCCL")
    return mx.gpu(0)


@pytest.mark.card
def test_card_two_towers_pull_their_sum():
    """Two towers on one card: the gradients of two half batches of a
    bf16 Dense stack (each loss weighted 1/2) pushed to a "device" store
    pull back as their `torch.add`, bit for bit, within 0.05 of the
    halves' norms from the whole batch's gradient (the bf16 rule of the
    parity tests, on the scale the bf16 sums round at)."""
    dev = _card()
    net = mx.gluon.nn.Sequential()
    net.add(mx.gluon.nn.Dense(256, in_units=128, activation="relu"),
            mx.gluon.nn.Dense(10, in_units=256))
    net.initialize(ctx=dev)
    net.cast("bfloat16")
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(64, 128).astype(np.float32)).to(dev) \
        .to(torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 10, 64).astype(np.float32)).to(dev)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = list(net.collect_params().values())

    def grads(rows, weight):
        for p in params:
            p.zero_grad()
        with autograd.record():
            loss = ce(net(nd.NDArray(x[rows])).astype("float32"),
                      nd.NDArray(y[rows])).mean() * weight
        loss.backward()
        return [p.grad()._data.clone() for p in params]
    g0, g1 = grads(slice(0, 32), 0.5), grads(slice(32, 64), 0.5)
    whole = grads(slice(0, 64), 1.0)
    kv = kvstore.create("device")
    assert kv.device == torch.device(dev)
    for i, (a, b, w) in enumerate(zip(g0, g1, whole)):
        kv.init(i, torch.zeros_like(a))
        kv.push(i, [a, b])
        got = kv.pull(i)._data
        assert got.is_cuda and torch.equal(got, torch.add(a, b))
        assert float((got.double() - w.double()).norm()) <= 0.05 * (
            float(a.double().norm()) + float(b.double().norm()))


@pytest.mark.card
def test_card_nccl_collectives_inside_a_cuda_graph():
    """On a one-rank NCCL group: the store's in-graph all-reduce (mean),
    reduce-scatter and all-gather captured in a CUDA graph, replayed on
    new values, give those values (a sum over one rank)."""
    _card()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kvstore.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = mx.parallel.make_mesh({"dp": 1})
        kv = kvstore.create("dist_sync").set_mesh(mesh)
        g = torch.Generator().manual_seed(2)

        def draw():
            return torch.randn(512, 768, generator=g).to(mesh.device).to(
                torch.bfloat16)
        red, rs_in, ag_in = draw(), draw(), draw()
        rs_out, ag_out = torch.empty_like(rs_in), torch.empty_like(ag_in)

        def collectives():
            kv.graph_allreduce(red, "dp", 1, mean=True)
            kv.graph_reduce_scatter(rs_in, "dp", 1, out=rs_out)
            kv.graph_all_gather(ag_in, "dp", out=ag_out)
        collectives()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            collectives()
        want = [draw(), draw(), draw()]
        for t, w in zip((red, rs_in, ag_in), want):
            t.copy_(w)
        graph.replay()
        torch.cuda.synchronize()
        for got, w in zip((red, rs_out, ag_out), want):
            assert torch.equal(got, w)
    finally:
        kvstore.reset_distributed()
