"""Data parallelism of the port against the JAX package on the CPU.

The port runs in spawned gloo ranks (P = 2 and P = 4, every case of a
world size in one spawn, both spawns at once; the ranks import torch,
numpy and the port only); the JAX package runs here, on the conftest's
8-device CPU mesh cut to P devices, or on one device where its reference
is the whole batch. Both take the same inputs, made with numpy from a
seed, and the same weights (set by position in `collect_params()`, never
by sorted names). The cases:

  * `make_train_step` with and without `zero` and `remat` on a small
    BatchNorm net: the global batch's statistics on every rank, as the
    JAX global-view program has them;
  * the eager `Trainer(kvstore="dist_sync")` on a 2-layer narrow BERT
    (dropout 0), each rank on its rows, against the JAX package on one
    device on the whole batch;
  * `Trainer.capture` over a store with a `dp` mesh, `grad_reduce`
    "mean" and "sum" and `sharded_update=True`, in the flow of
    `tests/test_cachedop.py::test_captured_ici_psum_and_sharded_update_parity`;
  * the prefetcher staging each rank's rows for that captured step;
  * a ZeRO checkpoint saved at P = 2 and restored here at P = 1.

Tolerances are the matching JAX tests': `tests/test_parallel.py` for the
step (rtol 1e-5, atol 1e-6), `tests/test_cachedop.py` for the captured
step (rtol 2e-4, atol 1e-5) and `tests/test_torch_bert.py` for BERT."""
import json
import multiprocessing
import os
import socket
import traceback

import numpy as np
import pytest
import torch

WORLDS = (2, 4)
RANK_TIMEOUT_S = 150
DP_TOL = dict(rtol=1e-5, atol=1e-6)          # tests/test_parallel.py
CAP_TOL = dict(rtol=2e-4, atol=1e-5)         # tests/test_cachedop.py
BERT_TOL = dict(rtol=1e-4, atol=1e-6)        # tests/test_torch_bert.py

# the BatchNorm net: Dense(16) -> BatchNorm -> relu -> Dense(3)
BN_B, BN_IN, BN_H, BN_OUT, BN_STEPS = 16, 8, 16, 3, 3
# the captured step's MLP (tests/test_cachedop.py)
CAP_B, CAP_DIM, CAP_CLS, CAP_STEPS = 8, 16, 4, 4
# the narrow BERT (tests/test_torch_bert.py's TINY)
VOCAB, BERT_B, BERT_S, BERT_P, BERT_STEPS = 64, 4, 32, 5, 3
TINY = dict(vocab_size=VOCAB, units=128, hidden_size=256, num_layers=2,
            num_heads=2, max_length=BERT_S, dropout=0.0)


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds: the same on every rank and here)
# ---------------------------------------------------------------------------
def _bn_shapes():
    return [(BN_H, BN_IN), (BN_H,), (BN_H,), (BN_H,), (BN_H,), (BN_H,),
            (BN_OUT, BN_H), (BN_OUT,)]


def _bn_weights():
    rs = np.random.RandomState(11)
    out = [(0.3 * rs.randn(*s)).astype(np.float32) for s in _bn_shapes()]
    out[2] += 1.0                                # gamma
    out[5] = np.abs(out[5]) + 0.5                # running_var
    return out


def _bn_data():
    rs = np.random.RandomState(12)
    return (rs.randn(BN_B, BN_IN).astype(np.float32) * 2 + 0.5,
            rs.randint(0, BN_OUT, BN_B).astype(np.float32))


def _cap_data():
    rng = np.random.RandomState(0)
    return (rng.randn(CAP_B, CAP_DIM).astype(np.float32),
            rng.randint(0, CAP_CLS, CAP_B).astype(np.float32))


def _cap_weights():
    rs = np.random.RandomState(21)
    shapes = [(16, CAP_DIM), (16,), (16, 16), (16,), (16, 16), (16,),
              (CAP_CLS, 16), (CAP_CLS,)]
    return [(0.3 * rs.randn(*s)).astype(np.float32) for s in shapes]


def _bert_batch():
    rng = np.random.RandomState(0)
    return dict(tok=rng.randint(0, VOCAB, (BERT_B, BERT_S)).astype(np.int32),
                seg=rng.randint(0, 2, (BERT_B, BERT_S)).astype(np.int32),
                vl=np.array([BERT_S, 1, 17, 9], np.int32),
                pos=rng.randint(0, BERT_S, (BERT_B, BERT_P)).astype(
                    np.int32),
                mlm_y=rng.randint(0, VOCAB, (BERT_B, BERT_P)).astype(
                    np.int32),
                nsp_y=rng.randint(0, 2, (BERT_B,)).astype(np.int32))


def _set_weights(pkg, net, weights, ctx=None):
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(pkg.nd.array(w) if ctx is None
                   else pkg.nd.array(w, ctx=ctx))


def _nd(a, ctx):
    import mxnet_tpu_torch as mx
    return mx.nd.array(a, ctx=ctx)


def _bn_trainable_shapes():
    """The BatchNorm net's trainable shapes: both Dense layers, gamma and
    beta (the running statistics are grad_req "null")."""
    s = _bn_shapes()
    return s[:4] + s[6:]


def _zero_numel(shape, world):
    """A ZeRO leaf's size on one rank: 1/P of it when some dimension
    splits over P, else all of it."""
    n = int(np.prod(shape))
    return n // world if any(d % world == 0 and d >= world
                             for d in shape) else n


# ---------------------------------------------------------------------------
# model builders, shared by both packages (`pkg` is the package)
# ---------------------------------------------------------------------------
def _bn_net(pkg, ctx=None):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(BN_H, in_units=BN_IN), nn.BatchNorm(in_channels=BN_H),
            nn.Activation("relu"), nn.Dense(BN_OUT, in_units=BN_H))
    net.initialize(ctx=ctx) if ctx is not None else net.initialize()
    _set_weights(pkg, net, _bn_weights(), ctx)
    return net


def _cap_net(pkg, ctx=None):
    nn = pkg.gluon.nn
    net = nn.Sequential()
    net.add(nn.Dense(16, in_units=CAP_DIM, activation="relu"),
            nn.Dense(16, in_units=16, activation="relu"),
            nn.Dense(16, in_units=16, activation="relu"),
            nn.Dense(CAP_CLS, in_units=16))
    net.initialize(ctx=ctx) if ctx is not None else net.initialize()
    _set_weights(pkg, net, _cap_weights(), ctx)
    return net


def _bert_loss(pkg, model, a, rows):
    """The sum over the batch's rows of each row's mean MLM loss plus its
    NSP loss: a rank's gradient is the sum over its own rows."""
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    mlm, nsp = model(a["tok"], a["seg"], a["vl"], a["pos"])
    per = ce(mlm.reshape((-1, VOCAB)), a["mlm_y"].reshape((-1,)))
    return (per.reshape((rows, BERT_P)).mean(axis=1)
            + ce(nsp, a["nsp_y"])).sum()


def _weights_of(net):
    return [p.data().asnumpy().astype(np.float32)
            for p in net.collect_params().values()]


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _dp_cases(mx, world, rank, res):
    """make_train_step on the BatchNorm net: plain, zero, remat."""
    from mxnet_tpu_torch import gluon, parallel
    mesh = parallel.make_mesh({"dp": world})
    x, y = _bn_data()
    for tag, kw in (("dp", {}), ("zero", {"zero": True}),
                    ("remat", {"remat": True})):
        net = _bn_net(mx, mx.cpu())
        opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        step, init = parallel.make_train_step(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), opt, mesh=mesh, **kw)
        state = init()
        losses = []
        for _ in range(BN_STEPS):
            # the zero run takes batches that shard_batch placed, the
            # others the global batch, which each rank cuts when told
            if kw.get("zero"):
                xb, yb = parallel.shard_batch(mesh, (x, y))
                state, loss = step(state, xb, yb, 0.1)
            else:
                state, loss = step(state, x, y, 0.1, global_batch=True)
            losses.append(float(loss))
        params, opt_state, count = state
        res[f"{tag}_loss"] = np.array(losses)
        res[f"{tag}_params"] = np.stack([np.concatenate(
            [params[n].numpy().ravel() for n in params])])
        res[f"{tag}_count"] = np.array(int(count))
        res[f"{tag}_state_numel"] = np.array(sum(
            s.numel() for sv in opt_state.values() for s in sv))


def _bert_case(mx, world, rank, res, path):
    """The eager store path: each rank its rows, `dist_sync` sums."""
    from mxnet_tpu_torch.models import bert as tb
    rows = BERT_B // world
    batch = {k: v[rank * rows:(rank + 1) * rows]
             for k, v in _bert_batch().items()}
    a = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in batch.items()}
    model = tb.BERTForPretraining(tb.BERTModel(**TINY))
    model.load_parameters(path, ctx=mx.cpu())
    tr = mx.gluon.Trainer(model.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9},
                          kvstore="dist_sync")
    assert tr._kvstore.num_workers == world and tr._kvstore.rank == rank
    for _ in range(BERT_STEPS):
        with mx.autograd.record():
            loss = _bert_loss(mx, model, a, rows)
        loss.backward()
        tr.step(BERT_B)
    res["bert"] = np.concatenate([w.ravel() for w in _weights_of(model)])


def _capture_run(mx, mesh, sharded=False, grad_reduce="mean", feed=None):
    """CAP_STEPS captured Adam steps of the MLP over a store on `mesh`,
    fed `feed` (this rank's rows) or the global batch, which the step
    cuts (`global_batch=True`); (weights, trainer, step)."""
    from mxnet_tpu_torch import gluon
    net = _cap_net(mx, mx.cpu())
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 0.05}, kvstore="ici")
    tr._kvstore.set_mesh(mesh)
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    step = tr.capture(lambda a, b: lossf(net(a), b).mean(),
                      sharded_update=sharded, grad_reduce=grad_reduce)
    x, y = _cap_data()
    batches = feed if feed is not None else [
        (_nd(x, mx.cpu()), _nd(y, mx.cpu()))] * CAP_STEPS
    for xb, yb in batches:
        step(xb, yb, global_batch=feed is None)
        assert step.last_fallback_reason is None, step.last_fallback_reason
    assert step.cache_size == 1
    return _weights_of(net), tr, step


def _capture_cases(mx, world, rank, res):
    from mxnet_tpu_torch import parallel, prefetch
    from mxnet_tpu_torch.observability import registry
    mesh = parallel.make_mesh({"dp": world})
    for tag, kw in (("cap_mean", {}), ("cap_sum", {"grad_reduce": "sum"}),
                    ("cap_sharded", {"sharded": True})):
        w, tr, _ = _capture_run(mx, mesh, **kw)
        res[tag] = np.concatenate([a.ravel() for a in w])
        if kw.get("sharded"):
            # Adam's m and v keep this rank's rows of each weight
            st = tr._updater.states
            res["sharded_state_rows"] = np.array(
                [st[i][0].shape[0] for i in sorted(st)])
            res["sharded_state_marked"] = np.array(
                [parallel._comm.leaf_shard(st[i][0]._data) is not None
                 for i in sorted(st)])
    ops = {s["labels"].get("op") for s in
           registry().snapshot().get("kv_collective_bytes", ())}
    res["coll_ops"] = np.array(sorted(o for o in ops if o))
    # the prefetcher stages each rank's rows for the store: no second
    # placement, the same bits as the captured run fed the global batch
    x, y = _cap_data()
    host, _, _ = _capture_run(mx, mesh)
    # shard_batch's rows after an op (a cast there and back): still this
    # rank's rows, taken as they are, never cut again
    xs, ys = parallel.shard_batch(mesh, (_nd(x, mx.cpu()), _nd(y, mx.cpu())))
    xs = xs.astype("float64").astype("float32")
    cast, _, _ = _capture_run(mx, mesh, feed=[(xs, ys)] * CAP_STEPS)
    res["cast_rows"] = np.array(xs.shape[0])
    res["cast_equal"] = np.array(all(
        np.array_equal(a, b) for a, b in zip(cast, host)))
    net = _cap_net(mx, mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.05}, kvstore="ici")
    tr._kvstore.set_mesh(mesh)
    lossf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = tr.capture(lambda a, b: lossf(net(a), b).mean())
    pf = prefetch.DevicePrefetcher(((x, y) for _ in range(CAP_STEPS)),
                                   capture_spec=tr._kvstore)
    shapes, mine = [], slice(rank * (CAP_B // world),
                             (rank + 1) * (CAP_B // world))
    for xb, yb in pf:
        shapes.append(xb.shape[0])
        assert np.array_equal(xb.asnumpy(), x[mine])
        step(xb, yb)
        assert step.last_fallback_reason is None
    pf.close()
    assert step.cache_size == 1
    res["prefetch_rows"] = np.array(shapes)
    res["prefetch_equal"] = np.array(all(
        np.array_equal(a, b) for a, b in zip(_weights_of(net), host)))


def _zero_checkpoint(mx, world, rank, res, out_dir):
    """A DataParallelTrainer(zero=True)'s state saved by every rank (rank
    0 writes), restored into this rank's rows; the replicated run's
    momentum beside it for the parent's check at P = 1."""
    from mxnet_tpu_torch import checkpoint, gluon, parallel
    mesh = parallel.make_mesh({"dp": world})
    x, y = _bn_data()
    states = {}
    for zero in (False, True):
        net = _bn_net(mx, mx.cpu())
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.optimizer.SGD(learning_rate=0.1, momentum=0.9), mesh,
            zero=zero)
        for _ in range(2):
            tr.step(x, y, global_batch=True)
        states[zero] = tr.state[1]
    # by position: the parameters' names differ between processes
    zero = list(states[True].values())
    d = os.path.join(out_dir, "zero_ckpt")
    checkpoint.save_sharded(d, 2, {"opt": zero})
    parallel._comm.all_reduce(torch.zeros(1), mesh.group("dp"))  # saved
    back = checkpoint.load_sharded(d, 2, {"opt": [
        tuple(parallel._comm.clone_leaf(s).zero_() for s in sv)
        for sv in zero]})["opt"]
    res["zero_restored_equal"] = np.array(all(
        torch.equal(a, b) for sv, bv in zip(back, zero)
        for a, b in zip(sv, bv)))
    res["zero_full"] = np.concatenate([s.numpy().ravel()
                                       for sv in states[False].values()
                                       for s in sv])


def _rank_main(world, rank, port, out_dir, bert_path):
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore
    path = os.path.join(out_dir, f"p{world}_rank{rank}")
    res, errors = {}, {}
    try:
        kvstore.init_distributed(f"127.0.0.1:{port}", world, rank,
                                 device="cpu")
        try:
            for name, fn in (
                    ("dp", lambda: _dp_cases(mx, world, rank, res)),
                    ("bert", lambda: _bert_case(mx, world, rank, res,
                                                bert_path)),
                    ("capture", lambda: _capture_cases(mx, world, rank,
                                                       res)),
                    ("zero_ckpt", lambda: world == 2 and _zero_checkpoint(
                        mx, world, rank, res, out_dir))):
                try:
                    fn()
                except Exception:
                    errors[name] = traceback.format_exc()
        finally:
            kvstore.reset_distributed()
        res["errors"] = np.array(json.dumps(errors))
        np.savez(path + ".npz", **res)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def bert_path(tmp_path_factory):
    """A JAX BERTForPretraining's save_parameters file (tiny, random)."""
    import mxnet_tpu as mxj
    from mxnet_tpu.models import bert as jb
    mxj.random.seed(5)
    m = jb.BERTForPretraining(jb.BERTModel(**TINY))
    m.initialize(mxj.init.Normal(0.05))
    b = {k: mxj.nd.array(v) for k, v in _bert_batch().items()}
    m(b["tok"], b["seg"], b["vl"], b["pos"])
    path = str(tmp_path_factory.mktemp("dp_bert") / "bert.params")
    m.save_parameters(path)
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, bert_path):
    """({P: [results of rank 0, ..., rank P-1]}, the ranks' directory,
    the JAX references): the references are computed here while the
    ranks run."""
    out_dir = str(tmp_path_factory.mktemp("dp_ranks"))
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [ctx.Process(target=_rank_main,
                              args=(world, r, port, out_dir, bert_path))
                  for r in range(world)]
    for p in procs:
        p.start()
    refs = {"bert": _jax_bert(bert_path)}
    for world in WORLDS:
        for zero in (False, True):
            refs["dp", world, zero] = _jax_dp(world, zero=zero)
        refs["imperative", world] = _jax_capture(world, imperative=True)
        refs["sum", world] = _jax_capture(world, grad_reduce="sum")
        refs["sharded", world] = _jax_capture(world, sharded=True)
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = {f: open(os.path.join(out_dir, f)).read()
              for f in os.listdir(out_dir) if f.endswith(".err")}
    assert not hung and not errors, (len(hung), errors)
    return {world: [dict(np.load(os.path.join(out_dir,
                                              f"p{world}_rank{r}.npz")))
                    for r in range(world)] for world in WORLDS}, out_dir, refs


def _on_every_rank(results, key):
    """The case ran on every rank (no error) and left the same bits on
    each: the replicas stay in step."""
    for r, res in enumerate(results):
        assert key in res, (r, json.loads(str(res["errors"])))
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        np.testing.assert_array_equal(res[key], first, err_msg=f"rank {r}")
    return first


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _jax_dp(world, zero=False):
    """The JAX make_train_step over a P-device mesh: (losses, params flat
    in collect_params order)."""
    import mxnet_tpu as mxj
    import jax
    from mxnet_tpu.parallel.data_parallel import make_train_step
    from mxnet_tpu.parallel.mesh import make_mesh, shard_batch
    net = _bn_net(mxj)
    mesh = make_mesh({"dp": world})
    opt = mxj.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    step, init = make_train_step(net, mxj.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 opt, mesh=mesh, zero=zero)
    state = init()
    x, y = _bn_data()
    losses = []
    for _ in range(BN_STEPS):
        state, loss = step(state, shard_batch(mesh, x), shard_batch(mesh, y),
                           0.1, jax.random.PRNGKey(0))
        losses.append(float(loss))
    names = [n for n, _ in net.collect_params().items()]
    return np.array(losses), np.concatenate(
        [np.asarray(state[0][n]).ravel() for n in names])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["dp", "zero", "remat"])
def test_make_train_step_matches_jax_global_batchnorm(ranks, world, tag):
    """make_train_step over P ranks (global BatchNorm statistics; ZeRO
    and remat change memory, not the numbers) equals the JAX step over a
    P-device mesh: losses, weights and running statistics."""
    res = ranks[0][world]
    got_loss = _on_every_rank(res, f"{tag}_loss")
    got = _on_every_rank(res, f"{tag}_params")[0]
    want_loss, want = ranks[2]["dp", world, tag == "zero"]
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **DP_TOL)
    assert int(res[0][f"{tag}_count"]) == BN_STEPS


@pytest.mark.parametrize("world", WORLDS)
def test_zero_keeps_a_1_over_p_share_of_the_optimizer_state(ranks, world):
    """Each ZeRO leaf keeps 1/P of itself, split on its first dimension
    that P divides; the (3,) bias has none and stays whole."""
    res = ranks[0][world]
    full = int(res[0]["dp_state_numel"])
    part = int(_on_every_rank(res, "zero_state_numel"))
    assert full == sum(int(np.prod(s)) for s in _bn_trainable_shapes())
    assert part == sum(_zero_numel(s, world)
                       for s in _bn_trainable_shapes()) < full


def _jax_bert(path):
    import mxnet_tpu as mxj
    from mxnet_tpu.models import bert as jb
    model = jb.BERTForPretraining(jb.BERTModel(**TINY))
    model.load_parameters(path)
    a = {k: mxj.nd.array(v) for k, v in _bert_batch().items()}
    tr = mxj.gluon.Trainer(model.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9})
    for _ in range(BERT_STEPS):
        with mxj.autograd.record():
            loss = _bert_loss(mxj, model, a, BERT_B)
        loss.backward()
        tr.step(BERT_B)
    return np.concatenate([w.ravel() for w in _weights_of(model)])


@pytest.mark.parametrize("world", WORLDS)
def test_eager_dist_sync_trainer_matches_jax_whole_batch(ranks, world):
    """Trainer(kvstore="dist_sync") on a narrow BERT: each rank's rows,
    gradients summed over the ranks, `step(global batch)`: the weights
    equal the JAX package's on one device on the whole batch."""
    got = _on_every_rank(ranks[0][world], "bert")
    np.testing.assert_allclose(got, ranks[2]["bert"], **BERT_TOL)


def _jax_capture(world, imperative=False, sharded=False, grad_reduce="mean"):
    import mxnet_tpu as mxj
    from mxnet_tpu.parallel.mesh import make_mesh
    x, y = (mxj.nd.array(a) for a in _cap_data())
    net = _cap_net(mxj)
    tr = mxj.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.05}, kvstore="ici")
    tr._kvstore.set_mesh(make_mesh({"dp": world}))
    lossf = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    if imperative:
        for _ in range(CAP_STEPS):
            with mxj.autograd.record():
                L = lossf(net(x), y).mean()
            L.backward()
            tr.step(CAP_B)
    else:
        step = tr.capture(lambda a, b: lossf(net(a), b).mean(),
                          sharded_update=sharded, grad_reduce=grad_reduce)
        for _ in range(CAP_STEPS):
            step(x, y)
            assert step.last_fallback_reason is None
    return np.concatenate([w.ravel() for w in _weights_of(net)])


@pytest.mark.parametrize("world", WORLDS)
def test_captured_store_step_matches_jax_psum_and_sharded_update(ranks,
                                                                 world):
    """The captured step over a `dp` store: 'mean' equals the JAX
    imperative run on the whole batch, 'sum' the JAX captured 'sum', and
    sharded_update=True the replicated capture; the in-graph collectives
    are counted, and the sharded states keep 1/P of the rows."""
    res = ranks[0][world]
    mean = _on_every_rank(res, "cap_mean")
    refs = ranks[2]
    np.testing.assert_allclose(mean, refs["imperative", world], **CAP_TOL)
    np.testing.assert_allclose(_on_every_rank(res, "cap_sum"),
                               refs["sum", world], **CAP_TOL)
    sharded = _on_every_rank(res, "cap_sharded")
    np.testing.assert_allclose(sharded, mean, **CAP_TOL)
    np.testing.assert_allclose(sharded, refs["sharded", world], **CAP_TOL)
    assert {"in_graph_psum", "in_graph_reduce_scatter"} <= set(
        res[0]["coll_ops"].tolist())
    rows = _on_every_rank(res, "sharded_state_rows")
    # (16, 16, 16, 4) rows a weight and bias; 4 over P = 4 is 1 row each
    full = np.array([16, 16, 16, 16, 16, 16, CAP_CLS, CAP_CLS])
    np.testing.assert_array_equal(rows, full // world)
    assert _on_every_rank(res, "sharded_state_marked").all()


@pytest.mark.parametrize("world", WORLDS)
def test_prefetcher_stages_each_ranks_rows_for_the_store(ranks, world):
    """A DevicePrefetcher with the store as capture_spec hands each rank
    its rows, which the step takes as they are: the weights equal the
    captured run fed the global batch, bit for bit. So do those of a run
    fed `shard_batch`'s rows after a cast: an op on the rows does not
    make the step cut them again."""
    res = ranks[0][world]
    for r in res:
        np.testing.assert_array_equal(r["prefetch_rows"],
                                      [CAP_B // world] * CAP_STEPS)
        assert bool(r["prefetch_equal"])
        assert int(r["cast_rows"]) == CAP_B // world
        assert bool(r["cast_equal"])


def test_zero_checkpoint_saved_at_2_ranks_restores_at_1(ranks):
    """Rank 0 writes the gathered ZeRO state as unsharded leaves; each of
    the 2 ranks restores its own rows bit for bit, and here, at P = 1,
    the whole state equals the replicated run's momentum."""
    from mxnet_tpu_torch import checkpoint
    results, out_dir = ranks[:2]
    res = results[2]
    for r in res:
        assert "zero_restored_equal" in r, json.loads(str(r["errors"]))
        assert bool(r["zero_restored_equal"])
    d = os.path.join(out_dir, "zero_ckpt")
    assert checkpoint.validate_checkpoint(os.path.join(d, "2")) == []
    template = {"opt": [(torch.zeros(s),) for s in _bn_trainable_shapes()]}
    back = checkpoint.load_sharded(d, 2, template)["opt"]
    got = np.concatenate([sv[0].numpy().ravel() for sv in back])
    np.testing.assert_allclose(got, res[0]["zero_full"], **DP_TOL)
