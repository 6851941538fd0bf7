"""Tensor, pipeline and expert parallelism of the port against the JAX
package on the CPU (`tests/test_parallel.py`'s TP, pipeline and MoE
tests ported).

The port runs in spawned gloo ranks (P = 2 and P = 4, both spawns at
once; the ranks import torch, numpy and the port only); the JAX package
runs here on the conftest's CPU mesh cut to P devices. Both take the same
inputs, made with numpy from a seed (the MoE's weights are the JAX
package's `init_moe_params`, carried over by
`convert.moe_params_from_jax`). The cases, each at P = 2 and 4:

  * TP dense (column-parallel then row-parallel, as the JAX test, and
    again with both biases: the row bias after the sum) against the JAX
    package's TP functions under `jit`, and the gradients of x and of
    each rank's weight blocks against `jax.grad` of the dense product;
  * the GPipe pipeline (P stages of tanh(h @ w), 6 microbatches) against
    the sequential loop, forward and gradients (stacked weights and
    microbatches), and against the JAX pipeline's outputs and weight
    gradients;
  * expert-sharded `moe_ffn` (4 experts, capacity 4.0) against the
    unsharded JAX function: outputs, aux loss and every gradient;
  * `shard_params` with `tp_rules_transformer` on BERT-like names (with
    a dim that no P divides, and one that 2 divides and 4 does not)
    against the JAX package's device shards.

`tp_rules_transformer` is checked against the JAX table entry for entry
here. Tolerances are the JAX tests': rtol 1e-4, atol 1e-5."""
import json
import multiprocessing
import os
import socket
import traceback

import numpy as np
import pytest
import torch

WORLDS = (2, 4)
RANK_TIMEOUT_S = 120
TOL = dict(rtol=1e-4, atol=1e-5)
N_EXPERTS, MOE_D, MOE_F, MOE_CAP = 4, 8, 16, 4.0
# (name, shape): the spec each rule gives, and one dim (6, 10) that
# P = 4 does not divide
SHARD_NAMES = [("bert.encoder.layers.0.attn.query.weight", (8, 16)),
               ("bert.encoder.layers.0.attn.query.bias", (8,)),
               ("bert.encoder.layers.0.attn.proj.weight", (16, 8)),
               ("bert.encoder.layers.0.ffn_1.weight", (12, 8)),
               ("bert.encoder.layers.0.ffn_1.bias", (6,)),
               ("bert.encoder.layers.0.ffn_2.weight", (8, 12)),
               ("bert.word_embed.weight", (10, 8)),
               ("bert.encoder.layers.0.ln.gamma", (8,))]


def _inputs():
    """Every array of every case (numpy, seed 0)."""
    rs = np.random.RandomState(0)
    f = np.float32
    a = dict(tp_x=rs.randn(4, 16).astype(f),
             tp_w1=(rs.randn(32, 16) * 0.1).astype(f),
             tp_w2=(rs.randn(16, 32) * 0.1).astype(f),
             tp_b1=(rs.randn(32) * 0.1).astype(f),
             tp_b2=(rs.randn(16) * 0.1).astype(f),
             tp_r=rs.randn(4, 16).astype(f),
             pp_x=rs.randn(6, 4, 8).astype(f),
             pp_r=rs.randn(6, 4, 8).astype(f),
             moe_x=rs.randn(2, 8, MOE_D).astype(f),
             moe_r=rs.randn(2, 8, MOE_D).astype(f))
    for i in range(max(WORLDS)):
        a[f"pp_w{i}"] = (rs.randn(8, 8) * 0.3).astype(f)
    for name, shape in SHARD_NAMES:
        a[name] = rs.randn(*shape).astype(f)
    return a


def _moe_params():
    import jax
    from mxnet_tpu.parallel import moe
    p = moe.init_moe_params(jax.random.PRNGKey(0), N_EXPERTS, MOE_D, MOE_F)
    return {k: np.asarray(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _tp_case(mx, mesh, a, world, rank, res):
    from mxnet_tpu_torch.parallel import tensor_parallel as tp
    rows = slice(rank * 32 // world, (rank + 1) * 32 // world)
    for tag, bias in (("tp", False), ("tp_bias", True)):
        x = torch.tensor(a["tp_x"], requires_grad=True)
        w1 = torch.tensor(a["tp_w1"][rows], requires_grad=True)
        w2 = torch.tensor(a["tp_w2"][:, rows], requires_grad=True)
        b1 = torch.tensor(a["tp_b1"][rows]) if bias else None
        b2 = torch.tensor(a["tp_b2"]) if bias else None
        h = torch.relu(tp.column_parallel_dense(x, w1, b1, mesh=mesh))
        y = tp.row_parallel_dense(h, w2, b2, mesh=mesh)
        gx, gw1, gw2 = torch.autograd.grad(
            (y * torch.tensor(a["tp_r"])).sum(), (x, w1, w2))
        res.update({f"{tag}_y": y.detach().numpy(), f"{tag}_gx": gx.numpy(),
                    f"{tag}_gw1": gw1.numpy(), f"{tag}_gw2": gw2.numpy()})
    res["tp_constrain_is_x"] = np.array(tp.constrain(x, mesh, ("tp",)) is x)


def _pp_case(mx, mesh, a, world, rank, res):
    from mxnet_tpu_torch import parallel
    ws = [torch.tensor(a[f"pp_w{i}"]) for i in range(world)]
    stacked = parallel.stack_stage_params([{"w": w} for w in ws])
    stacked["w"].requires_grad_(True)
    x = torch.tensor(a["pp_x"], requires_grad=True)
    out = parallel.pipeline_apply(
        lambda p, h: torch.tanh(torch.matmul(h, p["w"])), stacked, x, mesh)
    gw, gx = torch.autograd.grad((out * torch.tensor(a["pp_r"])).sum(),
                                 (stacked["w"], x))
    res.update(pp_out=out.detach().numpy(), pp_gw=gw.numpy(),
               pp_gx=gx.numpy())
    with torch.no_grad():
        res["pp_out_no_grad"] = parallel.pipeline_apply(
            lambda p, h: torch.tanh(torch.matmul(h, p["w"])), stacked, x,
            mesh).numpy()


def _moe_case(mx, mesh, a, world, rank, res, moe_np):
    from mxnet_tpu_torch import parallel
    full = mx.convert.moe_params_from_jax(moe_np, device="cpu")
    specs = parallel.moe_param_specs()
    local = {k: parallel.Sharding(mesh, specs[k]).place(v).clone()
             .requires_grad_(True) for k, v in full.items()}
    x = torch.tensor(a["moe_x"], requires_grad=True)
    out, aux = parallel.moe_ffn(local, x, capacity_factor=MOE_CAP,
                                mesh=mesh)
    loss = (out * torch.tensor(a["moe_r"])).sum() + aux
    grads = torch.autograd.grad(loss, (x, local["gate"], local["wi"],
                                       local["wo"]))
    res.update(moe_out=out.detach().numpy(), moe_aux=aux.detach().numpy(),
               moe_gx=grads[0].numpy(), moe_ggate=grads[1].numpy(),
               moe_gwi=grads[2].numpy(), moe_gwo=grads[3].numpy())


def _shard_case(mx, mesh, a, world, rank, res):
    from mxnet_tpu_torch.parallel import tensor_parallel as tp
    got = tp.shard_params({n: torch.tensor(a[n]) for n, _ in SHARD_NAMES},
                          mesh, tp.tp_rules_transformer())
    for n, _ in SHARD_NAMES:
        res[f"shard|{n}"] = got[n].numpy()


def _rank_main(world, rank, port, in_path, out_dir):
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore
    path = os.path.join(out_dir, f"p{world}_rank{rank}")
    res, errors = {}, {}
    try:
        data = dict(np.load(in_path))
        moe_np = {k[4:]: data.pop(k) for k in list(data)
                  if k.startswith("moe.")}
        kvstore.init_distributed(f"127.0.0.1:{port}", world, rank,
                                 device="cpu")
        try:
            meshes = {ax: mx.parallel.make_mesh({ax: world})
                      for ax in ("tp", "pp", "ep")}
            for name, fn in (
                    ("tp", lambda: _tp_case(mx, meshes["tp"], data, world,
                                            rank, res)),
                    ("pp", lambda: _pp_case(mx, meshes["pp"], data, world,
                                            rank, res)),
                    ("moe", lambda: _moe_case(mx, meshes["ep"], data, world,
                                              rank, res, moe_np)),
                    ("shard", lambda: _shard_case(mx, meshes["tp"], data,
                                                  world, rank, res))):
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


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _jax_refs(a, moe_np, world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mxnet_tpu.parallel import moe as jmoe
    from mxnet_tpu.parallel import pipeline as jpp
    from mxnet_tpu.parallel import tensor_parallel as jtp
    from mxnet_tpu.parallel.mesh import make_mesh
    devs = jax.devices()[:world]
    refs = {}
    # TP: the JAX test's jit over the tp mesh, and jax.grad of the dense
    mesh = make_mesh({"tp": world}, devs)
    for tag, bias in (("tp", False), ("tp_bias", True)):
        b1 = a["tp_b1"] if bias else None
        b2 = a["tp_b2"] if bias else None

        def fn(x_, w1_, w2_, b1=b1, b2=b2):
            h = jax.nn.relu(jtp.column_parallel_dense(x_, w1_, b1,
                                                      mesh=mesh))
            return jtp.row_parallel_dense(h, w2_, b2, mesh=mesh)

        with mesh:
            refs[f"{tag}_y"] = np.asarray(jax.jit(fn, in_shardings=(
                NamedSharding(mesh, P()), NamedSharding(mesh, P("tp", None)),
                NamedSharding(mesh, P(None, "tp"))))(
                    a["tp_x"], a["tp_w1"], a["tp_w2"]))

        def dense(x_, w1_, w2_, b1=b1, b2=b2):
            h = jax.nn.relu(x_ @ w1_.T + (0 if b1 is None else b1))
            y = h @ w2_.T + (0 if b2 is None else b2)
            return jnp.sum(y * a["tp_r"])

        g = jax.grad(dense, (0, 1, 2))(a["tp_x"], a["tp_w1"], a["tp_w2"])
        refs[f"{tag}_g"] = [np.asarray(t) for t in g]
    # the pipeline: the JAX test's, and the sequential loop's gradients
    ws = [a[f"pp_w{i}"] for i in range(world)]
    pmesh = make_mesh({"pp": world}, devs)

    def stage_fn(params, h):
        return jnp.tanh(jnp.matmul(h, params["w"]))

    def piped(w, x):
        return jnp.sum(jpp.pipeline_apply(stage_fn, {"w": w}, x, pmesh)
                       * a["pp_r"])

    def seq(w, x):
        for i in range(world):
            x = jnp.tanh(jnp.matmul(x, w[i]))
        return jnp.sum(x * a["pp_r"])

    w = np.stack(ws)
    refs["pp_out"] = np.asarray(jpp.pipeline_apply(
        stage_fn, jpp.stack_stage_params([{"w": v} for v in ws]), a["pp_x"],
        pmesh))
    refs["pp_g_piped"] = np.asarray(jax.grad(piped)(w, a["pp_x"]))
    refs["pp_g_seq"] = [np.asarray(t) for t in
                        jax.grad(seq, (0, 1))(w, a["pp_x"])]
    # MoE, unsharded: the outputs, aux and every gradient
    params = {k: jnp.asarray(v) for k, v in moe_np.items()}

    def moe_loss(p, x):
        out, aux = jmoe.moe_ffn(p, x, capacity_factor=MOE_CAP)
        return jnp.sum(out * a["moe_r"]) + aux

    out, aux = jmoe.moe_ffn(params, a["moe_x"], capacity_factor=MOE_CAP)
    refs["moe_out"], refs["moe_aux"] = np.asarray(out), np.asarray(aux)
    gp, gx = jax.grad(moe_loss, (0, 1))(params, a["moe_x"])
    refs["moe_g"] = dict(x=np.asarray(gx),
                         **{k: np.asarray(v) for k, v in gp.items()})
    # shard_params: each device's shard, device r = rank r
    sharded = jtp.shard_params({n: a[n] for n, _ in SHARD_NAMES}, mesh,
                               jtp.tp_rules_transformer())
    for n, _ in SHARD_NAMES:
        by_dev = {s.device: np.asarray(s.data)
                  for s in sharded[n].addressable_shards}
        refs[f"shard|{n}"] = [by_dev[d] for d in devs]
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({P: [results of rank 0, ..., P-1]}, {P: JAX references})."""
    out_dir = str(tmp_path_factory.mktemp("tp_ranks"))
    a = _inputs()
    moe_np = _moe_params()
    in_path = os.path.join(out_dir, "inputs.npz")
    np.savez(in_path, **a, **{f"moe.{k}": v for k, v in moe_np.items()})
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [ctx.Process(target=_rank_main,
                              args=(world, r, port, in_path, out_dir))
                  for r in range(world)]
    for p in procs:
        p.start()
    refs = {world: _jax_refs(a, moe_np, world) for world in WORLDS}
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = {f: open(os.path.join(out_dir, f)).read()
              for f in os.listdir(out_dir) if f.endswith(".err")}
    assert not hung and not errors, (len(hung), errors)
    res = {world: [dict(np.load(os.path.join(out_dir,
                                             f"p{world}_rank{r}.npz")))
                   for r in range(world)] for world in WORLDS}
    return res, refs


def _results(ranks, world, case):
    res = ranks[0][world]
    for r in res:
        errors = json.loads(str(r["errors"]))
        assert case not in errors, errors[case]
    return res, ranks[1][world]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["tp", "tp_bias"])
def test_tensor_parallel_dense_matches_dense(ranks, world, tag):
    """Column- then row-parallel over P ranks: y equals the JAX TP
    functions' on every rank; x's gradient is whole on every rank (f),
    each weight block's gradient is its block of the dense one."""
    res, ref = _results(ranks, world, "tp")
    gx, gw1, gw2 = ref[f"{tag}_g"]
    n = 32 // world
    for r, got in enumerate(res):
        np.testing.assert_allclose(got[f"{tag}_y"], ref[f"{tag}_y"], **TOL)
        np.testing.assert_allclose(got[f"{tag}_gx"], gx, **TOL)
        np.testing.assert_allclose(got[f"{tag}_gw1"],
                                   gw1[r * n:(r + 1) * n], **TOL)
        np.testing.assert_allclose(got[f"{tag}_gw2"],
                                   gw2[:, r * n:(r + 1) * n], **TOL)
        assert bool(got["tp_constrain_is_x"])


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_sequential(ranks, world):
    """GPipe over P stages equals the sequential loop on every rank, with
    and without gradients; the stacked weights' gradient and the
    microbatches' are the whole ones on every rank (the JAX pipeline's
    weight gradient equals the loop's too)."""
    res, ref = _results(ranks, world, "pp")
    gw, gx = ref["pp_g_seq"]
    np.testing.assert_allclose(ref["pp_g_piped"], gw, **TOL)
    for got in res:
        np.testing.assert_allclose(got["pp_out"], ref["pp_out"], **TOL)
        np.testing.assert_allclose(got["pp_out_no_grad"], ref["pp_out"],
                                   **TOL)
        np.testing.assert_allclose(got["pp_gw"], gw, **TOL)
        np.testing.assert_allclose(got["pp_gx"], gx, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_moe_sharded_matches_dense(ranks, world):
    """Experts sharded over ep: the outputs and aux loss of the unsharded
    JAX function, its gradients for x and gate on every rank, and each
    rank's block of its expert weights' gradients."""
    res, ref = _results(ranks, world, "moe")
    g = ref["moe_g"]
    n = N_EXPERTS // world
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["moe_out"], ref["moe_out"], **TOL)
        np.testing.assert_allclose(got["moe_aux"], ref["moe_aux"], **TOL)
        np.testing.assert_allclose(got["moe_gx"], g["x"], **TOL)
        np.testing.assert_allclose(got["moe_ggate"], g["gate"], **TOL)
        np.testing.assert_allclose(got["moe_gwi"], g["wi"][r * n:(r + 1) * n],
                                   **TOL)
        np.testing.assert_allclose(got["moe_gwo"], g["wo"][r * n:(r + 1) * n],
                                   **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_params_matches_jax_shards(ranks, world):
    """Rank r holds exactly the JAX package's shard on device r, bit for
    bit: the first matching rule, an axis that does not divide left
    replicated (the (6,) bias and the (10, 8) table at P = 4)."""
    res, ref = _results(ranks, world, "shard")
    for r, got in enumerate(res):
        for n, shape in SHARD_NAMES:
            np.testing.assert_array_equal(got[f"shard|{n}"],
                                          ref[f"shard|{n}"][r], err_msg=n)
    if world == 4:
        assert res[1]["shard|bert.encoder.layers.0.ffn_1.bias"].shape == (6,)
        assert res[1]["shard|bert.word_embed.weight"].shape == (10, 8)


@pytest.mark.parametrize("kw", [{}, dict(tp_axis="model"),
                                dict(tp_axis="tp", dp_axis="dp")])
def test_tp_rules_match_the_jax_table(kw):
    from mxnet_tpu.parallel import tensor_parallel as jtp
    from mxnet_tpu_torch.parallel import tensor_parallel as tp
    got, want = tp.tp_rules_transformer(**kw), jtp.tp_rules_transformer(**kw)
    assert len(got) == len(want)
    for (pat, spec), (jpat, jspec) in zip(got, want):
        assert pat == jpat and tuple(spec) == tuple(jspec)


@pytest.mark.card
def test_card_helpers_on_a_one_rank_nccl_group():
    """Phase 14 (e) of chip_smoke.py at a small size, on a one-rank NCCL
    group: column- then row-parallel against torch.matmul, the pipeline
    with four layers stacked in its one stage against the loop (forward
    and gradients), moe_ffn over ep = 1 against it without a mesh (the
    same function: f and g are the identity on one rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore, parallel as par
    dev = mx.gpu(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    d, f = 64, 256

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    kvstore.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        x, w1, w2 = rnd(128, d), rnd(f, d, scale=0.1), rnd(d, f, scale=0.1)
        tp = par.make_mesh({"tp": 1})
        y = par.row_parallel_dense(torch.relu(par.column_parallel_dense(
            x, w1, mesh=tp)), w2, mesh=tp)
        torch.testing.assert_close(y, torch.relu(x @ w1.T) @ w2.T, **TOL)
        ws = rnd(1, 4, d, d, scale=d ** -0.5).requires_grad_(True)
        xm = rnd(4, 16, d).requires_grad_(True)
        r = rnd(4, 16, d)

        def stage(p, h):
            for i in range(p["w"].shape[0]):
                h = torch.tanh(h @ p["w"][i])
            return h
        out = par.pipeline_apply(stage, {"w": ws}, xm,
                                 par.make_mesh({"pp": 1}))
        got = torch.autograd.grad((out * r).sum(), (ws, xm))
        ref = stage({"w": ws[0]}, xm)
        want = torch.autograd.grad((ref * r).sum(), (ws, xm))
        torch.testing.assert_close(out, ref, **TOL)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)
        moe = {k: v.requires_grad_(True) for k, v in
               par.init_moe_params(g, 4, d, f, device=dev).items()}
        xe = rnd(2, 32, d).requires_grad_(True)
        runs = []
        for mesh in (par.make_mesh({"ep": 1}), None):
            o, aux = par.moe_ffn(moe, xe, mesh=mesh)
            runs.append((o, aux, *torch.autograd.grad(
                o.sum() + aux, (xe, *moe.values()))))
        for a, b in zip(*runs):
            torch.testing.assert_close(a, b, **TOL)
    finally:
        kvstore.reset_distributed()
