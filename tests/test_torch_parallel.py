"""Sequence parallelism of the port against the JAX package on the CPU.

`mxnet_tpu_torch.parallel` runs in spawned gloo ranks (P = 2 and P = 4,
all cases of a world size in one spawn, both spawns at once); the JAX
package runs here, on the conftest's 8-device CPU mesh cut to P devices.
Both take the same inputs, made with numpy from a seed. JAX is imported
inside the tests, so that the ranks, which import this module, load
torch and numpy only. Tolerances are `tests/test_parallel.py`'s."""
import multiprocessing
import os
import socket
import traceback

import numpy as np
import pytest
import torch

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
INTERPRET_TOL = dict(rtol=5e-3, atol=5e-4)

WORLDS = (2, 4)
# ring inputs are (B, H, S, D), Ulysses inputs (B, S, H, D): H = 8 over
# P = 4 gives each rank two heads, so a wrong head-block order of the
# all-to-all cannot pass (tests/test_parallel.py:290-292)
RING_SHAPE = (1, 2, 32, 8)
ULYSSES_SHAPE = (1, 32, 8, 8)
# examples/long_context.py --smoke: B=1, S=256, H=8, D=64, causal
EXAMPLE_SHAPE = (1, 256, 8, 64)
SP_CASES = [(strategy, causal) for strategy in ("ring", "ulysses")
            for causal in (False, True)]
RANK_TIMEOUT_S = 120


def _inputs(shape, seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _case_seed(strategy, causal):
    return 10 * ("ring", "ulysses").index(strategy) + int(causal)


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _port_run(fn, arrays):
    """out and the gradients of sum(out * w) from the port's `fn`."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays[:3])
    out = fn(q, k, v)
    (out * torch.tensor(arrays[3])).sum().backward()
    return [out.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
            v.grad.numpy()]


def _rank_cases(world, rank):
    from mxnet_tpu_torch import parallel
    res = {}
    mesh = parallel.make_mesh({"sp": world})
    for strategy, causal in SP_CASES:
        arrays = _inputs(RING_SHAPE if strategy == "ring" else ULYSSES_SHAPE,
                         _case_seed(strategy, causal))
        fn = (parallel.ring_attention_sharded if strategy == "ring"
              else parallel.ulysses_attention_sharded)
        for name, got in zip(("out", "dq", "dk", "dv"), _port_run(
                lambda q, k, v: fn(q, k, v, mesh, causal=causal), arrays)):
            res[f"{strategy}_{causal}_{name}"] = got
    # the example: both strategies on one input, (B, S, H, D)
    q, k, v = (torch.tensor(a) for a in _inputs(EXAMPLE_SHAPE, 7, 3))
    with torch.no_grad():
        res["example_ulysses"] = parallel.ulysses_attention_sharded(
            q, k, v, mesh, causal=True).numpy()
        res["example_ring"] = parallel.ring_attention_sharded(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)), mesh,
            causal=True).transpose(1, 2).numpy()
    # ppermute: rank r receives rank r - 1's tensor; the cotangent goes
    # back the other way
    from mxnet_tpu_torch.parallel import _comm
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = _comm.ppermute(x, mesh.group("sp"), 1)
    (y * (rank + 1)).sum().backward()
    res["ppermute"] = np.array([y[0].item(), x.grad[0].item()])
    # heads that do not divide over the axis
    x = torch.zeros((1, 2 * world, world - 1, 8))
    try:
        parallel.ulysses_attention_sharded(x, x, x, mesh)
        res["indivisible"] = np.array("no error")
    except ValueError as e:
        res["indivisible"] = np.array(str(e))
    if world == 4:
        # the ring over 'sp' of a dp x sp mesh: one ring a dp line
        mesh2 = parallel.make_mesh({"dp": 2, "sp": -1})
        res["mesh2_shape"] = np.array(list(mesh2.shape.items()), dtype=object)
        arrays = _inputs(RING_SHAPE, 5)
        for name, got in zip(("out", "dq", "dk", "dv"), _port_run(
                lambda q, k, v: parallel.ring_attention_sharded(
                    q, k, v, mesh2, causal=True), arrays)):
            res[f"mesh2_{name}"] = got
    return res


def _rank_main(world, rank, port, out_dir):
    """One gloo rank: every case of this world size; writes its results
    (or its traceback) under `out_dir`."""
    torch.set_num_threads(1)
    from mxnet_tpu_torch import kvstore
    path = os.path.join(out_dir, f"p{world}_rank{rank}")
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{P: [results of rank 0, ..., rank P-1]} for P in WORLDS."""
    out_dir = str(tmp_path_factory.mktemp("sp_ranks"))
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [ctx.Process(target=_rank_main,
                              args=(world, r, port, out_dir))
                  for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = {f: open(os.path.join(out_dir, f)).read()
              for f in os.listdir(out_dir) if f.endswith(".err")}
    assert not hung and not errors, (len(hung), errors)
    assert all(p.exitcode == 0 for p in procs)
    return {world: [dict(np.load(os.path.join(out_dir,
                                              f"p{world}_rank{r}.npz"),
                             allow_pickle=True)) for r in range(world)]
            for world in WORLDS}


def _same_on_every_rank(results, key):
    """Every rank gathers the global output and gradients: the same bits
    on each."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        np.testing.assert_array_equal(res[key], first, err_msg=f"rank {r}")
    return first


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _jax_vjp(fn, args, cotangent):
    """fn(*args) and its vjp at `cotangent`, in one jitted call (eager
    shard_map differentiation takes seconds a case)."""
    import jax

    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)
    out, grads = jax.jit(run)(tuple(args), cotangent)
    return out, list(grads)


def _jax_run(fn, arrays):
    out, grads = _jax_vjp(fn, arrays[:3], arrays[3])
    return [np.asarray(t) for t in (out, *grads)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy,causal", SP_CASES)
def test_sequence_parallel_matches_jax(ranks, world, strategy, causal):
    """Ring and Ulysses attention over P gloo ranks: the output and the
    gradients of a weighted sum equal the JAX package's over a P-device
    mesh."""
    from mxnet_tpu.parallel import (make_mesh, ring_attention_sharded,
                                    ulysses_attention_sharded)
    mesh = make_mesh({"sp": world})
    fn = (ring_attention_sharded if strategy == "ring"
          else ulysses_attention_sharded)
    arrays = _inputs(RING_SHAPE if strategy == "ring" else ULYSSES_SHAPE,
                     _case_seed(strategy, causal))
    want = _jax_run(lambda q, k, v: fn(q, k, v, mesh, causal=causal),
                    arrays)
    for name, ref in zip(("out", "dq", "dk", "dv"), want):
        got = _same_on_every_rank(ranks[world],
                                  f"{strategy}_{causal}_{name}")
        np.testing.assert_allclose(
            got, ref, **(FWD_TOL if name == "out" else GRAD_TOL),
            err_msg=f"{strategy} causal={causal} P={world} {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_and_ulysses_agree_on_the_example(ranks, world):
    """examples/long_context.py's check at its smoke size (S = 256):
    the two strategies agree with each other and with JAX's Ulysses."""
    import jax
    from mxnet_tpu.parallel import make_mesh, ulysses_attention_sharded
    uly = _same_on_every_rank(ranks[world], "example_ulysses")
    ring = _same_on_every_rank(ranks[world], "example_ring")
    np.testing.assert_allclose(ring, uly, **FWD_TOL)
    q, k, v = _inputs(EXAMPLE_SHAPE, 7, 3)
    mesh = make_mesh({"sp": world})
    want = jax.jit(lambda *a: ulysses_attention_sharded(*a, mesh,
                                                        causal=True))(q, k, v)
    np.testing.assert_allclose(uly, np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ppermute_shifts_forward_and_back(ranks, world):
    """ppermute(x, shift=1): rank r holds rank r - 1's x, and x's
    gradient on rank r is the weight that rank r + 1 put on it."""
    for r, res in enumerate(ranks[world]):
        got, grad = res["ppermute"]
        assert got == (r - 1) % world + 1
        assert grad == (r + 1) % world + 1


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_rejects_indivisible_heads(ranks, world):
    for res in ranks[world]:
        assert "divisible" in str(res["indivisible"])


def test_ring_over_one_axis_of_a_2d_mesh(ranks):
    """make_mesh({"dp": 2, "sp": -1}) over 4 ranks: each dp line runs its
    own ring over 'sp', as shard_map does over a replicated dp axis."""
    from mxnet_tpu.parallel import make_mesh, ring_attention_sharded
    for res in ranks[4]:
        assert [tuple(x) for x in res["mesh2_shape"]] == [("dp", 2),
                                                           ("sp", 2)]
    mesh = make_mesh({"dp": 2, "sp": 2})
    assert dict(mesh.shape) == {"dp": 2, "sp": 2}
    want = _jax_run(lambda q, k, v: ring_attention_sharded(
        q, k, v, mesh, causal=True), _inputs(RING_SHAPE, 5))
    for name, ref in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(
            _same_on_every_rank(ranks[4], f"mesh2_{name}"), ref,
            **(FWD_TOL if name == "out" else GRAD_TOL), err_msg=name)


# ---------------------------------------------------------------------------
# flash_block_attention, in this process
# ---------------------------------------------------------------------------
def _block_pair(b, h, sq, sk, d, causal, seed, pallas):
    """(port, JAX) results of flash_block_attention: out, lse and the
    gradients for random cotangents of both, lse's nonzero."""
    import jax.numpy as jnp
    import mxnet_tpu.ops.pallas_kernels as pk
    from mxnet_tpu_torch.ops.kernels import flash_block_attention
    rs = np.random.RandomState(seed)
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    g = rs.standard_normal((b, h, sq, d)).astype(np.float32)
    g_lse = rs.standard_normal((b, h, sq)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert pk._flash_block_impl(jq, jk, jv, causal, None)[2] == pallas
    (jout, jlse), grads = _jax_vjp(
        lambda *a: pk.flash_block_attention(*a, causal), (jq, jk, jv),
        (jnp.asarray(g), jnp.asarray(g_lse)))
    want = [jout, jlse, *grads]
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = flash_block_attention(tq, tk, tv, causal)
    torch.autograd.backward([out, lse], [torch.tensor(g),
                                         torch.tensor(g_lse)])
    got = [out.detach(), lse.detach(), tq.grad, tk.grad, tv.grad]
    return ([t.numpy() for t in got], [np.asarray(a) for a in want])


def _compare_block(got, want, grad_tol):
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(
            a, b, **(FWD_TOL if name in ("out", "lse") else grad_tol),
            err_msg=name)


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 2, 40, 40, 16, False), (2, 2, 40, 40, 16, True),
    (1, 3, 40, 24, 16, True), (1, 2, 24, 56, 8, True),
    (1, 2, 24, 56, 8, False)])
def test_flash_block_matches_jax_xla_form(b, h, sq, sk, d, causal):
    """Against `_block_fwd_xla` / `_block_bwd_xla` (shapes off the
    128-tiling): out, lse and dQ, dK, dV with an lse cotangent, causal
    with Sq != Sk both ways (the top-left mask)."""
    got, want = _block_pair(b, h, sq, sk, d, causal, seed=sq + sk + causal,
                            pallas=False)
    _compare_block(got, want, GRAD_TOL)


@pytest.mark.parametrize("sq,sk,causal", [(128, 128, False),
                                          (128, 128, True),
                                          (128, 256, False)])
def test_flash_block_matches_jax_pallas_interpret(monkeypatch, sq, sk,
                                                  causal):
    """Against the Pallas kernels in interpret mode (128-multiple
    shapes), with a silent XLA fallback made fatal, as
    `test_ring_flash_pallas_interpret` does."""
    import mxnet_tpu.ops.pallas_kernels as pk

    def _no_fallback(site, err):
        raise AssertionError(f"pallas {site} fell back: {err!r}")

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pk, "_warn_fallback", _no_fallback)
    got, want = _block_pair(1, 2, sq, sk, 64, causal, seed=3, pallas=True)
    _compare_block(got, want, INTERPRET_TOL)


def test_flash_block_zero_cotangents():
    """Either cotangent may arrive as zeros: with lse unused the
    gradients are flash_attention's, and with out unused they are those
    of the lse alone."""
    from mxnet_tpu_torch.ops.kernels import (flash_attention,
                                             flash_block_attention)
    rs = np.random.RandomState(4)
    q, k, v = (rs.standard_normal((1, 2, 24, 8)).astype(np.float32)
               for _ in range(3))
    w = torch.tensor(rs.standard_normal((1, 2, 24, 8)).astype(np.float32))

    def grads(fn):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        fn(*ts).backward()
        return [t.grad for t in ts]

    for a, b in zip(
            grads(lambda *t: (flash_block_attention(*t, True)[0] * w).sum()),
            grads(lambda *t: (flash_attention(*t, True) * w).sum())):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # d lse / d k is softmax-weighted q / sqrt(D): nonzero, and dV is 0
    _, dk, dv = grads(lambda *t: flash_block_attention(*t)[1].sum())
    assert dk.abs().max() > 0 and dv.abs().max() == 0


# ---------------------------------------------------------------------------
# the bootstrap: _cluster_env, init_distributed, make_mesh
# ---------------------------------------------------------------------------
_CLUSTER_VARS = ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS", "MXTPU_WORKER_ID",
                 "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
                 "DMLC_WORKER_ID")


@pytest.mark.parametrize("env", [
    {},
    {"MXTPU_COORDINATOR": "10.0.0.1:1234", "MXTPU_NUM_WORKERS": "4",
     "MXTPU_WORKER_ID": "2"},
    {"DMLC_PS_ROOT_URI": "10.0.0.2", "DMLC_PS_ROOT_PORT": "9000",
     "DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "1"},
    {"DMLC_PS_ROOT_URI": "host", "DMLC_NUM_WORKER": " 8\n",
     "DMLC_WORKER_ID": "0"},
    {"MXTPU_COORDINATOR": "h:1", "MXTPU_NUM_WORKERS": "2"},
    {"MXTPU_COORDINATOR": "h:1", "MXTPU_NUM_WORKERS": "4x",
     "MXTPU_WORKER_ID": "0"},
    {"MXTPU_COORDINATOR": "h:1", "MXTPU_NUM_WORKERS": "2",
     "DMLC_WORKER_ID": "1_0"}])
def test_cluster_env_matches_jax(monkeypatch, env):
    """The launcher's environment parses as the JAX package parses it;
    a garbled worker count or id raises in both."""
    import mxnet_tpu.kvstore as jkv
    from mxnet_tpu_torch import kvstore
    for name in _CLUSTER_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    try:
        want = jkv._cluster_env()
    except ValueError:
        with pytest.raises(ValueError):
            kvstore._cluster_env()
        return
    assert kvstore._cluster_env() == want


@pytest.fixture
def cpu_group(monkeypatch):
    """No cluster in the environment, fast retries, and the default group
    torn down after the test."""
    from mxnet_tpu_torch import fault, kvstore
    for name in _CLUSTER_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MXTPU_DIST_RETRY_BASE", "0.01")
    yield kvstore
    fault.clear()
    kvstore.reset_distributed()


def test_init_distributed_cpu_group_and_mesh(cpu_group):
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel
    cpu_group.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                               device="cpu")
    cpu_group.init_distributed()          # a second call returns at once
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    mesh = parallel.make_mesh({"sp": -1})
    assert mesh.shape == {"sp": 1} and mesh.axis_names == ("sp",)
    assert mesh.device_type == "cpu" and mesh.axis_index("sp") == 0
    assert parallel.single_axis_mesh("dp").shape == {"dp": 1}
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        parallel.make_mesh({"sp": 2})
    # a group of one: no collective runs, the ring is one causal block
    rs = np.random.RandomState(6)
    q, k, v = (torch.tensor(rs.standard_normal((1, 2, 16, 8))
                            .astype(np.float32)) for _ in range(3))
    from mxnet_tpu_torch.ops.kernels import flash_attention
    ref = flash_attention(q, k, v, True)
    torch.testing.assert_close(
        parallel.ring_attention_sharded(q, k, v, mesh, causal=True), ref)
    torch.testing.assert_close(parallel.ulysses_attention_sharded(
        *(t.transpose(1, 2) for t in (q, k, v)), mesh,
        causal=True).transpose(1, 2), ref)
    cpu_group.reset_distributed()
    assert not dist.is_initialized()
    cpu_group.reset_distributed()          # safe with nothing to tear down


def test_init_distributed_retries_then_gives_up(cpu_group, monkeypatch):
    """An explicit rendezvous that fails is retried (the fault point
    `kv.init` fires once, the second attempt joins); when the retries run
    out, MXNetError."""
    import torch.distributed as dist
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.base import MXNetError
    fault.inject("kv.init", at=[1])
    cpu_group.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                               device="cpu")
    assert dist.is_initialized() and fault.fires("kv.init") == 1
    cpu_group.reset_distributed()
    fault.inject("kv.init")
    monkeypatch.setenv("MXTPU_DIST_RETRIES", "2")
    with pytest.raises(MXNetError, match="after 3 attempt"):
        cpu_group.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                   device="cpu")
    assert fault.fires("kv.init") == 3 and not dist.is_initialized()


def test_init_distributed_rejects_bad_arguments(cpu_group):
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="not in"):
        cpu_group.init_distributed("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(MXNetError, match="together"):
        cpu_group.init_distributed("127.0.0.1:1", device="cpu")
    with pytest.raises(MXNetError, match="host:port"):
        cpu_group.init_distributed("nohost", 1, 0, device="cpu")
    with pytest.raises(MXNetError, match="CUDA"):
        cpu_group.create("device")         # the card, and there is none
    assert cpu_group.create("device", device="cpu").type == "device"
