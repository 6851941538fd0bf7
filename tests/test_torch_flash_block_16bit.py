"""`flash_block_attention` in bfloat16 and float16 on the CPU against the
JAX package: out, lse and the gradients of both (a nonzero lse
cotangent) against JAX's function in its XLA form (`_block_fwd_xla` /
`_block_bwd_xla`, shapes off the 128 tiling) and its Pallas form in
interpret mode (S = 128); the merge identity of two key halves; and ring
and Ulysses attention in bf16 over 2 and 4 gloo ranks against the JAX
package's over a P-device CPU mesh.

Inputs are made with numpy from a seed and rounded to the dtype once, so
both packages start from the same bits. The tolerance rule is
`tests/test_torch_bf16.py`'s and `tests/test_torch_fp16.py`'s: each
reading is also taken in float64 on the same inputs; the port's distance
from float64 must be at most twice the JAX package's plus one unit
roundoff of the dtype times the largest float64 value, and port vs JAX
must lie within the dtype's limit (bf16 `tests/test_pallas.py:80-84`'s
rtol = atol = 0.05, fp16 that times 2^-3). lse is fp32 in both: its
limit is 1e-5 and its unit fp32's. JAX is imported inside the tests, so
that the spawned ranks, which import this module, load torch and numpy
only."""
import multiprocessing
import os
import socket
import traceback

import numpy as np
import pytest
import torch

DTYPES = {
    "bfloat16": (torch.bfloat16, dict(rtol=0.05, atol=0.05), 2.0 ** -8),
    "float16": (torch.float16, dict(rtol=0.05 * 2.0 ** -3,
                                    atol=0.05 * 2.0 ** -3), 2.0 ** -11),
}
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
WORLDS = (2, 4)
# ring inputs (B, H, S, D), Ulysses inputs (B, S, H, D), as
# tests/test_torch_parallel.py's
RING_SHAPE = (1, 2, 32, 8)
ULYSSES_SHAPE = (1, 32, 8, 8)
SP_CASES = [(strategy, causal) for strategy in ("ring", "ulysses")
            for causal in (False, True)]
RANK_TIMEOUT_S = 120


def _round(a, tdt):
    """numpy float32 -> the dtype's value of each element, as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt).float() \
        .numpy()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _rule(port, jx, exact, tol, unit, what):
    port, jx = _np(port), _np(jx)
    exact = np.asarray(exact, np.float64)
    np.testing.assert_allclose(port, jx, **tol, err_msg=what)
    dp, dj = np.abs(port - exact).max(), np.abs(jx - exact).max()
    assert dp <= 2 * dj + unit * np.abs(exact).max(), (what, dp, dj)


def _block_f64(q, k, v, g, g_lse, causal, scale):
    """out, lse and (dQ, dK, dV) of block attention by float64 autograd
    for the cotangents g of out and g_lse of lse (the top-left mask)."""
    q, k, v = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.tensor(-torch.inf, dtype=s.dtype))
    lse = torch.logsumexp(s, -1)
    out = torch.softmax(s, -1) @ v
    grads = torch.autograd.grad((out, lse), (q, k, v),
                                (torch.tensor(g, dtype=torch.float64),
                                 torch.tensor(g_lse, dtype=torch.float64)))
    return [out.detach().numpy(), lse.detach().numpy(),
            *(t.numpy() for t in grads)]


def _block_case(dtype, b, h, sq, sk, d, causal, seed, pallas):
    """(port, JAX, float64) results of flash_block_attention in `dtype`:
    out, lse and the gradients for random cotangents of both."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu.ops.pallas_kernels as pk
    from mxnet_tpu_torch.ops.kernels import flash_block_attention
    tdt = DTYPES[dtype][0]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float16
    rs = np.random.RandomState(seed)
    q, k, v = (_round(rs.standard_normal(s), tdt)
               for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    g = _round(rs.standard_normal((b, h, sq, d)), tdt)
    g_lse = rs.standard_normal((b, h, sq)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    assert pk._flash_block_impl(jq, jk, jv, causal, None)[2] == pallas

    def run(args, ct):
        out, vjp = jax.vjp(lambda *a: pk.flash_block_attention(*a, causal),
                           *args)
        return out, vjp(ct)
    (jout, jlse), grads = jax.jit(run)((jq, jk, jv),
                                       (jnp.asarray(g, jdt),
                                        jnp.asarray(g_lse)))
    want = [jout, jlse, *grads]
    tq, tk_, tv = (torch.tensor(a).to(tdt).requires_grad_(True)
                   for a in (q, k, v))
    out, lse = flash_block_attention(tq, tk_, tv, causal)
    assert out.dtype == tdt and lse.dtype == torch.float32
    torch.autograd.backward([out, lse], [torch.tensor(g).to(tdt),
                                         torch.tensor(g_lse)])
    got = [out.detach(), lse.detach(), tq.grad, tk_.grad, tv.grad]
    for t in got[2:]:
        assert t.dtype == tdt
    exact = _block_f64(q, k, v, g, g_lse, causal, d ** -0.5)
    return got, [np.asarray(jnp.asarray(a).astype(jnp.float32))
                 for a in want], exact


def _check(dtype, got, want, exact):
    _, tol, unit = DTYPES[dtype]
    for name, a, w, e in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                             exact):
        assert a.shape == w.shape, name
        if name == "lse":
            _rule(a, w, e, LSE_TOL, 2.0 ** -24, f"{dtype} lse")
        else:
            _rule(a, w, e, tol, unit, f"{dtype} {name}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 2, 40, 40, 16, False), (2, 2, 40, 40, 16, True),
    (1, 3, 40, 24, 16, True), (1, 2, 24, 56, 8, True),
    (1, 2, 24, 56, 200, False)])
def test_flash_block_16bit_matches_jax_xla_form(dtype, b, h, sq, sk, d,
                                                causal):
    """Against `_block_fwd_xla` / `_block_bwd_xla` (shapes off the
    128-tiling, a wide head among them): out, lse and dQ, dK, dV with an
    lse cotangent, causal with Sq != Sk both ways; the outputs in the
    input dtype, lse fp32."""
    _check(dtype, *_block_case(dtype, b, h, sq, sk, d, causal,
                               seed=sq + sk + causal + d, pallas=False))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_16bit_matches_jax_pallas_interpret(monkeypatch, dtype,
                                                        causal):
    """Against the Pallas kernels in interpret mode (S = 128), with a
    silent XLA fallback made fatal, as the fp32 test does."""
    import mxnet_tpu.ops.pallas_kernels as pk

    def _no_fallback(site, err):
        raise AssertionError(f"pallas {site} fell back: {err!r}")

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pk, "_warn_fallback", _no_fallback)
    _check(dtype, *_block_case(dtype, 1, 2, 128, 128, 64, causal, seed=3,
                               pallas=True))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_block_16bit_halves_merge_to_the_whole(dtype):
    """Partials over two disjoint key halves merge through lse to the
    attention over all the keys (the ring's combine, in fp32): lse to
    fp32's limit, out within the dtype's limit of the whole block's."""
    from mxnet_tpu_torch.ops.kernels import flash_block_attention
    tdt, tol, _ = DTYPES[dtype]
    rs = np.random.RandomState(11)
    q, k, v = (torch.tensor(rs.standard_normal(s).astype(np.float32))
               .to(tdt) for s in ((1, 2, 30, 16), (1, 2, 50, 16),
                                  (1, 2, 50, 16)))
    out, lse = flash_block_attention(q, k, v)
    oa, la = flash_block_attention(q, k[:, :, :20].contiguous(),
                                   v[:, :, :20].contiguous())
    ob, lb = flash_block_attention(q, k[:, :, 20:].contiguous(),
                                   v[:, :, 20:].contiguous())
    merged_lse = torch.logaddexp(la, lb)
    merged = oa.float() * torch.exp(la - merged_lse)[..., None] \
        + ob.float() * torch.exp(lb - merged_lse)[..., None]
    torch.testing.assert_close(merged_lse, lse, **LSE_TOL)
    torch.testing.assert_close(merged, out.float(), **tol)


# ---------------------------------------------------------------------------
# ring and Ulysses in bf16 over gloo ranks
# ---------------------------------------------------------------------------
def _inputs(shape, seed, n=4):
    """bf16 values as float32, made from a seed."""
    rs = np.random.RandomState(seed)
    return [_round(rs.standard_normal(shape), torch.bfloat16)
            for _ in range(n)]


def _case_seed(strategy, causal):
    return 20 * ("ring", "ulysses").index(strategy) + int(causal) + 3


def _rank_cases(world):
    from mxnet_tpu_torch import parallel
    res = {}
    mesh = parallel.make_mesh({"sp": world})
    for strategy, causal in SP_CASES:
        arrays = _inputs(RING_SHAPE if strategy == "ring" else ULYSSES_SHAPE,
                         _case_seed(strategy, causal))
        fn = (parallel.ring_attention_sharded if strategy == "ring"
              else parallel.ulysses_attention_sharded)
        q, k, v = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
                   for a in arrays[:3])
        out = fn(q, k, v, mesh, causal=causal)
        assert out.dtype == torch.bfloat16
        (out.float() * torch.tensor(arrays[3])).sum().backward()
        for name, t in zip(("out", "dq", "dk", "dv"),
                           (out.detach(), q.grad, k.grad, v.grad)):
            res[f"{strategy}_{causal}_{name}"] = t.float().numpy()
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
            res = _rank_cases(world)
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
    out_dir = str(tmp_path_factory.mktemp("sp_bf16_ranks"))
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
                                              f"p{world}_rank{r}.npz")))
                    for r in range(world)] for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy,causal", SP_CASES)
def test_sequence_parallel_bf16_matches_jax(ranks, world, strategy, causal):
    """Ring and Ulysses attention in bf16 over P gloo ranks: every rank
    gathers the same output and gradients of a weighted sum, and they
    equal the JAX package's over a P-device mesh in bf16 under the
    tolerance rule (float64 on the same bf16 inputs)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import (make_mesh, ring_attention_sharded,
                                    ulysses_attention_sharded)
    mesh = make_mesh({"sp": world})
    fn = (ring_attention_sharded if strategy == "ring"
          else ulysses_attention_sharded)
    arrays = _inputs(RING_SHAPE if strategy == "ring" else ULYSSES_SHAPE,
                     _case_seed(strategy, causal))

    def run(args, w):
        out, vjp = jax.vjp(lambda *a: fn(*a, mesh, causal=causal), *args)
        return out, vjp(w.astype(out.dtype))
    jargs = tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays[:3])
    jout, jgrads = jax.jit(run)(jargs, jnp.asarray(arrays[3]))
    want = [np.asarray(jnp.asarray(t).astype(jnp.float32))
            for t in (jout, *jgrads)]
    # float64 on the same bf16 inputs, in (B, H, S, D)
    q, k, v, w = (torch.tensor(a, dtype=torch.float64) for a in arrays)
    if strategy == "ulysses":
        q, k, v, w = (t.transpose(1, 2) for t in (q, k, v, w))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool)
                          .tril(), -torch.inf)
    out = torch.softmax(s, -1) @ v
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    exact = [t.detach() for t in (out, *grads)]
    if strategy == "ulysses":
        exact = [t.transpose(1, 2) for t in exact]
    _, tol, unit = DTYPES["bfloat16"]
    for name, ref, e in zip(("out", "dq", "dk", "dv"), want, exact):
        first = ranks[world][0][f"{strategy}_{causal}_{name}"]
        for res in ranks[world][1:]:
            np.testing.assert_array_equal(
                res[f"{strategy}_{causal}_{name}"], first)
        _rule(first, ref, e.numpy(), tol, unit,
              f"{strategy} causal={causal} P={world} {name}")
