"""The bfloat16 pieces of the port on the CPU against the JAX package:
dtype names, `cast` on a small net, the bf16 plain versions of the flash
forward, the flash backward pair and LayerNorm against the JAX Pallas
kernels in interpret mode (`MXTPU_PALLAS_INTERPRET=1`, 1 head, S = 256,
as `tests/test_pallas.py` runs them), SGD-momentum in bf16 and Adam with
`multi_precision=True`, and the wrappers' dtype rules. Inputs are made
with numpy from a seed and rounded to bf16 once, so both packages start
from the same bits.

The tolerance rule: each reading is also taken in float64 on the same
bf16 inputs; the port's distance from float64 must be at most twice the
JAX package's, plus a floor of one bf16 ulp (2^-8 relative) of the
largest float64 value (one rounding landing the other way), and port vs
JAX must lie within `tests/test_pallas.py:80-84`'s bf16 limits (rtol =
atol = 0.05) elementwise. The kernels themselves run only on the card:
`tests/test_torch_bf16_design.py` holds their plans, and each kernel
against its plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError, dtype_of, torch_dtype
from mxnet_tpu_torch.ops import kernels as tk

CPU = mx.cpu()
BF16_TOL = dict(rtol=0.05, atol=0.05)     # tests/test_pallas.py:80-84
FLOOR = 2.0 ** -8


def _bf16(a):
    """numpy float32 -> the bf16 value of each element, as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rule(port, jx, exact, what):
    """The tolerance rule of the module docstring; returns the two
    distances from float64."""
    port, jx = _np(port).astype(np.float64), _np(jx).astype(np.float64)
    exact = np.asarray(exact, np.float64)
    np.testing.assert_allclose(port, jx, **BF16_TOL, err_msg=what)
    dp, dj = np.abs(port - exact).max(), np.abs(jx - exact).max()
    assert dp <= 2 * dj + FLOOR * np.abs(exact).max(), (what, dp, dj)
    return dp, dj


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# dtypes and cast
# ---------------------------------------------------------------------------
def test_bfloat16_names_and_asnumpy():
    """"bfloat16", torch.bfloat16 and ml_dtypes' numpy bfloat16 (the JAX
    package's) all name torch.bfloat16; a Parameter reports it; asnumpy
    gives float32 holding the same values; nd.array keeps a bf16 array's
    bits."""
    for name in ("bfloat16", torch.bfloat16, jnp.bfloat16,
                 np.dtype(jnp.bfloat16)):
        assert torch_dtype(name) == torch.bfloat16
        assert dtype_of(name) == torch.bfloat16
    assert dtype_of("float32") == np.float32
    with pytest.raises(MXNetError, match="unsupported dtype"):
        torch_dtype("bfloat17")
    vals = _bf16(np.random.RandomState(0).randn(5, 3) * 100)
    a = mx.nd.array(vals, ctx=CPU, dtype="bfloat16")
    assert a.dtype == torch.bfloat16
    out = a.asnumpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, vals)
    b = mx.nd.array(np.asarray(_j(vals)), ctx=CPU)
    assert b.dtype == torch.bfloat16
    assert torch.equal(b._data, a._data)
    np.testing.assert_array_equal(a.astype("float32").asnumpy(), vals)


def _small_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(32, in_units=16, activation="relu"))
        net.add(pkg.gluon.nn.LayerNorm(in_channels=32))
        net.add(pkg.gluon.nn.Dense(8, in_units=32))
    return net


def test_cast_small_net_matches_jax():
    """`cast("bfloat16")` on a Dense / LayerNorm / Dense net: every
    parameter and its gradient buffer bf16 with the JAX package's values
    bit for bit (both round to nearest even), the gradient still bound
    (a backward fills it), children before the block's own; the forward
    and every gradient under the tolerance rule against float64."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16).astype(np.float32)
    jnet = _small_net(mxj)
    jnet.initialize(mxj.init.Normal(0.5))
    jnet(mxj.nd.array(x))
    arrays = {n: p.data().asnumpy() for n, p in
              jnet._collect_params_with_prefix().items()}
    tnet = _small_net(mx)
    mx.convert.load_jax_parameters(tnet, arrays, ctx=CPU)
    assert tnet.cast("bfloat16") is tnet
    jnet.cast("bfloat16")
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        assert p.dtype == torch.bfloat16
        assert p.data()._data.dtype == torch.bfloat16
        assert p.grad()._data.dtype == torch.bfloat16
        assert p.data()._grad is p.grad()
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      _np(jp[name].data()._data))
    xb = _bf16(x)
    with mx.autograd.record():
        ty = tnet(mx.nd.array(xb, ctx=CPU, dtype="bfloat16"))
        tl = (ty.astype("float32") ** 2).sum()
    tl.backward()
    with mxj.autograd.record():
        jy = jnet(mxj.nd.array(xb).astype("bfloat16"))
        jl = (jy.astype("float32") ** 2).sum()
    jl.backward()
    assert ty.dtype == torch.bfloat16
    # float64: the same net on the bf16 weights and input
    w64 = {n: torch.tensor(_np(p.data()._data), dtype=torch.float64,
                           requires_grad=True)
           for n, p in tnet._collect_params_with_prefix().items()}
    h = torch.tensor(xb, dtype=torch.float64) @ w64["0.weight"].T \
        + w64["0.bias"]
    h = torch.relu(h)
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    h = (h - mu) / torch.sqrt(var + 1e-5) * w64["1.gamma"] + w64["1.beta"]
    y64 = h @ w64["2.weight"].T + w64["2.bias"]
    (y64 ** 2).sum().backward()
    _rule(ty._data, jy._data, y64.detach().numpy(), "forward")
    for name, p in tnet._collect_params_with_prefix().items():
        _rule(p.grad()._data, jp[name].grad()._data, w64[name].grad.numpy(),
              f"gradient of {name}")


def test_from_jax_weights_keeps_bf16_snapshots():
    """A JAX TransformerNMT cast to bf16 hands `encoder_weights` /
    `decoder_weights` over as ml_dtypes bf16 arrays; `from_jax_weights`
    reads them through their bits (no float32 detour through ml_dtypes)
    into a bf16 port model holding every value exactly."""
    from mxnet_tpu.models import transformer as jt
    mxj.random.seed(13)
    m = jt.TransformerNMT(40, units=16, hidden=32, num_layers=1,
                          num_heads=2, max_length=48, dropout=0.0)
    m.initialize()
    m.cast("bfloat16")
    ew = jax.tree.map(np.asarray, jt.encoder_weights(m))
    dw = jax.tree.map(np.asarray, jt.decoder_weights(m))
    assert np.asarray(dw["embed"]).dtype.name == "bfloat16"
    tm = mx.convert.from_jax_weights(ew, dw, device="cpu")
    got = {n: p.data() for n, p in tm._collect_params_with_prefix().items()}
    assert all(a.dtype == torch.bfloat16 for a in got.values())
    np.testing.assert_array_equal(got["embed.weight"].asnumpy(),
                                  _np(dw["embed"]))
    w, b = dw["layers"][0]["ffn1"]
    np.testing.assert_array_equal(
        got["decoder.layers.0.ffn.ffn1.weight"].asnumpy(), _np(w))
    np.testing.assert_array_equal(
        got["decoder.layers.0.ffn.ffn1.bias"].asnumpy(), _np(b))


# ---------------------------------------------------------------------------
# the flash kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------
def _attention_inputs(seed, b=2, h=1, s=256, d=64):
    rng = np.random.RandomState(seed)
    return [_bf16(rng.randn(b, h, s, d)) for _ in range(4)]


def _attention_f64(q, k, v, do, causal, lens, scale):
    """out, lse and (dQ, dK, dV) of softmax attention in float64 on the
    bf16 inputs (autograd), with the kernels' masks."""
    q, k, v = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    allowed = torch.ones(s.shape, dtype=torch.bool)
    if lens is not None:
        keys = torch.arange(s.shape[-1])[None, :] < torch.tensor(lens)[:, None]
        allowed &= keys[:, None, None, :]
    if causal:
        allowed &= torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    s = torch.where(allowed, s, torch.tensor(-torch.inf, dtype=s.dtype))
    out = torch.softmax(s, -1) @ v
    lse = torch.logsumexp(s, -1)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.tensor(do, dtype=torch.float64))
    return out.detach().numpy(), lse.detach().numpy(), \
        [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", [None, (200, 256)], ids=["full", "lens"])
def test_flash_plain_versions_match_jax_kernels(interpret, causal, lens):
    """The bf16 forward's and backward pair's plain versions against
    `_flash_fwd_pallas` / `_flash_bwd_pallas` (Pallas interpret mode) and
    `attention_reference` in bf16, on the same bf16 q, k, v, dO: out and
    lse, then dQ, dK, dV from each package's own out and lse, under the
    tolerance rule; out and the gradients bf16, lse fp32."""
    q, k, v, do = _attention_inputs(1 + causal)
    b, h, s, d = q.shape
    scale = d ** -0.5
    tvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    jvl = None if lens is None else jnp.asarray(lens, jnp.int32)
    out, lse = tk.flash_attention_fwd(_t(q), _t(k), _t(v), causal,
                                      kv_lengths=tvl)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jout, jlse = pk._flash_fwd_pallas(_j(q), _j(k), _j(v), causal, scale,
                                      lengths=jvl)
    o64, l64, g64 = _attention_f64(q, k, v, do, causal, lens, scale)
    _rule(out, jout, o64, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse[..., 0]),
                               rtol=1e-5, atol=1e-5)
    _rule(lse, jlse[..., 0], l64.reshape(b * h, s), "lse")
    mask = None if lens is None else pk._lengths_mask(jvl, s)
    ref = pk.attention_reference(_j(q), _j(k), _j(v), causal=causal,
                                 sm_scale=scale, mask=mask)
    _rule(out, ref, o64, "out vs attention_reference")

    delta = (out.float() * _t(do).float()).sum(-1).reshape(b * h, s)
    got = tk.flash_attention_bwd(_t(q), _t(k), _t(v), _t(do), lse, delta,
                                 causal, kv_lengths=tvl)
    want = pk._flash_bwd_pallas(_j(q), _j(k), _j(v), jout, jlse[..., 0],
                                _j(do), causal, scale, lengths=jvl)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, g64):
        assert g.dtype == torch.bfloat16
        _rule(g, w, e, name)
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)


def test_flash_plain_rounds_where_the_kernels_do():
    """In bf16 the plain forward rounds P to bf16 before P V and out
    once, and the backward takes bf16(p) for dV and dK but fp32 p for dQ
    (`pallas_kernels.py:455-461, 521-526`): each against the formula
    written out here, bit for bit."""
    q, k, v, do = (_t(a) for a in _attention_inputs(3, s=64))
    scale = 0.125
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                         v.float()) / p.sum(-1, keepdim=True)).to(
        torch.bfloat16)
    out, lse = tk.flash_attention_fwd(q, k, v)
    assert torch.equal(out, want)
    delta = (out.float() * do.float()).sum(-1).reshape(2, 64)
    pf = torch.exp(s - lse.reshape(2, 1, 64, 1))
    pb = pf.to(torch.bfloat16).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()) \
        - delta.reshape(2, 1, 64, 1)
    dsk = (pb * dp * scale).to(torch.bfloat16).float()
    dsq = (pf * dp * scale).to(torch.bfloat16).float()
    dq, dk, dv = tk.flash_attention_bwd(q, k, v, do, lse, delta)
    assert torch.equal(dv, torch.einsum("bhqk,bhqd->bhkd", pb, do.float())
                       .to(torch.bfloat16))
    assert torch.equal(dk, torch.einsum("bhqk,bhqd->bhkd", dsk, q.float())
                       .to(torch.bfloat16))
    assert torch.equal(dq, torch.einsum("bhqk,bhkd->bhqd", dsq, k.float())
                       .to(torch.bfloat16))
    assert not torch.equal(dsk, dsq)


def test_zero_length_rows_are_zeros_in_bf16():
    """A key length of 0 gives zeros and zero gradients in bf16 too (the
    kernels' convention, ROADMAP Queue 3 item 4)."""
    q, k, v, do = (_t(a) for a in _attention_inputs(4, s=32))
    vl = torch.tensor([0, 32], dtype=torch.int32)
    out, lse = tk.flash_attention_fwd(q, k, v, kv_lengths=vl)
    assert out[0].abs().max().item() == 0.0
    delta = (out.float() * do.float()).sum(-1).reshape(2, 32)
    dq, dk, dv = tk.flash_attention_bwd(q, k, v, do, lse, delta,
                                        kv_lengths=vl)
    for g in (dq, dk, dv):
        assert g[0].abs().max().item() == 0.0 and g[1].abs().max() > 0


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
def _layer_norm_case(rows, d, gdtype, seed):
    """`fused_layer_norm` on bf16 x with gamma / beta in `gdtype` against
    the JAX one (its Pallas kernel in interpret mode) forward and
    backward at (rows, d), under the tolerance rule: y, dx in x's dtype,
    dgamma / dbeta in gamma's, fp32 statistics."""
    rng = np.random.RandomState(seed)
    x = _bf16(3 * rng.randn(rows, d) + 1)
    gam, bet = (_bf16(1 + 0.3 * rng.randn(d)) for _ in range(2))
    dy = _bf16(rng.randn(rows, d))
    gt = torch.bfloat16 if gdtype == "bfloat16" else torch.float32
    gj = jnp.bfloat16 if gdtype == "bfloat16" else jnp.float32
    xt = _t(x).requires_grad_(True)
    gt_, bt = (torch.tensor(a).to(gt).requires_grad_(True)
               for a in (gam, bet))
    y = tk.fused_layer_norm(xt, gt_, bt)
    y.backward(_t(dy))
    assert y.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    assert gt_.grad.dtype == gt

    def f(a, g_, b_):
        return pk.fused_layer_norm(a, g_, b_)
    jy, vjp = jax.vjp(f, _j(x), jnp.asarray(gam, gj), jnp.asarray(bet, gj))
    jgrads = vjp(_j(dy))
    x64, g64, b64 = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                     for a in (x, gam, bet))
    mu = x64.mean(-1, keepdim=True)
    var = ((x64 - mu) ** 2).mean(-1, keepdim=True)
    y64 = (x64 - mu) / torch.sqrt(var + 1e-5) * g64 + b64
    y64.backward(torch.tensor(dy, dtype=torch.float64))
    _rule(y, jy, y64.detach().numpy(), "y")
    for name, g, w, e in zip(("dx", "dgamma", "dbeta"),
                             (xt.grad, gt_.grad, bt.grad), jgrads,
                             (x64.grad, g64.grad, b64.grad)):
        _rule(g, w, e.numpy(), name)


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_layer_norm_bf16_matches_jax_kernel(interpret, gdtype):
    """`_layer_norm_case` at D = 256, 64 rows (the one-warp form's
    width on the card)."""
    _layer_norm_case(64, 256, gdtype, 5)


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [4096, 8192])
def test_layer_norm_bf16_wide_rows_match_jax_kernel(interpret, d, gdtype):
    """`_layer_norm_case` at the one-block-a-row form's widths on the
    card (D = 4096, 8192; 8 rows, the Pallas kernel's least block)."""
    _layer_norm_case(8, d, gdtype, 6)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def _opt_inputs(seed, n=4):
    rng = np.random.RandomState(seed)
    w = _bf16(rng.randn(n, 64) * 0.1)
    grads = [_bf16(rng.randn(n, 64)) for _ in range(2)]
    return w, grads


def test_sgd_momentum_two_steps_in_bf16():
    """Without multi_precision a bf16 weight updates in bf16 with a bf16
    momentum (JAX: zeros_like(weight)): two SGD-momentum steps against
    the JAX optimizer and float64, under the tolerance rule, for the
    weight and the momentum."""
    w, grads = _opt_inputs(6)
    lr, mu, wd = 0.05, 0.9, 1e-3
    jo = mxj.optimizer.create("sgd", learning_rate=lr, momentum=mu, wd=wd)
    to = mx.optimizer.create("sgd", learning_rate=lr, momentum=mu, wd=wd)
    jw, tw = mxj.nd.array(w).astype("bfloat16"), mx.nd.array(
        w, ctx=CPU, dtype="bfloat16")
    js, ts = jo.create_state_multi_precision(0, jw), \
        to.create_state_multi_precision(0, tw)
    assert ts[0]._data.dtype == torch.bfloat16
    w64, m64 = w.astype(np.float64), np.zeros_like(w, np.float64)
    for g in grads:
        jo.update_multi_precision(0, jw, mxj.nd.array(g).astype("bfloat16"),
                                  js)
        to.update_multi_precision(0, tw, mx.nd.array(
            g, ctx=CPU, dtype="bfloat16"), ts)
        m64 = mu * m64 + g + wd * w64
        w64 = w64 - lr * m64
    assert tw._data.dtype == torch.bfloat16
    _rule(tw._data, jw._data, w64, "weight")
    _rule(ts[0]._data, js[0]._data, m64, "momentum")


def test_adam_multi_precision_two_steps():
    """With multi_precision a bf16 weight has an fp32 master and fp32
    states: two Adam steps against the JAX optimizer (mean and variance
    to fp32 rounding; the master too, except that JAX takes the bias
    corrections 1 - beta^t in fp32, where 1 - 0.999^2 = 0.002 keeps
    about 3e-5 of relative error, up to 1.5e-5 of the update's size lr
    through the square root: atol 3e-5 lr; the written-back weight the
    master rounded to bf16) and float64 under the tolerance rule."""
    w, grads = _opt_inputs(7)
    kw = dict(learning_rate=1e-2, wd=1e-3, multi_precision=True)
    jo, to = mxj.optimizer.create("adam", **kw), mx.optimizer.create(
        "adam", **kw)
    jw, tw = mxj.nd.array(w).astype("bfloat16"), mx.nd.array(
        w, ctx=CPU, dtype="bfloat16")
    js, ts = jo.create_state_multi_precision(0, jw), \
        to.create_state_multi_precision(0, tw)
    master, mean, var, count = ts
    assert master._data.dtype == mean._data.dtype == torch.float32
    b1, b2, eps = 0.9, 0.999, 1e-8
    w64 = w.astype(np.float64)
    m64, v64 = np.zeros_like(w64), np.zeros_like(w64)
    for t, g in enumerate(grads, 1):
        jo.update_multi_precision(0, jw, mxj.nd.array(g).astype("bfloat16"),
                                  js)
        to.update_multi_precision(0, tw, mx.nd.array(
            g, ctx=CPU, dtype="bfloat16"), ts)
        gg = g + kw["wd"] * w64
        m64 = b1 * m64 + (1 - b1) * gg
        v64 = b2 * v64 + (1 - b2) * gg * gg
        w64 = w64 - kw["learning_rate"] * (m64 / (1 - b1 ** t)) / (
            np.sqrt(v64 / (1 - b2 ** t)) + eps)
    assert int(count._data) == 2 and tw._data.dtype == torch.bfloat16
    for name, got, want, atol in (
            ("master", master, js[0], 3e-5 * kw["learning_rate"]),
            ("mean", mean, js[1], 1e-7), ("variance", var, js[2], 1e-7)):
        np.testing.assert_allclose(got.asnumpy(), np.asarray(want._data),
                                   rtol=1e-5, atol=atol, err_msg=name)
    _rule(master._data, js[0]._data, w64, "master")
    _rule(tw._data, jw._data, w64, "weight")
    np.testing.assert_array_equal(tw.asnumpy(), _bf16(master.asnumpy()))


def test_multi_precision_leaves_fp32_weights_alone():
    """An fp32 weight under multi_precision has no master: the states
    and the update are those of `create_state` / `update`."""
    w, grads = _opt_inputs(8)
    a = mx.optimizer.create("adam", learning_rate=1e-2,
                            multi_precision=True)
    b = mx.optimizer.create("adam", learning_rate=1e-2)
    wa, wb = (mx.nd.array(w, ctx=CPU) for _ in range(2))
    sa, sb = a.create_state_multi_precision(0, wa), b.create_state(0, wb)
    assert len(sa) == 3
    for g in grads:
        a.update_multi_precision(0, wa, mx.nd.array(g, ctx=CPU), sa)
        b.update(0, wb, mx.nd.array(g, ctx=CPU), sb)
    assert torch.equal(wa._data, wb._data)


# ---------------------------------------------------------------------------
# the wrappers' dtype rules
# ---------------------------------------------------------------------------
def test_other_dtypes_raise_and_the_cpu_launches_nothing():
    """bf16 on the CPU takes the plain versions (no launch); float64 and
    mixed dtypes raise in every wrapper (float16 has forms of its own:
    `tests/test_torch_fp16.py`); flash_block_attention takes bf16 too
    (out in bf16, lse fp32, no launch on the CPU) and refuses float64."""
    tk.reset_launch_counts()
    q = torch.zeros((1, 1, 8, 16), dtype=torch.bfloat16)
    tk.flash_attention(q, q, q)
    tk.fused_layer_norm(torch.zeros((2, 16), dtype=torch.bfloat16),
                        torch.ones(16), torch.zeros(16))
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)
    for dt in (torch.float64,):
        x = q.to(dt)
        with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
            tk.flash_attention_fwd(x, x, x)
        with pytest.raises(MXNetError, match="layer norm kernel takes"):
            tk.layer_norm_fwd(x[0, 0], torch.ones(16, dtype=dt),
                              torch.zeros(16, dtype=dt))
    with pytest.raises(MXNetError, match="of one dtype"):
        tk.flash_attention_fwd(q, q.float(), q)
    lse = torch.zeros((1, 8))
    with pytest.raises(MXNetError, match="of q's dtype"):
        tk.flash_attention_bwd(q, q, q, q.float(), lse, lse)
    with pytest.raises(MXNetError, match="layer norm kernel takes"):
        tk.layer_norm_fwd(torch.zeros((2, 16)), torch.ones(16,
                          dtype=torch.bfloat16), torch.zeros(16))
    out, lse = tk.flash_block_attention(q, q, q)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tk.flash_block_attention(q.double(), q.double(), q.double())
