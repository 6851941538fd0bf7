"""A TransformerNMT after `cast("bfloat16")`, as bench_nmt.py trains it
(bench_nmt.py:40-61), on the CPU against the JAX package.

Cast, the model holds bf16 weights but computes in fp32 in both
packages: the positional add promotes the bf16 embeddings to fp32, every
product promotes an fp32 activation and a bf16 weight to fp32
(`jnp.matmul`'s rule, `mxnet_tpu/ops/nn_ops.py:58-67`), and LayerNorm
takes fp32 x with bf16 gamma / beta, y in x's dtype. So the logits are
fp32, the attention runs in fp32 and each weight's gradient is an fp32
value rounded once to bf16.

A 2 + 2-layer narrow model (vocab 50, units 64, hidden 128, 4 heads, B=3,
S=12, source lengths below S, dropout 0) is built by `mxnet_tpu`, its
weights carried into the port by `convert.load_jax_parameters`, both
cast to bf16, and bench_nmt.py's step (the cross-entropy on the logits
as fp32, backward, SGD lr 0.05 momentum 0.9 on the mean loss's
gradient) runs twice in both on the same seeded numpy batch.

Tolerances: logits and loss are fp32 sums in other orders through 4
layers (FWD_TOL, as tests/test_torch_train.py). A bf16 gradient is one
rounding of an fp32 value, which may land one bf16 ulp (2^-7 of it)
apart, plus the fp32 part relative to the tensor's largest value
(GRAD_RTOL, GRAD_SCALE_ATOL); the tied embedding's gradient sums three
such bf16 gradients in bf16 (EMBED_ULPS of them). The weights after two
bf16 SGD steps: each step's bf16 rounding of w - lr m may land one ulp
apart (WEIGHT_RTOL, two ulps), and the two steps move w by lr (2 + mu)
gradients at most, each as far apart as the gradients are, taken at
twice the first step's largest value (STEP_ATOL times that value; a key
bias's gradient is 0 up to fp32 noise, so its weight has no scale of
its own).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.ops import nn_ops as jnn_ops
from mxnet_tpu.ops import pallas_kernels as jk
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk
from mxnet_tpu_torch.ops.kernels import LAUNCHES

CPU = mx.cpu()
VOCAB, B, S = 50, 3, 12
NARROW = dict(units=64, hidden=128, num_layers=2, num_heads=4,
              max_length=16, dropout=0.0)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_SCALE_ATOL, EMBED_ULPS = 2.0 ** -7, 1e-4, 3
WEIGHT_RTOL = 2.0 ** -6
# tests/test_pallas.py:219's LayerNorm tolerance (fp32)
LN_TOL = dict(rtol=1e-4, atol=1e-5)
LR, MU = 0.05, 0.9
STEP_ATOL = LR * (2 + MU) * (EMBED_ULPS * GRAD_RTOL + GRAD_SCALE_ATOL) * 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _batch():
    rng = np.random.RandomState(0)
    return dict(src=rng.randint(4, VOCAB, (B, S)).astype(np.int32),
                tgt=rng.randint(4, VOCAB, (B, S)).astype(np.int32),
                out=rng.randint(4, VOCAB, (B, S)).astype(np.int32),
                vl=np.array([12, 7, 3], np.int32))


@pytest.fixture(scope="module")
def weights():
    """A JAX TransformerNMT's weights as numpy, its LayerNorm affines
    made random so that bf16 gamma / beta are not all 1 and 0."""
    mxj.random.seed(11)
    m = jt.TransformerNMT(VOCAB, **NARROW)
    m.initialize(mxj.init.Normal(0.1))
    b = _batch()
    m(*(mxj.nd.array(b[k]) for k in ("src", "tgt", "vl")))
    arrays = {n: p.data().asnumpy() for n, p in
              m._collect_params_with_prefix().items()}
    rng = np.random.RandomState(1)
    for name, value in arrays.items():
        if name.endswith(".gamma"):
            arrays[name] = (1 + 0.1 * rng.randn(*value.shape)).astype(
                np.float32)
        elif name.endswith(".beta"):
            arrays[name] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
    return arrays


def _models(arrays):
    jm = jt.TransformerNMT(VOCAB, **NARROW)
    b = _batch()
    jm.initialize()
    jm(*(mxj.nd.array(b[k]) for k in ("src", "tgt", "vl")))
    for n, p in jm._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(arrays[n]))
    tm = tt.TransformerNMT(VOCAB, **NARROW)
    mx.convert.load_jax_parameters(tm, arrays, ctx=CPU)
    return jm.cast("bfloat16"), tm.cast("bfloat16")


def _steps(pkg, model, n):
    """bench_nmt.py's step n times: (logits and loss of the first, every
    gradient of the first, the weights after the last)."""
    b = _batch()
    if pkg is mx:
        a = {k: mx.nd.array(v, ctx=CPU) for k, v in b.items()}
    else:
        a = {k: mxj.nd.array(v) for k, v in b.items()}
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": MU})
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    first = None
    for _ in range(n):
        with pkg.autograd.record():
            logits = model(a["src"], a["tgt"], a["vl"]).astype("float32")
            loss = ce(logits.reshape((-1, VOCAB)),
                      a["out"].reshape((-1,))).mean()
        loss.backward()
        if first is None:
            grads = {k: (_np(p.grad()._data), str(p.grad().dtype))
                     for k, p in model._collect_params_with_prefix().items()}
            first = (logits, float(loss.asnumpy()), grads)
        trainer.step(1)
    weights = {k: (_np(p.data()._data), str(p.data().dtype)) for k, p in
               model._collect_params_with_prefix().items()}
    return first, weights


def test_cast_nmt_trains_in_fp32_on_bf16_weights_as_jax_does(weights):
    """The cast model's fp32 logits and loss, its 65 bf16 gradients and
    its bf16 weights after two SGD-momentum steps against the JAX
    package's; no kernel launches on the CPU."""
    jm, tm = _models(weights)
    tk.reset_launch_counts()
    (tlog, tloss, tgrads), tw = _steps(mx, tm, 2)
    (jlog, jloss, jgrads), jw = _steps(mxj, jm, 2)
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)
    assert tlog._data.dtype == torch.float32
    assert jlog._data.dtype == jnp.float32
    np.testing.assert_allclose(_np(tlog._data), _np(jlog._data), **FWD_TOL)
    np.testing.assert_allclose(tloss, jloss, **FWD_TOL)
    assert len(tgrads) == 65 and set(tgrads) == set(jgrads)
    for name, (g, dt) in tgrads.items():
        jg, jdt = jgrads[name]
        assert dt.endswith("bfloat16") and jdt.endswith("bfloat16"), name
        ulps = EMBED_ULPS if name == "embed.weight" else 1
        lim = ulps * GRAD_RTOL * np.abs(jg) \
            + GRAD_SCALE_ATOL * np.abs(jg).max()
        assert (np.abs(g - jg) <= lim).all(), (name, np.abs(g - jg).max())
    for name, (w, dt) in tw.items():
        assert dt.endswith("bfloat16"), name
        jwn = jw[name][0]
        np.testing.assert_allclose(
            w, jwn, rtol=WEIGHT_RTOL,
            atol=STEP_ATOL * np.abs(jgrads[name][0]).max(), err_msg=name)
    assert not np.array_equal(tw["embed.weight"][0],
                              weights["embed.weight"])


@pytest.mark.parametrize("xdt,wdt", [("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_fully_connected_promotes_as_jnp_matmul(xdt, wdt):
    """`FullyConnected` on mixed dtypes takes `jnp.matmul`'s result dtype
    (fp32 for fp32 with bf16), the bias in y's dtype, each gradient in
    its operand's dtype, and the JAX op's values (FWD_TOL in fp32, one
    bf16 ulp in bf16)."""
    rng = np.random.RandomState(2)
    x, w, b = (rng.randn(*s).astype(np.float32)
               for s in ((5, 3, 8), (6, 24), (6,)))
    tx = mx.nd.array(x, ctx=CPU, dtype=xdt)
    tw_ = mx.nd.array(w, ctx=CPU, dtype=wdt)
    tb = mx.nd.array(b, ctx=CPU, dtype=wdt)
    for t in (tx, tw_, tb):
        t.attach_grad()
    with mx.autograd.record():
        y = mx.nd.FullyConnected(tx, tw_, tb, num_hidden=6)
        (y.astype("float32") ** 2).sum().backward()
    jargs = [jnp.asarray(a, dt) for a, dt in ((x, xdt), (w, wdt), (b, wdt))]
    jy = jnn_ops.fully_connected(*jargs)
    assert str(y.dtype).endswith(str(jy.dtype))
    tol = FWD_TOL if jy.dtype == jnp.float32 else dict(rtol=2.0 ** -7,
                                                       atol=2.0 ** -7)
    np.testing.assert_allclose(_np(y._data), _np(jy), **tol)
    jg = jax.grad(lambda *a: (jnn_ops.fully_connected(*a)
                              .astype(jnp.float32) ** 2).sum(),
                  argnums=(0, 1, 2))(*jargs)
    for t, g in zip((tx, tw_, tb), jg):
        assert str(t.grad.dtype).endswith(str(g.dtype))
        np.testing.assert_allclose(_np(t.grad._data), _np(g), rtol=2.0 ** -6,
                                   atol=2.0 ** -6 * np.abs(_np(g)).max())


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("rows,d", [(16, 512), (64, 128), (13, 200),
                                    (5, 1032)],
                         ids=["512-pallas", "128-pallas", "200", "1032"])
def test_layer_norm_fp32_x_bf16_gamma_matches_jax(interpret, monkeypatch,
                                                  rows, d):
    """`fused_layer_norm` with fp32 x and bf16 gamma / beta against the
    JAX function, run as tests/test_pallas.py runs it: its Pallas kernel
    in interpret mode where it takes the shape (D % 128 == 0, rows % 8
    == 0), its XLA form elsewhere. y and dx fp32, dgamma and dbeta bf16
    (one rounding of an fp32 sum, one bf16 ulp apart at most); y, mean
    and rstd within LN_TOL."""
    rng = np.random.RandomState(4)
    x = (3 * rng.randn(rows, d) + 1).astype(np.float32)
    g16, b16, w = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   .to(torch.bfloat16) for s in ((d,), (d,), (rows, d)))
    calls, real = [], jk.pl.pallas_call
    monkeypatch.setattr(jk.pl, "pallas_call",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jx = jnp.asarray(x)
    jg, jb = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
              for t in (g16, b16))
    want_y, want_m, want_r = jk._fused_ln_fwd_impl(jx, jg, jb, 1e-5)
    assert bool(calls) == (d % 128 == 0 and rows % 8 == 0)
    got_y, got_m, got_r = tk.layer_norm_fwd(torch.from_numpy(x), g16, b16,
                                            1e-5)
    assert got_y.dtype == torch.float32 and want_y.dtype == jnp.float32
    for got, want in ((got_y, want_y), (got_m, want_m[:, 0]),
                      (got_r, want_r[:, 0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LN_TOL)
    wn = w.float().numpy()
    jgrad = jax.grad(lambda *a: (jk.fused_layer_norm(*a) * wn).sum(),
                     argnums=(0, 1, 2))(jx, jg, jb)
    tx = torch.tensor(x, requires_grad=True)
    tg, tb = (t.clone().requires_grad_() for t in (g16, b16))
    (tk.fused_layer_norm(tx, tg, tb) * w.float()).sum().backward()
    assert tx.grad.dtype == torch.float32
    assert tg.grad.dtype == tb.grad.dtype == torch.bfloat16
    assert jgrad[1].dtype == jgrad[2].dtype == jnp.bfloat16
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad[0]),
                               **LN_TOL)
    for t, ref in ((tg, jgrad[1]), (tb, jgrad[2])):
        r = _np(ref)
        np.testing.assert_allclose(_np(t.grad), r, rtol=2.0 ** -7,
                                   atol=LN_TOL["rtol"] * np.abs(r).max())


class _LnLibrary:
    """Records the LayerNorm launches; writes nothing."""

    def __init__(self):
        self.calls = []

    def mxtt_layer_norm_f32(self, *args):
        self.calls.append(("f32",) + args)
        return 0

    def mxtt_layer_norm_bf16(self, *args):
        self.calls.append(("bf16",) + args)
        return 0


@pytest.fixture
def card(monkeypatch):
    """CPU tensors dispatched as if they lay on the card, into a fake
    kernel library; the plain version must not run."""
    lib = _LnLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tk, "_device_of", lambda *t: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())

    def no_plain(*a):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(tk, "_ln_plain", no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_layer_norm_wrapper_hands_the_gamma_dtype(card, xdt, gdt):
    """On a card tensor, fp32 x launches `mxtt_layer_norm_f32` with the
    gamma-dtype flag of `mxtt_layer_norm_bf16` (1 for bf16 gamma / beta),
    as many arguments as `_build` declares, and counts under
    `layer_norm`; bf16 x launches the bf16 form as before."""
    x = torch.zeros((6, 96), dtype=xdt)
    g, b = torch.ones(96, dtype=gdt), torch.zeros(96, dtype=gdt)
    y, mean, rstd = tk.layer_norm_fwd(x, g, b, 1e-5)
    assert y.dtype == xdt and mean.dtype == rstd.dtype == torch.float32
    form = "f32" if xdt == torch.float32 else "bf16"
    ((got_form, *args),) = card.calls
    assert got_form == form
    assert len(args) == len(_build._SIGNATURES[f"mxtt_layer_norm_{form}"])
    assert tuple(args[6:10]) == (6, 96, 1e-5, int(gdt == torch.bfloat16))
    assert tk.LAUNCHES["layer_norm" + ("" if form == "f32" else "_bf16")] \
        == 1


def test_cast_transformer_base_keeps_its_names():
    """`transformer_base(36548)` cast to bf16 in both packages: the same
    193 structural names, every parameter bf16 (no forward)."""
    jm = jt.transformer_base(36548, max_length=64, dropout=0.0)
    tm = tt.transformer_base(36548, max_length=64, dropout=0.0)
    jp = jm._collect_params_with_prefix()
    tp = tm._collect_params_with_prefix()
    assert list(tp) == list(jp) and len(tp) == 193
    tm.cast("bfloat16")
    jm.cast("bfloat16")
    for n, p in tp.items():
        assert p.dtype == torch.bfloat16
        assert np.dtype(jp[n].dtype).name == "bfloat16", n
