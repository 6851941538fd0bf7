"""The bf16 BERT slice on the CPU against the JAX package: a 2-layer
`BERTForPretraining` of narrow width (units 128, 2 heads, hidden 512,
S = 128, key lengths below S, dropout 0) built by `mxnet_tpu`, its
weights carried into the port, both cast to bfloat16, and the step of
`bench_bert.py` (the MLM + NSP losses on logits cast to fp32) run in
both packages on the same seeded numpy batch: the MLM and NSP logits,
the loss, every gradient, and every weight after one Trainer step (SGD
with momentum, bench_bert.py's optimizer, in bf16; and Adam with
`multi_precision=True`).

The yardstick is the same computation in float64 (`_bert_f64`: the
block tree written out in torch, on the bf16 weights), under the rule
of `tests/test_torch_bf16.py`: the port's distance from float64 at most
twice the JAX package's plus one bf16 ulp of the largest float64 value,
and port vs JAX within rtol = atol = 0.05 elementwise. A bf16 JAX BERT
also carries across as bf16 (`convert.load_jax_parameters` on the
ml_dtypes arrays numpy hands over).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.models import bert as jb
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import bert as tb
from mxnet_tpu_torch.ops.kernels import LAUNCHES

CPU = mx.cpu()
VOCAB, B, S, P, L, U, H = 64, 3, 128, 6, 2, 128, 2
NARROW = dict(vocab_size=VOCAB, units=U, hidden_size=512, num_layers=L,
              num_heads=H, max_length=S, dropout=0.0)
BF16_TOL = dict(rtol=0.05, atol=0.05)     # tests/test_pallas.py:80-84
FLOOR = 2.0 ** -8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _rule(port, jx, exact, what):
    port, jx, exact = _np(port), _np(jx), np.asarray(exact, np.float64)
    np.testing.assert_allclose(port, jx, **BF16_TOL, err_msg=what)
    dp, dj = np.abs(port - exact).max(), np.abs(jx - exact).max()
    assert dp <= 2 * dj + FLOOR * np.abs(exact).max(), (what, dp, dj)


def _batch():
    rng = np.random.RandomState(0)
    vl = np.array([100, 37, 127], np.int32)
    return dict(tok=rng.randint(0, VOCAB, (B, S)).astype(np.int32),
                seg=rng.randint(0, 2, (B, S)).astype(np.int32), vl=vl,
                pos=(rng.uniform(0, 1, (B, P)) * vl[:, None]).astype(
                    np.int32),
                mlm_y=rng.randint(0, VOCAB, (B, P)).astype(np.int32),
                nsp_y=rng.randint(0, 2, (B,)).astype(np.int32))


def _arrays(pkg, batch):
    if pkg is mx:
        return {k: mx.nd.array(v, ctx=CPU) for k, v in batch.items()}
    return {k: mxj.nd.array(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A JAX BERTForPretraining's weights as numpy (and in a
    save_parameters file, for the JAX models), its position weights, MLM
    bias and LayerNorm affines made random."""
    mxj.random.seed(3)
    m = jb.BERTForPretraining(jb.BERTModel(**NARROW))
    m.initialize(mxj.init.Normal(0.05))
    a = _arrays(mxj, _batch())
    m(a["tok"], a["seg"], a["vl"], a["pos"])
    arrays = {n: p.data().asnumpy() for n, p in
              m._collect_params_with_prefix().items()}
    rng = np.random.RandomState(1)
    for name, value in arrays.items():
        if name.endswith(("position_weight", "mlm_bias", ".beta")):
            arrays[name] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        elif name.endswith(".gamma"):
            arrays[name] = (1 + 0.1 * rng.randn(*value.shape)).astype(
                np.float32)
    path = str(tmp_path_factory.mktemp("bert_bf16") / "bert.params")
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    arrays["path"] = path
    return arrays


def _models(arrays):
    """The JAX and the port model on `arrays`, both cast to bf16."""
    jm = jb.BERTForPretraining(jb.BERTModel(**NARROW))
    jm.load_parameters(arrays["path"])
    arrays = {k: v for k, v in arrays.items() if k != "path"}
    tm = tb.BERTForPretraining(tb.BERTModel(**NARROW))
    mx.convert.load_jax_parameters(tm, arrays, ctx=CPU)
    return jm.cast("bfloat16"), tm.cast("bfloat16")


def _loss(pkg, model, a):
    """bench_bert.py's loss: the MLM and NSP cross-entropies on logits
    cast to fp32 (bench_bert.py:60-61)."""
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    mlm, nsp = model(a["tok"], a["seg"], a["vl"], a["pos"])
    mlm32, nsp32 = mlm.astype("float32"), nsp.astype("float32")
    return (ce(mlm32.reshape((-1, VOCAB)), a["mlm_y"].reshape((-1,))).mean()
            + ce(nsp32, a["nsp_y"]).mean()), mlm, nsp


def _step(pkg, model, optimizer, params):
    """One recorded forward, backward and Trainer.step(1) (the batch-mean
    loss's gradient as it is, as bench_bert.py's step takes it)."""
    a = _arrays(pkg, _batch())
    trainer = pkg.gluon.Trainer(model.collect_params(), optimizer, params)
    with pkg.autograd.record():
        loss, mlm, nsp = _loss(pkg, model, a)
    loss.backward()
    grads = {n: _np(p.grad()._data) for n, p in
             model._collect_params_with_prefix().items()}
    trainer.step(1)
    return float(loss.asnumpy()), mlm, nsp, grads


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def _gelu(x):
    return 0.5 * x * (1 + torch.tanh((2 / np.pi) ** 0.5
                                     * (x + 0.044715 * x ** 3)))


def _bert_f64(w, batch):
    """The forward of BERTForPretraining in float64 on the weights `w`
    ({structural name: float64 leaf}) and the loss of `_loss`: (loss,
    mlm, nsp)."""
    tok, seg, vl, pos = (torch.from_numpy(batch[k]).long()
                         for k in ("tok", "seg", "vl", "pos"))
    x = w["bert.word_embed.weight"][tok] \
        + w["bert.token_type_embed.weight"][seg] \
        + w["bert.encoder.position_weight"][:S][None]
    x = _ln(x, w["bert.encoder.ln.gamma"], w["bert.encoder.ln.beta"])
    keep = (torch.arange(S)[None, :] < vl[:, None])[:, None, None, :]
    for i in range(L):
        pre = f"bert.encoder.layers.{i}."
        qkv = x @ w[pre + "attention.qkv.weight"].T \
            + w[pre + "attention.qkv.bias"]
        q, k, v = (t.reshape(B, S, H, U // H).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        s = q @ k.transpose(-1, -2) / (U // H) ** 0.5
        s = s.masked_fill(~keep, -torch.inf)
        o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, S, U)
        o = o @ w[pre + "attention.proj.weight"].T \
            + w[pre + "attention.proj.bias"]
        x = _ln(x + o, w[pre + "ln1.gamma"], w[pre + "ln1.beta"])
        f = _gelu(x @ w[pre + "ffn.ffn1.weight"].T + w[pre + "ffn.ffn1.bias"])
        f = f @ w[pre + "ffn.ffn2.weight"].T + w[pre + "ffn.ffn2.bias"]
        x = _ln(x + f, w[pre + "ln2.gamma"], w[pre + "ln2.beta"])
    pooled = torch.tanh(x[:, 0] @ w["bert.pooler.weight"].T
                        + w["bert.pooler.bias"])
    at = x[torch.arange(B)[:, None], pos]
    h = _gelu(at @ w["bert.mlm_dense.weight"].T + w["bert.mlm_dense.bias"])
    h = _ln(h, w["bert.mlm_ln.gamma"], w["bert.mlm_ln.beta"])
    mlm = h @ w["bert.word_embed.weight"].T + w["bert.mlm_bias"]
    nsp = pooled @ w["nsp.weight"].T + w["nsp.bias"]
    ce = torch.nn.functional.cross_entropy
    loss = ce(mlm.reshape(-1, VOCAB),
              torch.from_numpy(batch["mlm_y"]).long().reshape(-1)) \
        + ce(nsp, torch.from_numpy(batch["nsp_y"]).long())
    return loss, mlm, nsp


def _f64(model):
    """The float64 forward and gradients on `model`'s (bf16) weights."""
    w = {n: torch.tensor(_np(p.data()._data), requires_grad=True)
         for n, p in model._collect_params_with_prefix().items()}
    loss, mlm, nsp = _bert_f64(w, _batch())
    loss.backward()
    return (loss.item(), mlm.detach().numpy(), nsp.detach().numpy(),
            {n: t.grad.numpy() for n, t in w.items()})


def test_bf16_slice_matches_jax_and_float64(weights):
    """The MLM and NSP logits (bf16 in both), the loss, all 38 gradients
    and every weight after one SGD-momentum step in bf16 (lr 0.05, so
    that the step moves the weights past bf16's rounding), under the
    tolerance rule against float64; no kernel launches on the CPU."""
    jm, tm = _models(weights)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ref = _f64(tm)
    lr, mu = 0.05, 0.9
    opt = {"learning_rate": lr, "momentum": mu}
    jl, jmlm, jnsp, jg = _step(mxj, jm, "sgd", opt)
    tl, tmlm, tnsp, tg = _step(mx, tm, "sgd", opt)
    assert tmlm.dtype == torch.bfloat16 and tnsp.dtype == torch.bfloat16
    assert tmlm.shape == (B, P, VOCAB)
    _rule(tmlm._data, jmlm._data, ref[1], "mlm logits")
    _rule(tnsp._data, jnsp._data, ref[2], "nsp logits")
    _rule(np.array(tl), np.array(jl), np.array(ref[0]), "loss")
    assert len(tg) == 38
    for name in tg:
        assert np.abs(ref[3][name]).max() > 0, name
        _rule(tg[name], jg[name], ref[3][name], f"gradient of {name}")
    jw = jm._collect_params_with_prefix()
    for name, p in tm._collect_params_with_prefix().items():
        assert p.data()._data.dtype == torch.bfloat16
        w0 = _np(mx.nd.array(weights[name], ctx=CPU, dtype="bfloat16")
                 ._data)
        # one step from zero momentum: m = g, w = w0 - lr g (float64)
        _rule(p.data()._data, jw[name].data()._data,
              w0 - lr * ref[3][name], f"weight {name}")
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)


def test_bf16_adam_multi_precision_step_matches(weights):
    """One Trainer step with Adam and multi_precision=True on the bf16
    models, in both packages: every fp32 master is Adam's first update of
    its own package's gradient, w0 - lr g / (|g| + eps) in float64, to
    fp32 rounding (about 8 operations of the update, 1e-6 of lr, and
    the sum, 2^-23 of the master; the JAX package takes the bias
    corrections 1 - beta^t in fp32 too, 1 - 0.999 with 5e-5 of relative
    error, so 3e-5 of lr there); every bf16 weight is its master
    rounded; and the port's gradients, which decide the update's
    direction, are held to the JAX package's and float64 by
    `test_bf16_slice_matches_jax_and_float64`."""
    lr, eps = 1e-3, 1e-8
    jm, tm = _models(weights)
    opt = {"learning_rate": lr, "multi_precision": True}
    for pkg, model in ((mxj, jm), (mx, tm)):
        arr = _arrays(pkg, _batch())
        trainer = pkg.gluon.Trainer(model.collect_params(), "adam", opt)
        with pkg.autograd.record():
            loss = _loss(pkg, model, arr)[0]
        loss.backward()
        trainer.step(1)
        index = {id(p): i for i, p in enumerate(trainer._params)}
        for name, p in model._collect_params_with_prefix().items():
            master = trainer._updater.states[index[id(p)]][0]
            g = _np(p.grad()._data)
            w0 = _np(mx.nd.array(weights[name], ctx=CPU, dtype="bfloat16")
                     ._data)
            want = w0 - lr * g / (np.abs(g) + eps)
            np.testing.assert_allclose(
                _np(master._data), want, rtol=2.0 ** -23,
                atol=(1e-6 if pkg is mx else 3e-5) * lr,
                err_msg=f"{pkg.__name__} {name}")
            assert _np(master._data).dtype == np.float64
            np.testing.assert_array_equal(
                _np(p.data()._data),
                _np(torch.from_numpy(_np(master._data).astype(np.float32))
                    .to(torch.bfloat16)), err_msg=name)
        if pkg is mx:
            assert all(st[0]._data.dtype == torch.float32
                       for st in trainer._updater.states.values())


def test_bf16_bert_carries_across(weights):
    """A JAX BERT cast to bf16 hands its arrays over as ml_dtypes bf16;
    `convert.load_jax_parameters` takes them without converting through
    float32 (a port model cast first keeps bf16), every value bit for
    bit, and the outputs agree under the tolerance rule."""
    jm, tm = _models(weights)
    arrays = {n: np.asarray(p.data()._data) for n, p in
              jm._collect_params_with_prefix().items()}
    assert all(a.dtype.name == "bfloat16" for a in arrays.values())
    fresh = tb.BERTForPretraining(tb.BERTModel(**NARROW))
    fresh.initialize(ctx=CPU)
    fresh.cast("bfloat16")
    mx.convert.load_jax_parameters(fresh, arrays, ctx=CPU)
    for name, p in fresh._collect_params_with_prefix().items():
        assert p.data()._data.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      _np(arrays[name]).astype(np.float32))
    ref = _f64(fresh)
    ta, ja = _arrays(mx, _batch()), _arrays(mxj, _batch())
    got = fresh(ta["tok"], ta["seg"], ta["vl"], ta["pos"])
    want = jm(ja["tok"], ja["seg"], ja["vl"], ja["pos"])
    _rule(got[0]._data, want[0]._data, ref[1], "mlm logits")
    _rule(got[1]._data, want[1]._data, ref[2], "nsp logits")
