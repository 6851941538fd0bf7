"""The training slice on the CPU against the JAX package: a tiny
TransformerNMT (vocab 50, units 32, hidden 64, 2 + 2 layers, 4 heads,
dropout 0) is built by `mxnet_tpu`, its `save_parameters` file is loaded
into the port's model, and the Gluon loop of examples/nmt_translate.py
(record, SoftmaxCrossEntropyLoss, backward, Trainer.step) runs in both
packages on the same seeded numpy batch (B=2, S=8, source lengths
[8, 5])."""
import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu.models import transformer as jt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops.kernels import LAUNCHES

CPU = mx.cpu()
VOCAB, B, S = 50, 2, 8
TINY = dict(units=32, hidden=64, num_layers=2, num_heads=4, max_length=16,
            dropout=0.0)
# fp32 through 4 layers on the CPU in both packages (XLA vs ATen sum
# orders): logits and the loss
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# gradients and updated weights: the same fp32 sums through a whole
# backward pass
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def jax_model_file(tmp_path_factory):
    """(JAX model, its save_parameters file, batch as numpy arrays)."""
    mxj.random.seed(5)
    m = jt.TransformerNMT(VOCAB, **TINY)
    m.initialize()
    rng = np.random.RandomState(0)
    batch = dict(src=rng.randint(4, VOCAB, (B, S)).astype(np.int32),
                 tgt=rng.randint(4, VOCAB, (B, S)).astype(np.int32),
                 out=rng.randint(4, VOCAB, (B, S)).astype(np.int32),
                 vl=np.array([8, 5], np.int32))
    m(*(mxj.nd.array(batch[k]) for k in ("src", "tgt", "vl")))
    path = str(tmp_path_factory.mktemp("nmt") / "nmt.params")
    m.save_parameters(path)
    return m, path, batch


def _port_model(path):
    pm = tt.TransformerNMT(VOCAB, **TINY)
    pm.load_parameters(path, ctx=CPU)
    return pm


def _train(pkg, model, batch, steps, optimizer, opt_params):
    """The loop of examples/nmt_translate.py; returns the losses."""
    if pkg is mx:
        arr = {k: mx.nd.array(v, ctx=CPU) for k, v in batch.items()}
    else:
        arr = {k: mxj.nd.array(v) for k, v in batch.items()}
    trainer = pkg.gluon.Trainer(model.collect_params(), optimizer,
                                opt_params)
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            logits = model(arr["src"], arr["tgt"], arr["vl"])
            loss = ce(logits.reshape((-1, VOCAB)),
                      arr["out"].reshape((-1,))).mean()
        loss.backward()
        trainer.step(B)
        losses.append(float(loss.asnumpy()))
    return losses


def _by_name(model, what):
    return {n: getattr(p, what)().asnumpy() for n, p in
            model._collect_params_with_prefix().items()}


def test_structural_names_and_shapes_match_jax():
    """transformer_base(36548) has the JAX package's 193 structural
    parameter names with the same shapes; the tiny model has 65."""
    for vocab, kw, n in ((36548, {}, 193), (VOCAB, TINY, 65)):
        if kw:
            jm, tm = jt.TransformerNMT(vocab, **kw), tt.TransformerNMT(
                vocab, **kw)
        else:
            jm, tm = jt.transformer_base(vocab), tt.transformer_base(vocab)
        want = {k: p.shape for k, p in
                jm._collect_params_with_prefix().items()}
        got = {k: p.shape for k, p in
               tm._collect_params_with_prefix().items()}
        assert len(got) == n
        assert got == want
        if not kw:
            assert got["decoder.layers.5.ln3.beta"] == (512,)
            assert got["encoder.layers.0.attn.qkv.weight"] == (1536, 512)
            assert got["embed.weight"] == (36548, 512)


def test_jax_parameters_load_and_logits_match(jax_model_file):
    """The JAX file loads with no name missing or extra and every value
    exact; the teacher-forcing logits agree; a missing name or a wrong
    shape is refused."""
    jm, path, batch = jax_model_file
    pm = _port_model(path)
    for name, value in _by_name(jm, "data").items():
        np.testing.assert_array_equal(_by_name(pm, "data")[name], value)
    want = jm(*(mxj.nd.array(batch[k]) for k in ("src", "tgt", "vl")))
    got = pm(*(mx.nd.array(batch[k], ctx=CPU) for k in ("src", "tgt",
                                                         "vl")))
    assert got.shape == (B, S, VOCAB)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **FWD_TOL)
    arrays = dict(np.load(path))
    with pytest.raises(mx.MXNetError, match="missing"):
        mx.convert.load_jax_parameters(tt.TransformerNMT(VOCAB, **TINY),
                                       {k: v for k, v in arrays.items()
                                        if k != "embed.weight"}, ctx=CPU)
    with pytest.raises(mx.MXNetError, match="shape"):
        bad = dict(arrays, **{"embed.weight": np.zeros((VOCAB, 8))})
        mx.convert.load_jax_parameters(_port_model(path), bad, ctx=CPU)


def test_one_step_loss_and_every_gradient_match(jax_model_file):
    _jm, path, batch = jax_model_file
    pm = _port_model(path)
    jmc = jt.TransformerNMT(VOCAB, **TINY)
    jmc.load_parameters(path)
    want = _train(mxj, jmc, batch, 1, "sgd", {"learning_rate": 0.0})
    got = _train(mx, pm, batch, 1, "sgd", {"learning_rate": 0.0})
    np.testing.assert_allclose(got, want, **FWD_TOL)
    want_g, got_g = _by_name(jmc, "grad"), _by_name(pm, "grad")
    assert got_g.keys() == want_g.keys() and len(got_g) == 65
    for name in want_g:
        assert np.abs(want_g[name]).max() > 0, name
        np.testing.assert_allclose(got_g[name], want_g[name], **GRAD_TOL,
                                   err_msg=name)


def test_three_sgd_momentum_steps_match(jax_model_file):
    """Losses and final weights over 3 SGD-momentum steps; no kernel is
    launched on the CPU."""
    _jm, path, batch = jax_model_file
    opt = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-4}
    jmc = jt.TransformerNMT(VOCAB, **TINY)
    jmc.load_parameters(path)
    pm = _port_model(path)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    want = _train(mxj, jmc, batch, 3, "sgd", opt)
    got = _train(mx, pm, batch, 3, "sgd", opt)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, **FWD_TOL)
    want_w = _by_name(jmc, "data")
    for name, value in _by_name(pm, "data").items():
        np.testing.assert_allclose(value, want_w[name], **GRAD_TOL,
                                   err_msg=name)
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)


def test_trained_model_serves_like_jax(jax_model_file):
    """After training steps the same block tree serves: the port's and
    the JAX package's servers, on the JAX-trained weights carried across
    by file, give the same greedy tokens."""
    _jm, path, batch = jax_model_file
    jmc = jt.TransformerNMT(VOCAB, **TINY)
    jmc.load_parameters(path)
    _train(mxj, jmc, batch, 2, "adam", {"learning_rate": 3e-3})
    trained = str(path) + ".trained"
    jmc.save_parameters(trained)
    pm = _port_model(trained)
    kw = dict(slots=2, page_size=4, max_src_len=8, max_new_tokens=5,
              engine_driven=False)
    js = mxj.serve.Server(jmc, **kw)
    ts = mx.serve.Server(pm, device="cpu", **kw)
    try:
        for src in batch["src"]:
            want = js.submit(src).result()
            got = ts.submit(src).result()
            assert got == want and len(got) == 5
        assert ts.pool.in_use() == 0
    finally:
        js.close()
        ts.close()
