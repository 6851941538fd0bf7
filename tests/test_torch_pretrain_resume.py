"""BERT MLM pretraining fed from a RecordIO pack, checkpointed
asynchronously and resumed, on the CPU (the path `chip_smoke.py`'s phase
11r drives at full width on the card, at a small size): a 2-layer,
128-wide BERTForPretraining built by the JAX package, its
`save_parameters` file loaded into the port's model, the same pack
(`chip_smoke.write_bert_pack`, one sample a record) read by each
package's `RecordFileDataset` + `DataLoader` (the port's through
`prefetch_to_device=True, pin_memory=True`), SGD with momentum in both.
The losses match the JAX package's within `tests/test_torch_bert.py`'s
tolerance; a run resumed from the async checkpoint at step k equals the
uninterrupted one at step K bit for bit, eager (a fresh model and
Trainer) and captured (restored into the live captured step)."""
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu as mxj
import mxnet_tpu.recordio as jrio
from mxnet_tpu.models import bert as jb
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import bert as tb

CPU = mx.cpu()
VOCAB, B, S, P = 64, 4, 32, 5
TINY = dict(vocab_size=VOCAB, units=128, hidden_size=256, num_layers=2,
            num_heads=2, max_length=S, dropout=0.0)
# tests/test_torch_bert.py's tolerance for losses (fp32 through a few
# layers in both packages: XLA against ATen sum orders)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
N_BATCHES, STEPS, RESUME_AT = 8, 6, 3
LR, MOMENTUM = 0.01, 0.9


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """The pack (written by the port) and the JAX model's weights file."""
    d = tmp_path_factory.mktemp("pack")
    batches = cs.bert_pack_batches(N_BATCHES, B, S, P, VOCAB)
    rec = str(d / "pretrain.rec")
    cs.write_bert_pack(mx, rec, batches)
    mxj.random.seed(5)
    m = jb.BERTForPretraining(jb.BERTModel(**TINY))
    m.initialize(mxj.init.Normal(0.05))
    m(*(mxj.nd.array(a) for a in batches[0][:4]))
    weights = str(d / "bert.params")
    m.save_parameters(weights)
    return rec, weights, batches


def _loss(pkg, model, ce, tok, seg, vl, pos, mlm_y, nsp_y):
    mlm, nsp = model(tok, seg, vl, pos)
    return ce(mlm.reshape((-1, VOCAB)), mlm_y.reshape((-1,))).mean() \
        + ce(nsp, nsp_y).mean()


def _port_model(weights=None):
    m = tb.BERTForPretraining(tb.BERTModel(**TINY))
    m.initialize(ctx=CPU)
    if weights is not None:
        m.load_parameters(weights, ctx=CPU)
    return m


def _trainer(pkg, model):
    return pkg.gluon.Trainer(model.collect_params(), "sgd",
                             {"learning_rate": LR, "momentum": MOMENTUM})


def _params_of(model):
    return {"params": {k: p.data() for k, p in
                       model._collect_params_with_prefix().items()}}


def _state(model, trainer):
    return ({k: t.clone() for k, t in
             ((n, p.data()._data) for n, p in
              model._collect_params_with_prefix().items())},
            {i: s[0]._data.clone() for i, s in
             trainer._updater.states.items()})


def _assert_same_state(got, want):
    (gw, gm), (ww, wm) = got, want
    assert gw.keys() == ww.keys() and gm.keys() == wm.keys()
    for k in ww:
        assert torch.equal(gw[k], ww[k]), k
    for i in wm:
        assert torch.equal(gm[i], wm[i]), i


def _port_loader(rec, start=0):
    _, samples = cs.bert_record_dataset(mx, rec)
    return cs.bert_pack_loader(mx, samples, B, start, ctx=CPU,
                               prefetch_to_device=True, pin_memory=True)


def _run(step, loader, first, last, mgr=None, trainer=None, model=None):
    """Steps first+1..last on the loader's batches; an async save at
    RESUME_AT. Returns the losses."""
    losses = []
    it = iter(loader)
    for s in range(first + 1, last + 1):
        losses.append(float(step(*next(it)).asnumpy()))
        if mgr is not None and s == RESUME_AT:
            mgr.save(s, _params_of(model), _async=True, extras={
                "trainer": trainer.states_bytes(),
                "cursor": json.dumps({"batches": s}).encode()})
    it.close()
    return losses


def _eager(pkg, model, trainer):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(*batch):
        with pkg.autograd.record():
            loss = _loss(pkg, model, ce, *batch)
        loss.backward()
        trainer.step(batch[0].shape[0])
        return loss
    return step


def test_pack_reads_back_the_written_samples(pack):
    """Both packages' RecordFileDataset over the pack give each written
    sample, in order; the port's loader gives the written batches."""
    rec, _, batches = pack
    ds, samples = cs.bert_record_dataset(mx, rec)
    jds = mxj.gluon.data.RecordFileDataset(rec)
    assert isinstance(ds._records, mx.recordio.NativeRecordFile)
    assert ds._rec is None and len(ds) == len(jds) == N_BATCHES * B
    for i in (0, 5, len(ds) - 1):
        want = [f[i % B] for f in batches[i // B]]
        for got in (samples[i],
                    cs.unpack_bert_sample(jrio.unpack(jds[i])[1])):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for got, want in zip(_port_loader(rec), batches):
        for g, w in zip(got, want):
            assert g._data.dtype == torch.int32
            np.testing.assert_array_equal(g.asnumpy(), w)


def test_losses_match_the_jax_package_on_the_same_records(pack):
    """STEPS SGD steps on the pack's batches in both packages, each read
    through its own RecordFileDataset and DataLoader: the same losses
    within FWD_TOL (each step on new random batches, so they need not
    fall)."""
    rec, weights, _ = pack
    jm = jb.BERTForPretraining(jb.BERTModel(**TINY))
    jm.load_parameters(weights)
    jtr = _trainer(mxj, jm)
    jds = mxj.gluon.data.RecordFileDataset(rec).transform(
        lambda r: cs.unpack_bert_sample(jrio.unpack(r)[1]))
    # prefetch=0: the JAX package's indexed reader shares one file
    # position, which its loader's engine tasks would race on
    jloader = mxj.gluon.data.DataLoader(jds, batch_size=B, prefetch=0)
    want = _run(_eager(mxj, jm, jtr), jloader, 0, STEPS)
    tm = _port_model(weights)
    got = _run(_eager(mx, tm, _trainer(mx, tm)), _port_loader(rec), 0, STEPS)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_resumed_run_equals_the_uninterrupted_one(pack, tmp_path):
    """Eager: K steps with an async save at k, then a fresh model and
    Trainer restored from it (`restore_latest`, `load_states_bytes`,
    the loader at the saved cursor) run k..K: the same losses and, at
    K, the same weights and momenta, bit for bit."""
    rec, weights, _ = pack
    model = _port_model(weights)
    trainer = _trainer(mx, model)
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    losses = _run(_eager(mx, model, trainer), _port_loader(rec), 0, STEPS,
                  mgr, trainer, model)
    mgr.wait()
    final = _state(model, trainer)
    fresh = _port_model()
    tr2 = _trainer(mx, fresh)
    step, restored = mgr.restore_latest(_params_of(fresh))
    assert step == RESUME_AT
    for k, p in fresh._collect_params_with_prefix().items():
        p.set_data(restored["params"][k])
    tr2.load_states_bytes(mgr.read_extra(step, "trainer"))
    cursor = json.loads(mgr.read_extra(step, "cursor"))
    assert cursor == {"batches": RESUME_AT}
    resumed = _run(_eager(mx, fresh, tr2),
                   _port_loader(rec, cursor["batches"]), RESUME_AT, STEPS)
    assert resumed == losses[RESUME_AT:]
    _assert_same_state(_state(fresh, tr2), final)


def test_resume_into_the_live_captured_step(pack, tmp_path):
    """Captured: K steps of `Trainer.capture` with an async save at k;
    restored into the same model, Trainer and step (weights copied in
    place, the states rebound): one `state_change` miss, and at K the
    same weights and momenta as before the restore, bit for bit."""
    rec, weights, _ = pack
    model = _port_model(weights)
    trainer = _trainer(mx, model)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    cap = trainer.capture(lambda *b: _loss(mx, model, ce, *b))
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    losses = _run(cap, _port_loader(rec), 0, STEPS, mgr, trainer, model)
    assert cap.last_fallback_reason is None
    mgr.wait()
    final = _state(model, trainer)
    reg = mx.observability.registry()
    before = reg.counter("cachedop_cache_misses",
                         reason="state_change").value
    step, restored = mgr.restore_latest(_params_of(model))
    for k, p in model._collect_params_with_prefix().items():
        p.set_data(restored["params"][k])
    trainer.load_states_bytes(mgr.read_extra(step, "trainer"))
    resumed = _run(cap, _port_loader(rec, RESUME_AT), RESUME_AT, STEPS)
    assert reg.counter("cachedop_cache_misses",
                       reason="state_change").value == before + 1
    assert cap.last_fallback_reason is None
    assert resumed == losses[RESUME_AT:]
    _assert_same_state(_state(model, trainer), final)
