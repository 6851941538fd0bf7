"""The port's serving path on the CPU against the JAX package's: a tiny
TransformerNMT built by `mxnet_tpu` (vocab 50, units 32, 2 layers, 4
heads, as tests/test_serve.py builds it) is carried across with
`convert.from_jax_weights`, then prefill, one decode step and whole
`Server` runs go through both packages on the same inputs."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serve import PagePool as JaxPagePool
from mxnet_tpu.serve.decode import DecodeRuntime as JaxRuntime
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_weights
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops.kernels import LAUNCHES
from mxnet_tpu_torch.serve.decode import DecodeRuntime as TorchRuntime

TOL = dict(rtol=1e-5, atol=1e-5)
SERVER_KW = dict(slots=2, page_size=4, max_src_len=16, max_new_tokens=12,
                 engine_driven=False)


@pytest.fixture(scope="module")
def models():
    """(jax model, numpy encoder snapshot, numpy decoder snapshot, port
    model on the CPU). Weights are redrawn from a numpy seed at scales
    (small tied embedding, large layer weights) where greedy decoding
    does not just repeat one token."""
    mxj.random.seed(11)
    m = jt.TransformerNMT(50, units=32, hidden=64, num_layers=2,
                          num_heads=4, max_length=32, dropout=0.0)
    m.initialize()
    rng = np.random.RandomState(0)
    for name, p in sorted(m.collect_params().items()):
        shp = p.shape
        if name.endswith("gamma"):
            val = np.ones(shp)
        elif name.endswith(("beta", "bias")):
            val = np.zeros(shp)
        elif "embed" in name:
            val = rng.randn(*shp) * 0.05
        else:
            val = rng.randn(*shp) * (4.0 / np.sqrt(shp[-1]))
        p.set_data(mxj.nd.array(val.astype(np.float32)))
    ew = jax.tree.map(np.asarray, jt.encoder_weights(m))
    dw = jax.tree.map(np.asarray, jt.decoder_weights(m))
    return m, ew, dw, from_jax_weights(ew, dw, device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_weights_carried_across(models):
    _m, ew, dw, pm = models
    for want, got in ((ew, tt.encoder_weights(pm)),
                      (dw, tt.decoder_weights(pm))):
        assert got["num_heads"] == want["num_heads"]
        assert got["scale"] == pytest.approx(want["scale"])
        np.testing.assert_array_equal(_np(got["embed"]), want["embed"])
        np.testing.assert_array_equal(_np(got["pos"]), want["pos"])
        for lw, lg in zip(want["layers"], got["layers"]):
            assert lw.keys() == lg.keys()
            for key in lw:
                for a, b in zip(lw[key], lg[key]):
                    np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_prefill_parity(models):
    """encode_memory (flash attention with source lengths) and the
    cross-attention K/V projection agree at rtol=atol=1e-5."""
    _m, ew, dw, pm = models
    rng = np.random.RandomState(3)
    src = np.zeros((2, 16), np.int32)
    src[0, :9] = rng.randint(4, 50, 9)
    src[1, :] = rng.randint(4, 50, 16)
    vl = np.array([9, 16], np.int32)
    jew = jax.tree.map(jax.numpy.asarray, ew)
    jdw = jax.tree.map(jax.numpy.asarray, dw)
    want = jt.encode_memory(jew, jax.numpy.asarray(src),
                            jax.numpy.asarray(vl))
    got = tt.encode_memory(tt.encoder_weights(pm), torch.from_numpy(src)
                           .long(), torch.from_numpy(vl))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    kv_want = jt.precompute_memory_kv(jdw, want)
    kv_got = tt.precompute_memory_kv(tt.decoder_weights(pm), got)
    for (kw, vw), (kg, vg) in zip(kv_want, kv_got):
        np.testing.assert_allclose(_np(kg), np.asarray(kw), **TOL)
        np.testing.assert_allclose(_np(vg), np.asarray(vw), **TOL)


def test_decode_steps_logits_parity(models):
    """Both DecodeRuntimes, the same page tables, lens and tokens: the
    active slots' logits agree at each step and pick the same token.
    Slot 1 turns active mid-way; its table stays null-padded."""
    m, _ew, _dw, pm = models
    kw = dict(slots=2, num_pages=9, page_size=4, max_pages_per_slot=4,
              max_src_len=12)
    jrt = JaxRuntime(jt.decoder_weights(m), jt.encoder_weights(m), **kw)
    trt = TorchRuntime(tt.decoder_weights(pm), tt.encoder_weights(pm), **kw)
    rng = np.random.RandomState(4)
    srcs = [rng.randint(4, 50, 9), rng.randint(4, 50, 5)]
    for rt in (jrt, trt):
        rt.prefill(0, srcs[0])
    pt = np.zeros((2, 4), np.int32)
    pt[0] = [1, 2, 3, 4]
    pt[1, 0] = 5
    lens = np.zeros(2, np.int32)
    tok = np.array([2, 2], np.int32)
    active = np.array([1, 0], np.int32)
    for step in range(7):
        if step == 3:
            for rt in (jrt, trt):
                rt.prefill(1, srcs[1])
            active[1] = 1
        nj, lj = jrt.decode(pt, lens, tok, active)
        nt, lt = trt.decode(pt, lens, tok, active)
        on = active > 0
        np.testing.assert_allclose(_np(lt)[on], np.asarray(lj)[on], **TOL)
        assert np.array_equal(nt[on], np.asarray(nj)[on]), f"step {step}"
        tok = np.where(on, nt, tok).astype(np.int32)
        lens = lens + on.astype(np.int32)


def _run(server, requests):
    handles = [server.submit(src, max_new_tokens=n, prompt_tokens=prompt)
               for src, n, prompt in requests]
    return [h.result() for h in handles], handles


def test_server_greedy_tokens_match_jax(models):
    """Three mixed-length requests on 2 slots (the third backfills a
    freed slot): identical greedy tokens; the pool drains."""
    m, _ew, _dw, pm = models
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(4, 50, 6), 10, None),
            (rng.randint(4, 50, 5), 2, None),
            (rng.randint(4, 50, 7), 3, None)]
    js = mxj.serve.Server(m, **SERVER_KW)
    ts = tserve.Server(pm, device="cpu", **SERVER_KW)
    try:
        want, _ = _run(js, reqs)
        got, _ = _run(ts, reqs)
        assert got == want, (got, want)
        assert len({t for toks in got for t in toks}) > 1
        assert ts.pool.in_use() == 0
        assert ts.scheduler.decode_turns > 0
        assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)
    finally:
        js.close()
        ts.close()


def test_prefix_cache_repeat(models):
    """A repeat of the same (src, prompt_tokens) adopts the cached
    prompt pages and returns identical tokens — identical to the JAX
    server's too."""
    m, _ew, _dw, pm = models
    rng = np.random.RandomState(2)
    src = rng.randint(4, 50, 8)
    prompt = rng.randint(4, 50, 8).tolist()
    kw = dict(SERVER_KW, max_prompt_len=8, max_new_tokens=6)
    js = mxj.serve.Server(m, **kw)
    ts = tserve.Server(pm, device="cpu", **kw)
    try:
        want, _ = _run(js, [(src, 6, prompt)] * 2)
        first, _ = _run(ts, [(src, 6, prompt)])
        again, (h,) = _run(ts, [(src, 6, prompt)])
        assert h.prompt_cached_tokens > 0
        assert first == again == want[:1]
        assert want[0] == want[1]
        held = ts.prefix_cache.pages_held()
        assert ts.pool.in_use() == held == ts.pool.total_refs()
    finally:
        js.close()
        ts.close()
    assert ts.pool.in_use() == 0


def _pool_alloc_free(P):
    pool = P(num_pages=8, page_size=4)
    out = [pool.capacity, pool.available()]
    a = pool.alloc(3)
    out += [a, pool.in_use(), pool.available()]
    b = pool.alloc(4)
    out += [b, pool.available()]
    pool.free(a)
    out += [pool.in_use(), pool.available()]
    pool.free(b)
    out += [pool.in_use(), pool.available()]
    return out + [pool.pages_for(n) for n in (0, 1, 4, 5)]


def _pool_exhaustion(P):
    pool = P(num_pages=4, page_size=2)
    pool.alloc(2)
    try:
        pool.alloc(2)           # only 1 free: all-or-nothing
        raised = False
    except Exception as e:      # each package's own PageAllocError
        raised = type(e).__name__
    return [raised, pool.available()]


def _pool_free_errors(P):
    pool = P(num_pages=4, page_size=2)
    pages = pool.alloc(1)
    pool.free(pages)
    out = []
    for bad in (pages, [0]):    # double free, the reserved null page
        try:
            pool.free(bad)
            out.append(None)
        except Exception as e:
            out.append(type(e).__name__)
    return out + [pool.available()]


def _pool_defrag(P):
    pool = P(num_pages=8, page_size=2)
    a = pool.alloc(5)
    pool.free([a[0], a[2]])
    mapping = pool.defrag()
    return [sorted(mapping.items()), pool.in_use(), pool.available(),
            pool.alloc(2)]


@pytest.mark.parametrize("case", [_pool_alloc_free, _pool_exhaustion,
                                  _pool_free_errors, _pool_defrag],
                         ids=["alloc_free", "exhaustion", "free_errors",
                              "defrag"])
def test_page_pool_host_copy(case):
    """The host-side PagePool copy behaves exactly like the JAX
    package's (tests/test_serve.py's allocation cases)."""
    assert case(tserve.PagePool) == case(JaxPagePool)


def test_remap_pages_moves_pool_rows(models):
    """A defrag mapping permutes the device pools in place."""
    _m, _ew, _dw, pm = models
    rt = TorchRuntime(tt.decoder_weights(pm), tt.encoder_weights(pm),
                      slots=1, num_pages=5, page_size=4,
                      max_pages_per_slot=2, max_src_len=8)
    ids = torch.arange(5, dtype=torch.float32)[None, :, None, None, None]
    rt.k_pages += ids
    rt.v_pages += 2 * ids
    k_before = rt.k_pages
    rt.remap_pages({3: 1, 4: 2})
    assert rt.k_pages is k_before              # same buffer, updated
    assert rt.k_pages[0, :, 0, 0, 0].tolist() == [0, 3, 4, 3, 4]
    assert rt.v_pages[0, :, 0, 0, 0].tolist() == [0, 6, 8, 6, 8]


@pytest.mark.parametrize("setting", [{"engine_driven": True}],
                         ids=["engine_driven"])
def test_unported_settings_raise(models, setting):
    """The setting that waited for the dependency engine (ROADMAP.md
    Queue 1 [9]) is ported: `engine_driven=True` runs the decode loop on
    the engine and serves the inline server's tokens. A setting the
    server cannot take still raises MXNetError instead of falling
    back."""
    kw = dict(SERVER_KW, **setting)
    with tserve.Server(models[3], device="cpu", **kw) as srv:
        assert srv._loop is not None
        got = srv.submit([5, 9, 11, 7]).result(timeout=60)
    with tserve.Server(models[3], device="cpu", **SERVER_KW) as srv:
        assert srv._loop is None
        assert srv.submit([5, 9, 11, 7]).result(timeout=60) == got
    with pytest.raises(MXNetError, match="weight_dtype"):
        tserve.Server(models[3], device="cpu", weight_dtype="bfloat16",
                      **kw)
