"""Serving a TransformerNMT after `cast("bfloat16")` on the CPU, port
against the JAX package: `tests/test_torch_serve.py`'s model (vocab 50,
units 32, 2 layers, 4 heads) cast to bf16 in the JAX package and carried
across by `convert.from_jax_weights`, which keeps bf16. In both packages
the serving snapshots hold the bf16 weights, the positional table stays
fp32 (`cast` leaves it), so the embedded tokens, every activation and
the KV pages are fp32 (the JAX runtime takes the position table's dtype,
`mxnet_tpu/serve/decode.py:157`), and each product promotes an fp32
activation and a bf16 weight to fp32 (`jnp.matmul`'s rule). The
embedded rows times the embedding scale are formed in fp32 as the JAX
runtime's compiled programs form them (the scale, a Python float,
rounded to bf16). A bf16 weight widens to fp32 exactly, so the two
packages compute the fp32 test's function: prefill and decode logits
agree at that test's TOL, and whole `Server` runs give the JAX
package's tokens, at k = 0 and with `speculative_k=3` on int8 KV
pages."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serve.decode import DecodeRuntime as JaxRuntime
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.convert import from_jax_weights
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops.kernels import LAUNCHES
from mxnet_tpu_torch.serve.decode import DecodeRuntime as TorchRuntime
import test_torch_serve as fp32serve

TOL = fp32serve.TOL
models = fp32serve.models


@pytest.fixture(scope="module")
def cast_models(models):
    """(JAX model cast to bf16, its numpy snapshots, the port model built
    from them on the CPU)."""
    m = models[0]
    m.cast("bfloat16")
    ew = jax.tree.map(np.asarray, jt.encoder_weights(m))
    dw = jax.tree.map(np.asarray, jt.decoder_weights(m))
    assert np.asarray(dw["embed"]).dtype.name == "bfloat16"
    assert np.asarray(dw["pos"]).dtype == np.float32
    return m, ew, dw, from_jax_weights(ew, dw, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_cast_snapshots_keep_bf16_weights_and_fp32_positions(cast_models):
    """The port's snapshots hold bf16 weights bit for bit and the fp32
    positional table, as the JAX package's."""
    _m, ew, dw, pm = cast_models
    for want, got in ((ew, tt.encoder_weights(pm)),
                      (dw, tt.decoder_weights(pm))):
        assert got["embed"].dtype == torch.bfloat16
        assert got["pos"].dtype == torch.float32
        np.testing.assert_array_equal(_np(got["embed"]), _np(want["embed"]))
        for lw, lg in zip(want["layers"], got["layers"]):
            for key in lw:
                for a, b in zip(lw[key], lg[key]):
                    if isinstance(b, torch.Tensor):
                        assert b.dtype == torch.bfloat16, key
                        np.testing.assert_array_equal(_np(b), _np(a))


def test_cast_prefill_parity(cast_models):
    """`encode_memory` (the flash attention over fp32 activations with
    source lengths) and the cross-attention K/V projection: fp32 in both
    packages, within the fp32 test's TOL."""
    m, _ew, _dw, pm = cast_models
    rng = np.random.RandomState(3)
    src = np.zeros((2, 16), np.int32)
    src[0, :9] = rng.randint(4, 50, 9)
    src[1, :] = rng.randint(4, 50, 16)
    vl = np.array([9, 16], np.int32)
    # compiled over the snapshots as the JAX runtime holds them (its
    # prefill program closes over them): the embedding scale a Python
    # float, and the product of the bf16 rows with it formed in fp32
    jew, jdw = jt.encoder_weights(m), jt.decoder_weights(m)
    assert isinstance(jew["scale"], float)
    want = jax.jit(lambda s, v: jt.encode_memory(jew, s, v))(
        jax.numpy.asarray(src), jax.numpy.asarray(vl))
    got = tt.encode_memory(tt.encoder_weights(pm), torch.from_numpy(src)
                           .long(), torch.from_numpy(vl))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    kv_want = jt.precompute_memory_kv(jdw, want)
    kv_got = tt.precompute_memory_kv(tt.decoder_weights(pm), got)
    for (kw, vw), (kg, vg) in zip(kv_want, kv_got):
        assert kg.dtype == vg.dtype == torch.float32
        np.testing.assert_allclose(_np(kg), _np(kw), **TOL)
        np.testing.assert_allclose(_np(vg), _np(vw), **TOL)


def test_cast_decode_steps_logits_parity(cast_models):
    """Both DecodeRuntimes on the cast snapshots: fp32 pages in both, and
    at each step the active slots' fp32 logits agree within TOL and pick
    the same token; slot 1 turns active mid-way."""
    m, _ew, _dw, pm = cast_models
    kw = dict(slots=2, num_pages=9, page_size=4, max_pages_per_slot=4,
              max_src_len=12)
    jrt = JaxRuntime(jt.decoder_weights(m), jt.encoder_weights(m), **kw)
    trt = TorchRuntime(tt.decoder_weights(pm), tt.encoder_weights(pm), **kw)
    assert trt.k_pages.dtype == torch.float32
    assert np.dtype(jrt.k_pages.dtype) == np.float32
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
        assert lt.dtype == torch.float32
        on = active > 0
        np.testing.assert_allclose(_np(lt)[on], _np(lj)[on], **TOL)
        assert np.array_equal(nt[on], np.asarray(nj)[on]), f"step {step}"
        tok = np.where(on, nt, tok).astype(np.int32)
        lens = lens + on.astype(np.int32)


@pytest.mark.parametrize("extra", [{}, dict(speculative_k=3,
                                            kv_dtype="int8")],
                         ids=["k0", "spec3_int8"])
def test_cast_server_tokens_match_jax(cast_models, extra):
    """Whole `Server` runs on the cast model, three mixed-length requests
    on 2 slots (one prompted, so the prompt chunks run too): the port's
    greedy tokens equal the JAX server's with the same settings, at k =
    0 and with `speculative_k=3` on int8 KV pages; the pages are fp32
    (int8 with scales there), the pool drains, no kernel launches on the
    CPU."""
    m, _ew, _dw, pm = cast_models
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(4, 50, 6), 10, None),
            (rng.randint(4, 50, 5), 6, rng.randint(4, 50, 6)),
            (rng.randint(4, 50, 7), 3, None)]
    kw = dict(fp32serve.SERVER_KW, max_prompt_len=8, **extra)
    js = mxj.serve.Server(m, **kw)
    ts = tserve.Server(pm, device="cpu", **kw)
    try:
        want, _ = fp32serve._run(js, reqs)
        got, _ = fp32serve._run(ts, reqs)
        assert got == want, (got, want)
        assert len({t for toks in got for t in toks}) > 1
        page = torch.int8 if extra else torch.float32
        assert ts.runtime.k_pages.dtype == page
        if not extra:
            assert np.dtype(js.runtime.k_pages.dtype) == np.float32
        assert ts.pool.in_use() == ts.prefix_cache.pages_held()
        assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)
    finally:
        js.close()
        ts.close()
    assert ts.pool.in_use() == 0
