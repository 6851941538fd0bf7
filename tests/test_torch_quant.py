"""The serving fast path's pieces below the server, port against the
JAX package on the CPU, on the same seeded numpy inputs: the per-channel
int8 quantizer and the int8 weight snapshots, the plain versions of the
int8 and widened paged-attention kernels (against the JAX lax gathers
and the Pallas kernels run in interpret mode), the running-max int8 page
write, and both `DecodeRuntime`s stepping one snapshot, int8 or fp32,
1-wide or widened.

The CUDA kernels themselves run only on the card; `chip_smoke.py` holds
them against these plain versions there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.contrib.quantization import quantize_channelwise as jq_cw
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.ops import pallas_kernels as jk
from mxnet_tpu.serve import quant as jquant
from mxnet_tpu.serve.decode import DecodeRuntime as JaxRuntime
from mxnet_tpu.serve.decode import _quant_page_write as jax_page_write
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_channelwise
from mxnet_tpu_torch.convert import from_jax_snapshot, from_jax_weights
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import kernels as tk
from mxnet_tpu_torch.serve import quant as tquant
from mxnet_tpu_torch.serve.decode import DecodeRuntime as TorchRuntime
from mxnet_tpu_torch.serve.decode import _quant_page_write

# tests/test_serve.py's paged-kernel-vs-lax tolerance
RPA_TOL = dict(rtol=2e-6, atol=2e-6)
# tests/test_torch_serve.py's runtime logits tolerance
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def int8_model():
    """tests/test_serve.py's `_int8_model()` (vocab 40, units 16, 1
    layer, 2 heads) and its port twin on the CPU."""
    mxj.random.seed(13)
    m = jt.TransformerNMT(40, units=16, hidden=32, num_layers=1,
                          num_heads=2, max_length=48, dropout=0.0)
    m.initialize()
    ew = jax.tree.map(np.asarray, jt.encoder_weights(m))
    dw = jax.tree.map(np.asarray, jt.decoder_weights(m))
    return m, ew, dw, from_jax_weights(ew, dw, device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------- quant
@pytest.mark.parametrize("shape,axis", [((7, 5), 0), ((7, 5), 1),
                                        ((3, 4, 6), 1), ((3, 4, 6), -1)],
                         ids=["out", "in", "3d-mid", "3d-last"])
def test_quantize_channelwise_matches_jax(shape, axis):
    """Port == JAX: int8 codes exactly, scales within 1 ulp; a channel
    of zeros quantizes to 0 with the minimum scale."""
    rng = np.random.RandomState(0)
    w = (rng.randn(*shape) * rng.choice([0.01, 1.0, 30.0], shape)) \
        .astype(np.float32)
    zero = [slice(None)] * len(shape)
    zero[axis] = 0
    w[tuple(zero)] = 0.0
    qj, sj = jq_cw(jnp.asarray(w), axis=axis)
    qt, st = quantize_channelwise(torch.from_numpy(w), axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_max_ulp(st.numpy(), np.asarray(sj), maxulp=1)
    assert np.all(qt.numpy()[tuple(zero)] == 0)
    assert st[0].item() == pytest.approx(1e-12 / 127.0)


@pytest.mark.parametrize("which", ["decoder", "encoder"])
def test_int8_weight_snapshot_matches_jax(int8_model, which):
    """`quantize_decoder_weights` / `quantize_encoder_weights`: the dense
    leaves become (w_int8, b, scale), the embedding int8 rows with
    `embed_scale`, LayerNorms and the rest unchanged — equal to the JAX
    snapshot (int8 exactly, scales within 1 ulp); the input snapshot is
    not modified."""
    m, _ew, _dw, pm = int8_model
    jfn, tfn = (jt.decoder_weights, tt.decoder_weights) \
        if which == "decoder" else (jt.encoder_weights, tt.encoder_weights)
    qfn = "quantize_decoder_weights" if which == "decoder" \
        else "quantize_encoder_weights"
    want = jax.tree.map(np.asarray, getattr(jquant, qfn)(jfn(m)))
    master = tfn(pm)
    embed0 = master["embed"].clone()
    got = getattr(tquant, qfn)(master)
    assert got["embed"].dtype == torch.int8
    np.testing.assert_array_equal(_np(got["embed"]), want["embed"])
    np.testing.assert_array_max_ulp(_np(got["embed_scale"]),
                                    want["embed_scale"], maxulp=1)
    assert torch.equal(master["embed"], embed0)
    assert master["embed"].dtype == torch.float32
    for lw, lg in zip(want["layers"], got["layers"]):
        assert lw.keys() == lg.keys()
        for key in lw:
            assert len(lw[key]) == len(lg[key]) == 3
            if not key.startswith("ln"):    # (w_int8, b, scale)
                wq, b, s = lg[key]
                assert wq.dtype == torch.int8
                assert s.shape == (wq.shape[0],)
                np.testing.assert_array_equal(_np(wq), lw[key][0])
                np.testing.assert_array_equal(_np(b), lw[key][1])
                np.testing.assert_array_max_ulp(_np(s), lw[key][2],
                                                maxulp=1)
            else:                           # LayerNorm (gamma, beta, eps)
                np.testing.assert_array_equal(_np(lg[key][0]), lw[key][0])
                np.testing.assert_array_equal(_np(lg[key][1]), lw[key][1])
                assert lg[key][2] == pytest.approx(lw[key][2])


def test_kv_byte_accounting_matches_jax():
    """Page bytes, pool size and token capacity for a byte budget agree
    with the JAX package's, and int8 pages hold >= 1.9x the fp32 tokens
    (tests/test_serve.py's capacity pin)."""
    geo = dict(n_layers=6, page_size=16, num_heads=8, head_dim=64)
    budget = 32 * jquant.kv_page_bytes(kv_dtype="float32", **geo) + 123
    for dt in ("float32", "int8"):
        assert tquant.kv_page_bytes(kv_dtype=dt, **geo) \
            == jquant.kv_page_bytes(kv_dtype=dt, **geo)
        assert tquant.token_capacity(budget, kv_dtype=dt, **geo) \
            == jquant.token_capacity(budget, kv_dtype=dt, **geo)
    ratio = tquant.token_capacity(budget, kv_dtype="int8", **geo) \
        / tquant.token_capacity(budget, kv_dtype="float32", **geo)
    assert ratio >= 1.9
    assert tquant.kv_page_bytes(kv_dtype="float32", **geo) == 393216
    assert tquant.kv_page_bytes(kv_dtype="int8", **geo) == 98688


# ----------------------------------------------------- paged attention
def _paged_inputs(seed, psize, wide, quant, S=3, H=2, dh=8, P=9, W=4):
    """tests/test_serve.py's paged fixtures: a null-page-padded table and
    mixed lengths; int8 pages with scales as at test_serve.py:1366."""
    rng = np.random.RandomState(seed)
    if quant:
        kp, vp = (rng.randint(-127, 128, (P, psize, H, dh)).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((rng.rand(P, H) * 0.05 + 1e-3).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (rng.randn(P, psize, H, dh).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    q = rng.randn(*((S, W, H, dh) if wide else (S, H, dh))) \
        .astype(np.float32)
    pt = np.array([[1, 2], [3, 0], [4, 5]], np.int32)
    lens = np.array([12, 5, 16] if psize == 8 else [24, 10, 32], np.int32)
    return q, kp, vp, pt, lens, ks, vs


def _port_rpa(q, kp, vp, pt, lens, ks, vs):
    t = (None if a is None else torch.from_numpy(a)
         for a in (q, kp, vp, pt, lens, ks, vs))
    q, kp, vp, pt, lens, ks, vs = t
    return tk.ragged_paged_attention(q, kp, vp, pt, lens, k_scales=ks,
                                     v_scales=vs).numpy()


@pytest.mark.parametrize("psize", [8, 16])
@pytest.mark.parametrize("wide,quant", [(False, True), (True, False),
                                        (True, True)],
                         ids=["int8", "widened", "widened-int8"])
def test_rpa_forms_match_jax(interpret, psize, wide, quant):
    """Port plain version == the JAX lax gather AND the JAX Pallas
    kernel (interpret mode) for the int8 1-wide, fp32 widened and int8
    widened forms; rows of a slot past its page budget included (the
    length-16 / 32 slot with W = 4)."""
    args = _paged_inputs(22, psize, wide, quant)
    q, kp, vp, pt, lens, ks, vs = (None if a is None else jnp.asarray(a)
                                   for a in args)
    assert jk._rpa_pallas_ok(psize)      # the JAX side takes the kernel
    want_kernel = jk.ragged_paged_attention(q, kp, vp, pt, lens,
                                            k_scales=ks, v_scales=vs)
    lax = jk._paged_attention_lax_multi if wide else jk._paged_attention_lax
    want_lax = lax(q, kp, vp, pt, lens, k_scales=ks, v_scales=vs)
    got = _port_rpa(*args)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **RPA_TOL)
    np.testing.assert_allclose(got, np.asarray(want_lax), **RPA_TOL)


@pytest.mark.parametrize("psize", [8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_rpa_window_of_9_matches_jax(interpret, psize, quant):
    """A window of 9 rows (speculative_k = 8), wider than the JAX
    kernel's 8-row sublane tile, which pads it to 16: the port == the
    JAX Pallas kernel (interpret mode) and its lax gather, rows past the
    page budget included."""
    args = _paged_inputs(26, psize, True, quant, W=9)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    q, kp, vp, pt, lens, ks, vs = jargs
    assert jk._rpa_sublanes(9) == 16
    want_kernel = jk.ragged_paged_attention(q, kp, vp, pt, lens,
                                            k_scales=ks, v_scales=vs)
    want_lax = jk._paged_attention_lax_multi(q, kp, vp, pt, lens,
                                             k_scales=ks, v_scales=vs)
    got = _port_rpa(*args)
    assert got.shape == (3, 9, 2, 8)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **RPA_TOL)
    np.testing.assert_allclose(got, np.asarray(want_lax), **RPA_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_rpa_widened_rows_are_the_1wide_form(quant):
    """Row i of the widened form == the 1-wide form at lengths + i."""
    q, kp, vp, pt, lens, ks, vs = _paged_inputs(23, 8, True, quant)
    out = _port_rpa(q, kp, vp, pt, lens, ks, vs)
    for i in range(q.shape[1]):
        ref = _port_rpa(np.ascontiguousarray(q[:, i]), kp, vp, pt,
                        lens + i, ks, vs)
        np.testing.assert_allclose(out[:, i], ref, **RPA_TOL,
                                   err_msg=f"row {i}")


def test_rpa_int8_zero_length_row_is_zeros():
    """A row with no visible key writes zeros in the int8 and widened
    plain versions too (the kernels' convention)."""
    q, kp, vp, pt, _lens, ks, vs = _paged_inputs(24, 8, True, True)
    out = _port_rpa(q, kp, vp, pt, np.array([0, 5, 16], np.int32), ks, vs)
    assert np.array_equal(out[0, 0], np.zeros_like(out[0, 0]))
    assert np.abs(out[0, 1]).sum() > 0       # row 1 sees one key
    one = _port_rpa(np.ascontiguousarray(q[:, 0]), kp, vp, pt,
                    np.array([0, 5, 16], np.int32), ks, vs)
    assert np.array_equal(one[0], np.zeros_like(one[0]))


def test_rpa_fast_path_wrappers_check_layout():
    """What the kernels refuse is refused on the CPU too: scales of one
    side only, int8 pages without scales, wrong scale shapes, a
    non-contiguous widened q and an empty window. A window of any width
    computes (W = 9: row i is the 1-wide form at lengths + i)."""
    q, kp, vp, pt, lens, ks, vs = (None if a is None else torch.from_numpy(a)
                                   for a in _paged_inputs(25, 8, True, True))
    with pytest.raises(MXNetError, match="together"):
        tk.ragged_paged_attention(q, kp, vp, pt, lens, k_scales=ks)
    with pytest.raises(MXNetError, match="int8 pages"):
        tk.ragged_paged_attention(q, kp, vp, pt, lens)
    with pytest.raises(MXNetError, match="k_scales"):
        tk.ragged_paged_attention(q, kp, vp, pt, lens, k_scales=ks.T,
                                  v_scales=vs)
    qkv = torch.cat([q, q, q], dim=-1)
    with pytest.raises(MXNetError, match="contiguous q"):
        tk.ragged_paged_attention(qkv[..., :8], kp, vp, pt, lens,
                                  k_scales=ks, v_scales=vs)
    wide = torch.from_numpy(np.random.RandomState(25).randn(3, 9, 2, 8)
                            .astype(np.float32))
    out = tk.ragged_paged_attention(wide, kp, vp, pt, lens, k_scales=ks,
                                    v_scales=vs)
    assert out.shape == wide.shape and torch.isfinite(out).all()
    torch.testing.assert_close(
        out[:, 8], tk.ragged_paged_attention(wide[:, 8].contiguous(), kp, vp,
                                             pt, lens + 8, k_scales=ks,
                                             v_scales=vs), **RPA_TOL)
    with pytest.raises(MXNetError, match="W >= 1"):
        tk.ragged_paged_attention(wide[:, :0], kp, vp, pt, lens, k_scales=ks,
                                  v_scales=vs)
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)


# ------------------------------------------------------ int8 page write
def _write_cases():
    """(page, off) sequences: fresh pages, a growing scale on the same
    pages, a widened window with duplicate pages that also restarts a
    used page at offset 0, and an inactive row on the null page."""
    return [(np.array([1, 2]), np.array([0, 0]), 1.0),
            (np.array([1, 2]), np.array([1, 1]), 3.0),
            (np.array([[1, 1, 3], [2, 2, 2]]), np.array([[2, 3, 0],
                                                         [0, 1, 2]]), 0.5),
            (np.array([[3, 3, 0], [4, 0, 0]]), np.array([[1, 2, 3],
                                                         [0, 1, 2]]), 5.0)]


@pytest.mark.parametrize("start", ["zeros", "random"])
def test_quant_page_write_matches_jax(start):
    """The in-place page write == the JAX package's functional one, step
    after step: pages exactly, scales at 1e-7."""
    rng = np.random.RandomState(26)
    L, P, psize, H, dh, li = 2, 6, 4, 2, 8, 1
    if start == "zeros":
        pages = np.zeros((L, P, psize, H, dh), np.int8)
        scales = np.zeros((L, P, H), np.float32)
    else:
        pages = rng.randint(-127, 128, (L, P, psize, H, dh)).astype(np.int8)
        scales = (rng.rand(L, P, H) * 0.02 + 1e-3).astype(np.float32)
    jp, js = jnp.asarray(pages), jnp.asarray(scales)
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    for page, off, mag in _write_cases():
        vals = (rng.randn(*page.shape, H, dh) * mag).astype(np.float32)
        jp, js = jax_page_write(jp, js, li, jnp.asarray(page, jnp.int32),
                                jnp.asarray(off, jnp.int32),
                                jnp.asarray(vals))
        _quant_page_write(tp, ts, li, torch.from_numpy(page).long(),
                          torch.from_numpy(off).long(),
                          torch.from_numpy(vals))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                                   atol=1e-12)
    assert np.abs(tp.numpy()[li, 1:]).sum() > 0
    # the other layer is never touched
    np.testing.assert_array_equal(tp.numpy()[0], pages[0])


# ------------------------------------------------------- runtime parity
@pytest.mark.parametrize("width,kv_dtype,weights", [
    (1, "int8", "fp32"), (3, None, "fp32"), (3, "int8", "fp32"),
    (4, "int8", "int8")], ids=["1wide-int8kv", "widened", "widened-int8kv",
                               "widened-int8kv-int8w"])
def test_runtime_steps_match_jax(int8_model, width, kv_dtype, weights):
    """Both DecodeRuntimes on one snapshot (`from_jax_snapshot` carries
    the JAX one across, int8 weights included), the same tables, lens,
    tokens and window lengths over a few turns: the active slots' logits
    within TOL and identical argmax. Slot 1 turns active mid-way, and
    its windows are ragged."""
    m = int8_model[0]
    jdw, jew = jt.decoder_weights(m), jt.encoder_weights(m)
    if weights == "int8":
        jdw = jquant.quantize_decoder_weights(jdw)
        jew = jquant.quantize_encoder_weights(jew)
    kw = dict(slots=2, num_pages=9, page_size=4, max_pages_per_slot=4,
              max_src_len=12, width=width, kv_dtype=kv_dtype)
    jrt = JaxRuntime(jdw, jew, **kw)
    trt = TorchRuntime(
        from_jax_snapshot(jax.tree.map(np.asarray, jdw), device="cpu"),
        from_jax_snapshot(jax.tree.map(np.asarray, jew), device="cpu"), **kw)
    rng = np.random.RandomState(27)
    srcs = [rng.randint(4, 40, 9), rng.randint(4, 40, 5)]
    for rt in (jrt, trt):
        rt.prefill(0, srcs[0])
    pt = np.zeros((2, 4), np.int32)
    pt[0] = [1, 2, 3, 4]
    pt[1, :2] = [5, 6]
    lens = np.zeros(2, np.int32)
    toks = rng.randint(4, 40, (2, width)).astype(np.int32)
    active = np.array([1, 0], np.int32)
    for turn in range(5):
        if turn == 2:
            for rt in (jrt, trt):
                rt.prefill(1, srcs[1])
            active[1] = 1
        if width == 1:
            nj, lj = jrt.decode(pt, lens, toks[:, 0], active)
            nt, lt = trt.decode(pt, lens, toks[:, 0], active)
            nj, lj, nt, lt = (a[:, None] for a in (np.asarray(nj),
                                                   np.asarray(lj), nt,
                                                   _np(lt)))
            qlens = np.ones(2, np.int32)
        else:
            qlens = np.array([width, 1 + turn % width], np.int32)
            nj, lj = jrt.decode_multi(pt, lens, toks, qlens, active)
            nt, lt = trt.decode_multi(pt, lens, toks, qlens, active)
            lj, lt = np.asarray(lj), _np(lt)
        for s in np.flatnonzero(active):
            q = qlens[s]
            np.testing.assert_allclose(lt[s, :q], lj[s, :q], **TOL,
                                       err_msg=f"turn {turn} slot {s}")
            assert np.array_equal(np.asarray(nt)[s, :q],
                                  np.asarray(nj)[s, :q]), f"turn {turn}"
        lens = lens + active * qlens
        toks = rng.randint(4, 40, (2, width)).astype(np.int32)
    if kv_dtype == "int8":
        # the same pages and scales on both sides after the turns
        np.testing.assert_array_equal(trt.k_pages.numpy(),
                                      np.asarray(jrt.k_pages))
        np.testing.assert_allclose(trt.v_scales.numpy(),
                                   np.asarray(jrt.v_scales), rtol=1e-6)
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)


def test_remap_pages_moves_int8_scales(int8_model):
    """A defrag mapping permutes the int8 pools and their scale arrays
    in place: scales travel with their page ids."""
    pm = int8_model[3]
    rt = TorchRuntime(tt.decoder_weights(pm), tt.encoder_weights(pm),
                      slots=1, num_pages=5, page_size=4,
                      max_pages_per_slot=2, max_src_len=8, kv_dtype="int8")
    assert rt.k_pages.dtype == torch.int8 and rt.k_scales.shape == (1, 5, 2)
    ids = torch.arange(5, dtype=torch.float32)[None, :, None]
    rt.k_scales += ids
    rt.v_pages += torch.arange(5, dtype=torch.int8)[None, :, None, None,
                                                    None]
    before = rt.k_scales
    rt.remap_pages({3: 1, 4: 2})
    assert rt.k_scales is before
    assert rt.k_scales[0, :, 0].tolist() == [0, 3, 4, 3, 4]
    assert rt.v_pages[0, :, 0, 0, 0].tolist() == [0, 3, 4, 3, 4]
    assert rt.kv_bytes_per_page() == tquant.kv_page_bytes(
        1, 4, 2, 8, "int8")
