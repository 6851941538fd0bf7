"""The port's attention kernels (plain versions, CPU) against the JAX
package: the same seeded numpy inputs go through `mxnet_tpu`'s Pallas
kernels (interpret mode, which runs the kernel bodies on the CPU) or its
XLA references, and through `mxnet_tpu_torch`'s counterparts.

The CUDA kernels themselves run only on the card; `chip_smoke.py` holds
them against these plain versions there."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import pallas_kernels as jk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as tk

# kernel-vs-reference tolerance of tests/test_pallas.py
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
# tests/test_serve.py's paged-kernel-vs-lax tolerance
RPA_TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32))


def _port_flash(q, k, v, causal=False, lengths=None):
    vl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = tk.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             kv_lengths=vl)
    return out.numpy()


@pytest.mark.parametrize("s,lengths,causal", [
    (128, [77, 128], False),
    (128, [77, 128], True),
    (256, [77, 256], False),
    (256, None, True),
], ids=["s128-len", "s128-len-causal", "s256-len", "s256-causal"])
def test_flash_matches_jax_pallas_interpret(interpret, s, lengths, causal):
    """Port flash (plain path) == the JAX Pallas kernel body run in
    interpret mode, with and without key lengths, causal or not."""
    q, k, v = _qkv(0, 2, 2, s, s, 32)
    vl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    assert jk._pallas_ok(s)          # the JAX side really takes the kernel
    want = jk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, kv_lengths=vl)
    got = _port_flash(q, k, v, causal, lengths)
    np.testing.assert_allclose(got, np.asarray(want), **FLASH_TOL)


def test_flash_rectangular_matches_jax_pallas_interpret(interpret):
    """Cross-attention shape Sq != Sk, with key lengths."""
    q, k, v = _qkv(1, 2, 1, 128, 256, 32)
    want = jk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v),
                              kv_lengths=jnp.asarray([200, 31], jnp.int32))
    got = _port_flash(q, k, v, lengths=[200, 31])
    np.testing.assert_allclose(got, np.asarray(want), **FLASH_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ragged_matches_jax_reference(causal):
    """A ragged S (40) — the TPU sends it to `attention_reference`; the
    port's kernel takes every length, and its plain version must agree."""
    q, k, v = _qkv(2, 2, 2, 40, 40, 16)
    lengths = [17, 40]
    mask = (np.arange(40)[None, :] < np.array(lengths)[:, None])
    want = jk.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  mask=jnp.asarray(mask[:, None, None, :]))
    got = _port_flash(q, k, v, causal, lengths)
    np.testing.assert_allclose(got, np.asarray(want), **FLASH_TOL)


@pytest.mark.parametrize("sq,sk,lengths", [
    (128, 256, None), (128, 256, [200, 31]),
    (256, 128, None), (256, 128, [100, 128]),
], ids=["sq<sk", "sq<sk-len", "sq>sk", "sq>sk-len"])
def test_flash_causal_rectangular_matches_jax_pallas_interpret(
        interpret, sq, sk, lengths):
    """Causal with Sq != Sk, both ways, with and without key lengths: the
    top-left mask (kj <= qi in absolute indices) of the JAX Pallas kernel
    in interpret mode."""
    q, k, v = _qkv(6, 2, 2, sq, sk, 32)
    assert jk._pallas_ok(sq) and jk._pallas_ok(sk)
    vl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = jk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), True, kv_lengths=vl)
    got = _port_flash(q, k, v, True, lengths)
    np.testing.assert_allclose(got, np.asarray(want), **FLASH_TOL)


@pytest.mark.parametrize("sq,sk,lengths", [
    (23, 41, None), (23, 41, [30, 7]), (41, 23, None), (41, 23, [5, 23]),
], ids=["sq<sk", "sq<sk-len", "sq>sk", "sq>sk-len"])
def test_flash_causal_rectangular_matches_jax_reference(sq, sk, lengths):
    """Causal with ragged Sq != Sk (the TPU sends them to
    `attention_reference`): out and the lse agree with the reference's
    top-left mask."""
    q, k, v = _qkv(7, 2, 2, sq, sk, 16)
    mask = None
    if lengths is not None:
        mask = jnp.asarray((np.arange(sk)[None, :]
                            < np.array(lengths)[:, None])[:, None, None, :])
    want = jk.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, mask=mask)
    got = _port_flash(q, k, v, True, lengths)
    np.testing.assert_allclose(got, np.asarray(want), **FLASH_TOL)
    vl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    _, lse = tk.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                    causal=True, kv_lengths=vl)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    seen = np.tril(np.ones((sq, sk), bool))[None, None]
    if lengths is not None:
        seen = seen & (np.arange(sk) < np.array(lengths)[:, None])[:, None,
                                                                    None]
    s = np.where(seen, s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(4, sq),
                               **FLASH_TOL)


def test_flash_lse_is_row_logsumexp():
    """The forward's compact (B*H, Sq) lse is the log-sum-exp of the
    scaled, masked scores."""
    q, k, v = _qkv(3, 1, 2, 24, 24, 16)
    tq, tk_, tv = map(torch.from_numpy, (q, k, v))
    _, lse = tk.flash_attention_fwd(tq, tk_, tv, causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    s = np.where(np.tril(np.ones((24, 24), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert lse.shape == (2, 24)
    np.testing.assert_allclose(lse.numpy(), want.reshape(2, 24),
                               **FLASH_TOL)


def test_zero_length_row_is_zeros():
    """A row with no visible key writes zeros (the TPU kernel's `l`
    guard), in the flash plain version and in the paged plain version."""
    q, k, v = _qkv(4, 2, 1, 16, 16, 8)
    out = _port_flash(q, k, v, lengths=[0, 16])
    assert np.array_equal(out[0], np.zeros_like(out[0]))
    assert np.abs(out[1]).sum() > 0
    rng = np.random.RandomState(5)
    pages = torch.from_numpy(rng.randn(3, 4, 1, 8).astype(np.float32))
    got = tk.ragged_paged_attention(
        torch.from_numpy(rng.randn(2, 1, 8).astype(np.float32)), pages,
        pages, torch.tensor([[1], [2]], dtype=torch.int32),
        torch.tensor([0, 3], dtype=torch.int32))
    assert np.array_equal(got[0].numpy(), np.zeros((1, 8), np.float32))
    assert np.abs(got[1].numpy()).sum() > 0


def _paged_fixture(seed=0, S=3, H=2, dh=8, P=9, psize=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(S, H, dh).astype(np.float32),
            rng.randn(P, psize, H, dh).astype(np.float32),
            rng.randn(P, psize, H, dh).astype(np.float32),
            # slot 1 is padded with the null page 0
            np.array([[1, 2], [3, 0], [4, 5]], np.int32))


@pytest.mark.parametrize("psize,lens", [(8, [12, 5, 16]),
                                        (16, [24, 10, 32])],
                         ids=["psize8", "psize16"])
def test_rpa_matches_jax(interpret, psize, lens):
    """Port RPA (plain path) == the JAX Pallas kernel in interpret mode
    AND == the JAX lax gather, on test_serve.py's fixture: a
    null-page-padded table and mixed lengths."""
    q, kp, vp, pt = _paged_fixture(psize=psize)
    lens = np.array(lens, np.int32)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, pt, lens)]
    want_kernel = jk.ragged_paged_attention(*jargs)
    want_lax = jk._paged_attention_lax(*jargs)
    got = tk.ragged_paged_attention(*(torch.from_numpy(a) for a in
                                      (q, kp, vp, pt, lens))).numpy()
    np.testing.assert_allclose(got, np.asarray(want_kernel), **RPA_TOL)
    np.testing.assert_allclose(got, np.asarray(want_lax), **RPA_TOL)


def test_single_query_attention_matches_jax():
    """The shared decode-attention math (cross-attention and the paged
    plain version) == the JAX function, with a key mask."""
    rng = np.random.RandomState(6)
    qh = rng.randn(3, 2, 1, 8).astype(np.float32)
    kc = rng.randn(3, 2, 10, 8).astype(np.float32)
    vc = rng.randn(3, 2, 10, 8).astype(np.float32)
    keep = (np.arange(10)[None, :] < np.array([3, 10, 7])[:, None])
    keep = keep[:, None, None, :]
    want = jk.single_query_cached_attention(
        jnp.asarray(qh), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(keep))
    got = tk.single_query_cached_attention(
        *(torch.from_numpy(a) for a in (qh, kc, vc, keep)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RPA_TOL)


def test_cpu_path_launches_no_kernel():
    """The CPU path runs the plain versions: both launch counters stay 0."""
    tk.reset_launch_counts()
    q, k, v = _qkv(7, 1, 1, 8, 8, 8)
    _port_flash(q, k, v, lengths=[5])
    qp, kp, vp, pt = _paged_fixture()
    tk.ragged_paged_attention(*(torch.from_numpy(a) for a in
                                (qp, kp, vp, pt,
                                 np.array([3, 4, 5], np.int32))))
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)


def test_wrappers_check_what_the_kernels_take():
    """The wrappers refuse, on the CPU too, the layouts the CUDA kernels
    refuse on the card (a non-contiguous q, int64 lengths, an empty head
    D = 0), so a caller's layout bug shows in the CPU tests; any D > 0
    is taken (D = 520 gives softmax attention, as the JAX function
    does)."""
    qp, kp, vp, pt = (torch.from_numpy(a) for a in _paged_fixture())
    lens = torch.tensor([3, 4, 5], dtype=torch.int32)
    qkv = torch.cat([qp, qp, qp], dim=-1)
    with pytest.raises(MXNetError, match="contiguous q"):
        tk.ragged_paged_attention(qkv[..., :8], kp, vp, pt, lens)
    with pytest.raises(MXNetError, match="lengths"):
        tk.ragged_paged_attention(qp, kp, vp, pt, lens.long())
    q, k, v = map(torch.from_numpy, _qkv(8, 1, 1, 4, 4, 520))
    want = torch.softmax(q @ k.transpose(-1, -2) / 520 ** 0.5, -1) @ v
    torch.testing.assert_close(tk.flash_attention(q, k, v), want,
                               **FLASH_TOL)
    with pytest.raises(MXNetError, match="D > 0"):
        tk.flash_attention(q[..., :0], k[..., :0], v[..., :0], sm_scale=1.0)
    with pytest.raises(MXNetError, match="contiguous"):
        tk.flash_attention(q[..., :8], k[..., :8].contiguous(),
                           v[..., :8].contiguous())


def test_unported_forms_raise():
    """The int8 and widened forms take what their kernels take, on the
    CPU too: scales come in pairs, and a widened q must be contiguous
    (a column slice of the fused QKV output is not)."""
    qp, kp, vp, pt = (torch.from_numpy(a) for a in _paged_fixture())
    lens = torch.tensor([3, 4, 5], dtype=torch.int32)
    scales = torch.ones(kp.shape[0], kp.shape[2])
    with pytest.raises(MXNetError, match="together"):
        tk.ragged_paged_attention(qp, kp.to(torch.int8), vp.to(torch.int8),
                                  pt, lens, k_scales=scales)
    wide = torch.cat([qp[:, None]] * 3, dim=-1).expand(3, 2, 2, 24)
    with pytest.raises(MXNetError, match="contiguous q"):
        tk.ragged_paged_attention(wide[..., :8], kp, vp, pt, lens)
