"""The training path's kernels of the port (plain versions, CPU) against
the JAX package: the flash-attention backward and the fused LayerNorm.

The same seeded numpy inputs go through `mxnet_tpu`'s Pallas kernels in
interpret mode (`MXTPU_PALLAS_INTERPRET=1`, which runs the kernel bodies
on the CPU, as tests/test_pallas.py does) and through `mxnet_tpu_torch`'s
autograd Functions. The CUDA kernels themselves run only on the card;
`chip_smoke.py` holds them against these plain versions there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as jk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as tk

# the flash-backward kernel-vs-reference tolerance of
# tests/test_pallas.py:130 (fp32, sums in another order)
BWD_TOL = dict(rtol=2e-3, atol=2e-4)
# the fused-LN kernel tolerance of tests/test_pallas.py:219
LN_TOL = dict(rtol=1e-4, atol=1e-5)
# two torch formulations of the same fp32 math on the CPU
SAME_MATH_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _port_grads(q, k, v, w, causal, lengths):
    """(dq, dk, dv) of sum(flash_attention(q, k, v) * w) through the
    port's autograd Function (plain versions on the CPU)."""
    tq, tk_, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    vl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = tk.flash_attention(tq, tk_, tv, causal=causal, kv_lengths=vl)
    (out * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk_, tv)]


@pytest.mark.parametrize("b,sq,sk,lengths,causal", [
    (2, 128, 128, [77, 128], False),
    (1, 128, 128, None, True),
    (2, 128, 256, [200, 31], False),
], ids=["s128-len", "s128-causal", "rect-len"])
def test_flash_bwd_matches_jax_pallas_interpret(interpret, b, sq, sk,
                                                lengths, causal):
    """dQ/dK/dV of the port == `jax.grad` through the JAX Pallas forward
    and backward kernels (interpret mode): key lengths, causal, and the
    cross-attention shape Sq != Sk."""
    q, k, v, w = _arrays(0, (b, 2, sq, 32), (b, 2, sk, 32), (b, 2, sk, 32),
                         (b, 2, sq, 32))
    assert jk._pallas_ok(sq) and jk._pallas_ok(sk)   # the kernels run
    vl = None if lengths is None else jnp.asarray(lengths, jnp.int32)

    def f(q_, k_, v_):
        return (jk.flash_attention(q_, k_, v_, causal, kv_lengths=vl)
                * w).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(q, k, v, w, causal, lengths)
    for name, g, ref in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(ref), **BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("sq,sk,lengths", [
    (128, 256, None), (128, 256, [200, 31]),
    (256, 128, None), (256, 128, [100, 128]),
], ids=["sq<sk", "sq<sk-len", "sq>sk", "sq>sk-len"])
def test_flash_bwd_causal_rectangular_matches_jax_pallas_interpret(
        interpret, sq, sk, lengths):
    """Causal with Sq != Sk, both ways, with and without key lengths:
    dQ/dK/dV of the port == `jax.grad` through the JAX Pallas kernels in
    interpret mode (the top-left mask)."""
    q, k, v, w = _arrays(6, (1, 2, sq, 32), (1, 2, sk, 32), (1, 2, sk, 32),
                         (1, 2, sq, 32))
    if lengths is not None:
        q, k, v, w = (np.concatenate([a, a[:, ::-1]]) for a in (q, k, v, w))
    assert jk._pallas_ok(sq) and jk._pallas_ok(sk)
    vl = None if lengths is None else jnp.asarray(lengths, jnp.int32)

    def f(q_, k_, v_):
        return (jk.flash_attention(q_, k_, v_, True, kv_lengths=vl)
                * w).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(q, k, v, w, True, lengths)
    for name, g, ref in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(ref), **BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("sq,sk,lengths", [
    (23, 41, None), (23, 41, [30, 7]), (41, 23, None), (41, 23, [5, 23]),
], ids=["sq<sk", "sq<sk-len", "sq>sk", "sq>sk-len"])
def test_flash_bwd_causal_rectangular_matches_jax_reference(sq, sk,
                                                            lengths):
    """Causal with ragged Sq != Sk: the port's gradients == `jax.vjp` of
    `attention_reference` with its top-left mask."""
    q, k, v, w = _arrays(7, (2, 2, sq, 16), (2, 2, sk, 16), (2, 2, sk, 16),
                         (2, 2, sq, 16))
    mask = None
    if lengths is not None:
        mask = jnp.asarray((np.arange(sk)[None, :]
                            < np.array(lengths)[:, None])[:, None, None, :])
    _, vjp = jax.vjp(lambda *a: jk.attention_reference(*a, causal=True,
                                                       mask=mask),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(w))
    got = _port_grads(q, k, v, w, True, lengths)
    for name, g, ref in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(ref), **BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,lengths,sq,sk", [
    (True, [9, 24], 24, 24),
    (False, [3, 40], 17, 40),
], ids=["causal-len", "rect-len"])
def test_flash_bwd_plain_is_autograd_of_flash_plain(causal, lengths, sq, sk):
    """The backward kernels' formula (`_flash_bwd_plain`, fed the
    forward's lse and delta = rowsum(dO * O)) == torch autograd through
    the plain forward."""
    q, k, v, do = _arrays(1, (2, 3, sq, 16), (2, 3, sk, 16), (2, 3, sk, 16),
                          (2, 3, sq, 16))
    tq, tk_, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    vl = torch.tensor(lengths, dtype=torch.int32)
    out, lse = tk._flash_plain(tq, tk_, tv, causal, 0.25, vl)
    out.backward(torch.from_numpy(do))
    tdo = torch.from_numpy(do)
    delta = (out.detach() * tdo).sum(-1).reshape(6, sq)
    got = tk.flash_attention_bwd(tq.detach(), tk_.detach(), tv.detach(), tdo,
                                 lse.detach(), delta, causal, 0.25, vl)
    for g, t in zip(got, (tq, tk_, tv)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(),
                                   **SAME_MATH_TOL)


def test_flash_bwd_masked_keys_get_exact_zeros():
    """Keys at or past kv_lengths[b] get dK = dV = 0 exactly, and a row
    with no visible key (length 0) gives zero gradients."""
    q, k, v, w = _arrays(2, (3, 2, 20, 8), (3, 2, 30, 8), (3, 2, 30, 8),
                         (3, 2, 20, 8))
    lengths = [0, 11, 30]
    dq, dk, dv = _port_grads(q, k, v, w, False, lengths)
    for bi, n in enumerate(lengths):
        assert np.array_equal(dk[bi, :, n:], np.zeros_like(dk[bi, :, n:]))
        assert np.array_equal(dv[bi, :, n:], np.zeros_like(dv[bi, :, n:]))
    assert np.array_equal(dq[0], np.zeros_like(dq[0]))
    assert np.abs(dk[1, :, :11]).sum() > 0 and np.abs(dq[2]).sum() > 0


def test_ln_matches_jax_pallas_interpret(interpret):
    """y, mean and rstd of the port's LayerNorm == the JAX `_ln_kernel`
    (interpret mode) on (64, 128), and so do the gradients of
    sum(LN(x) * w) for x, gamma and beta."""
    x, g, b, w = _arrays(3, (64, 128), (128,), (128,), (64, 128))
    jx, jg, jb = map(jnp.asarray, (x, g, b))
    want_y, want_m, want_r = jk._fused_ln_fwd_impl(jx, jg, jb, 1e-5)
    got_y, got_m, got_r = tk.layer_norm_fwd(*map(torch.from_numpy,
                                                 (x, g, b)), 1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **LN_TOL)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m)[:, 0],
                               **LN_TOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r)[:, 0],
                               **LN_TOL)

    want = jax.grad(lambda *a: (jk.fused_layer_norm(*a) * w).sum(),
                    argnums=(0, 1, 2))(jx, jg, jb)
    tx, tg, tb = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    (tk.fused_layer_norm(tx, tg, tb) * torch.from_numpy(w)).sum().backward()
    for name, t, ref in zip(("x", "gamma", "beta"), (tx, tg, tb), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   **LN_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("rows,d", [
    (16, 768), (13, 768), (24, 1024), (7, 1024), (11, 200), (16, 1152),
    (5, 1032),
], ids=["768-pallas", "768-odd-rows", "1024-pallas", "1024-odd-rows",
        "200", "1152-pallas", "1032"])
def test_ln_widths_match_jax(interpret, monkeypatch, rows, d):
    """The port's LayerNorm at BERT's width (768), bert_large's (1024),
    a width that is no multiple of 128 (200) and widths above the
    kernel's one-warp form (1152, 1032), at row counts that are not
    multiples of 8 too, against the JAX `_fused_ln_fwd_impl`: its Pallas
    kernel in interpret mode where it takes the shape (D % 128 == 0,
    rows % 8 == 0), its XLA form elsewhere. y, mean, rstd and the three
    gradients of sum(LN(x) * w)."""
    x, g, b, w = _arrays(6, (rows, d), (d,), (d,), (rows, d))
    x = 3 * x + 1                    # a mean and a scale of their own
    jx, jg, jb = map(jnp.asarray, (x, g, b))
    calls, real = [], jk.pl.pallas_call
    monkeypatch.setattr(jk.pl, "pallas_call",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want_y, want_m, want_r = jk._fused_ln_fwd_impl(jx, jg, jb, 1e-5)
    assert bool(calls) == (d % 128 == 0 and rows % 8 == 0)
    got_y, got_m, got_r = tk.layer_norm_fwd(*map(torch.from_numpy,
                                                 (x, g, b)), 1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **LN_TOL)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m)[:, 0],
                               **LN_TOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r)[:, 0],
                               **LN_TOL)
    want = jax.grad(lambda *a: (jk.fused_layer_norm(*a) * w).sum(),
                    argnums=(0, 1, 2))(jx, jg, jb)
    tx, tg, tb = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    (tk.fused_layer_norm(tx, tg, tb) * torch.from_numpy(w)).sum().backward()
    for name, t, ref in zip(("x", "gamma", "beta"), (tx, tg, tb), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   **LN_TOL, err_msg=f"d{name}")


def test_ln_backward_is_autograd_of_the_plain_forward():
    """The closed-form backward == torch autograd through `_ln_plain`,
    on a 3-D input whose row count is not a multiple of 8."""
    x, g, b, dy = _arrays(4, (3, 5, 48), (48,), (48,), (3, 5, 48))
    ref = [torch.tensor(a, requires_grad=True) for a in (x, g, b)]
    y, _, _ = tk._ln_plain(ref[0].reshape(15, 48), ref[1], ref[2], 1e-5)
    y.reshape(3, 5, 48).backward(torch.from_numpy(dy))
    got = [torch.tensor(a, requires_grad=True) for a in (x, g, b)]
    tk.fused_layer_norm(*got).backward(torch.from_numpy(dy))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(),
                                   **SAME_MATH_TOL)


def test_training_kernels_check_their_inputs_and_launch_nothing_here(
        monkeypatch):
    """The wrappers refuse, on the CPU too, what the CUDA kernels refuse
    (a non-contiguous dO or x, a wrong lse shape). The LayerNorm kernel
    takes every width: the card-side checks pass a D = 1032 card tensor
    on to the launch, while a non-contiguous one, or one neither float32
    nor bfloat16 (the kernel's two forms), is refused before any launch.
    The CPU path launches no kernel."""
    tk.reset_launch_counts()
    x = torch.randn(4, 1032)
    y = tk.fused_layer_norm(x, torch.ones(1032), torch.zeros(1032))
    assert y.shape == x.shape and torch.isfinite(y).all()
    launched = []

    def ln_launch(x2, gamma, beta, eps):
        launched.append(tuple(x2.shape))
        return tk._ln_plain(x2, gamma, beta, eps)
    with monkeypatch.context() as m:
        m.setattr(tk, "_device_of", lambda *t: torch.device("cuda", 0))
        m.setattr(tk, "_ln_cuda", ln_launch)
        got = tk.fused_layer_norm(x, torch.ones(1032), torch.zeros(1032))
        assert launched == [(4, 1032)]
        torch.testing.assert_close(got, y)
        with pytest.raises(MXNetError, match="contiguous"):
            tk.fused_layer_norm(x[:, :8], torch.ones(8), torch.zeros(8))
        with pytest.raises(MXNetError,
                           match=r"takes float32 x .* or bfloat16 x"):
            tk.fused_layer_norm(x.double(), torch.ones(1032).double(),
                                torch.zeros(1032).double())
        assert launched == [(4, 1032)]
    with pytest.raises(MXNetError, match="contiguous"):
        tk.fused_layer_norm(x[:, :8], torch.ones(8), torch.zeros(8))
    q = torch.randn(1, 2, 8, 16)
    lse = torch.zeros(2, 8)
    with pytest.raises(MXNetError, match="dO"):
        tk.flash_attention_bwd(q, q, q, torch.randn(1, 2, 16, 8)
                               .transpose(2, 3), lse, lse)
    with pytest.raises(MXNetError, match="lse"):
        tk.flash_attention_bwd(q, q, q, q, lse[:1], lse)
    _port_grads(*_arrays(5, (1, 1, 8, 8), (1, 1, 8, 8), (1, 1, 8, 8),
                         (1, 1, 8, 8)), True, None)
    tk.fused_layer_norm(torch.randn(3, 8), torch.ones(8), torch.zeros(8))
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)
