"""Wide heads (D > 128, any width) in the port's flash attention: the
plain route on the CPU against the JAX Pallas kernels in interpret mode
(`MXTPU_PALLAS_INTERPRET=1`, 1 head, S = 128, as `tests/test_pallas.py`
runs them; the JAX function takes any head width) at D = 192, 200 (a
multiple of 8, not of 64: padded to 256), 256 and 512 (640 and 1024 in
`tests/test_torch_flash_wide_jax.py`), in float32, bfloat16 and
float16, causal with key lengths and without masks, forward (out, lse)
and backward (dQ, dK, dV); the wrappers taking any width; and what the
wrappers hand `csrc/flash_wide.cu` on a card tensor (a stand-in
library). The launch plans are `tests/test_torch_flash_wide_design.py`'s.

The tolerance rule, `tests/test_torch_fp16.py`'s for every dtype: each
reading is also taken in float64 on the same inputs (rounded to the
dtype once); the port's distance from float64 must be at most twice the
JAX package's plus one unit roundoff of the dtype times the largest
float64 value, and port vs JAX must lie within the dtype's limit:
float32 `tests/test_torch_kernels.py`'s FLASH_TOL, bfloat16
`tests/test_pallas.py:80-84`'s 0.05, float16 that times 2^-3 (the same
count of fp16's unit roundoff). The kernels themselves run only on the
card, where `chip_smoke.py`'s `flash_wide` phase holds each against its
plain version and float64."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

DTYPES = {
    "float32": (torch.float32, jnp.float32, dict(rtol=2e-4, atol=2e-5),
                2.0 ** -24),
    "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(rtol=0.05, atol=0.05),
                 2.0 ** -8),
    "float16": (torch.float16, jnp.float16,
                dict(rtol=0.05 * 2.0 ** -3, atol=0.05 * 2.0 ** -3),
                2.0 ** -11),
}
S = 128


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _round(a, tdt):
    """numpy float32 -> the dtype's value of each element, as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt).float() \
        .numpy()


def _inputs(seed, d, tdt):
    rng = np.random.RandomState(seed)
    return [_round(rng.randn(2, 1, S, d), tdt) for _ in range(4)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _f64(q, k, v, do, causal, lens, scale):
    """out, lse, (dQ, dK, dV) in float64 (autograd) with the kernels'
    masks."""
    return _f64_at(q, k, v, do, causal, scale, lens)


def _f64_at(q, k, v, do, causal, scale, lens=None):
    """`_f64` at any (B, H, S, D)."""
    q, k, v = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    n = s.shape[-1]
    allowed = torch.ones(s.shape, dtype=torch.bool)
    if lens is not None:
        keys = torch.arange(n)[None, :] < torch.tensor(lens)[:, None]
        allowed &= keys[:, None, None, :]
    if causal:
        allowed &= torch.ones(n, n, dtype=torch.bool).tril()
    s = torch.where(allowed, s, torch.tensor(-torch.inf, dtype=s.dtype))
    out = torch.softmax(s, -1) @ v
    lse = torch.logsumexp(s, -1)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.tensor(do, dtype=torch.float64))
    return out.detach().numpy(), lse.detach().numpy(), \
        [g.numpy() for g in grads]


def _rule(port, jx, exact, tol, unit, what):
    port, jx = _np(port), _np(jx)
    exact = np.asarray(exact, np.float64)
    np.testing.assert_allclose(port, jx, **tol, err_msg=what)
    dp, dj = np.abs(port - exact).max(), np.abs(jx - exact).max()
    assert dp <= 2 * dj + unit * np.abs(exact).max(), (what, dp, dj)


MASKS = pytest.mark.parametrize(
    "causal,lens", [(True, (100, 1)), (False, None)],
    ids=["causal-lens", "full"])


@pytest.mark.parametrize("d", [192, 200, 256, 512])
@pytest.mark.parametrize("dtype", list(DTYPES))
@MASKS
def test_wide_plain_matches_jax_kernels(interpret, d, dtype, causal, lens):
    """out and lse from `flash_attention_fwd`, then dQ, dK, dV from
    `flash_attention_bwd` on each package's own out and lse, against
    `_flash_fwd_pallas` / `_flash_bwd_pallas`: the tolerance rule; the
    outputs in the input dtype (lse fp32); nothing launches on the CPU
    (`tests/test_torch_flash_wide_jax.py` holds D = 640 and 1024)."""
    plain_matches_jax(d, dtype, causal, lens)


def plain_matches_jax(d, dtype, causal, lens):
    """One case of `test_wide_plain_matches_jax_kernels`."""
    tdt, jdt, tol, unit = DTYPES[dtype]
    tk.reset_launch_counts()
    q, k, v, do = _inputs(d + len(dtype) + causal, d, tdt)
    scale = d ** -0.5
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, do)]
    j = [jnp.asarray(a, jdt) for a in (q, k, v, do)]
    tvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    jvl = None if lens is None else jnp.asarray(lens, jnp.int32)
    out, lse = tk.flash_attention_fwd(*t[:3], causal, kv_lengths=tvl)
    assert out.dtype == tdt and lse.dtype == torch.float32
    jout, jlse = pk._flash_fwd_pallas(*j[:3], causal, scale, lengths=jvl)
    o64, l64, g64 = _f64(q, k, v, do, causal, lens, scale)
    _rule(out, jout, o64, tol, unit, "out")
    _rule(lse, jlse[..., 0], l64.reshape(2, S), dict(rtol=1e-5, atol=1e-5),
          2.0 ** -24, "lse")
    delta = (out.float() * t[3].float()).sum(-1).reshape(2, S)
    got = tk.flash_attention_bwd(*t, lse, delta, causal, kv_lengths=tvl)
    want = pk._flash_bwd_pallas(*j[:3], jout, jlse[..., 0], j[3], causal,
                                scale, lengths=jvl)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, g64):
        assert g.dtype == tdt
        _rule(g, w, e, tol, unit, name)
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)


def test_autograd_through_a_wide_head():
    """`flash_attention` is differentiable at D = 320 (no multiple of
    64) on the CPU, equal to float64 autograd within FLASH_TOL."""
    rng = np.random.RandomState(2)
    q, k, v, w = (rng.randn(1, 2, 40, 320).astype(np.float32)
                  for _ in range(4))
    tq, tk_, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (tk.flash_attention(tq, tk_, tv, causal=True)
     * torch.from_numpy(w)).sum().backward()
    q64, k64, v64 = (torch.tensor(a, dtype=torch.float64,
                                  requires_grad=True) for a in (q, k, v))
    s = (q64 @ k64.transpose(-1, -2)) / np.sqrt(320)
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                      -torch.inf)
    ((torch.softmax(s, -1) @ v64) * torch.from_numpy(w).double()).sum() \
        .backward()
    for a, b in ((tq, q64), (tk_, k64), (tv, v64)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_wrapper_limit_and_narrow_plans():
    """The wrappers take any D > 0 on either device (the JAX function
    does: a refusal there was a result that differs): D = 513 and 1024
    run forward and backward on the CPU, equal to float64 within
    FLASH_TOL, and D = 0 is refused; the narrow kernels' plans keep their
    limit of 128 (wider heads never reach them)."""
    assert not hasattr(tk, "FLASH_MAX_D")
    rng = np.random.RandomState(5)
    for d in (513, 1024):
        q, k, v, do = (rng.randn(1, 2, 12, d).astype(np.float32)
                       for _ in range(4))
        t = [torch.from_numpy(a) for a in (q, k, v, do)]
        out, lse = tk.flash_attention_fwd(*t[:3], True)
        delta = (out * t[3]).sum(-1).reshape(2, 12)
        got = tk.flash_attention_bwd(*t, lse, delta, True)
        o64, l64, g64 = _f64_at(q, k, v, do, True, d ** -0.5)
        np.testing.assert_allclose(out.numpy(), o64, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), l64.reshape(2, 12),
                                   rtol=1e-5, atol=1e-5)
        for g, e in zip(got, g64):
            np.testing.assert_allclose(g.numpy(), e, rtol=2e-4, atol=2e-5)
    x = torch.zeros((1, 1, 4, 0))
    with pytest.raises(MXNetError, match="D > 0"):
        tk.flash_attention_fwd(x, x, x)
    with pytest.raises(MXNetError, match="0 < D <= 128"):
        tk.flash_fwd_plan(1, 4, 4, 192)
    with pytest.raises(MXNetError, match="0 < D <= 128"):
        tk.flash_bwd_plan(4, 192, torch.bfloat16)


class _FakeLibrary:
    """Records each wide entry's name and arguments; returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mxtt_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tk, "_device_of", lambda *t: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())

    def no_plain(*a):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(tk, "_flash_plain", no_plain)
    monkeypatch.setattr(tk, "_flash_bwd_plain", no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


@pytest.mark.parametrize("dtype,sfx", [(torch.float32, "_f32"),
                                       (torch.bfloat16, "_bf16"),
                                       (torch.float16, "_f16")])
@pytest.mark.parametrize("d", [129, 192, 512, 1024])
def test_card_tensors_launch_the_wide_kernels(card, dtype, sfx, d):
    """D > 128 on a card tensor: one `mxtt_flash_wide_fwd*` launch with
    (q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal, scale, then
    `flash_wide_plan`'s chunks, stages, vec and shared bytes, stream),
    then the backward's dK/dV and dQ launches with the forward's lse and
    the caller's delta and their plans; each counted under its own
    name."""
    b, h, sq, sk = 2, 3, 9, 11
    q = torch.zeros((b, h, sq, d), dtype=dtype)
    k = torch.zeros((b, h, sk, d), dtype=dtype)
    vl = torch.tensor([5, 11], dtype=torch.int32)
    out, lse = tk.flash_attention_fwd(q, k, k, True, 0.25, kv_lengths=vl)
    name, args = card.calls[-1]
    assert name == "mxtt_flash_wide_fwd" + sfx
    assert args[:6] == (q.data_ptr(), k.data_ptr(), k.data_ptr(),
                        vl.data_ptr(), out.data_ptr(), lse.data_ptr())
    vec = int(d * q.element_size() % 16 == 0)

    def plan(kind, causal):
        p = tk.flash_wide_plan(d, dtype, b * h, sq, sk, causal)[kind]
        # every wide kernel on the tensor cores: wgmma in 16 bits, split
        # TF32 on mma.sync in fp32 (no simple kernel is left)
        assert p["kind"] == ("mma" if dtype == torch.float32 else "wgmma")
        return (p["chunks"], p["stages"], vec, p["smem"])
    assert args[6:] == (b, h, sq, sk, d, 1, 0.25, *plan("fwd", True), 7)
    assert out.dtype == dtype and lse.shape == (b * h, sq)
    delta = torch.zeros(b * h, sq)
    dq, dk, dv = tk.flash_attention_bwd(q, k, k, q, lse, delta, False, 0.5)
    (n1, a1), (n2, a2) = card.calls[-2:]
    assert n1 == "mxtt_flash_wide_bwd_dkv" + sfx
    assert n2 == "mxtt_flash_wide_bwd_dq" + sfx
    ptrs = (q.data_ptr(), k.data_ptr(), k.data_ptr(), q.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None)
    assert a1[:7] == ptrs and a2[:7] == ptrs
    assert a1[7:] == (dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, 0, 0.5,
                      *plan("dkv", False), 7)
    assert a2[7:] == (dq.data_ptr(), b, h, sq, sk, d, 0, 0.5,
                      *plan("dq", False), 7)
    counts = {n: c for n, c in tk.LAUNCHES.items() if c}
    c = "" if dtype == torch.float32 else sfx
    assert counts == {"flash_wide_fwd" + c: 1, "flash_wide_bwd_dkv" + c: 1,
                      "flash_wide_bwd_dq" + c: 1}
