"""The float16 forms of the flash forward, the flash backward pair and
LayerNorm on the CPU: their plain versions against the JAX Pallas
kernels in interpret mode (`MXTPU_PALLAS_INTERPRET=1`, 1 head, S = 256,
as `tests/test_pallas.py` runs them) on the same float16 inputs, their
rounding points written out, what the wrappers hand the float16 kernels
on a card tensor (a stand-in library), and the dtypes the wrappers
refuse on either device. Inputs are made with numpy from a seed and
rounded to float16 once, so both packages start from the same bits.

The tolerance rule, `tests/test_torch_bf16.py`'s at fp16's unit
roundoff: each reading is also taken in float64 on the same float16
inputs; the port's distance from float64 must be at most twice the JAX
package's, plus a floor of one fp16 rounding (2^-11 relative) of the
largest float64 value (one rounding landing the other way), and port vs
JAX must lie within FP16_TOL elementwise: `tests/test_pallas.py:80-84`'s
bf16 limit of 0.05 is 12.8 of bf16's unit roundoff (2^-8), and the same
count of fp16's (2^-11) is 0.00625. The kernels themselves run only on
the card, where `chip_smoke.py`'s `flash_f16` and `ln_f16` phases hold
each against its plain version and float64.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

F16 = torch.float16
UNIT = 2.0 ** -11                       # fp16's unit roundoff
FP16_TOL = dict(rtol=0.05 * 2.0 ** -3, atol=0.05 * 2.0 ** -3)
FLOOR = UNIT


def _f16(a):
    """numpy float32 -> the float16 value of each element, as float32."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(F16)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.float16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _rule(port, jx, exact, what):
    """The tolerance rule of the module docstring; returns the two
    distances from float64."""
    port, jx = _np(port), _np(jx)
    exact = np.asarray(exact, np.float64)
    np.testing.assert_allclose(port, jx, **FP16_TOL, err_msg=what)
    dp, dj = np.abs(port - exact).max(), np.abs(jx - exact).max()
    assert dp <= 2 * dj + FLOOR * np.abs(exact).max(), (what, dp, dj)
    return dp, dj


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# the flash kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------
def _attention_inputs(seed, b=2, h=1, s=256, d=64):
    rng = np.random.RandomState(seed)
    return [_f16(rng.randn(b, h, s, d)) for _ in range(4)]


def _attention_f64(q, k, v, do, causal, lens, scale):
    """out, lse and (dQ, dK, dV) of softmax attention in float64 on the
    float16 inputs (autograd), with the kernels' masks."""
    q, k, v = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    allowed = torch.ones(s.shape, dtype=torch.bool)
    if lens is not None:
        keys = torch.arange(s.shape[-1])[None, :] < torch.tensor(lens)[:, None]
        allowed &= keys[:, None, None, :]
    if causal:
        allowed &= torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    s = torch.where(allowed, s, torch.tensor(-torch.inf, dtype=s.dtype))
    out = torch.softmax(s, -1) @ v
    lse = torch.logsumexp(s, -1)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.tensor(do, dtype=torch.float64))
    return out.detach().numpy(), lse.detach().numpy(), \
        [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", [None, (200, 1)], ids=["full", "lens"])
def test_flash_plain_versions_match_jax_kernels(interpret, causal, lens):
    """The float16 forward's and backward pair's plain versions against
    `_flash_fwd_pallas` / `_flash_bwd_pallas` (Pallas interpret mode, on
    float16 q, k, v, dO as the JAX kernels read them) and
    `attention_reference` in float16: out and lse, then dQ, dK, dV from
    each package's own out and lse, under the tolerance rule (a key
    length of 1 included: its dQ and dK are 0 up to rounding); out and
    the gradients float16, lse fp32; nothing launches on the CPU."""
    tk.reset_launch_counts()
    q, k, v, do = _attention_inputs(21 + causal)
    b, h, s, d = q.shape
    scale = d ** -0.5
    tvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    jvl = None if lens is None else jnp.asarray(lens, jnp.int32)
    out, lse = tk.flash_attention_fwd(_t(q), _t(k), _t(v), causal,
                                      kv_lengths=tvl)
    assert out.dtype == F16 and lse.dtype == torch.float32
    jout, jlse = pk._flash_fwd_pallas(_j(q), _j(k), _j(v), causal, scale,
                                      lengths=jvl)
    assert jout.dtype == jnp.float16
    o64, l64, g64 = _attention_f64(q, k, v, do, causal, lens, scale)
    _rule(out, jout, o64, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse[..., 0]),
                               rtol=1e-5, atol=1e-5)
    _rule(lse, jlse[..., 0], l64.reshape(b * h, s), "lse")
    mask = None if lens is None else pk._lengths_mask(jvl, s)
    ref = pk.attention_reference(_j(q), _j(k), _j(v), causal=causal,
                                 sm_scale=scale, mask=mask)
    _rule(out, ref, o64, "out vs attention_reference")

    delta = (out.float() * _t(do).float()).sum(-1).reshape(b * h, s)
    got = tk.flash_attention_bwd(_t(q), _t(k), _t(v), _t(do), lse, delta,
                                 causal, kv_lengths=tvl)
    want = pk._flash_bwd_pallas(_j(q), _j(k), _j(v), jout, jlse[..., 0],
                                _j(do), causal, scale, lengths=jvl)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, g64):
        assert g.dtype == F16 and w.dtype == jnp.float16
        _rule(g, w, e, name)
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)


def test_flash_plain_rounds_where_the_kernels_do():
    """In float16 the plain forward rounds P to float16 before P V and
    out once, and the backward takes fp16(p) for dV and dK but fp32 p
    for dQ (`pallas_kernels.py:455-461, 521-526`): each against the
    formula written out here, bit for bit."""
    q, k, v, do = (_t(a) for a in _attention_inputs(23, s=64))
    scale = 0.125
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (torch.einsum("bhqk,bhkd->bhqd", p.to(F16).float(), v.float())
            / p.sum(-1, keepdim=True)).to(F16)
    out, lse = tk.flash_attention_fwd(q, k, v)
    assert torch.equal(out, want)
    delta = (out.float() * do.float()).sum(-1).reshape(2, 64)
    pf = torch.exp(s - lse.reshape(2, 1, 64, 1))
    pb = pf.to(F16).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()) \
        - delta.reshape(2, 1, 64, 1)
    dsk = (pb * dp * scale).to(F16).float()
    dsq = (pf * dp * scale).to(F16).float()
    dq, dk, dv = tk.flash_attention_bwd(q, k, v, do, lse, delta)
    assert torch.equal(dv, torch.einsum("bhqk,bhqd->bhkd", pb, do.float())
                       .to(F16))
    assert torch.equal(dk, torch.einsum("bhqk,bhqd->bhkd", dsk, q.float())
                       .to(F16))
    assert torch.equal(dq, torch.einsum("bhqk,bhkd->bhqd", dsq, k.float())
                       .to(F16))
    assert not torch.equal(dsk, dsq)
    # the float16 roundings are not bfloat16's
    assert not torch.equal(out.float(), (torch.einsum(
        "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), v.float())
        / p.sum(-1, keepdim=True)).to(F16).float())


def test_zero_length_rows_are_zeros_in_float16():
    """A key length of 0 gives zeros and zero gradients in float16 too
    (the kernels' convention, ROADMAP Queue 3 item 4)."""
    q, k, v, do = (_t(a) for a in _attention_inputs(24, s=32))
    vl = torch.tensor([0, 32], dtype=torch.int32)
    out, lse = tk.flash_attention_fwd(q, k, v, kv_lengths=vl)
    assert out[0].abs().max().item() == 0.0
    delta = (out.float() * do.float()).sum(-1).reshape(2, 32)
    dq, dk, dv = tk.flash_attention_bwd(q, k, v, do, lse, delta,
                                        kv_lengths=vl)
    for g in (dq, dk, dv):
        assert g[0].abs().max().item() == 0.0 and g[1].abs().max() > 0


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
def _layer_norm_case(rows, d, gdtype, seed):
    """`fused_layer_norm` on float16 x with gamma / beta in `gdtype`
    against the JAX one (its Pallas kernel in interpret mode) forward and
    backward at (rows, d), under the tolerance rule: y, dx in x's dtype,
    dgamma / dbeta in gamma's, fp32 statistics."""
    rng = np.random.RandomState(seed)
    x = _f16(3 * rng.randn(rows, d) + 1)
    gam, bet = (_f16(1 + 0.3 * rng.randn(d)) for _ in range(2))
    dy = _f16(rng.randn(rows, d))
    gt = F16 if gdtype == "float16" else torch.float32
    gj = jnp.float16 if gdtype == "float16" else jnp.float32
    xt = _t(x).requires_grad_(True)
    gt_, bt = (torch.tensor(a).to(gt).requires_grad_(True)
               for a in (gam, bet))
    y = tk.fused_layer_norm(xt, gt_, bt)
    y.backward(_t(dy))
    assert y.dtype == F16 and xt.grad.dtype == F16
    assert gt_.grad.dtype == gt

    def f(a, g_, b_):
        return pk.fused_layer_norm(a, g_, b_)
    jy, vjp = jax.vjp(f, _j(x), jnp.asarray(gam, gj), jnp.asarray(bet, gj))
    assert jy.dtype == jnp.float16
    jgrads = vjp(_j(dy))
    x64, g64, b64 = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                     for a in (x, gam, bet))
    mu = x64.mean(-1, keepdim=True)
    var = ((x64 - mu) ** 2).mean(-1, keepdim=True)
    y64 = (x64 - mu) / torch.sqrt(var + 1e-5) * g64 + b64
    y64.backward(torch.tensor(dy, dtype=torch.float64))
    _rule(y, jy, y64.detach().numpy(), "y")
    for name, g, w, e in zip(("dx", "dgamma", "dbeta"),
                             (xt.grad, gt_.grad, bt.grad), jgrads,
                             (x64.grad, g64.grad, b64.grad)):
        _rule(g, w, e.numpy(), name)


@pytest.mark.parametrize("gdtype", ["float32", "float16"])
def test_layer_norm_fp16_matches_jax_kernel(interpret, gdtype):
    """`_layer_norm_case` at D = 768 (BERT's width, the one-warp form on
    the card), 16 rows: fp32 gamma / beta as float16 AMP leaves them,
    float16 as `cast("float16")` makes them."""
    _layer_norm_case(16, 768, gdtype, 25)


@pytest.mark.parametrize("gdtype", ["float32", "float16"])
def test_layer_norm_fp16_wide_rows_match_jax_kernel(interpret, gdtype):
    """`_layer_norm_case` at the one-block-a-row form's width on the card
    (D = 4096; 8 rows, the Pallas kernel's least block)."""
    _layer_norm_case(8, 4096, gdtype, 26)


def test_layer_norm_plain_rounds_y_once():
    """The plain float16 LayerNorm forms y in fp32 from fp32 statistics
    and rounds it once to float16, bit for bit, with fp32 gamma."""
    rng = np.random.RandomState(27)
    x = _t(_f16(2 * rng.randn(5, 200)))
    g = torch.tensor(1 + 0.2 * rng.randn(200), dtype=torch.float32)
    b = torch.tensor(0.1 * rng.randn(200), dtype=torch.float32)
    y, mean, rstd = tk.layer_norm_fwd(x, g, b, 1e-5)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    r = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    assert torch.equal(y, ((xf - mu) * r * g + b).to(F16))
    assert mean.dtype == rstd.dtype == torch.float32


# ---------------------------------------------------------------------------
# what the wrappers hand the float16 kernels, on a card tensor
# ---------------------------------------------------------------------------
class _FakeLibrary:
    """Records the launches of the float16 entries; writes nothing. Any
    other form's entry is missing, so reaching it fails the test."""

    def __init__(self):
        self.calls = []

    def mxtt_flash_fwd_f16(self, *args):
        self.calls.append(("fwd",) + args[6:18])
        return 0

    def mxtt_flash_bwd_f16(self, *args):
        self.calls.append(("dkv", args[7] is not None) + args[10:21])
        return 0

    def mxtt_flash_bwd_dq_f16(self, *args):
        self.calls.append(("dq",) + args[8:17])
        return 0

    def mxtt_layer_norm_f16(self, *args):
        self.calls.append(("ln",) + args[6:11])
        return 0


@pytest.fixture
def card(monkeypatch):
    """float16 CPU tensors dispatched as if they lay on the card, into a
    fake kernel library; the plain versions must not run."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tk, "_device_of", lambda *t: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())

    def no_plain(*a):
        raise AssertionError("a card tensor reached the plain version")
    for name in ("_flash_plain", "_flash_bwd_plain", "_ln_plain"):
        monkeypatch.setattr(tk, name, no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


def _inputs(b, h, sq, sk, d):
    rng = np.random.RandomState(28)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(F16)
            for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                          (b, h, sq, d))]


@pytest.mark.parametrize("b,h,sq,sk,d", [
    (32, 8, 64, 64, 64),        # the training step: fused backward
    (16, 12, 512, 512, 64),     # BERT: 128-row forward, split backward
    (1, 8, 128, 128, 64),       # the serving prefill
    (2, 2, 45, 45, 30),         # D no multiple of 8: element copies
])
def test_fp16_wrappers_launch_the_16_bit_plans(card, b, h, sq, sk, d):
    """On a float16 card tensor the forward and the backward launch the
    `_f16` entries with the plans `flash_fwd_plan` / `flash_bwd_plan`
    give for float16, which are bfloat16's (one kernel template, both 2
    bytes), count under the `*_f16` counters alone, and hand back
    float16 outputs with fp32 lse."""
    q, k, v, do = _inputs(b, h, sq, sk, d)
    fplan = tk.flash_fwd_plan(b * h, sq, sk, d, F16)
    bplan = tk.flash_bwd_plan(sk, d, F16)
    assert fplan == tk.flash_fwd_plan(b * h, sq, sk, d, torch.bfloat16)
    assert bplan == tk.flash_bwd_plan(sk, d, torch.bfloat16)
    vl = torch.tensor([sk] + [1] * (b - 1), dtype=torch.int32)
    out, lse = tk.flash_attention_fwd(q, k, v, True, 0.125, vl)
    assert out.dtype == F16 and lse.dtype == torch.float32
    delta = torch.zeros(b * h, sq)
    dq, dk, dv = tk.flash_attention_bwd(q, k, v, do, lse, delta, True,
                                        0.125, vl)
    assert dq.dtype == dk.dtype == dv.dtype == F16
    vec = int(d % 8 == 0)
    fused = bplan["path"] == "fused"
    want = [("fwd", b, h, sq, sk, d, 1, 0.125, fplan["bk"], fplan["rw"], 1,
             vec, fplan["smem"]),
            ("dkv", fused, b, h, sq, sk, d, 1, 0.125, bplan["bk"],
             int(fused), vec, bplan["smem"])]
    if not fused:
        want.append(("dq", b, h, sq, sk, d, 1, 0.125, vec,
                     bplan["dq_smem"]))
    assert card.calls == want
    moved = {n: c for n, c in tk.LAUNCHES.items() if c}
    assert moved == dict(flash_fwd_f16=1, flash_bwd_f16=1,
                         **({} if fused else dict(flash_bwd_dq_f16=1)))


@pytest.mark.parametrize("gdt", [torch.float32, F16])
def test_fp16_layer_norm_wrapper_hands_the_gamma_dtype(card, gdt):
    """float16 x launches `mxtt_layer_norm_f16` with gamma's flag (1 for
    float16 gamma / beta, 0 for fp32), the 16-byte flag, as many
    arguments as `_build` declares, and counts under `layer_norm_f16`."""
    x = torch.zeros((6, 96), dtype=F16)
    g, b = torch.ones(96, dtype=gdt), torch.zeros(96, dtype=gdt)
    y, mean, rstd = tk.layer_norm_fwd(x, g, b, 1e-5)
    assert y.dtype == F16 and mean.dtype == rstd.dtype == torch.float32
    assert card.calls == [("ln", 6, 96, 1e-5, int(gdt == F16), 1)]
    assert len(_build._SIGNATURES["mxtt_layer_norm_f16"]) == 12
    assert {n: c for n, c in tk.LAUNCHES.items() if c} == {
        "layer_norm_f16": 1}


@pytest.mark.parametrize("gdt", [torch.float32, F16])
@pytest.mark.parametrize("shifted", ["none", "gamma", "beta"])
def test_fp16_layer_norm_vec_needs_aligned_gamma_and_beta(card, gdt,
                                                          shifted):
    """The 16-byte flag holds only where gamma and beta are 16-byte
    aligned too (the kernel then reads a chunk's 8 of each in 16-byte
    loads): a gamma or beta whose base lies one element off takes the
    masked element loads (vec 0), in fp32 as in float16."""
    d = 96
    x = torch.zeros((6, d), dtype=F16)

    def param(shift):
        return torch.ones(d + 1, dtype=gdt)[1:] if shift \
            else torch.ones(d, dtype=gdt)
    g, b = param(shifted == "gamma"), param(shifted == "beta")
    assert (g.data_ptr() % 16 != 0) == (shifted == "gamma")
    assert (b.data_ptr() % 16 != 0) == (shifted == "beta")
    tk.layer_norm_fwd(x, g, b, 1e-5)
    assert card.calls == [("ln", 6, d, 1e-5, int(gdt == F16),
                           int(shifted == "none"))]


# ---------------------------------------------------------------------------
# what the wrappers refuse, on either device
# ---------------------------------------------------------------------------
def test_wrappers_refuse_what_the_card_would_refuse():
    """float16 takes the plain versions on the CPU (no launch); what the
    float16 kernels do not take raises on the CPU as on the card: an
    empty head D = 0 (any D > 0 is taken: the narrow kernels' plan stops
    at D = 128 and wider heads go to `flash_wide.cu`), q / k / v or dO
    of mixed dtypes, float16 x with bfloat16 gamma, float32 x with
    float16 gamma, float64; `flash_block_attention` takes float16 (out
    in float16, lse fp32) and refuses float64."""
    tk.reset_launch_counts()
    q = torch.zeros((1, 1, 8, 16), dtype=F16)
    tk.flash_attention(q, q, q)
    tk.fused_layer_norm(torch.zeros((2, 16), dtype=F16), torch.ones(16),
                        torch.zeros(16))
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)
    wide = torch.zeros((1, 1, 8, 520), dtype=F16)
    out, _ = tk.flash_attention_fwd(wide, wide, wide)
    assert out.dtype == F16 and out.shape == wide.shape
    with pytest.raises(MXNetError, match="D > 0"):
        tk.flash_attention_fwd(wide[..., :0], wide[..., :0], wide[..., :0])
    with pytest.raises(MXNetError, match="0 < D <= 128"):
        tk.flash_fwd_plan(1, 8, 8, 136, F16)
    with pytest.raises(MXNetError, match="of one dtype"):
        tk.flash_attention_fwd(q, q.to(torch.bfloat16), q)
    with pytest.raises(MXNetError, match="of one dtype"):
        tk.flash_attention_fwd(q, q, q.float())
    lse = torch.zeros((1, 8))
    with pytest.raises(MXNetError, match="of q's dtype"):
        tk.flash_attention_bwd(q, q, q, q.to(torch.bfloat16), lse, lse)
    with pytest.raises(MXNetError, match="layer norm kernel takes"):
        tk.layer_norm_fwd(torch.zeros((2, 16), dtype=F16),
                          torch.ones(16, dtype=torch.bfloat16),
                          torch.zeros(16, dtype=torch.bfloat16))
    with pytest.raises(MXNetError, match="layer norm kernel takes"):
        tk.layer_norm_fwd(torch.zeros((2, 16)), torch.ones(16, dtype=F16),
                          torch.zeros(16, dtype=F16))
    with pytest.raises(MXNetError, match="layer norm kernel takes"):
        tk.layer_norm_fwd(torch.zeros((2, 16), dtype=F16), torch.ones(16),
                          torch.zeros(16, dtype=F16))
    x64 = q.double()
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tk.flash_attention_fwd(x64, x64, x64)
    with pytest.raises(MXNetError, match="no torch.float64 form"):
        tk.flash_bwd_plan(8, 16, torch.float64)
    out, lse = tk.flash_block_attention(q, q, q)
    assert out.dtype == F16 and lse.dtype == torch.float32
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tk.flash_block_attention(x64, x64, x64)
