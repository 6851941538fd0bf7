"""The design of the port's flash-attention backward (`csrc/flash_bwd.cu`),
checked on the CPU: its launch plan, a model of its split-TF32
arithmetic against float64 autograd, and what the wrapper hands the
kernels. The kernels themselves run only on the card, where
`chip_smoke.py` holds them against `_flash_bwd_plain` and float64
autograd; the plain version's parity with the JAX Pallas kernels is in
tests/test_torch_train_kernels.py."""
import contextlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu.ops import pallas_kernels as jk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

SRC = Path(tk.__file__).resolve().parent / "csrc" / "flash_bwd.cu"
# the most dynamic shared memory one block may take on Hopper
SMEM_LIMIT = 232448
WIDTHS = (8, 32, 64, 96, 128)
# the flash-backward kernel-vs-reference tolerance of
# tests/test_pallas.py:130 (fp32, sums in another order)
BWD_TOL = dict(rtol=2e-3, atol=2e-4)


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


def test_plan_constants_are_the_kernels():
    """The plan's tile sizes are the ones `flash_bwd.cu` compiles in."""
    assert tk._BWD_BQ == _cu_constant("kBQ") == 32
    assert tk._BWD_DQ_TILE == _cu_constant("kDqBQ") == _cu_constant("kDqBK")
    assert _cu_constant("kMaxBK") == 128


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_is_fused_up_to_one_block_and_split_above(d):
    """Every Sk up to the largest block takes the fused path with the
    keys rounded up to a warp's 16; above it, the split path with the
    largest block."""
    dp = tk.flash_bwd_plan(1, d)["dp"]
    bk_max = 128 if dp <= 64 else 64
    for sk in range(1, bk_max + 1):
        plan = tk.flash_bwd_plan(sk, d)
        assert plan["path"] == "fused" and plan["dq_smem"] is None
        assert plan["bk"] == 16 * -(-sk // 16) >= sk
    for sk in (bk_max + 1, bk_max + 16, 1024, 4097):
        plan = tk.flash_bwd_plan(sk, d)
        assert plan["path"] == "split" and plan["bk"] == bk_max
        assert plan["dq_smem"] is not None


def test_every_training_attention_takes_the_fused_path():
    """The training step's attentions (Sk = 64 at D = 64) and
    chip_smoke.py's rectangular case (Sk = 80) take one launch; the
    long-sequence drive (S = 1024) splits."""
    for sk in (64, 80):
        assert tk.flash_bwd_plan(sk, 64)["path"] == "fused"
    for case in chip_smoke._train_attention_cases():
        assert tk.flash_bwd_plan(case[3], case[4])["path"] == "fused"
    assert tk.flash_bwd_plan(chip_smoke.LONG_S, 64)["path"] == "split"


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_shared_bytes_fit_one_block(d):
    """For every Sk the plan's shared bytes stay within Hopper's per-block
    limit (the fused kernel's dS tile only on the fused path), and D is
    padded to a multiple of 32 (so of 8) of at least D."""
    seen = set()
    for sk in range(1, 300):
        plan = tk.flash_bwd_plan(sk, d)
        assert plan["dp"] % 32 == 0 and d <= plan["dp"] < d + 32
        assert plan["bq"] == 32 and 0 < plan["smem"] <= SMEM_LIMIT
        if plan["dq_smem"] is not None:
            assert plan["dq_smem"] <= SMEM_LIMIT
        seen.add(plan["path"])
    assert seen == {"fused", "split"}


def test_plan_refuses_what_the_kernels_do_not_take():
    for sk, d in ((0, 64), (64, 0), (64, 129)):
        with pytest.raises(MXNetError, match="0 < D <= 128"):
            tk.flash_bwd_plan(sk, d)


# ---------------------------------------------------------------------------
# the kernels' arithmetic: split TF32 on the tensor cores
# ---------------------------------------------------------------------------
def _tf32(x):
    """fp32 -> TF32 as cvt.rna.tf32.f32 does it: round to nearest, ties
    away from zero, on the 13 low mantissa bits (bit operations)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """hi carries 10 explicit mantissa bits (rounded to nearest, ties
    away), and hi + lo carries x to 2^-22 of itself."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert _tf32(np.array([one + ulp / 4]))[0] == one
    assert _tf32(np.array([one + ulp / 2]))[0] == one + ulp      # tie: away
    assert _tf32(np.array([-(one + ulp / 2)]))[0] == -(one + ulp)
    assert _tf32(np.array([one + 3 * ulp / 4]))[0] == one + ulp
    x = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi, lo = _split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.abs(hi - x).max() <= np.abs(x).max() * 2.0 ** -11
    err = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert err.max() <= 2.0 ** -22


def _product(passes):
    """a @ b as the kernels compute it: one TF32 product (hi * hi), or
    three (lo * hi + hi * lo + hi * hi), each summed in fp32."""
    def mm(a, b):
        (ah, al), (bh, bl) = _split(a.numpy()), _split(b.numpy())
        ah, al, bh, bl = map(torch.from_numpy, (ah, al, bh, bl))
        if passes == 1:
            return ah @ bh
        return al @ bh + ah @ bl + ah @ bh
    return mm


def _kernel_model(q, k, v, do, lse, delta, causal, scale, lens, mm):
    """The backward's five products, each through `mm`, around the
    kernels' fp32 p and dS (the formula of `_flash_bwd_plain`)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = mm(q, k.transpose(-1, -2)) * scale
    allowed = torch.ones(b, 1, sq, sk, dtype=torch.bool)
    if lens is not None:
        allowed &= (torch.arange(sk)[None, :]
                    < torch.tensor(lens)[:, None])[:, None, None, :]
    if causal:
        allowed &= torch.ones(sq, sk, dtype=torch.bool).tril()
    p = torch.where(allowed, torch.exp(s - lse.reshape(b, h, sq, 1)),
                    torch.zeros(()))
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    dv = mm(p.transpose(-1, -2).contiguous(), do)
    dk = mm(ds.transpose(-1, -2).contiguous(), q)
    dq = mm(ds, k)
    return dq, dk, dv


def _training_case(causal):
    """The training shape (B=32, H=8, S=64, D=64), inputs from numpy seed
    0; key lengths 5-64 as chip_smoke.py draws them, or causal."""
    b, h, s, d = chip_smoke.TRAIN_B, 8, chip_smoke.TRAIN_S, 64
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d)
                                    .astype(np.float32)) for _ in range(4))
    lens = None if causal else chip_smoke._train_attention_cases()[1][-1]
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = tk._flash_plain(q, k, v, causal, d ** -0.5, vl)
    delta = (out * do).sum(-1).reshape(b * h, s)
    return q, k, v, do, lse, delta, causal, d ** -0.5, lens


@pytest.mark.parametrize("causal", [False, True], ids=["lengths", "causal"])
def test_split_tf32_holds_the_float64_limit_and_one_pass_does_not(causal):
    """At the training shape, the five products in split TF32 keep dQ, dK
    and dV within chip_smoke.py's BWD_F64_TOL of float64 autograd; the
    same products in one-pass TF32 fall outside it, at least 10x further
    off."""
    q, k, v, do, lse, delta, causal, scale, lens = _training_case(causal)
    ref = chip_smoke._attention_grads_f64(torch, q, k, v, do, causal, scale,
                                          lens)
    worst = {}
    for passes in (3, 1):
        got = _kernel_model(q, k, v, do, lse, delta, causal, scale, lens,
                            _product(passes))
        close = [torch.allclose(g.double(), r, **chip_smoke.BWD_F64_TOL)
                 for g, r in zip(got, ref)]
        worst[passes] = max((g.double() - r).abs().max().item()
                            for g, r in zip(got, ref))
        if passes == 3:
            assert all(close), worst
        else:
            assert not all(close), worst
    assert worst[1] > 10 * worst[3], worst


# ---------------------------------------------------------------------------
# what the wrapper hands the kernels
# ---------------------------------------------------------------------------
class _FakeLibrary:
    """Records the backward launches; writes nothing."""

    def __init__(self):
        self.calls = []

    def mxtt_flash_bwd_f32(self, *args):
        self.calls.append(("fused", args[7] is not None) + args[10:21])
        return 0

    def mxtt_flash_bwd_dq_f32(self, *args):
        self.calls.append(("dq",) + args[8:17])
        return 0


@pytest.fixture
def card(monkeypatch):
    """CPU tensors dispatched as if they lay on the card, into a fake
    kernel library; the plain version must not run."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tk, "_device_of", lambda *t: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())

    def no_plain(*a):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(tk, "_flash_bwd_plain", no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


def _bwd_inputs(b, h, sq, sk, d, offset=0):
    rng = np.random.RandomState(3)
    base = torch.from_numpy(
        rng.randn(4 * b * h * max(sq, sk) * d + offset).astype(np.float32))
    q = base[offset:offset + b * h * sq * d].view(b, h, sq, d)
    k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                for shape in ((b, h, sk, d), (b, h, sk, d), (b, h, sq, d)))
    lse = torch.zeros(b * h, sq)
    return q, k, v, do, lse, lse.clone()


@pytest.mark.parametrize("sq,sk,d,path", [
    (64, 64, 64, "fused"), (48, 80, 64, "fused"), (64, 128, 64, "fused"),
    (130, 200, 64, "split"), (33, 33, 128, "fused"), (100, 100, 96, "split"),
    (50, 300, 18, "split"), (45, 45, 30, "fused"),
])
def test_wrapper_launches_the_plan(card, sq, sk, d, path):
    """On a card tensor the backward launches the fused kernel (writing
    dQ only on the fused path) and, on the split path, the dQ kernel
    after it, with the plan's BK and shared bytes; each launch counts
    once; rows are copied in 16-byte pieces only when D % 4 == 0."""
    q, k, v, do, lse, delta = _bwd_inputs(2, 2, sq, sk, d)
    plan = tk.flash_bwd_plan(sk, d)
    assert plan["path"] == path
    vl = torch.tensor([sk, 1], dtype=torch.int32)
    dq, dk, dv = tk.flash_attention_bwd(q, k, v, do, lse, delta, False,
                                        0.125, vl)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    vec = int(d % 4 == 0)
    fused = ("fused", path == "fused", 2, 2, sq, sk, d, 0, 0.125,
             plan["bk"], int(path == "fused"), vec, plan["smem"])
    want = [fused]
    if path == "split":
        want.append(("dq", 2, 2, sq, sk, d, 0, 0.125, vec, plan["dq_smem"]))
    assert card.calls == want
    assert tk.LAUNCHES["flash_bwd"] == 1
    assert tk.LAUNCHES["flash_bwd_dq"] == int(path == "split")


def test_wrapper_copies_misaligned_rows_float_by_float(card):
    """A q whose storage starts 4 bytes past a 16-byte boundary is still
    taken, with the float-by-float copies."""
    q, k, v, do, lse, delta = _bwd_inputs(1, 2, 64, 64, 64, offset=1)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    tk.flash_attention_bwd(q, k, v, do, lse, delta)
    assert card.calls[0][11] == 0
    card.calls.clear()
    tk.flash_attention_bwd(q.clone(), k, v, do, lse, delta)
    assert card.calls[0][11] == 1


# ---------------------------------------------------------------------------
# the plain version at the split path's shapes
# ---------------------------------------------------------------------------
@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def test_plain_matches_jax_pallas_interpret_above_one_block(interpret):
    """Sk = 256 > 128 keys at D = 64 (the shapes of the split path):
    dQ/dK/dV through the port's autograd Function (the plain versions
    here) == `jax.grad` through the JAX Pallas kernels in interpret
    mode, with key lengths."""
    b, h, sq, sk, d = 2, 1, 128, 256, 64
    assert tk.flash_bwd_plan(sk, d)["path"] == "split"
    assert jk._pallas_ok(sq) and jk._pallas_ok(sk)
    rng = np.random.RandomState(4)
    q, k, v, w = (rng.randn(*s).astype(np.float32) for s in
                  ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)))
    lengths = [200, 129]
    vl = jnp.asarray(lengths, jnp.int32)
    want = jax.grad(lambda *a: (jk.flash_attention(*a, False, kv_lengths=vl)
                                * w).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk_, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tk.flash_attention(tq, tk_, tv,
                             kv_lengths=torch.tensor(lengths,
                                                     dtype=torch.int32))
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, ref in zip("qkv", (tq, tk_, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   **BWD_TOL, err_msg=f"d{name}")
