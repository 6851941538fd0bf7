"""The design of the port's flash-attention forward (`csrc/flash_fwd.cu`),
checked on the CPU: its launch plan, a model of its split-TF32
arithmetic and online softmax against float64, and what the wrapper
hands the kernel. The kernel itself runs only on the card, where
`chip_smoke.py` holds it against `_flash_plain` and float64; the plain
version's parity with the JAX Pallas kernel is in
tests/test_torch_kernels.py."""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

SRC = Path(tk.__file__).resolve().parent / "csrc" / "flash_fwd.cu"
# the most dynamic shared memory one block may take on Hopper
SMEM_LIMIT = 232448
WIDTHS = (8, 18, 32, 64, 96, 128)
LOG2E = np.float32(1.4426950408889634)


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


# (row warps, key-split warps) of every block the kernel takes
SPLITS = [(rw, ks) for rw in (1, 2, 4) for ks in (1, 2, 4, 8)
          if rw * ks <= 8]


def _smem(dp, rw, ks, bk):
    return 4 * (16 * rw + 4 * ks * bk) * (dp + 4)


def test_plan_constants_are_the_kernels():
    """The plan's rows a warp, warps a block and keys of a warp's tile
    are the ones `flash_fwd.cu` compiles in."""
    assert tk._FWD_WARP_ROWS == _cu_constant("kWarpRows") == 16
    assert tk._FWD_MAX_ROW_WARPS == _cu_constant("kMaxRowWarps") == 4
    assert tk._FWD_MAX_WARPS == _cu_constant("kMaxWarps") == 8
    assert tk._FWD_WIDE_BK == _cu_constant("kWideBK") == 32
    assert tk._FWD_SPLIT_BK == _cu_constant("kSplitBK") == 16


@pytest.mark.parametrize("d", WIDTHS)
def test_every_plan_fits_one_block(d):
    """Every plan fits Hopper's per-block shared memory at every padded
    width, and its bytes are the kernel's formula: the Q rows and two
    buffers of ks K / V tiles of bk keys, DP + 4 floats a row. A key
    split of 8 warps of 16 keys fits up to DP = 96; at 128 the plan
    halves it."""
    dp = tk.flash_fwd_plan(1, 1, 1, d)["dp"]
    assert dp % 32 == 0 and d <= dp < d + 32
    assert (_smem(dp, 1, 8, 16) <= SMEM_LIMIT) == (dp <= 96)
    assert _smem(dp, 4, 1, 32) <= SMEM_LIMIT
    for bh, sq, sk in ((1, 1, 1), (8, 128, 128), (256, 64, 64),
                       (192, 512, 512), (3, 1000, 17), (1, 16, 4096)):
        plan = tk.flash_fwd_plan(bh, sq, sk, d)
        assert (plan["rw"], plan["ks"]) in SPLITS
        assert plan["bk"] == (32 if plan["rw"] == 4 else 16)
        assert plan["rows"] == 16 * plan["rw"]
        assert plan["warps"] == plan["rw"] * plan["ks"]
        assert plan["smem"] == _smem(dp, plan["rw"], plan["ks"], plan["bk"])
        assert plan["smem"] <= SMEM_LIMIT


def test_plans_of_the_paths():
    """The serving prefill (B*H = 8, S = 128) takes 16 rows a block, 64
    blocks, with the keys split over eight warps of 16-key tiles; the
    training step's attentions, BERT's and the long drive take 64 rows a
    block, one warp each walking all 32-key tiles."""
    serve = tk.flash_fwd_plan(8, 128, 128, 64)
    assert (serve["rw"], serve["ks"], serve["bk"]) == (1, 8, 16)
    assert serve["smem"] == 143616
    for case in chip_smoke._train_attention_cases():
        b, h, sq, sk, d = case[:5]
        plan = tk.flash_fwd_plan(b * h, sq, sk, d)
        assert (plan["rw"], plan["ks"], plan["bk"]) == (4, 1, 32)
    bert = tk.flash_fwd_plan(chip_smoke.BERT_B * chip_smoke.BERT_H,
                             chip_smoke.BERT_S, chip_smoke.BERT_S, 64)
    assert (bert["rw"], bert["ks"], bert["bk"], bert["smem"]) \
        == (4, 1, 32, 52224)
    long = tk.flash_fwd_plan(chip_smoke.LONG_B * chip_smoke.LONG_H,
                             chip_smoke.LONG_S, chip_smoke.LONG_S, 64)
    assert (long["rw"], long["ks"]) == (4, 1)
    # a key split never walks tiles wholly past Sk, nor exceeds a
    # block's shared memory
    assert tk.flash_fwd_plan(8, 128, 64, 64)["ks"] == 4
    assert tk.flash_fwd_plan(8, 128, 16, 64)["ks"] == 1
    assert tk.flash_fwd_plan(8, 128, 17, 64)["ks"] == 2
    assert tk.flash_fwd_plan(8, 128, 128, 96)["ks"] == 8
    assert tk.flash_fwd_plan(8, 128, 128, 128)["ks"] == 4
    half = tk.flash_fwd_plan(100, 64, 128, 64)
    assert (half["rw"], half["ks"], half["bk"]) == (2, 4, 16)


@pytest.mark.parametrize("bh", [1, 3, 8, 32, 100, 192, 256])
def test_plan_takes_the_widest_block_that_fills_the_card(bh):
    """64 rows a block unless that grid leaves SMs of the card without
    a block; then the most rows whose grid fills it, or 16, and the
    warps up to 8 split the keys, as far as their tiles reach Sk."""
    for sq in (1, 16, 17, 64, 128, 200, 512, 1024):
        for sk in (1, 16, 17, 32, 33, 64, 65, 100, 128, 512):
            plan = tk.flash_fwd_plan(bh, sq, sk, 64)
            rw, ks, bk = plan["rw"], plan["ks"], plan["bk"]
            blocks = bh * -(-sq // plan["rows"])
            if rw < 4:
                assert bh * -(-sq // (2 * plan["rows"])) < tk._CARD_SMS
            if rw > 1:
                assert blocks >= tk._CARD_SMS
            if rw == 4:
                assert ks == 1
            else:
                assert ks <= 8 // rw
                assert ks == 8 // rw or bk * ks >= sk
                assert ks == 1 or bk * ks // 2 < sk


def test_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 64, 64, 0), (1, 64, 64, 129), (0, 64, 64, 64),
                 (1, 0, 64, 64), (1, 64, 0, 64)):
        with pytest.raises(MXNetError, match="0 < D <= 128"):
            tk.flash_fwd_plan(*args)


# ---------------------------------------------------------------------------
# the kernel's arithmetic: split TF32 and the online softmax over tiles
# ---------------------------------------------------------------------------
def _tf32(x):
    """fp32 -> TF32 as cvt.rna.tf32.f32 does it: round to nearest, ties
    away from zero, on the 13 low mantissa bits (bit operations)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def _mm(passes):
    """a @ b as the kernel computes it: one TF32 product (hi * hi), or
    three (lo * hi + hi * lo + hi * hi), each summed in fp32."""
    def mm(a, b):
        a, b = a.numpy(), b.numpy()
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        if passes == 1:
            return torch.from_numpy(ah @ bh)
        return torch.from_numpy(al @ bh + ah @ bl + ah @ bh)
    return mm


def _merge(a, b):
    """Two softmax states (m, l, O) of one row group as the kernel's key
    split merges them."""
    (m, l, acc), (pm, pl, pacc) = a, b
    mx = torch.maximum(m, pm)
    x, y = torch.exp2((m - mx) * LOG2E), torch.exp2((pm - mx) * LOG2E)
    return mx, l * x + pl * y, acc * x + pacc * y


def _kernel_model(q, k, v, causal, scale, lens, mm, ks=1, bk=32):
    """The forward as the kernel walks it: bk-key tiles (with a key
    split of `ks` warps, warp w takes tiles w, w + ks, ..., and the
    states merge at the end), S through `mm`, scaled and masked to
    -1e30, the running max and sum in fp32 with exp2 and masked p set to
    0, O rescaled and P V added through `mm`, then the guarded divide
    and lse = m + log(max(l, 1e-30))."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kend = torch.tensor(lens if lens is not None else [sk] * b)
    states = []
    for w in range(ks):
        m = torch.full((b, h, sq, 1), -1e30)
        l = torch.zeros(b, h, sq, 1)
        acc = torch.zeros(b, h, sq, d)
        for k0 in range(w * bk, sk, ks * bk):
            kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
            kj = torch.arange(k0, k0 + kt.shape[2])
            s = mm(q, kt.transpose(-1, -2).contiguous()) * np.float32(scale)
            allowed = (kj[None, :] < kend[:, None])[:, None, None, :]
            if causal:
                allowed = allowed & (kj[None, :]
                                     <= torch.arange(sq)[:, None])
            s = torch.where(allowed, s, torch.tensor(-1e30))
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            a = torch.exp2((m - mx) * LOG2E)
            p = torch.where(allowed, torch.exp2(s * LOG2E - mx * LOG2E),
                            torch.zeros(()))
            l = l * a + p.sum(-1, keepdim=True)
            acc = acc * a + mm(p.contiguous(), vt.contiguous())
            m = mx
        states.append((m, l, acc))
    m, l, acc = states[0]
    for state in states[1:]:
        m, l, acc = _merge((m, l, acc), state)
    den = l.clamp(min=1e-30)
    return acc / den, (m + torch.log(den)).reshape(b * h, sq)


@pytest.mark.parametrize("causal,lens", [(False, [300, 512]), (True, None)],
                         ids=["lengths", "causal"])
def test_split_tf32_holds_float64_and_one_pass_does_not(causal, lens):
    """At S = 512 (BERT's length; lengths that end inside a tile, or
    causal), the kernel's arithmetic in split TF32 keeps out and lse
    within chip_smoke.py's FLASH_F64_RATIO times the fp32 plain
    version's distance from float64; one-pass TF32 falls outside it."""
    b, h, s, d = 2, 2, 512, 64
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               for _ in range(3))
    scale = d ** -0.5
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    o64, l64, live = chip_smoke._attention_f64(torch, q, k, v, causal,
                                               scale, lens)
    assert live.all()

    def dist(out, lse):
        return ((out.double() - o64).abs().max().item(),
                (lse.double() - l64).abs().max().item())
    plain = dist(*tk._flash_plain(q, k, v, causal, scale, vl))
    split = dist(*_kernel_model(q, k, v, causal, scale, lens, _mm(3)))
    one = dist(*_kernel_model(q, k, v, causal, scale, lens, _mm(1)))
    ratio = chip_smoke.FLASH_F64_RATIO
    assert all(x <= ratio * p for x, p in zip(split, plain)), (split, plain)
    assert all(x > ratio * p for x, p in zip(one, plain)), (one, plain)
    out, lse = _kernel_model(q, k, v, causal, scale, lens, _mm(3))
    ref, ref_lse = tk._flash_plain(q, k, v, causal, scale, vl)
    torch.testing.assert_close(out, ref, **chip_smoke.FLASH_TOL)
    torch.testing.assert_close(lse, ref_lse, **chip_smoke.FLASH_TOL)


def test_tile_walk_matches_one_pass_softmax():
    """The tile walk itself (fp32 products, so only the order differs)
    equals the plain version with and without a key split (the plans'
    tiles), causal with lengths and a zero-length row (written as
    zeros)."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(3, 2, 70, 18).astype(np.float32))
               for _ in range(3))
    lens = [0, 41, 70]
    ref, ref_lse = tk._flash_plain(q, k, v, True, 0.3,
                                   torch.tensor(lens, dtype=torch.int32))
    for ks, bk in ((1, 32), (2, 16), (8, 16)):
        out, lse = _kernel_model(q, k, v, True, 0.3, lens, torch.matmul, ks,
                                 bk)
        torch.testing.assert_close(out, ref, **chip_smoke.FLASH_TOL)
        torch.testing.assert_close(lse[2:], ref_lse[2:],
                                   **chip_smoke.FLASH_TOL)
        assert out[0].abs().max().item() == 0.0


# ---------------------------------------------------------------------------
# what the wrapper hands the kernel
# ---------------------------------------------------------------------------
class _FakeLibrary:
    """Records the forward launches; writes nothing."""

    def __init__(self):
        self.calls = []

    def mxtt_flash_fwd_f32(self, *args):
        self.calls.append((args[3] is not None,) + args[6:18])
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
    monkeypatch.setattr(tk, "_flash_plain", no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


def _qkv(b, h, sq, sk, d, offset=0):
    rng = np.random.RandomState(2)
    base = torch.from_numpy(
        rng.randn(b * h * sq * d + offset).astype(np.float32))
    q = base[offset:].view(b, h, sq, d)
    k, v = (torch.from_numpy(rng.randn(b, h, sk, d).astype(np.float32))
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 8, 128, 128, 64, False), (32, 8, 64, 64, 64, True),
    (32, 8, 48, 80, 64, False), (16, 12, 512, 512, 64, False),
    (1, 4, 64, 200, 64, True), (1, 4, 200, 64, 64, True),
    (2, 2, 45, 45, 30, True), (2, 3, 100, 70, 128, False),
])
def test_wrapper_launches_the_plan(card, b, h, sq, sk, d, causal):
    """On a card tensor the forward launches the kernel once with the
    plan's row warps, key split and shared bytes (causal with Sq != Sk
    too), rows in 16-byte pieces only when D % 4 == 0, and counts the
    launch."""
    q, k, v = _qkv(b, h, sq, sk, d)
    vl = torch.full((b,), sk, dtype=torch.int32)
    plan = tk.flash_fwd_plan(b * h, sq, sk, d)
    out, lse = tk.flash_attention_fwd(q, k, v, causal, 0.125, vl)
    assert out.shape == q.shape and lse.shape == (b * h, sq)
    assert card.calls == [(True, b, h, sq, sk, d, int(causal), 0.125,
                           plan["bk"], plan["rw"], plan["ks"],
                           int(d % 4 == 0), plan["smem"])]
    assert tk.LAUNCHES == dict(dict.fromkeys(tk.LAUNCHES, 0), flash_fwd=1)


def test_wrapper_copies_misaligned_rows_float_by_float(card):
    """A q whose storage starts 4 bytes past a 16-byte boundary is still
    taken, with the float-by-float copies; no lengths pass NULL."""
    q, k, v = _qkv(1, 2, 64, 64, 64, offset=1)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    tk.flash_attention_fwd(q, k, v)
    tk.flash_attention_fwd(q.clone(), k, v)
    assert [(c[0], c[11]) for c in card.calls] == [(False, 0), (False, 1)]


def test_wrapper_checks_what_the_kernel_takes(card):
    """Inputs the kernel would misread are refused before any launch:
    a non-contiguous q, an empty head (D = 0; any wider head is taken,
    by the wide kernels above D = 128), float64, mismatched k / v,
    lengths of the wrong type or shape."""
    q, k, v = _qkv(2, 2, 16, 16, 8)
    strided = torch.randn(2, 2, 8, 16).transpose(2, 3)
    bad = [((strided, k, v), None, "contiguous"),
           ((*_qkv(1, 1, 4, 4, 0),), None, "D > 0"),
           ((q.double(), k.double(), v.double()), None, "float32"),
           ((q, k, v[:, :, :8]), None, "do not agree"),
           ((q, k, v), torch.tensor([16, 16]), "int32"),
           ((q, k, v), torch.tensor([16], dtype=torch.int32), "int32")]
    for args, vl, match in bad:
        with pytest.raises(MXNetError, match=match):
            tk.flash_attention_fwd(*args, kv_lengths=vl)
    assert card.calls == [] and tk.LAUNCHES["flash_fwd"] == 0


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    """Causal with Sq != Sk runs on the CPU both ways (the top-left
    mask) and launches no kernel."""
    tk.reset_launch_counts()
    for sq, sk in ((5, 9), (9, 5)):
        q, k, v = _qkv(1, 2, sq, sk, 8)
        out, lse = tk.flash_attention_fwd(q, k, v, causal=True)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8)
        s = s.masked_fill(torch.ones(sq, sk, dtype=torch.bool).tril()
                          .logical_not(), float("-inf"))
        torch.testing.assert_close(out, torch.softmax(s, -1) @ v,
                                   **chip_smoke.FLASH_TOL)
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)
