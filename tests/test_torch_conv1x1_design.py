"""The design of the port's conv1x1 + BatchNorm-statistics kernel
(`csrc/conv1x1_bn_stats.cu`), checked on the CPU: its launch plan, a
model of its split-TF32 arithmetic against float64, a model of its
fixed-order column reduction, and what the wrapper hands the kernel.
The kernel itself runs only on the card, where `chip_smoke.py` phases 2b
and 8 hold it against float64; the plain version's parity with the JAX
Pallas kernel is in tests/test_torch_conv_kernels.py."""
import contextlib
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

SRC = Path(tk.__file__).resolve().parent / "csrc" / "conv1x1_bn_stats.cu"
# the most dynamic shared memory one block may take on Hopper
SMEM_LIMIT = 232448
DTYPES = (torch.float32, torch.bfloat16)
# every shape phases 2b and 8 give the kernel: the probe's four, the odd
# one, and ResNet-50's live stride-1 1x1 convolutions at B = 128
SHAPES = sorted({*chip_smoke.CONV1X1_SHAPES, chip_smoke.CONV1X1_ODD,
                 *chip_smoke.RESNET_CONV1X1})


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


def test_plan_constants_are_the_kernels():
    """The plan's warps, tile rows, chunks, stages and paddings are the
    ones `conv1x1_bn_stats.cu` compiles in."""
    assert tk._C1_WARPS == _cu_int("kWarps") == 8
    assert tk._C1_BM == _cu_int("kBM") == 128
    f32 = tk._C1_F32
    assert f32["bk"] == _cu_int("kF32BK") == 32
    assert f32["stages"] == _cu_int("kF32Stages")
    assert f32["pad_a"] == _cu_int("kF32PadA")
    assert f32["pad_b"] == _cu_int("kF32PadB")
    assert tk._C1_BF16["bk"] == _cu_int("kBF16BK") == 64
    assert tk._C1_BF16["stages"] == _cu_int("kBF16Stages")
    assert _cu_int("kSmemLimit") == SMEM_LIMIT
    assert tk._SMEM_LIMIT <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [1, 50, 64, 65, 128, 200, 256, 257, 2048])
def test_every_plan_fits_one_block(dtype, n):
    """Every plan fits Hopper's per-block shared memory, and its bytes
    are the kernel's formula: 1024 to align the swizzled tiles; fp32: 3
    ring stages of raw x (128 rows of 32 + 4 floats) and w (32 rows of
    BN + 8) tiles, and the split planes (x hi / lo, w^T hi / lo: 128 or
    BN rows of 128 bytes); bf16: 5 stages of swizzled x (128 rows of 128
    bytes) and w (BN / 64 blocks of 64 such rows); both: the y staging
    (8 rows of BN + 8 a warp) and the column sums (a row a 16-row
    warp)."""
    plan = tk.conv1x1_plan(1000, 64, n, dtype)
    bn, bm, bk, s = plan["bn"], plan["bm"], plan["bk"], plan["stages"]
    assert bm == 128 and bn == (64 if n <= 64 else 128)
    if dtype == torch.float32:
        assert (bk, s) == (32, 3)
        tiles = 4 * s * (bm * 36 + bk * (bn + 8)) + 2 * (bm + bn) * 128
        esize = 4
    else:
        assert (bk, s) == (64, 5)
        tiles = s * (bm + bn) * 128
        esize = 2
    smem = 1024 + tiles + esize * 8 * 8 * (bn + 8) + 2 * (bm // 16) * bn * 4
    assert plan["smem"] == smem <= SMEM_LIMIT


def test_live_shapes_are_resnet50s():
    """`chip_smoke.RESNET_CONV1X1` is the port's resnet50_v1: its 30
    stride-1 1x1 convolutions in 9 (Cin, Cout) pairs at the stages'
    56, 28, 14 and 7 (a 64 x 64 forward here: 16, 8, 4, 2)."""
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1", layout="NHWC")
    net.initialize(ctx=mx.cpu())
    convs = [m for m in net.modules() if isinstance(m, mx.gluon.nn.Conv2D)
             and m._kernel == (1, 1) and m._strides == (1, 1)]
    seen = []
    hooks = [c.register_forward_hook(lambda mod, args, out: seen.append(
        (args[0]._data.shape[1], args[0]._data.shape[-1],
         mod.weight.data()._data.shape[0]))) for c in convs]
    try:
        x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
        net(mx.nd.array(x, ctx=mx.cpu()))
    finally:
        for h in hooks:
            h.remove()
    side = {16: 56, 8: 28, 4: 14, 2: 7}
    live = Counter((128 * side[h] ** 2, k, n) for h, k, n in seen)
    assert live == Counter(chip_smoke.RESNET_CONV1X1)
    assert sum(live.values()) == 30 and len(live) == 9


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_fills_the_card(dtype, m, k, n):
    """At every shape of phases 2b and 8 the grid is one block an SM on
    as many of the 132 SMs as whole column strips allow, or one block a
    row tile; row tiles spread over the blocks evenly; the scratch rows
    are the row groups; 16-byte copies wherever K and N allow."""
    plan = tk.conv1x1_plan(m, k, n, dtype)
    tiles_m = -(-m // plan["bm"])
    gm, tn = plan["grid_m"], plan["tiles_n"]
    assert tn == -(-n // plan["bn"]) and 1 <= gm <= tiles_m
    blocks = gm * tn
    assert blocks <= tk._CARD_SMS
    assert gm == tiles_m or blocks > tk._CARD_SMS - tn
    assert plan == tk.conv1x1_plan(m, k, n, dtype)
    epv = 16 // (4 if dtype == torch.float32 else 2)
    assert plan["vec"] == (k % epv == 0 and n % epv == 0)
    if (m, k, n) != chip_smoke.CONV1X1_ODD:
        assert plan["vec"] and blocks >= 128


# ---------------------------------------------------------------------------
# the kernel's arithmetic: split TF32 with per-chunk sums
# ---------------------------------------------------------------------------
def _tf32(x):
    """fp32 -> TF32 as cvt.rna.tf32.f32 does it: round to nearest, ties
    away from zero, on the 13 low mantissa bits (bit operations)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def _kernel_product(x, w, passes, bk=32):
    """x @ w as the fp32 kernel sums it: each K chunk of `bk` in zeroed
    fp32 accumulators, from one TF32 product (hi * hi) or three (lo * hi
    + hi * lo + hi * hi), added to the running sums in fp32 (tile_add)."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], bk):
        a, b = x[:, k0:k0 + bk], w[k0:k0 + bk]
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        part = ah @ bh if passes == 1 else al @ bh + ah @ bl + ah @ bh
        acc = acc + part
    return acc


def test_split_tf32_holds_float64_and_one_pass_does_not():
    """At K = 2048 (the deepest live convolution) the kernel's split-TF32
    arithmetic keeps y, mean and meansq within chip_smoke.py's float64
    limits and within FLASH_F64_RATIO times the fp32 plain version's
    distance from float64; one-pass TF32 falls outside the y limit."""
    rng = np.random.RandomState(0)
    m, k, n = 512, 2048, 64
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    y64 = x.astype(np.float64) @ w.astype(np.float64)
    msq64 = (y64 * y64).mean(0)
    y_lim = chip_smoke.CONV1X1_Y_RTOL * np.abs(y64).max()
    s_lim = chip_smoke.CONV1X1_STATS_RTOL * np.abs(msq64).max() \
        + chip_smoke.CONV1X1_STATS_ATOL

    def dist(y):
        y = y.astype(np.float32)
        return (np.abs(y - y64).max(),
                np.abs(y.mean(0, dtype=np.float32) - y64.mean(0)).max(),
                np.abs((y * y).mean(0, dtype=np.float32) - msq64).max())
    plain = dist(x @ w)
    split = dist(_kernel_product(x, w, 3))
    one = dist(_kernel_product(x, w, 1))
    assert split[0] <= y_lim and max(split[1:]) <= s_lim, (split, y_lim)
    ratio = chip_smoke.FLASH_F64_RATIO
    assert all(s <= ratio * p for s, p in zip(split, plain)), (split, plain)
    assert one[0] > y_lim and one[0] > ratio * plain[0], (one, y_lim)


# ---------------------------------------------------------------------------
# the statistics: a fixed order of sums, no atomics
# ---------------------------------------------------------------------------
def _block_sums(acc, plan, bx, by):
    """Column sums (s, q) of block (bx, by) in the kernel's order: a lane
    adds its rows of every row tile the block walks to its columns' sums
    (in registers), then xor shuffles 4, 8, 16 reduce the 8 lanes of a
    column, then the block adds its 8 warps (16 rows each) in order."""
    m = acc.shape[0]
    bm, bn = plan["bm"], plan["bn"]
    n0 = by * bn
    cols = acc[:, n0:n0 + bn]
    tiles = range(bx, -(-m // bm), plan["grid_m"])
    ws, wq = [], []
    for warp in range(bm // 16):
        lane_s, lane_q = [], []
        for g in range(8):
            s = np.zeros(cols.shape[1], np.float32)
            q = np.zeros(cols.shape[1], np.float32)
            for tm in tiles:
                for r in (tm * bm + 16 * warp + g, tm * bm + 16 * warp + 8 + g):
                    if r < m:
                        v = cols[r]
                        s = s + v
                        q = np.float32(v * v + q)   # fmaf in fp32
            lane_s.append(s)
            lane_q.append(q)
        for off in (1, 2, 4):   # xor 4, 8, 16 over lanes = g xor off
            lane_s = [lane_s[g] + lane_s[g ^ off] for g in range(8)]
            lane_q = [lane_q[g] + lane_q[g ^ off] for g in range(8)]
        ws.append(lane_s[0])
        wq.append(lane_q[0])
    s = np.zeros(cols.shape[1], np.float32)
    q = np.zeros(cols.shape[1], np.float32)
    for a, b in zip(ws, wq):
        s, q = s + a, q + b
    return s, q


def _kernel_stats(acc, plan, order):
    """mean, meansq as the kernel and its finalize compute them: blocks
    in `order` (the card's, any) each write their scratch row; the
    finalize sums rows g, g + 8, ... per group, then the 8 groups, in
    order, and scales by 1 / M."""
    m, n = acc.shape
    gm = plan["grid_m"]
    part = np.full((2, gm, n), np.nan, np.float32)
    for bx, by in order:
        s, q = _block_sums(acc, plan, bx, by)
        part[0, bx, by * plan["bn"]:(by + 1) * plan["bn"]] = s[:n]
        part[1, bx, by * plan["bn"]:(by + 1) * plan["bn"]] = q[:n]
    out = []
    for p in part:
        groups = []
        for g in range(8):
            t = np.zeros(n, np.float32)
            for r in range(g, gm, 8):
                t = t + p[r]
            groups.append(t)
        t = np.zeros(n, np.float32)
        for g in groups:
            t = t + g
        out.append(t * np.float32(1.0 / m))
    return out


def test_column_reduction_is_fixed_order():
    """The statistics take one order whatever order the blocks run in:
    two calls, and calls with the blocks finishing in other orders, are
    bit-identical, and within chip_smoke.py's float64 limit. Adding the
    blocks' sums in the order they finish (as atomics would) is not."""
    rng = np.random.RandomState(3)
    m, n = 3000, 300
    acc = (rng.randn(m, n) * 3 + 1).astype(np.float32)
    plan = dict(tk.conv1x1_plan(m, 64, n, torch.float32), grid_m=9)
    blocks = [(bx, by) for by in range(plan["tiles_n"])
              for bx in range(plan["grid_m"])]
    first = _kernel_stats(acc, plan, blocks)
    for seed in range(3):
        order = [blocks[i] for i in np.random.RandomState(seed)
                 .permutation(len(blocks))]
        again = _kernel_stats(acc, plan, order)
        for a, b in zip(first, again):
            assert a.tobytes() == b.tobytes()
    y64 = acc.astype(np.float64)
    msq64 = (y64 * y64).mean(0)
    lim = chip_smoke.CONV1X1_STATS_RTOL * msq64.max() \
        + chip_smoke.CONV1X1_STATS_ATOL
    assert np.abs(first[0] - y64.mean(0)).max() <= lim
    assert np.abs(first[1] - msq64).max() <= lim
    # atomics: the 9 row groups' sums of column block 0 in finish order
    rows = [_block_sums(acc, plan, bx, 0)[1] for bx in range(9)]
    finishes = set()
    for seed in range(8):
        t = np.zeros_like(rows[0])
        for i in np.random.RandomState(seed).permutation(9):
            t = t + rows[i]
        finishes.add(t.tobytes())
    assert len(finishes) > 1


# ---------------------------------------------------------------------------
# what the wrapper hands the kernel
# ---------------------------------------------------------------------------
class _FakeLibrary:
    """Records the conv1x1 launches; writes nothing."""

    def __init__(self):
        self.calls = []

    def _record(self, dtype, args):
        self.calls.append((dtype,) + args[7:14])
        return 0

    def mxtt_conv1x1_stats_f32(self, *args):
        return self._record("f32", args)

    def mxtt_conv1x1_stats_bf16(self, *args):
        return self._record("bf16", args)


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
    monkeypatch.setattr(tk, "_conv1x1_stats_plain", no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(1000, 64, 256), (777, 512, 128),
                                   (300, 77, 50), (64, 24, 2048),
                                   (129, 8, 8)])
def test_wrapper_launches_the_plan(card, dtype, m, k, n):
    """On card tensors the wrapper launches the kernel once with the
    plan's column block, row groups, copy form and shared bytes, and
    counts the launch under its dtype's name."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(k, n).astype(np.float32)).to(dtype)
    plan = tk.conv1x1_plan(m, k, n, dtype)
    y, mean, msq = tk.conv1x1_bn_stats(x, w)
    assert y.shape == (m, n) and y.dtype == dtype
    assert mean.shape == msq.shape == (n,) and mean.dtype == torch.float32
    tag = "f32" if dtype == torch.float32 else "bf16"
    assert card.calls == [(tag, m, k, n, plan["bn"], plan["grid_m"],
                           int(plan["vec"]), plan["smem"])]
    name = "conv1x1_bn_stats" + ("" if tag == "f32" else "_bf16")
    assert tk.LAUNCHES == dict(dict.fromkeys(tk.LAUNCHES, 0), **{name: 1})


def test_wrapper_copies_misaligned_rows_element_by_element(card):
    """An x whose storage starts past a 16-byte boundary is still taken,
    with the element-by-element copies; an aligned copy of it is not."""
    base = torch.randn(300 * 64 + 1)
    x = base[1:].view(300, 64)
    w = torch.randn(64, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    tk.conv1x1_bn_stats(x, w)
    tk.conv1x1_bn_stats(x.clone(), w)
    assert [c[6] for c in card.calls] == [0, 1]


def test_wrapper_checks_what_the_kernel_takes(card):
    """Inputs the kernel would misread are refused before any launch."""
    for x, w, match in [(torch.ones(4, 3), torch.ones(4, 5), "agree on K"),
                        (torch.ones(3, 4).t(), torch.ones(3, 5),
                         "contiguous"),
                        (torch.ones(4, 3).half(), torch.ones(3, 5).half(),
                         "float32 or bfloat16")]:
        with pytest.raises(MXNetError, match=match):
            tk.conv1x1_bn_stats(x, w)
    assert card.calls == [] and all(v == 0 for v in tk.LAUNCHES.values())


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    tk.reset_launch_counts()
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(70, 33).astype(np.float32))
    w = torch.from_numpy(rng.randn(33, 20).astype(np.float32))
    y, mean, msq = tk.conv1x1_bn_stats(x, w)
    y64 = x.double() @ w.double()
    torch.testing.assert_close(y.double(), y64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mean.double(), y64.mean(0), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(msq.double(), (y64 * y64).mean(0), rtol=1e-5,
                               atol=1e-5)
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)
