"""The design of the bfloat16 forms of the flash and LayerNorm kernels
(`mxtt_flash_fwd_bf16`, `mxtt_flash_bwd_bf16`, `mxtt_flash_bwd_dq_bf16`,
`mxtt_layer_norm_bf16`), checked on the CPU: their launch plans against
the .cu's constants and shared-memory formulas, the 128-byte swizzle the
wgmma kernels lay their tiles in, the copies and mbarriers the flash
sources share (`tma.cuh`), what the build binds, what the wrappers hand
the kernels, and that the wide LayerNorm reads its row once. The kernels
run only on the
card: the `card` tests hold each against its plain version there, within
chip_smoke.py's bf16 limits (this file imports no JAX, so it runs on the
card's machine: `python3 -m pytest --noconftest -m card
tests/test_torch_bf16_design.py`).
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

CSRC = Path(tk.__file__).resolve().parent / "csrc"
BWD = CSRC / "flash_bwd.cu"
FWD = CSRC / "flash_fwd.cu"
TMA = CSRC / "tma.cuh"
# the most dynamic shared memory one block may take on Hopper
SMEM_LIMIT = 232448
WIDTHS = (8, 18, 30, 32, 64, 96, 128)
BF = torch.bfloat16


def _cu_constant(name, src=BWD):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         src.read_text()).group(1))


def test_bf16_sources_and_entries_are_built():
    """The bf16, wgmma and TMA headers are hashed into the build's name
    with the sources, and the four bf16 entries are bound with the
    arguments of their fp32 forms (LayerNorm's with gamma's dtype and the
    16-byte flag)."""
    for head in ("bf16_mma.cuh", "wgmma.cuh", "tma.cuh"):
        assert head in _build.HEADERS
    sig = _build._SIGNATURES
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_dq"):
        assert sig[f"mxtt_{name}_bf16"] == sig[f"mxtt_{name}_f32"]
    assert sig["mxtt_layer_norm_bf16"][:9] == sig["mxtt_layer_norm_f32"][:9]
    assert len(sig["mxtt_layer_norm_bf16"]) == 12
    for src, entries in (("flash_fwd.cu", ["mxtt_flash_fwd_bf16"]),
                         ("flash_bwd.cu", ["mxtt_flash_bwd_bf16",
                                           "mxtt_flash_bwd_dq_bf16"]),
                         ("layer_norm.cu", ["mxtt_layer_norm_bf16"])):
        text = (CSRC / src).read_text()
        for e in entries:
            assert f'extern "C" int {e}(' in text
    # no mma.sync bf16 product is left in any source or header
    for path in CSRC.iterdir():
        assert "m16n8k16.row.col.f32.bf16" not in path.read_text(), path
    # the forward's byte formula is `_fwd_bf16_plan`'s
    fwd = FWD.read_text()
    for line in ("return 1024 +",
                 "sizeof(bf16) * ((size_t)3 * kBf16WgRows * rw * DP +",
                 "(size_t)2 * kBf16Stages * BK * DP) +",
                 "sizeof(uint64_t) * (2 * kBf16Stages + 4);"):
        assert line in fwd, line
    # the backward's byte formulas are `_flash_bwd_plan_bf16`'s
    bwd = BWD.read_text()
    for line in ("sizeof(bf16) * ((size_t)2 * BK * DP +",
                 "(size_t)2 * bf16_stages(DP) * kBf16BQ * DP +",
                 "(dq ? (size_t)kBf16BQ * BK : 0)) +",
                 "sizeof(float) * 2 * bf16_stages(DP) * kBf16LV +",
                 "sizeof(uint64_t) * (2 * bf16_stages(DP) + 1);",
                 "sizeof(bf16) * ((size_t)2 * kBf16DqBQ * DP +",
                 "(size_t)2 * bf16_stages(DP) * kBf16DqBK * DP) +"):
        assert line in bwd, line


# the helpers that feed the wgmma kernels, one header's
_TMA_HELPERS = ("exp2_approx", "sw_off", "copy_rows_sw", "zero_pad_sw",
                "smem_u32", "mbar_init", "mbar_init_fence", "mbar_expect_tx",
                "mbar_arrive", "mbar_wait", "tma_load_3d", "tma_load_1d",
                "encode_tiled", "map_rows")


@pytest.mark.parametrize("helper", _TMA_HELPERS)
def test_copy_helpers_live_in_one_header(helper):
    """Each mbarrier, TMA, swizzle and tensor-map helper is defined in
    `tma.cuh` alone, and both flash sources include it."""
    head = TMA.read_text()
    assert re.search(rf"(void|float|int|bool|uint32_t|EncodeTiled) "
                     rf"{helper}\(", head), helper
    for src in (FWD, BWD):
        text = src.read_text()
        assert '#include "tma.cuh"' in text
        assert not re.search(rf"(void|float|int|bool|uint32_t|EncodeTiled) "
                             rf"{helper}\(", text), (src.name, helper)


def test_bf16_backward_runs_on_wgmma_alone():
    """The bf16 backward kernels (one template with the float16 forms)
    compute every product with wgmma.mma_async (SS for S^T, dP^T, S and
    dP; RS for dV, dK and dQ) on the element type T, and no mma.sync is
    left in them; the wgmma helpers are one header's, shared with the
    conv1x1 kernel, each instruction spelled once for both types."""
    bwd = BWD.read_text()
    start = bwd.index("// bfloat16 and float16 forms, on wgmma")
    body = bwd[start:bwd.index("}  // namespace", start)]
    assert "mma_bf16(" not in body and "mma_tf32(" not in body
    assert "frag_b_trans" not in body and "frag_a(" not in body
    for kernel in ("flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel"):
        assert f"{kernel}(" in body
    assert body.count("wgmma_ss<64, 0, T>(") == 4    # S^T, dP^T, S, dP
    assert body.count("wgmma_rs<DP, 1, T>(") == 3    # dV, dK, dQ
    assert body.count("wgmma_ss<DP, 1, T>(") == 1    # the fused dQ
    head = (CSRC / "wgmma.cuh").read_text()
    for n in ("64", "128"):
        assert f'"wgmma.mma_async.sync.aligned.m64n{n}k16.f32." TY "." TY' \
            in head
        for form in ("SS", "RS"):
            for ty in ("bf16", "f16"):
                assert f'MXTT_{form}_N{n}("{ty}");' in head
    assert "{%64, %65, %66, %67}, %68, p, 1, 1, %70;" in head   # RS, N=128
    conv = (CSRC / "conv1x1_bn_stats.cu").read_text()
    assert '#include "wgmma.cuh"' in conv and '#include "wgmma.cuh"' in bwd
    assert "__device__ __forceinline__ uint64_t sw128_desc" not in conv


# ---------------------------------------------------------------------------
# the bf16 forward's plan
# ---------------------------------------------------------------------------
def _fwd_smem(dp, bk, rw):
    """`fwd_smem_bf16` of flash_fwd.cu: 1024 to align, two buffers of 64
    rw Q rows and one of O rows, the ring's K and V tiles (three
    stages), the mbarriers."""
    return 1024 + 2 * (3 * 64 * rw * dp + 6 * bk * dp) + 8 * 10


# the block shapes the kernel compiles: consumer warpgroups of 64 rows
FWD_ROW_WGS = (2, 1)


def test_bf16_forward_plan_constants_are_the_kernels():
    """The bf16 forward plan's rows, key tiles, block shapes and ring
    stages are the ones `flash_fwd.cu` compiles in."""
    assert tk._BF16_FWD_WG_ROWS == _cu_constant("kBf16WgRows", FWD) == 64
    assert tk._BF16_FWD_ROW_WGS == _cu_constant("kBf16RowWgs", FWD) == 2
    assert tk._BF16_FWD_STAGES == _cu_constant("kBf16Stages", FWD) == 3
    text = FWD.read_text()
    # the key tile of each block shape, and what the entry takes
    assert "return DP == 64 && rw == kBf16RowWgs ? 128 : 64;" in text
    for line in ("if ((rw != 1 && rw != kBf16RowWgs) || ks != 1 ||",
                 "BK != fwd_bf16_bk(DP, rw) ||",
                 "smem != static_cast<long long>(fwd_smem_bf16(DP, BK, rw)))",
                 "if (D <= 64) return MXTT_FWD_16(64);",
                 "return MXTT_FWD_16(128);"):
        assert line in text, line
    for dp, rw, bk in ((64, 2, 128), (64, 1, 64), (128, 2, 64),
                       (128, 1, 64)):
        plan = tk._fwd_bf16_plan(dp, rw)
        assert (plan["dp"], plan["rw"], plan["bk"], plan["ks"],
                plan["stages"]) == (dp, rw, bk, 1, 3)


@pytest.mark.parametrize("rw", FWD_ROW_WGS)
@pytest.mark.parametrize("bh", [4, 200])
def test_bf16_forward_plan_shared_bytes_fit_one_block(rw, bh):
    """At every D in 1-128 each block shape's shared bytes are the .cu's
    and fit one block (two an SM's 228 KB for 64 rows at DP = 64, where
    the launch bounds ask for two); D pads to one (64) or two (128)
    swizzle atoms."""
    for d in range(1, 129):
        plan = tk.flash_fwd_plan(bh, 300, 300, d, BF)
        dp = 64 if d <= 64 else 128
        assert plan["dp"] == dp and plan["rw"] == (2 if bh == 200 else 1)
        p = tk._fwd_bf16_plan(dp, rw)
        assert p["smem"] == _fwd_smem(dp, p["bk"], rw) <= SMEM_LIMIT
        if rw == 1 and dp == 64:
            assert 2 * (p["smem"] + 1024) <= 233472
        assert p["rows"] == 64 * rw and p["threads"] == 128 * (rw + 1)
        assert p["ks"] == 1


@pytest.mark.parametrize("bh,sq,sk,d,rw,bk", [
    (8, 128, 128, 64, 1, 64),       # the serving prefill: 16 items
    (256, 64, 64, 64, 1, 64),       # the training step: S = 64
    (192, 512, 512, 64, 2, 128),    # BERT: 768 items of 128 rows
    (8, 2048, 2048, 64, 1, 64),     # long_context: 256 items of 64
    (4, 1024, 1024, 128, 1, 64),    # DP = 128, a small grid
    (17, 1024, 1024, 128, 2, 64),   # DP = 128, 136 items of 128 rows
])
def test_bf16_forward_plans_of_the_paths(bh, sq, sk, d, rw, bk):
    """The plan at the paths' shapes: 128-row items where they cover the
    card (BERT), else 64-row items (the serving prefill, the training
    step's S = 64, the long-context drive)."""
    plan = tk.flash_fwd_plan(bh, sq, sk, d, BF)
    assert (plan["rw"], plan["ks"], plan["bk"]) == (rw, 1, bk)
    assert plan == tk._fwd_bf16_plan(plan["dp"], rw)


@pytest.mark.parametrize("bh", [1, 8, 32, 64, 66, 100, 132, 256])
def test_bf16_forward_takes_the_small_grid_where_sms_would_idle(bh):
    """128-row blocks only where their grid covers the card's 132 SMs
    (and Sq > 64: a 128-row block of 64 rows would idle a warpgroup);
    else 64-row blocks, twice as many."""
    for sq in (32, 64, 65, 128, 200, 512, 1024, 4096):
        for sk, d in ((1024, 64), (64, 64), (1024, 128)):
            plan = tk.flash_fwd_plan(bh, sq, sk, d, BF)
            wide = sq > 64 and bh * -(-sq // 128) >= 132
            assert (plan["rw"], plan["ks"]) == ((2, 1) if wide else (1, 1))


# ---------------------------------------------------------------------------
# the bf16 backward's plan
# ---------------------------------------------------------------------------
def test_bf16_plan_constants_are_the_kernels():
    """The bf16 plan's tile sizes, warpgroups and ring stages are the ones
    `flash_bwd.cu` compiles in."""
    assert tk._BF16_BWD_BQ == _cu_constant("kBf16BQ") == 64
    assert tk._BF16_BWD_MAX_BK == _cu_constant("kBf16MaxBK") == 128
    assert tk._BF16_DQ_BK == _cu_constant("kBf16DqBK") == 64
    assert tk._BF16_DQ_BQ == _cu_constant("kBf16DqBQ") == 64
    text = BWD.read_text()
    assert "return DP == 64 ? kBf16MaxBK : 64;" in text    # bf16_max_bk
    assert "return DP == 64 ? 3 : 2;" in text              # bf16_stages
    # the lse / delta slot: a box of 68 from a 16-byte boundary, in 96
    assert "constexpr int kBf16LVBox = kBf16BQ + 4;" in text
    assert "constexpr int kBf16LV = kBf16BQ + 32;" in text
    for d, wgs, stages in ((64, 2, 3), (128, 1, 2)):
        plan = tk.flash_bwd_plan(4096, d, BF)
        assert plan["warpgroups"] == wgs and plan["bk"] == 64 * wgs
        assert (plan["bq"], plan["stages"]) == (64, stages)


def _stages(dp):
    return 3 if dp == 64 else 2


def _dkv_smem(dp, bk, fused):
    """`dkv_smem_bf16` of flash_bwd.cu: 1024 to align, K and V, the
    ring's Q / dO tiles and lse / delta slots (96 floats), fused the dS
    tile, the mbarriers."""
    s = _stages(dp)
    return 1024 + 2 * (2 * bk * dp + 2 * s * 64 * dp
                       + (64 * bk if fused else 0)) + 4 * 2 * s * 96 \
        + 8 * (2 * s + 1)


def _dq_smem(dp):
    """`dq_smem_bf16` of flash_bwd.cu: 1024, 64 Q and dO rows, the ring's
    K / V tiles, the mbarriers."""
    s = _stages(dp)
    return 1024 + 2 * (2 * 64 * dp + 2 * s * 64 * dp) + 8 * (2 * s + 1)


@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_plan_shared_bytes_fit_one_block(d):
    """For every Sk both kernels' shared bytes are the .cu's and stay
    within Hopper's per-block limit on both paths; D pads to one (64) or
    two (128) 128-byte swizzle atoms."""
    seen = set()
    for sk in range(1, 400, 7):
        plan = tk.flash_bwd_plan(sk, d, BF)
        assert plan["dp"] == (64 if d <= 64 else 128)
        fused = plan["path"] == "fused"
        assert plan["smem"] == _dkv_smem(plan["dp"], plan["bk"], fused) \
            <= SMEM_LIMIT
        if fused:
            assert plan["dq_smem"] is None
        else:
            assert plan["dq_smem"] == _dq_smem(plan["dp"]) <= SMEM_LIMIT
        seen.add(plan["path"])
    assert seen == {"fused", "split"}


@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_plan_is_fused_up_to_one_block_and_split_above(d):
    """Every Sk up to the largest block (128 keys at DP = 64, 64 at DP =
    128) takes the fused path, its keys rounded up to a warpgroup's 64;
    above it, the split path with the largest block."""
    bk_max = 128 if d <= 64 else 64
    for sk in range(1, bk_max + 1):
        plan = tk.flash_bwd_plan(sk, d, BF)
        assert plan["path"] == "fused" and plan["bk"] == 64 * -(-sk // 64)
        assert plan["warpgroups"] == plan["bk"] // 64
    for sk in (bk_max + 1, bk_max + 64, 512, 4097):
        plan = tk.flash_bwd_plan(sk, d, BF)
        assert plan["path"] == "split" and plan["bk"] == bk_max


def test_fp32_plan_is_unchanged():
    """The fp32 plan keeps its values (mma.sync in split TF32, 16 keys a
    warp, 32-query tiles): pinned at the shapes the fp32 paths run."""
    want = {
        (64, 64): dict(path="fused", dp=64, bk=64, bq=32, smem=78848,
                       dq_smem=None),
        (80, 64): dict(path="fused", dp=64, bk=80, bq=32, smem=89600,
                       dq_smem=None),
        (512, 64): dict(path="split", dp=64, bk=128, bq=32, smem=104960,
                        dq_smem=104960),
        (300, 30): dict(path="split", dp=32, bk=128, bq=32, smem=55808,
                        dq_smem=55808),
        (100, 128): dict(path="split", dp=128, bk=64, bq=32, smem=135680,
                         dq_smem=203264),
        (33, 128): dict(path="fused", dp=128, bk=48, bq=32, smem=125440,
                        dq_smem=None),
    }
    for (sk, d), plan in want.items():
        assert tk.flash_bwd_plan(sk, d) == plan
        assert tk.flash_bwd_plan(sk, d, torch.float32) == plan


def _sw_off():
    """tma.cuh's `sw_off(r, c, rows)` as a Python function (its return
    expression is valid Python)."""
    expr = re.search(r"int sw_off\(int r, int c, int rows\) \{\s*return "
                     r"([^;]+);", TMA.read_text()).group(1)
    return eval("lambda r, c, rows: " + " ".join(expr.split()))


@pytest.mark.parametrize("rows,dp", [(64, 64), (128, 64), (64, 128),
                                     (128, 128)])
def test_swizzled_tiles_are_the_hardware_pattern(rows, dp):
    """`sw_off` lays element (r, c) of a tile where the 128-byte swizzle
    of a wgmma descriptor reads it: the logical byte address of a
    row-major tile in 64-column blocks of `rows` rows, with bits 4-6
    XORed by bits 7-9 (the 16-byte piece q of row r at piece q ^ (r % 8)).
    It is one-to-one onto the tile, and keeps each 8-element piece in one
    16-byte word (so a cp.async of 16 bytes lands whole)."""
    off = _sw_off()
    r, c = np.meshgrid(np.arange(rows), np.arange(dp), indexing="ij")
    got = np.vectorize(off)(r, c, rows)
    logical = 2 * ((c >> 6) * rows * 64 + r * 64 + (c & 63))
    assert np.array_equal(2 * got, logical ^ (((logical >> 7) & 7) << 4))
    assert sorted(got.ravel().tolist()) == list(range(rows * dp))
    pieces = got.reshape(rows, dp // 8, 8)
    assert np.array_equal(pieces[..., 0] % 8, np.zeros((rows, dp // 8)))
    assert np.array_equal(pieces - pieces[..., :1],
                          np.broadcast_to(np.arange(8), pieces.shape))


# ---------------------------------------------------------------------------
# what the wrapper hands the bf16 kernels
# ---------------------------------------------------------------------------
class _FakeLibrary:
    """Records the bf16 flash launches; writes nothing."""

    def __init__(self):
        self.calls = []

    def mxtt_flash_fwd_bf16(self, *args):
        self.calls.append(("fwd",) + args[6:18])
        return 0

    def mxtt_flash_bwd_bf16(self, *args):
        self.calls.append(("dkv", args[7] is not None) + args[10:21])
        return 0

    def mxtt_flash_bwd_dq_bf16(self, *args):
        self.calls.append(("dq",) + args[8:17])
        return 0


@pytest.fixture
def card(monkeypatch):
    """bf16 CPU tensors dispatched as if they lay on the card, into a
    fake kernel library; the plain version must not run."""
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
    monkeypatch.setattr(tk, "_flash_plain", no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


def _bwd_inputs(b, h, sq, sk, d, offset=0):
    rng = np.random.RandomState(3)
    base = torch.from_numpy(rng.randn(b * h * sq * d + offset)
                            .astype(np.float32)).to(BF)
    q = base[offset:].view(b, h, sq, d)
    k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                .to(BF) for shape in ((b, h, sk, d), (b, h, sk, d),
                                      (b, h, sq, d)))
    lse = torch.zeros(b * h, sq)
    return q, k, v, do, lse, lse.clone()


# every plan variant: fused with one and two warpgroups, split at DP = 64
# and 128, D no multiple of 8, Sq != Sk both ways
@pytest.mark.parametrize("sq,sk,d,path,bk", [
    (64, 64, 64, "fused", 64), (48, 80, 64, "fused", 128),
    (128, 128, 64, "fused", 128), (512, 512, 64, "split", 128),
    (130, 200, 64, "split", 128), (40, 64, 128, "fused", 64),
    (100, 100, 96, "split", 64), (50, 300, 18, "split", 128),
    (45, 45, 30, "fused", 64), (300, 200, 128, "split", 64),
])
def test_bf16_wrapper_launches_the_plan(card, sq, sk, d, path, bk):
    """On a bf16 card tensor the backward launches the bf16 dK/dV kernel
    (writing dQ only on the fused path) and, on the split path, the bf16
    dQ kernel after it, with the bf16 plan's BK and shared bytes; each
    launch counts once under its bf16 counter; rows go in 16-byte pieces
    only when D % 8 == 0."""
    q, k, v, do, lse, delta = _bwd_inputs(2, 2, sq, sk, d)
    plan = tk.flash_bwd_plan(sk, d, BF)
    assert (plan["path"], plan["bk"]) == (path, bk)
    vl = torch.tensor([sk, 1], dtype=torch.int32)
    dq, dk, dv = tk.flash_attention_bwd(q, k, v, do, lse, delta, True,
                                        0.125, vl)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dq.dtype == dk.dtype == dv.dtype == BF
    vec = int(d % 8 == 0)
    want = [("dkv", path == "fused", 2, 2, sq, sk, d, 1, 0.125, bk,
             int(path == "fused"), vec, plan["smem"])]
    if path == "split":
        want.append(("dq", 2, 2, sq, sk, d, 1, 0.125, vec,
                     plan["dq_smem"]))
    assert card.calls == want
    assert tk.LAUNCHES["flash_bwd_bf16"] == 1
    assert tk.LAUNCHES["flash_bwd_dq_bf16"] == int(path == "split")
    assert tk.LAUNCHES["flash_bwd"] == tk.LAUNCHES["flash_bwd_dq"] == 0


@pytest.mark.parametrize("sk", [64, 512])
def test_bf16_wrapper_copies_misaligned_rows_element_by_element(card, sk):
    """A bf16 q whose storage starts 2 bytes past a 16-byte boundary is
    still taken by the kernels (both paths), with the element-by-element
    copies; an aligned copy of it takes the 16-byte ones."""
    q, k, v, do, lse, delta = _bwd_inputs(1, 2, 64, sk, 64, offset=1)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    tk.flash_attention_bwd(q, k, v, do, lse, delta)
    assert [c[11 if c[0] == "dkv" else 8] for c in card.calls] \
        == [0] * len(card.calls) and len(card.calls) == 1 + (sk > 128)
    card.calls.clear()
    tk.flash_attention_bwd(q.clone(), k, v, do, lse, delta)
    assert [c[11 if c[0] == "dkv" else 8] for c in card.calls] \
        == [1] * len(card.calls)


# the forward's block shapes: 128-row items, 64-row ones; DP 64 and 128,
# D no multiple of 8, Sq != Sk both ways
@pytest.mark.parametrize("b,h,sq,sk,d,rw,bk", [
    (16, 12, 512, 512, 64, 2, 128), (2, 4, 128, 128, 64, 1, 64),
    (32, 8, 64, 64, 64, 1, 64), (1, 2, 300, 500, 64, 1, 64),
    (1, 2, 64, 200, 128, 1, 64), (2, 2, 45, 45, 30, 1, 64),
    (4, 33, 200, 100, 96, 2, 64), (1, 2, 50, 300, 18, 1, 64),
])
def test_bf16_forward_wrapper_launches_the_plan(card, b, h, sq, sk, d, rw,
                                                bk):
    """On a bf16 card tensor the forward launches the bf16 kernel with the
    plan's key tile, block shape and shared bytes (the plain version does
    not run), counts once under its bf16 counter, and hands back bf16
    out and compact fp32 lse; rows go by TMA only when D % 8 == 0."""
    q, k, v, _, _, _ = _bwd_inputs(b, h, sq, sk, d)
    plan = tk.flash_fwd_plan(b * h, sq, sk, d, BF)
    assert (plan["rw"], plan["bk"]) == (rw, bk)
    vl = torch.tensor([sk] + [1] * (b - 1), dtype=torch.int32)
    out, lse = tk.flash_attention_fwd(q, k, v, True, 0.125, vl)
    assert out.shape == q.shape and out.dtype == BF
    assert lse.shape == (b * h, sq) and lse.dtype == torch.float32
    assert card.calls == [("fwd", b, h, sq, sk, d, 1, 0.125, bk, rw, 1,
                           int(d % 8 == 0), plan["smem"])]
    assert tk.LAUNCHES["flash_fwd_bf16"] == 1
    assert tk.LAUNCHES["flash_fwd"] == 0


def test_bf16_forward_wrapper_copies_misaligned_rows_element_by_element(
        card):
    """A bf16 q whose storage starts 2 bytes past a 16-byte boundary is
    still taken by the forward kernel, with the element-by-element
    copies; an aligned copy of it goes by TMA."""
    q, k, v, _, _, _ = _bwd_inputs(1, 2, 100, 100, 64, offset=1)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    tk.flash_attention_fwd(q, k, v)
    tk.flash_attention_fwd(q.clone(), k, v)
    assert [c[11] for c in card.calls] == [0, 1]


def _ln_kernel_body(name):
    text = (CSRC / "layer_norm.cu").read_text()
    start = text.index(f"\n{name}(")
    return text[start:text.index("\n}\n", start)]


def test_wide_bf16_layer_norm_reads_its_row_once():
    """The one-block-a-row bf16 LayerNorm (D > 1024) loads each of its
    chunks once, into registers (as bf16) held across both sums and the
    output (a template count of chunks a thread): one load loop, one
    store loop, no other read of x. The launch takes the block shapes
    the card checks and times (D = 1032, 4096, 8192): 128 threads x 2
    chunks, 128 x 4, 256 x 4, and the strided form above D = 8192."""
    body = _ln_kernel_body("layer_norm_row_bf16_kernel")
    assert body.count("load_raw(") == 1 and body.count("store_chunk(") == 1
    assert "load_chunk(" not in body and "xr[" not in body
    assert "uint4 raw[C];" in body
    text = (CSRC / "layer_norm.cu").read_text()
    assert "template <typename G, int NT, int C, typename X>" in text
    launch = text[text.index("int launch_bf16("):]
    assert re.findall(r"MXTT_LN_ROW\((\d+), (\d+)\);", launch) == [
        ("128", "2"), ("128", "4"), ("256", "4")]
    assert "constexpr int kRegMaxD = 8192;" in text
    assert "layer_norm_strided_bf16_kernel<G><<<" in launch
    # the one-warp form is unchanged: one load loop too
    warp = _ln_kernel_body("layer_norm_warp_bf16_kernel")
    assert warp.count("load_chunk(") == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.card
def test_cuda_bf16_kernels_match_their_plain_versions():
    """On the card each bf16 wrapper launches its bf16 kernel (its own
    counter, no fp32 form) and matches its plain version within
    chip_smoke.py's bf16 limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    import chip_smoke
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 4, 300, 64), generator=g).to(dev).to(
        BF) for _ in range(4))
    vl = torch.tensor([300, 77], dtype=torch.int32, device=dev)
    tk.reset_launch_counts()
    out, lse = tk.flash_attention_fwd(q, k, v, kv_lengths=vl)
    delta = (out.float() * do.float()).sum(-1).reshape(8, 300)
    got = tk.flash_attention_bwd(q, k, v, do, lse, delta, kv_lengths=vl)
    x = torch.randn((64, 768), generator=g).to(dev).to(BF)
    ga = torch.ones(768, device=dev, dtype=BF)
    y, _, _ = tk.layer_norm_fwd(x, ga, ga * 0)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == dict(dict.fromkeys(tk.LAUNCHES, 0),
                               flash_fwd_bf16=1, flash_bwd_bf16=1,
                               flash_bwd_dq_bf16=1, layer_norm_bf16=1)
    ref, _ = tk._flash_plain(q, k, v, False, 0.125, vl)
    vmax = v.float().abs().amax(dim=(-2, -1), keepdim=True)
    assert chip_smoke._bf16_share(torch, out, ref,
                                  chip_smoke.BF16_OUT_ATOL * vmax) <= 1
    for a, r in zip(got, tk._flash_bwd_plain(q, k, v, do, lse, delta, False,
                                             0.125, vl)):
        assert chip_smoke._bf16_share(
            torch, a, r, chip_smoke.BF16_GRAD_ATOL
            * chip_smoke._slice_max(r)) <= 1
    torch.testing.assert_close(y.float(), tk._ln_plain(x, ga, ga * 0, 1e-5)[0]
                               .float(), **chip_smoke.LN_BF16_TOL)


@pytest.mark.card
@pytest.mark.parametrize("b,h,sq,sk,d,causal,lens,offset", [
    (4, 4, 64, 64, 64, True, None, 0),           # fused, one warpgroup
    (2, 3, 48, 80, 64, False, [80, 33], 0),      # fused, two
    (1, 2, 128, 128, 64, False, [40], 0),        # fused, a warpgroup idle
    (2, 2, 512, 512, 64, False, [300, 0], 0),    # split, DP 64
    (2, 2, 130, 300, 64, True, [280, 300], 0),   # split, causal Sq < Sk
    (1, 2, 40, 64, 128, True, [50], 0),          # fused, DP 128
    (2, 2, 300, 200, 128, True, [150, 200], 0),  # split, causal Sq > Sk
    (2, 2, 70, 90, 96, True, [0, 61], 0),        # split, DP 96 (two atoms)
    (2, 2, 512, 512, 32, False, [300, 512], 0),  # DP 32 padded to 64
    (1, 2, 50, 300, 18, False, [260], 0),        # D % 8 != 0
    (2, 2, 200, 200, 64, True, [70, 200], 1),    # misaligned q
])
def test_cuda_bf16_backward_plans_match_their_plain_versions(
        b, h, sq, sk, d, causal, lens, offset):
    """Each bf16 backward plan variant on the card against its plain
    version (chip_smoke.py's BF16_GRAD_ATOL rule), two launches
    bit-identical, dK / dV exactly 0 past each key length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    import chip_smoke
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    base = torch.randn(b * h * sq * d + offset, generator=g).to(dev).to(BF)
    q = base[offset:].view(b, h, sq, d)
    k, v = (torch.randn((b, h, sk, d), generator=g).to(dev).to(BF)
            for _ in range(2))
    do = torch.randn((b, h, sq, d), generator=g).to(dev).to(BF)
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    scale = d ** -0.5
    out, lse = tk.flash_attention_fwd(q, k, v, causal, scale, vl)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, sq)
    args = (q, k, v, do, lse, delta, causal, scale, vl)
    got = tk.flash_attention_bwd(*args)
    again = tk.flash_attention_bwd(*args)
    refs = tk._flash_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, a2, r in zip(got, again, refs):
        assert torch.equal(a, a2)
        assert chip_smoke._bf16_share(
            torch, a, r, chip_smoke.BF16_GRAD_ATOL
            * chip_smoke._slice_max(r)) <= 1
    for bi, n in enumerate(lens or []):
        assert got[1][bi, :, n:].abs().sum().item() == 0
        assert got[2][bi, :, n:].abs().sum().item() == 0


@pytest.mark.card
@pytest.mark.parametrize("b,h,sq,sk,d,causal,lens,offset", [
    (16, 12, 512, 512, 64, False, [300, 512] * 8, 0),  # BERT's shape
    (1, 8, 128, 128, 64, False, [77], 0),              # the serving prefill
    (2, 3, 256, 300, 64, False, [290, 261], 0),   # kv_len in the last tile
    (1, 2, 300, 170, 64, True, None, 0),          # causal, Sq > Sk
    (2, 2, 150, 400, 64, True, [390, 400], 0),    # causal, Sq < Sk
    (2, 2, 200, 150, 96, False, [150, 0], 0),     # DP 96, a zero row
    (1, 2, 130, 130, 128, True, None, 0),         # DP 128
    (1, 2, 50, 300, 18, False, [260], 0),         # D % 8 != 0
    (2, 2, 200, 200, 64, True, [70, 200], 1),     # misaligned q
])
def test_cuda_bf16_forward_plans_match_their_plain_versions(
        b, h, sq, sk, d, causal, lens, offset):
    """The bf16 forward at both block shapes it compiles (128 rows, 64
    rows) on the card against its plain version
    (chip_smoke.py's BF16_OUT_ATOL rule, lse FLASH_TOL), two launches
    bit-identical, a zero-length row exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    import chip_smoke
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(2)
    base = torch.randn(b * h * sq * d + offset, generator=g).to(dev).to(BF)
    q = base[offset:].view(b, h, sq, d)
    k, v = (torch.randn((b, h, sk, d), generator=g).to(dev).to(BF)
            for _ in range(2))
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    scale = d ** -0.5
    ref, ref_lse = tk._flash_plain(q, k, v, causal, scale, vl)
    plans = chip_smoke._fwd_plans(tk, q, k)
    assert len(plans) == 2
    for name, plan in plans.items():
        out, lse = tk._flash_cuda(q, k, v, causal, scale, vl, plan)
        out2, lse2 = tk._flash_cuda(q, k, v, causal, scale, vl, plan)
        torch.cuda.synchronize()
        assert torch.equal(out, out2) and torch.equal(lse, lse2), name
        assert chip_smoke._bf16_share(
            torch, out, ref, chip_smoke.BF16_OUT_ATOL
            * chip_smoke._slice_max(v)) <= 1, name
        torch.testing.assert_close(lse, ref_lse, **chip_smoke.FLASH_TOL)
        for bi, n in enumerate(lens or []):
            if n == 0:
                assert out[bi].abs().max().item() == 0.0, name
