"""The design of the wide-head flash kernels (`csrc/flash_wide.cu`, any D
> 128), checked on the CPU: `flash_wide_plan` for every D from 129 to
1024 and at 2048 in each dtype (shared bytes within a block's 227 KB, the
accumulator registers the design gives a thread, the column chunks and
the grid) against the .cu's constants and layouts, the dQ kernel's at
the widths a user gives (D % 8 != 0 included) in detail; the wgmma
kernels' products issued outside any branch on a non-uniform value; what
the
build binds; and what `flash_block_attention` hands the 16-bit flash
kernels on a card tensor (a stand-in library). The kernels run only on
the card: the `card` tests hold each against its plain version there
(this file imports no JAX, so it runs on the card's machine: `python3 -m
pytest --noconftest -m card tests/test_torch_flash_wide_design.py`).
"""
import contextlib
import re
from pathlib import Path

import pytest
import torch

from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

WIDE = Path(tk.__file__).resolve().parent / "csrc" / "flash_wide.cu"
# the most dynamic shared memory one block may take on Hopper
SMEM_LIMIT = 232448
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
WIDTHS = list(range(129, 1025)) + [2048]


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         WIDE.read_text()).group(1))


def test_plan_constants_are_the_kernels():
    """kernels.py's layout constants are the .cu's."""
    for name, value in (("kTcThreads", tk._WIDE_TC_THREADS),
                        ("kTcRows", tk._WIDE_TC_ROWS),
                        ("kTcBK", tk._WIDE_TC_BK),
                        ("kTcBQ", tk._WIDE_TC_BQ),
                        ("kTcAtoms", tk._WIDE_TC_ATOMS),
                        ("kTcMaxStages", tk._WIDE_TC_MAX_STAGES),
                        ("kF32Warps", tk._WIDE_F32_WARPS),
                        ("kF32BK", tk._WIDE_F32_BK),
                        ("kF32BQ", tk._WIDE_F32_BQ),
                        ("kF32PW", tk._WIDE_F32_PW),
                        ("kF32DC", tk._WIDE_F32_DC),
                        ("kF32QResMaxD", tk._WIDE_F32_QRES_MAX_D)):
        assert _cu_constant(name) == value, name
    # the simple dQ kernel and its constants are gone
    for gone in ("kWarps", "kTile"):
        assert not re.search(rf"constexpr int {gone} = ", WIDE.read_text())
    for gone in ("simple_nj", "simple_smem", "wide_bwd_dq_kernel"):
        assert gone not in WIDE.read_text(), gone
    assert not hasattr(tk, "_wide_simple_plan")


def _tc_bytes(fixed, stage, stages):
    # `tc_smem`: 1024 to align the swizzled tiles, a full and an empty
    # mbarrier a stage and one more
    return 1024 + fixed + stages * stage + 8 * (2 * stages + 1)


def _tc_layout(d, kind):
    """The wgmma kernels' layouts as the .cu's design comment gives them
    (2-byte elements, 64-column atoms of 64 or 128 rows): (mode, fixed
    bytes, bytes a stage)."""
    atom = 64 * 64 * 2
    la = -(-d // 64)
    mode = "resident" if la <= 4 else "split" if la <= 8 else "streamed"
    if kind == "fwd":
        # Q (128 rows x 4 or 8 atoms); K + V, half of K or V, or an atom
        # of Q and K (the larger of that and V's chunk)
        fixed, stage = dict(resident=(8 * atom, 8 * atom),
                            split=(16 * atom, 4 * atom),
                            streamed=(0, 4 * atom))[mode]
    elif kind == "dq":
        xp = 2 * atom + atom                         # p in fp32, dS
        # Q and dO (64 rows x 4 or 8 atoms each); K + V, two atoms of
        # each, or an atom of Q, K, dO and V (the chunk's K alike)
        fixed, stage = dict(resident=(8 * atom + xp, 8 * atom),
                            split=(16 * atom + xp, 4 * atom),
                            streamed=(xp, 4 * atom))[mode]
    else:
        pt = 4 * atom                                # P^T, dS^T x 2
        # K and V (64 rows x 4 or 8 atoms each); Q + dO, two atoms of
        # each, or an atom of K, Q, V and dO
        fixed, stage = dict(resident=(8 * atom + pt, 8 * atom),
                            split=(16 * atom + pt, 4 * atom),
                            streamed=(pt, 4 * atom))[mode]
    return mode, fixed, stage


def _tc_expected(d, kind):
    """(mode, stages, bytes): the most stages (up to 6) that fit."""
    mode, fixed, stage = _tc_layout(d, kind)
    stages = 6
    while _tc_bytes(fixed, stage, stages) > SMEM_LIMIT:
        stages -= 1
    return mode, stages, _tc_bytes(fixed, stage, stages)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plan_for_every_width(dtype):
    """Every D from 129 to 1024 and 2048: each kernel's plan fits one
    block's shared memory; bf16 / fp16 forward and dK/dV run on wgmma,
    resident to D = 256 (one chunk), split to 512 (the resident side's
    eight atoms stay) and streamed above (an atom a stage), in chunks of
    four atoms, with at least two stages, their accumulators
    64 x 256 fp32 columns over a warpgroup (O: D / 2 = 128 registers a
    thread at D = 256; dK and dV halves 64 + 64); fp32 forward and dK/dV
    in split TF32 on mma.sync, chunks of 128 columns (64 registers a
    thread each of O, dK, dV); the dQ kernel beside its siblings: on
    wgmma in the dK/dV kernel's modes with 64-query blocks, in fp32 on
    mma.sync with 64-query blocks of 52,224 bytes. Grids cover every row
    and chunk."""
    bh, sq, sk = 6, 300, 200
    for d in WIDTHS:
        plans = tk.flash_wide_plan(d, dtype, bh, sq, sk)
        for kind, p in plans.items():
            assert 0 < p["smem"] <= SMEM_LIMIT, (d, kind)
            assert p["grid"][2] == p["chunks"]
        fwd, dkv, dq = plans["fwd"], plans["dkv"], plans["dq"]
        if dtype == torch.float32:
            for p in (fwd, dkv):
                assert p["kind"] == "mma" and p["stages"] == 0
                assert p["chunks"] == -(-d // 128) and p["threads"] == 128
            qp = 64 * -(-d // 64) + 4 if d <= 320 else 68
            assert fwd["smem"] == 4 * (64 * qp + 32 * 68 + 32 * 132)
            assert dkv["smem"] == 4 * 2 * 96 * 68
            assert fwd["regs"] == {"o": 64}
            assert dkv["regs"] == {"dk": 64, "dv": 64}
            assert fwd["grid"] == (bh, -(-sq // 64), fwd["chunks"])
            assert dkv["grid"] == (bh, -(-sk // 64), dkv["chunks"])
            assert dq["kind"] == "mma" and dq["stages"] == 0
            assert dq["chunks"] == -(-d // 128) and dq["threads"] == 128
            assert dq["smem"] == 4 * 2 * 96 * 68
            assert dq["regs"] == {"dq": 64}
            assert dq["grid"] == (bh, -(-sq // 64), dq["chunks"])
        else:
            for kind, p in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
                mode, stages, smem = _tc_expected(d, kind)
                assert p["kind"] == "wgmma" and p["threads"] == 256
                assert p["mode"] == mode
                assert (p["stages"], p["smem"]) == (stages, smem), (d, kind)
                assert p["chunks"] == -(-d // 256)
                assert p["atoms"] == -(-d // 64)
            assert fwd["regs"] == {"o": 128}
            assert dkv["regs"] == {"dk": 64, "dv": 64}
            assert dq["regs"] == {"dq": 64}
            assert fwd["grid"] == (bh, -(-sq // 128), fwd["chunks"])
            assert dkv["grid"] == (bh, -(-sk // 64), dkv["chunks"])
            assert dq["grid"] == (bh, -(-sq // 64), dq["chunks"])
            assert min(fwd["stages"], dkv["stages"], dq["stages"]) >= 2
            assert not dq["key_split"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_causal_resident_forward_splits_the_keys(dtype):
    """Causal and at most four atoms wide, the 16-bit forward splits the
    keys: 64 query rows a block (twice the blocks), both warpgroups on
    them, walking alternate key tiles; Q's 64 rows and three K + V
    stages, 230,456 bytes. Not causal, or wider, or the dK/dV and fp32
    kernels: no split."""
    for d in (129, 200, 256):
        p = tk.flash_wide_plan(d, dtype, 6, 300, 300, causal=True)["fwd"]
        assert p["key_split"] and p["grid"] == (6, 5, 1)
        assert (p["stages"], p["smem"]) == (3, 1024 + 8 * 4096 + 3 * 65536
                                            + 8 * 7)
        assert not tk.flash_wide_plan(d, dtype, 6, 300, 300)["fwd"][
            "key_split"]
        assert not tk.flash_wide_plan(d, dtype, 6, 300, 300, True)["dkv"][
            "key_split"]
    for d in (257, 512, 1024):
        assert not tk.flash_wide_plan(d, dtype, 6, 300, 300, True)["fwd"][
            "key_split"]
    assert "key_split" not in tk.flash_wide_plan(256, torch.float32, 6, 300,
                                                 300, True)["fwd"]


def test_resident_split_and_streamed_shared_bytes():
    """The three wgmma modes at D = 256, 512 and 1024: resident, the
    forward's Q (128 rows) and a K + V stage, two stages, 197,672 bytes,
    the dK/dV kernel's K, V, double-buffered P^T / dS^T and a Q + dO
    stage, two stages, 230,440 bytes (of 232,448); split, 8 atoms of Q
    and three 32 KB stages, 230,456 bytes, 8 atoms of K and V and two,
    230,440; streamed, six 32 KB stages."""
    bf = torch.bfloat16
    p = tk.flash_wide_plan(256, bf)
    assert (p["fwd"]["stages"], p["fwd"]["smem"]) == (2, 197672)
    assert (p["dkv"]["stages"], p["dkv"]["smem"]) == (2, 230440)
    p = tk.flash_wide_plan(512, bf)
    assert p["fwd"]["mode"] == p["dkv"]["mode"] == "split"
    assert (p["fwd"]["stages"], p["fwd"]["smem"]) == (3, 230456)
    assert (p["dkv"]["stages"], p["dkv"]["smem"]) == (2, 230440)
    assert p["fwd"]["chunks"] == p["dkv"]["chunks"] == 2
    p = tk.flash_wide_plan(1024, bf)
    assert (p["fwd"]["stages"], p["fwd"]["smem"]) == (6, 197736)
    assert (p["dkv"]["stages"], p["dkv"]["smem"]) == (6, 230504)
    assert p["fwd"]["chunks"] == p["dkv"]["chunks"] == 4
    # dQ: Q and dO, the fp32 p exchange and dS fixed; resident a K + V
    # stage, split two atoms of each, streamed an atom of Q, K, dO, V
    for d, mode, stages, smem in ((256, "resident", 2, 222248),
                                  (512, "split", 2, 222248),
                                  (1024, "streamed", 6, 222312)):
        dq = tk.flash_wide_plan(d, bf)["dq"]
        assert (dq["mode"], dq["stages"], dq["smem"]) == (mode, stages, smem)


DQ_WIDTHS = [130, 198, 200, 256, 320, 512, 640, 1024, 2048]
# registers a thread may hold (ptxas's ceiling under the kernels'
# __launch_bounds__) and the fp32 accumulators the design may take of
# them, the rest left to fragments, addresses and loop state
REGS_A_THREAD = 255
ACC_BUDGET = (REGS_A_THREAD + 1) // 2


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", DQ_WIDTHS)
def test_dq_plan(d, dtype):
    """The dQ kernel's plan at the widths users give (D % 8 != 0 at 130
    and 198: the element copies; 200 pads to 256; 320 and 512 split; 640
    to 2048 streamed): its shared bytes fit a block's 227 KB with the
    most ring stages that fit (6 at most); its fp32 accumulators a
    thread (dQ's share plus S's or dP's, and the slot product a long
    contraction sums in registers) stay within ACC_BUDGET and the block
    within an SM's 65,536 registers; chunks of four atoms (wgmma) or 128
    columns (fp32) cover D, and the grid every 64-query block and chunk.
    """
    bh, sq, sk = 32, 1000, 1100
    p = tk.flash_wide_plan(d, dtype, bh, sq, sk, causal=True)["dq"]
    assert p["smem"] <= SMEM_LIMIT
    assert p["grid"] == (bh, -(-sq // 64), p["chunks"])
    assert p["threads"] * REGS_A_THREAD <= 65536
    if dtype == torch.float32:
        assert p["kind"] == "mma" and p["stages"] == 0
        assert p["chunks"] == -(-d // 128)
        assert p["chunks"] * 128 >= d > (p["chunks"] - 1) * 128
        # a warp's 16 rows: dQ's 128 columns, S and dP of a 32-key tile
        # and a piece's products of both
        acc = p["regs"]["dq"] + 2 * 2 * 16 * 32 // 32
        assert p["regs"]["dq"] == 16 * 128 // 32
    else:
        mode, fixed, stage = _tc_layout(d, "dq")
        assert (p["kind"], p["mode"]) == ("wgmma", mode)
        assert p["smem"] == _tc_bytes(fixed, stage, p["stages"])
        assert 2 <= p["stages"] <= 6
        assert p["stages"] == 6 or _tc_bytes(fixed, stage, p["stages"]
                                             + 1) > SMEM_LIMIT
        assert p["chunks"] == -(-d // 256) and p["atoms"] == -(-d // 64)
        # a warpgroup's half of the chunk (64 rows x 128 columns over 128
        # threads), S or dP (64 x 64), and above four atoms a slot's
        # product summed in registers
        assert p["regs"]["dq"] == 64 * 128 // 128
        acc = p["regs"]["dq"] + 64 * 64 // 128 * (1 if mode == "resident"
                                                   else 2)
    assert acc <= ACC_BUDGET


def test_plan_refuses_what_no_kernel_takes():
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="D > 0"):
        tk.flash_wide_plan(0, torch.bfloat16)
    with pytest.raises(MXNetError, match="no torch.float64 form"):
        tk.flash_wide_plan(256, torch.float64)


def _kernel_body(name):
    src = WIDE.read_text()
    start = src.index(name + "(")
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("name", ["wide_fwd_tc_kernel", "wide_dkv_tc_kernel",
                                  "wide_dq_tc_kernel"])
def test_wgmma_kernels_branch_only_on_uniform_values(name):
    """The warp index is shuffled from lane 0 (ptxas then proves the
    warpgroup uniform), each product is retired (wg_wait<0>) in the step
    that issues it, and the key length is made uniform the same way: a
    wgmma under a branch ptxas cannot prove warp-uniform serialises every
    product of the kernel (C7515 / C7520)."""
    body = _kernel_body(name)
    assert "const int warp = __shfl_sync(kFull, tid >> 5, 0);" in body
    assert "kend = __shfl_sync(kFull, kend, 0);" in body
    assert body.count("wg_commit();") == body.count("wg_wait<0>();")
    assert "threadIdx.x % 32" not in body and "lane ==" not in body.replace(
        "if (lane == 0) mbar_arrive", "")


def test_wide_entries_are_built_with_their_plans():
    """Every wide source and entry is built, each entry taking the
    tensors, sizes, causal and scale, then chunks, stages, vec, shared
    bytes and the stream."""
    assert "flash_wide.cu" in _build.SOURCES
    for sfx in ("_f32", "_bf16", "_f16"):
        for name, ptrs in (("fwd", 6), ("bwd_dkv", 9), ("bwd_dq", 8)):
            sig = _build._SIGNATURES[f"mxtt_flash_wide_{name}{sfx}"]
            assert sig[-5:] == _build._WIDE_PLAN
            assert len(sig) == ptrs + 6 + 1 + 5
    assert "kMaxD" not in WIDE.read_text()
    assert not hasattr(tk, "FLASH_MAX_D")


class _FakeLibrary:
    """Records each entry's name and arguments; returns 0."""

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
        raise AssertionError("a card tensor reached a plain version")
    for name in ("_flash_plain", "_flash_bwd_plain", "_block_plain_fwd"):
        monkeypatch.setattr(tk, name, no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


@pytest.mark.parametrize("dtype,sfx", [(torch.bfloat16, "_bf16"),
                                       (torch.float16, "_f16")])
@pytest.mark.parametrize("d", [64, 192])
def test_block_attention_launches_the_16_bit_kernels(card, dtype, sfx, d):
    """`flash_block_attention` in bf16 / fp16 on a card tensor: the flash
    forward in that dtype (the narrow kernel to D = 128, the wide one
    above), counted under `flash_block` too, and a backward that hands
    the flash backward delta = rowsum(dO O) - g_lse; its out in q's dtype,
    lse fp32 (B, H, Sq); counted under `flash_block` + the dtype's
    suffix."""
    b, h, sq, sk = 1, 2, 9, 13
    q = torch.zeros((b, h, sq, d), dtype=dtype, requires_grad=True)
    k = torch.zeros((b, h, sk, d), dtype=dtype, requires_grad=True)
    out, lse = tk.flash_block_attention(q, k, k, True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (b, h, sq)
    name = card.calls[-1][0]
    assert name == ("mxtt_flash_fwd" if d <= 128 else
                    "mxtt_flash_wide_fwd") + sfx
    g_lse = torch.full((b, h, sq), 0.5)
    torch.autograd.backward([out, lse], [torch.ones_like(out), g_lse])
    names = [n for n, _ in card.calls[1:]]
    assert names[0] == ("mxtt_flash_bwd" if d <= 128 else
                        "mxtt_flash_wide_bwd_dkv") + sfx
    delta_ptr = card.calls[1][1][5]
    assert delta_ptr not in (out.data_ptr(), lse.data_ptr())
    counts = {n: c for n, c in tk.LAUNCHES.items() if c}
    assert counts["flash_block" + sfx] == 1 and "flash_block" not in counts
    fwd = ("flash_fwd" if d <= 128 else "flash_wide_fwd") + sfx
    assert counts[fwd] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,h,sq,sk,d,causal,lens", [
    (2, 2, 200, 200, 256, True, None),        # resident, causal
    (2, 2, 150, 300, 200, False, [300, 77]),  # D % 8 == 0, not of 64
    (1, 2, 130, 70, 130, True, [50]),         # D % 8 != 0: element copies
    (2, 1, 100, 140, 640, False, [140, 1]),   # streamed, three chunks
    (1, 1, 70, 90, 2048, True, None),         # streamed, eight chunks
])
def test_cuda_wide_kernels_match_their_plain_versions(dtype, b, h, sq, sk, d,
                                                      causal, lens):
    """On the card each wide kernel against its plain version (fp32
    chip_smoke.py's FLASH_TOL / BWD_TOL, the 16-bit forms its per-dtype
    limits), two launches bit-identical, dK / dV exactly 0 past each key
    length short of Sk. A (b, h) slice whose only key cancels dP - delta
    (a key length of 1: its true dQ and dK are 0, and both
    implementations return rounding noise there) holds its dQ and dK
    against float64 autograd instead, as
    `test_cuda_wide_dq_matches_its_plain_version` does: at most
    WIDE_F64_RATIO times the plain version's float64 distance plus one
    unit roundoff of the slice's largest input-scaled value, scale *
    A |K| for dQ and scale * A^T |Q| for dK (`_bwd_cancel_floor`'s A)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(d + sq)
    q, k, v, do = (torch.randn(s, generator=g).to(dev).to(dtype)
                   for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                             (b, h, sq, d)))
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    scale = d ** -0.5
    out, lse = tk.flash_attention_fwd(q, k, v, causal, scale, vl)
    out2, _ = tk.flash_attention_fwd(q, k, v, causal, scale, vl)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, sq)
    args = (q, k, v, do, lse, delta, causal, scale, vl)
    got = tk.flash_attention_bwd(*args)
    again = tk.flash_attention_bwd(*args)
    ref, ref_lse = tk._flash_plain(q, k, v, causal, scale, vl)
    refs = tk._flash_bwd_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    assert torch.allclose(lse, ref_lse, **cs.FLASH_TOL)
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    # the batch rows whose dQ / dK cancel to 0 (a key length of 1)
    cancelled = [bi for bi, n in enumerate(lens or []) if n == 1]
    rest = [bi for bi in range(b) if bi not in cancelled]

    def plain_part(i, t):
        return t[rest] if i < 2 and cancelled else t
    if dtype == torch.float32:
        assert torch.allclose(out, ref, **cs.FLASH_TOL)
        for i, (a, r) in enumerate(zip(got, refs)):
            assert cs._within(torch, plain_part(i, a), plain_part(i, r),
                              cs.BWD_TOL, True)
    else:
        lim = cs._lowp(dtype)
        assert cs._bf16_share(torch, out, ref, lim["out_atol"]
                              * cs._slice_max(v), lim["rtol"]) <= 1
        for i, (a, r) in enumerate(zip(got, refs)):
            a, r = plain_part(i, a), plain_part(i, r)
            assert cs._bf16_share(torch, a, r, lim["grad_atol"]
                                  * cs._slice_max(r), lim["rtol"]) <= 1
    if cancelled:
        r64 = cs._attention_grads_f64(torch, q, k, v, do, causal, scale,
                                      lens)
        terms = cs._bwd_cancel_floor(torch, q, k, v, do, out, causal, scale,
                                     lens)
        unit = cs.FP32_F64_FLOOR if dtype == torch.float32 \
            else cs._lowp(dtype)["f64_floor"]
        for i, key in ((0, "dq"), (1, "dk")):
            top = (terms[key] / (cs.BWD_CANCEL * d)).abs().amax(
                dim=(-2, -1)).cpu()
            e64, p64 = ((t.cpu().double() - r64[i]).abs().amax(dim=(-2, -1))
                        for t in (got[i], refs[i]))
            for bi in cancelled:
                assert bool((e64[bi] <= cs.WIDE_F64_RATIO * p64[bi]
                             + unit * top[bi]).all()), (key, e64[bi],
                                                        p64[bi], top[bi])
    for bi, n in enumerate(lens or []):
        if n < sk:
            assert got[1][bi, :, n:].abs().max().item() == 0.0
            assert got[2][bi, :, n:].abs().max().item() == 0.0


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq,sk,d,causal,lens,shift", [
    (200, 200, 256, True, None, 0),         # resident, causal
    (150, 300, 198, False, [300, 77], 0),   # D % 8 != 0: element copies
    (130, 130, 256, True, [100], 1),        # a misaligned q: copies
    (100, 140, 512, False, [140, 1], 0),    # split
    (70, 90, 1024, True, None, 0),          # streamed, four chunks
])
def test_cuda_wide_dq_matches_its_plain_version(dtype, sq, sk, d, causal,
                                                lens, shift):
    """On the card the dQ kernel (wgmma in 16 bits, split TF32 in fp32)
    against its plain version (chip_smoke.py's limits: fp32 BWD_TOL, the
    16-bit forms their grad_atol plus the cancellation floor that its
    16-bit backward checks add) and against float64 autograd (each
    (b, h) slice at most WIDE_F64_RATIO times the plain version's
    distance plus one unit roundoff of the slice's largest value), two
    launches bit-identical; `shift` moves q off 16-byte alignment, so
    that the wrapper hands the kernel vec = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    b, h = (1 if lens is None else len(lens)), 2
    g = torch.Generator().manual_seed(d + sk)
    base = torch.randn(b * h * sq * d + shift, generator=g).to(dev).to(dtype)
    q = base[shift:].view(b, h, sq, d)
    k, v, do = (torch.randn(s, generator=g).to(dev).to(dtype)
                for s in ((b, h, sk, d), (b, h, sk, d), (b, h, sq, d)))
    assert tk._vec_copies(d, q, k, v, do) == int(
        shift == 0 and d * q.element_size() % 16 == 0)
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    scale = d ** -0.5
    out, lse = tk.flash_attention_fwd(q, k, v, causal, scale, vl)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, sq)
    args = (q, k, v, do, lse, delta, causal, scale, vl)
    got = tk.flash_attention_bwd(*args)[0]
    again = tk.flash_attention_bwd(*args)[0]
    ref = tk._flash_bwd_plain(*args)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert cs._within(torch, got, ref, cs.BWD_TOL, True)
    else:
        # chip_smoke.py's 16-bit limit, with the fp32 cancellation floor
        # of dP - delta (a row of one key cancels to about 0)
        lim = cs._lowp(dtype)
        floor = cs._bwd_cancel_floor(torch, q, k, v, do, out, causal, scale,
                                     lens)["dq"].float().to(dev)
        assert cs._bf16_share(torch, got, ref, lim["grad_atol"]
                              * cs._slice_max(ref) + 2 * floor,
                              lim["rtol"]) <= 1
    # each (b, h) slice: where a key length of 1 cancels dQ to 0 the floor
    # is all of the limit above, and float64's dQ is 0 there, so the
    # kernel must lie within WIDE_F64_RATIO of the plain version's noise
    r64 = cs._attention_grads_f64(torch, q, k, v, do, causal, scale,
                                  lens)[0]
    e64, p64, top = ((t.abs().amax(dim=(-2, -1))) for t in (
        got.cpu().double() - r64, ref.cpu().double() - r64, r64))
    unit = cs.FP32_F64_FLOOR if dtype == torch.float32 \
        else cs._lowp(dtype)["f64_floor"]
    assert bool((e64 <= cs.WIDE_F64_RATIO * p64 + unit * top).all()), (
        e64, p64)
