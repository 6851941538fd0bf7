"""The design of the port's widened ragged-paged-attention kernels
(`mxtt_rpa_multi_f32` / `mxtt_rpa_multi_i8` in
`csrc/ragged_paged_attention.cu`), checked on the CPU: the launch plan,
a numpy model of the kernel's sums in their order (groups of 4 query
rows, positions split over warps, a (m, l, acc) per warp and row, merged
in warp order) against float64 and the JAX Pallas kernel in interpret
mode at W = 2, 4 and 9, on the draw where the first widened int8 kernel
read beyond RPA_TOL from float64, and what the wrapper hands the
kernels. The kernels themselves run only on the card, where
`chip_smoke.py`'s fast-path kernel phase holds them against their plain
versions (and the `card` test below runs them)."""
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_rpa_design as one
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

SRC = Path(tk.__file__).resolve().parent / "csrc" / \
    "ragged_paged_attention.cu"
SMEM_LIMIT = 232448      # the most dynamic shared memory a block may take
SMEM_DEFAULT = 49152     # what a block gets without opting in
RPA_TOL = chip_smoke.RPA_TOL
_fma, _rows = one._fma, one._rows


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
def test_plan_constants_are_the_kernels():
    """The plan's rows a group are the .cu's kGroupRows, its shared bytes
    the kernel's `rpa_multi_smem`, and the .cu asserts its widest plan
    fits the 48 KB a block gets without opting in; the kernel launches
    the plan's blocks, (S * H, groups of 4 rows), and refuses a plan
    that disagrees."""
    src = SRC.read_text()
    assert tk._RPA_GROUP_ROWS == one._cu_int("kGroupRows") == 4
    assert "return sizeof(float) * warps * kGroupRows * (2 + dh);" in src
    assert "static_assert(rpa_multi_smem(kMaxBlockWarps, 128) <= " \
        "kSmemDefault," in src
    assert "const int groups = (W + kGroupRows - 1) / kGroupRows;" in src
    assert "<<<dim3(S * H, groups), 32 * warps, smem, stream>>>" in src
    assert "smem != static_cast<long long>(rpa_multi_smem(warps, dh)))" \
        in src


@pytest.mark.parametrize("W", [2, 4, 5, 9, 33])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("npages", [1, 2, 10, 512])
def test_every_plan_fits_one_block(W, dh, npages):
    """Every plan fits one block's shared memory without an opt-in: each
    warp's (m, l) and dh accumulators for each of a group's 4 rows. One
    block per (slot, head, group of 4 rows), the groups on the grid's y
    axis; the warps are the 1-wide plan's, so row i of the window sums
    as the 1-wide kernel does at lengths + i; a shape always gets the
    same plan."""
    for slots in (8, 32):
        for psize in (8, 16):
            plan = tk.rpa_multi_plan(slots, W, 8, dh, psize, npages)
            w = plan["warps"]
            assert w == tk.rpa_plan(slots, 8, dh, psize, npages)["warps"]
            assert plan["blocks"] == (slots * 8, -(-W // 4))
            assert plan["smem"] == 4 * w * 4 * (2 + dh) <= SMEM_DEFAULT \
                <= SMEM_LIMIT
            assert plan == tk.rpa_multi_plan(slots, W, 8, dh, psize, npages)


def test_serving_shape_fills_more_of_the_card():
    """At the fast path's shape (8 slots, W = 4, 8 heads, tables of 2
    pages of 16) the grid is one block of 8 warps per (slot, head): 64
    blocks, where the first design launched 16 blocks of 4 warps; W = 9
    (speculative_k = 8) takes three groups, 192 blocks."""
    P, tables, lens = chip_smoke.RPA_CASES["serving"]
    plan = tk.rpa_multi_plan(len(lens), 4, 8, 64, 16, len(tables[0]))
    assert plan["blocks"] == (64, 1) and plan["warps"] == 8
    assert tk.rpa_multi_plan(8, 9, 8, 64, 16, 2)["blocks"] == (64, 3)


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------
def _multi_model(q, kp, vp, pt, lens, ks=None, vs=None):
    """The widened kernel's sums, in its order, in fp32. For each group of
    4 rows of a slot's window, over the group's longest row: each warp
    scores its 4 positions of each chunk against every live row (8 lanes
    a position, lane r taking the float4 pieces r, r + 8, ..., int8
    pieces dequantized first, xor-shuffle sums), row i masking positions
    at and past min(lengths + i, npages * psize); keeps an online (m, l,
    acc) per row over the chunks; the warps merge per row in warp
    order."""
    S, W, H, dh = q.shape
    psize, npages = kp.shape[1], pt.shape[1]
    warps = tk.rpa_multi_plan(S, W, H, dh, psize, npages)["warps"]
    G, lanes, wpos = tk._RPA_GROUP_ROWS, tk._RPA_POS_LANES, \
        tk._RPA_WARP_POSITIONS
    chunk, cap = wpos * warps, npages * psize
    sm_scale = np.float32(1.0 / np.sqrt(dh))
    masked = np.float32(-1e30)
    out = np.zeros_like(q)
    for s in range(S):
        for g0 in range(0, W, G):
            rows = min(G, W - g0)
            vis = np.clip(int(lens[s]) + g0 + np.arange(rows), 0, cap)
            glen = int(vis[-1])
            qg = q[s, g0:g0 + rows]                          # (rows, H, dh)
            m = np.full((warps, rows, H), masked, np.float32)
            l = np.zeros((warps, rows, H), np.float32)
            acc = np.zeros((warps, rows, H, dh), np.float32)
            for c in range(-(-glen // chunk)):
                for w in range(warps):
                    first = c * chunk + w * wpos
                    if first >= glen:
                        continue
                    ts = np.arange(first, min(first + wpos, glen))
                    k = _rows(kp, ks, pt[s], ts, psize)      # (nt, H, dh)
                    part = np.zeros((lanes, rows, len(ts), H), np.float32)
                    for i in range(-(-dh // (4 * lanes))):
                        for e in range(4):
                            d = 4 * (np.arange(lanes) + lanes * i) + e
                            live = d < dh
                            dl = d[live]
                            part[live] = _fma(
                                qg[:, :, dl].transpose(2, 0, 1)[:, :, None],
                                k[:, :, dl].transpose(2, 0, 1)[:, None],
                                part[live])
                    for o in (1, 2, 4):
                        part = part + part[np.arange(lanes) ^ o]
                    valid = (ts[None, :] < vis[:, None])[..., None]
                    sc = np.where(valid, part[0] * sm_scale, masked)
                    m_new = np.maximum(m[w], sc.max(1))       # (rows, H)
                    alpha = np.exp(m[w] - m_new)
                    p = np.zeros((rows, wpos, H), np.float32)
                    p[:, :len(ts)] = np.where(
                        valid, np.exp(sc - m_new[:, None]), np.float32(0))
                    psum = (p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])
                    l[w] = alpha * l[w] + psum
                    acc[w] = acc[w] * alpha[..., None]
                    v = _rows(vp, vs, pt[s], ts, psize)
                    for jj in range(len(ts)):
                        acc[w] = _fma(p[:, jj][..., None], v[jj][None],
                                      acc[w])
                    m[w] = m_new
            e = np.exp(m - m.max(0))             # each warp's own rescale
            lsum = np.zeros((rows, H), np.float32)
            o = np.zeros((rows, H, dh), np.float32)
            for w in range(warps):
                lsum = lsum + e[w] * l[w]
                o = o + e[w][..., None] * acc[w]
            out[s, g0:g0 + rows] = o / np.maximum(
                lsum, np.float32(1e-30))[..., None]
    return out


def _float64(q, kp, vp, pt, lens, ks=None, vs=None):
    """Row i of the window in float64 over the rows the kernel reads, at
    lengths + i (clamped to the table); no visible key is zeros."""
    return np.stack([one._float64(q[:, i], kp, vp, pt, lens + i, ks, vs)
                     for i in range(q.shape[1])], axis=1)


def _inputs(case, quant, W, seed=0):
    """`test_torch_rpa_design`'s draws (H = 2, dh = 64) with a window of
    W query rows."""
    q, kp, vp, pt, lens, ks, vs = one._inputs(case, quant, seed=seed)
    rng = np.random.RandomState(100 + seed)
    q = rng.randn(len(lens), W, *q.shape[1:]).astype(np.float32)
    return q, kp, vp, pt, lens, ks, vs


@pytest.mark.parametrize("W", [2, 4, 9])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(one.CASES))
def test_model_agrees_with_float64_and_the_jax_kernel(interpret, case,
                                                      quant, W):
    """The kernel's arithmetic agrees with float64 and with the JAX
    `_rpa_multi_pallas` (interpret mode, which pads the window to 8 or
    16 rows) within RPA_TOL, on chip_smoke.py's serving, edge and long
    tables and a null-padded table at psize 8. Row 0 of a slot of length
    0 sees no key: zeros in the model and in float64, the 1-wide kernels'
    convention. The JAX widened kernel writes there the mean of V over
    the first block its other rows read (all its scores masked to -1e30,
    so p = exp(0) = 1; ROADMAP Queue 3 item 4), so it is held to the
    rows that see a key."""
    jnp = pytest.importorskip("jax.numpy")
    jk = pytest.importorskip("mxnet_tpu.ops.pallas_kernels")
    q, kp, vp, pt, lens, ks, vs = _inputs(case, quant, W)
    got = _multi_model(q, kp, vp, pt, lens, ks, vs)
    np.testing.assert_allclose(got, _float64(q, kp, vp, pt, lens, ks, vs),
                               **RPA_TOL)
    want = np.asarray(jk._rpa_multi_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, lens)),
        1.0 / np.sqrt(q.shape[-1]),
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs)))
    seen = lens[:, None] + np.arange(W)[None] > 0              # (S, W)
    np.testing.assert_allclose(got[seen], want[seen], **RPA_TOL)
    assert not got[~seen].any()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_model_rows_are_the_1wide_model(quant):
    """A position a row cannot see leaves that row's state exactly as it
    was, so row i of the widened model is the 1-wide model at lengths +
    i, bit for bit, at every group of a 9-row window."""
    q, kp, vp, pt, lens, ks, vs = _inputs("long", quant, 9, seed=1)
    got = _multi_model(q, kp, vp, pt, lens, ks, vs)
    for i in range(9):
        want = one._kernel_model(np.ascontiguousarray(q[:, i]), kp, vp, pt,
                                 lens + i, ks, vs)
        assert np.array_equal(got[:, i], want), f"row {i}"


def _share(got, ref):
    """The largest share of RPA_TOL's limit atol + rtol * |ref| that
    |got - ref| takes at an element (as `chip_smoke.rpa_f64_witness`)."""
    err = np.abs(got.astype(np.float64) - ref)
    return float((err / (RPA_TOL["atol"] + RPA_TOL["rtol"]
                         * np.abs(ref))).max())


def test_model_is_within_tolerance_on_the_witness_draw():
    """On the draw where the first widened int8 kernel read 1.241 of
    RPA_TOL's limit from float64 on an NVIDIA H100
    (`chip_smoke.rpa_witness_inputs`, made on the CPU as the card makes
    it: W = 4, int8 pages, the long table, H = 8, dh = 64), the new
    design's sums are within the limit of float64 (`chip_smoke._rpa_f64`;
    the model reads about 0.35 of it)."""
    args = chip_smoke.rpa_witness_inputs(torch, dev=torch.device("cpu"))
    exact = chip_smoke._rpa_f64(torch, tk, *args).numpy()
    got = _multi_model(*(a.contiguous().numpy() for a in args))
    assert _share(got, exact) < 1.0


# ---------------------------------------------------------------------------
# what the wrapper hands the kernels
# ---------------------------------------------------------------------------
@pytest.fixture
def card(monkeypatch):
    """CPU tensors dispatched as if they lay on the card, into a fake
    kernel library that records the paged launches; the plain versions
    must not run."""
    lib = one._FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tk, "_device_of", lambda *t: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())

    def no_plain(*a, **k):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(tk, "_paged_attention_plain", no_plain)
    monkeypatch.setattr(tk, "_paged_attention_plain_multi", no_plain)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("W", [2, 4, 9, 17])
def test_wrapper_passes_the_plan(card, quant, W):
    """A widened q goes to `mxtt_rpa_multi_f32` / `mxtt_rpa_multi_i8`
    with (S, W, H) and, after the strides and the scale, the plan's
    warps and shared bytes; one launch, counted under its name. No width
    is refused."""
    kp, vp, ks, vs = one._pool(quant)
    pt = torch.zeros((8, 2), dtype=torch.int32)
    lens = torch.ones(8, dtype=torch.int32)
    q = torch.zeros((8, W, 8, 64))
    out = tk.ragged_paged_attention(q, kp, vp, pt, lens, k_scales=ks,
                                    v_scales=vs)
    assert out.shape == q.shape
    (name, args), = card.calls
    assert name == "mxtt_rpa_multi" + ("_i8" if quant else "_f32")
    plan = tk.rpa_multi_plan(8, W, 8, 64, 16, 2)
    sp, so, sh, _ = kp.stride()
    assert args[-13:-10] == (8, W, 8)
    assert args[-7:-1] == (sp, so, sh, 0.125, plan["warps"], plan["smem"])
    counter = "ragged_paged_attention_multi" + ("_int8" if quant else "")
    assert tk.LAUNCHES == dict(dict.fromkeys(tk.LAUNCHES, 0), **{counter: 1})


@pytest.mark.card
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_cuda_widened_windows_launch_the_plan(quant):
    """On the card a window of 2, 4 or 9 rows launches the widened kernel
    once, as planned: within RPA_TOL of its plain version in float64
    (`chip_smoke._rpa_f64`, as the card run holds it) on the serving,
    edge and long tables, two calls bit-identical, row 0 of a length-0
    slot zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    g = torch.Generator(device="cpu").manual_seed(12)
    name = "ragged_paged_attention_multi" + ("_int8" if quant else "")
    for W in (2, 4, 9):
        for case in ("serving", "edge", "long"):
            q, kp, vp, pt, ln, ks, vs = chip_smoke._rpa_inputs(
                torch, g, chip_smoke.RPA_CASES[case], W, quant)
            tk.reset_launch_counts()
            out = tk.ragged_paged_attention(q, kp, vp, pt, ln, k_scales=ks,
                                            v_scales=vs)
            assert tk.LAUNCHES[name] == 1 and sum(tk.LAUNCHES.values()) == 1
            again = tk.ragged_paged_attention(q, kp, vp, pt, ln,
                                              k_scales=ks, v_scales=vs)
            ref = chip_smoke._rpa_f64(torch, tk, q, kp, vp, pt, ln, ks, vs)
            torch.testing.assert_close(out.double(), ref, **RPA_TOL)
            assert torch.equal(out, again)
            lens = ln.tolist()
            if 0 in lens:
                assert not out[lens.index(0), 0].any()
