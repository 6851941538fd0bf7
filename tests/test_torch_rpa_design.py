"""The design of the port's 1-wide ragged-paged-attention kernels
(`mxtt_rpa_f32` / `mxtt_rpa_i8` in `csrc/ragged_paged_attention.cu`),
checked on the CPU: the launch plan, a numpy model of the kernel's
arithmetic (positions split over warps, a (m, l, acc) per warp, merged in
warp order) against float64 and the JAX Pallas kernel in interpret mode,
and what the wrapper hands the kernels. The kernels themselves run only
on the card, where `chip_smoke.py` phases 2 and the fast-path phase hold
them against their plain versions."""
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

SRC = Path(tk.__file__).resolve().parent / "csrc" / \
    "ragged_paged_attention.cu"
# the most dynamic shared memory one block may take on Hopper
SMEM_LIMIT = 232448
RPA_TOL = chip_smoke.RPA_TOL


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
def test_plan_constants_are_the_kernels():
    """The plan's lanes a position, positions a warp and warps are the
    ones the .cu compiles in, its shared bytes are the kernel's
    `rpa1_smem`, and the .cu asserts its plans fit the 48 KB of shared
    memory a block gets without opting in."""
    src = SRC.read_text()
    assert tk._RPA_POS_LANES == _cu_int("kPosLanes") == 8
    assert "constexpr int kWarpPositions = 32 / kPosLanes;" in src
    assert tk._RPA_WARP_POSITIONS == 32 // tk._RPA_POS_LANES == 4
    assert tk._RPA_MAX_WARPS == _cu_int("kMaxBlockWarps") == 8
    assert "return sizeof(float) * warps * (2 + dh);" in src
    assert _cu_int("kSmemDefault") == 49152


@pytest.mark.parametrize("slots", [8, 32])
@pytest.mark.parametrize("psize", [8, 16])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("npages", [1, 2, 10, 512])
def test_every_plan_fits_one_block(slots, psize, dh, npages):
    """Every plan fits one block's shared memory (232,448 bytes on
    Hopper) and even the 48 KB a kernel gets without opting in, and its
    bytes are the kernel's `rpa1_smem`: each warp's (m, l) and dh
    accumulators. One block per (slot, head); the warps are the fewest
    powers of two whose chunk of 4 positions a warp covers the table, at
    most 8; the same shape always gets the same plan (whatever the page
    type: fp32 and int8 pages share it)."""
    plan = tk.rpa_plan(slots, 8, dh, psize, npages)
    cap = psize * npages
    w = plan["warps"]
    assert plan["blocks"] == slots * 8
    assert w in (1, 2, 4, 8)
    assert 4 * w >= cap or w == 8
    assert w == 1 or 4 * (w // 2) < cap
    assert plan["smem"] == 4 * w * (2 + dh) <= 49152 <= SMEM_LIMIT
    assert plan == tk.rpa_plan(slots, 8, dh, psize, npages)


def _load_widths(dh, esize):
    """Bytes of the 1-wide kernel's loads of a K and a V row at width
    `dh`, read from the .cu: the `load_raw<T, N>` calls on the K and V
    pages of `load_chunk`, the loader the kernel calls, with DCH from
    `launch_1wide`'s dispatch on dh. Returns ({"kp": bytes, "vp":
    bytes}, DCH)."""
    src = SRC.read_text()
    kernel = src[src.index("rpa1_kernel(const float*"):
                 src.index("__global__ void launch_floor_kernel")]
    assert "load_chunk<T, DCH>(kp, vp, ks, vs," in kernel
    body = src[src.index("__device__ __forceinline__ void load_chunk("):
               src.index("rpa1_kernel(const float*")]
    loads = re.findall(r"load_raw<T, (\w+)>\((\w+) \+", body)
    dispatch = re.findall(r"if \(dh <= (\d+)\) return MXTT_RPA1\((\d)\);",
                          src)
    assert [lim for lim, _ in dispatch] == ["32", "64", "128"]
    dch = next(int(c) for lim, c in dispatch if dh <= int(lim))
    return {ptr: (dch if n == "DCH" else int(n)) * esize
            for n, ptr in loads}, dch


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_load_widths_divide_every_accepted_stride(quant):
    """For every dh and stride the wrapper accepts (dh and the strides
    multiples of 4 elements), the kernel's loads of a K piece (4
    elements: a float4 or a char4) and of a lane's V columns (DCH = 1, 2
    or 4 elements up to dh = 32, 64, 128) divide the row and every
    stride in bytes, so each is one aligned vector load, and 32 lanes'
    columns cover the row. The widths are read from the .cu source."""
    esize = 1 if quant else 4
    rng = np.random.RandomState(0)
    for dh in range(4, 129, 4):
        widths, dch = _load_widths(dh, esize)
        assert widths == {"kp": 4 * esize, "vp": dch * esize}
        assert 32 * dch >= dh
        for stride in [4, 8, 12, 16, *(4 * rng.randint(1, 4096, 24))]:
            for vec in widths.values():
                assert (stride * esize) % vec == 0
                assert (dh * esize) % vec == 0


def test_serving_shape_fills_more_of_the_card():
    """At the serving shape (8 slots, 8 heads, tables of 2 pages of 16)
    the grid is one block per (slot, head), 8 warps each: 64 blocks and
    512 warps, where the widened template's one warp per (slot, head)
    launches 16 blocks of 4."""
    P, tables, lens = chip_smoke.RPA_CASES["serving"]
    plan = tk.rpa_plan(len(lens), 8, 64, 16, len(tables[0]))
    assert plan["blocks"] == len(lens) * 8 == 64
    assert plan["warps"] == 8
    assert tk._RPA_WARP_POSITIONS * plan["warps"] == 32 >= max(lens)


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------
def _fma(a, b, c):
    """fmaf in fp32: one rounding of a * b + c (exact in float64)."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def _rows(pages, scales, table, ts, psize):
    """(len(ts), H, dh) fp32 rows of positions `ts`, int8 dequantized
    element by element as float(x) * scale[page, head]."""
    pg = table[ts // psize]
    x = pages[pg, ts % psize]
    if scales is not None:
        x = x.astype(np.float32) * scales[pg][:, :, None]
    return x


def _kernel_model(q, kp, vp, pt, lens, ks=None, vs=None):
    """The 1-wide kernel's sums, in its order, in fp32: each warp scores
    its 4 positions of each chunk (8 lanes a position, lane r taking the
    float4 pieces r, r + 8, ..., xor-shuffle sums), keeps its own online
    (m, l, acc) over the chunks, and the warps merge in warp order."""
    S, H, dh = q.shape
    psize, npages = kp.shape[1], pt.shape[1]
    warps = tk.rpa_plan(S, H, dh, psize, npages)["warps"]
    lanes, wpos = tk._RPA_POS_LANES, tk._RPA_WARP_POSITIONS
    chunk = wpos * warps
    sm_scale = np.float32(1.0 / np.sqrt(dh))
    out = np.zeros_like(q)
    for s in range(S):
        n = max(0, min(int(lens[s]), npages * psize))
        m = np.full((warps, H), -1e30, np.float32)
        l = np.zeros((warps, H), np.float32)
        acc = np.zeros((warps, H, dh), np.float32)
        for c in range(-(-n // chunk)):
            for w in range(warps):
                first = c * chunk + w * wpos
                if first >= n:
                    continue
                ts = np.arange(first, min(first + wpos, n))
                k = _rows(kp, ks, pt[s], ts, psize)
                part = np.zeros((lanes, len(ts), H), np.float32)
                for i in range(-(-dh // (4 * lanes))):
                    for e in range(4):
                        d = 4 * (np.arange(lanes) + lanes * i) + e
                        live = d < dh
                        dl = d[live]
                        part[live] = _fma(q[s][:, dl].T[:, None, :],
                                          k[:, :, dl].transpose(2, 0, 1),
                                          part[live])
                for o in (1, 2, 4):
                    part = part + part[np.arange(lanes) ^ o]
                sc = part[0] * sm_scale
                m_new = np.maximum(m[w], sc.max(0))
                alpha = np.exp(m[w] - m_new)
                p = np.zeros((wpos, H), np.float32)
                p[:len(ts)] = np.exp(sc - m_new)
                psum = (p[0] + p[1]) + (p[2] + p[3])
                l[w] = alpha * l[w] + psum
                acc[w] = acc[w] * alpha[:, None]
                v = _rows(vp, vs, pt[s], ts, psize)
                for jj in range(len(ts)):
                    acc[w] = _fma(p[jj][:, None], v[jj], acc[w])
                m[w] = m_new
        e = np.exp(m - m.max(0))             # each warp's own rescale
        lsum = np.zeros(H, np.float32)
        o = np.zeros((H, dh), np.float32)
        for w in range(warps):
            lsum = lsum + e[w] * l[w]
            o = o + e[w][:, None] * acc[w]
        out[s] = o / np.maximum(lsum, np.float32(1e-30))[:, None]
    return out


def _float64(q, kp, vp, pt, lens, ks=None, vs=None):
    """Attention in float64 over the rows the kernel reads (int8 rows as
    it dequantizes them); a slot with no visible key is zeros."""
    S, H, dh = q.shape
    psize, npages = kp.shape[1], pt.shape[1]
    out = np.zeros(q.shape, np.float64)
    for s in range(S):
        n = max(0, min(int(lens[s]), npages * psize))
        if n == 0:
            continue
        ts = np.arange(n)
        k = _rows(kp, ks, pt[s], ts, psize).astype(np.float64)
        v = _rows(vp, vs, pt[s], ts, psize).astype(np.float64)
        sc = np.einsum("hd,thd->ht", q[s].astype(np.float64), k) \
            / np.sqrt(dh)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        out[s] = np.einsum("ht,thd->hd", p / p.sum(-1, keepdims=True), v)
    return out


# (pool pages, tables, lengths, psize): chip_smoke.py's serving shape,
# its edges (length-0 slots, a length that ends mid-page, full tables)
# and long table; test_serve.py's null-page-padded table at psize 8
CASES = {**{k: (*chip_smoke.RPA_CASES[k], 16)
            for k in ("serving", "edge", "long")},
         "null_padded": (9, [[1, 2], [3, 0], [4, 5]], [12, 5, 16], 8)}


def _inputs(case, quant, H=2, dh=64, seed=0):
    P, tables, lens, psize = CASES[case]
    rng = np.random.RandomState(seed)
    if quant:
        kp, vp = (rng.randint(-127, 128, (P, psize, H, dh)).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((rng.rand(P, H) * 0.05 + 1e-3).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (rng.randn(P, psize, H, dh).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    q = rng.randn(len(lens), H, dh).astype(np.float32)
    return (q, kp, vp, np.array(tables, np.int32), np.array(lens, np.int32),
            ks, vs)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_agrees_with_float64_and_the_jax_kernel(interpret, case,
                                                      quant):
    """The kernel's arithmetic agrees with float64 and with the JAX
    `_rpa_pallas` (interpret mode) within RPA_TOL; a slot of length 0
    is exactly zero in both the model and the JAX kernel. (JAX is
    imported here, not with the module, so that the card test below
    runs where there is no JAX.)"""
    jnp = pytest.importorskip("jax.numpy")
    jk = pytest.importorskip("mxnet_tpu.ops.pallas_kernels")
    q, kp, vp, pt, lens, ks, vs = _inputs(case, quant)
    got = _kernel_model(q, kp, vp, pt, lens, ks, vs)
    np.testing.assert_allclose(got, _float64(q, kp, vp, pt, lens, ks, vs),
                               **RPA_TOL)
    want = np.asarray(jk._rpa_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, lens)),
        1.0 / np.sqrt(q.shape[-1]),
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs)))
    np.testing.assert_allclose(got, want, **RPA_TOL)
    for s in np.flatnonzero(lens == 0):
        assert not got[s].any() and not want[s].any()


def test_model_is_the_plain_version_within_tolerance():
    """The port's plain version (the card tests' yardstick) and the
    model agree within RPA_TOL on the long table."""
    q, kp, vp, pt, lens, ks, vs = _inputs("long", True, seed=3)
    plain = tk.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt, lens)),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(_kernel_model(q, kp, vp, pt, lens, ks, vs),
                               plain.numpy(), **RPA_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_float64_witness_is_float64(quant):
    """`chip_smoke._rpa_f64`, against which the card run holds every
    paged kernel (and the widened int8 kernel on the draw where it once
    read beyond RPA_TOL), is this
    file's float64 reference (int8 pages dequantized in float64) for a
    3-D q and for each row of a W-row window, where row i sees lengths
    + i keys, clamped to the table. On CPU tensors the witness replays
    its draw with the plain version as the kernel."""
    import mxnet_tpu_torch as mx
    q, kp, vp, pt, lens, ks, vs = _inputs("edge", quant)
    if quant:
        kp, vp = (x.astype(np.float64) * sc[:, None, :, None]
                  for x, sc in ((kp, ks), (vp, vs)))
    q4 = np.stack([q, -q, 0.5 * q], axis=1)               # W = 3
    t = [None if a is None else torch.from_numpy(a)
         for a in (q4, *_inputs("edge", quant)[1:])]
    got = chip_smoke._rpa_f64(torch, tk, *t).numpy()
    for i in range(3):
        want = _float64(q4[:, i], kp, vp, pt, lens + i)
        np.testing.assert_allclose(got[:, i], want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        chip_smoke._rpa_f64(torch, tk, t[0][:, 0], *t[1:]).numpy(),
        got[:, 0], rtol=0, atol=0)
    if quant:
        res = chip_smoke.rpa_f64_witness(mx, torch, dev=torch.device("cpu"))
        assert res["kernel_vs_plain"] == (0.0, 0.0)
        assert res["kernel_vs_f64"] == res["plain_vs_f64"]
        assert res["plain_vs_f64"][0] < 1e-5


# ---------------------------------------------------------------------------
# what the wrapper hands the kernels
# ---------------------------------------------------------------------------
class _FakeLibrary:
    """Records the paged launches by entry point; writes nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mxtt_rpa"):
            raise AttributeError(name)

        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


@pytest.fixture
def card(monkeypatch):
    """CPU tensors dispatched as if they lay on the card, into a fake
    kernel library; the plain versions must not run."""
    lib = _FakeLibrary()
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


def _pool(quant, L=3, P=17, psize=16, H=8, dh=64):
    """A layer slice of a 5-D pool, as the serving runtime passes it."""
    if quant:
        kp = torch.zeros((L, P, psize, H, dh), dtype=torch.int8)
        return (kp[1], kp[1].clone(), torch.ones((P, H)),
                torch.ones((P, H)))
    kp = torch.zeros((L, P, psize, H, dh))
    return kp[1], kp[1].clone(), None, None


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("W", [1, 4])
def test_wrapper_launches_the_plan(card, quant, W):
    """A 1-wide (3-D) q goes to `mxtt_rpa_f32` / `mxtt_rpa_i8` with the
    plan's warps and shared bytes after the strides; a widened q to the
    widened entry with `rpa_multi_plan`'s. One launch each, counted
    under its name."""
    kp, vp, ks, vs = _pool(quant)
    pt = torch.zeros((8, 2), dtype=torch.int32)
    lens = torch.ones(8, dtype=torch.int32)
    q = torch.zeros((8, 8, 64) if W == 1 else (8, W, 8, 64))
    out = tk.ragged_paged_attention(q, kp, vp, pt, lens, k_scales=ks,
                                    v_scales=vs)
    assert out.shape == q.shape
    (name, args), = card.calls
    sp, so, sh, _ = kp.stride()
    wide = "_multi" if W > 1 else ""
    assert name == "mxtt_rpa" + wide + ("_i8" if quant else "_f32")
    plan = tk.rpa_plan(8, 8, 64, 16, 2) if W == 1 else \
        tk.rpa_multi_plan(8, W, 8, 64, 16, 2)
    assert args[-7:-1] == (sp, so, sh, 0.125, plan["warps"], plan["smem"])
    counter = "ragged_paged_attention" + wide + ("_int8" if quant else "")
    assert tk.LAUNCHES == dict(dict.fromkeys(tk.LAUNCHES, 0), **{counter: 1})


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_wrapper_sends_a_one_row_window_to_the_1wide_entry(card, quant):
    """A 4-D q with a window of one row (W = 1) is the 1-wide form: it
    goes to `mxtt_rpa_f32` / `mxtt_rpa_i8` with the same arguments as
    the 3-D q it lays out like in memory, is counted under the 1-wide
    name, and comes back (S, 1, H, dh); the widened entries see only
    W >= 2."""
    kp, vp, ks, vs = _pool(quant)
    pt = torch.zeros((8, 2), dtype=torch.int32)
    lens = torch.ones(8, dtype=torch.int32)
    q = torch.zeros((8, 8, 64))
    for form in (q, q[:, None]):
        out = tk.ragged_paged_attention(form, kp, vp, pt, lens, k_scales=ks,
                                        v_scales=vs)
        assert out.shape == form.shape
    (n3, a3), (n4, a4) = card.calls
    assert n3 == n4 == "mxtt_rpa" + ("_i8" if quant else "_f32")
    # all but the q and out pointers and the stream: pages, table,
    # lengths, shape, strides, scale and plan
    assert a3[1:-13] + a3[-12:-1] == a4[1:-13] + a4[-12:-1]
    assert a3[-12:-10] == (8, 8)
    counter = "ragged_paged_attention" + ("_int8" if quant else "")
    assert tk.LAUNCHES == dict(dict.fromkeys(tk.LAUNCHES, 0), **{counter: 2})


def test_wrapper_takes_int8_rows_aligned_to_4_bytes(card):
    """int8 pools whose strides are multiples of 4 but not of 16 bytes
    are still taken: a lane's loads are 4 bytes (a K piece) or fewer."""
    base = torch.zeros((17, 16, 8, 68), dtype=torch.int8)
    kp = base[..., :64]                     # rows 68 bytes apart
    ks = torch.ones((17, 8))
    q = torch.zeros((8, 8, 64))
    pt = torch.zeros((8, 2), dtype=torch.int32)
    tk.ragged_paged_attention(q, kp, kp, pt, torch.ones(8, dtype=torch.int32),
                              k_scales=ks, v_scales=ks)
    (name, args), = card.calls
    assert name == "mxtt_rpa_i8"
    assert args[-7:-4] == (16 * 8 * 68, 8 * 68, 68)
    assert args[-3:-1] == (8, tk.rpa_plan(8, 8, 64, 16, 2)["smem"])


def test_wrapper_checks_what_the_kernels_take(card):
    """Layouts the kernels would misread are refused before any launch:
    a width that is no multiple of 4, rows not 4-element aligned."""
    pt = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    kp = torch.zeros((3, 16, 2, 6))
    with pytest.raises(MXNetError, match="dh % 4 == 0"):
        tk.ragged_paged_attention(torch.zeros((2, 2, 6)), kp, kp, pt, lens)
    kp = torch.zeros((3, 16, 2, 10))[..., :8]
    with pytest.raises(MXNetError, match="aligned to 4"):
        tk.ragged_paged_attention(torch.zeros((2, 2, 8)), kp, kp, pt, lens)
    assert card.calls == [] and all(v == 0 for v in tk.LAUNCHES.values())


@pytest.mark.card
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_cuda_q_reaches_the_new_entries(quant):
    """On the card a 3-D q and a 4-D q with W = 1 launch the 1-wide
    kernel (the same bits) and a 4-D q with W > 1 the widened one, each
    within RPA_TOL of the function in float64 (`chip_smoke._rpa_f64`,
    the yardstick `chip_smoke.py` holds every paged kernel to). The fp32
    plain version, the CPU path's counterpart of the JAX lax path, is
    logged beside and not asserted against: on int8 pages it lies up to
    1.745 of RPA_TOL's limit from float64 itself (ROADMAP Queue 3 item
    8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    shape = (3, 17, 16, 8, 64)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, generator=g,
                                dtype=torch.int8).to(dev)[1]
                  for _ in range(2))
        ks, vs = ((torch.rand((17, 8), generator=g) * 0.05 + 1e-3).to(dev)
                  for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=g).to(dev)[1]
                  for _ in range(2))
        ks = vs = None
    pt = torch.tensor(chip_smoke.RPA_CASES["serving"][1], dtype=torch.int32,
                      device=dev)
    lens = torch.tensor(chip_smoke.SERVE_LENS, dtype=torch.int32, device=dev)
    outs = {}
    for form, counter in (("3d", ""), ("4d_w1", ""), ("4d_w4", "_multi")):
        W = 4 if form == "4d_w4" else 1
        q = torch.randn((8, 8, 64) if W == 1 else (8, W, 8, 64),
                        generator=torch.Generator().manual_seed(W)).to(dev)
        if form == "4d_w1":
            q = q[:, None]
        tk.reset_launch_counts()
        out = tk.ragged_paged_attention(q, kp, vp, pt, lens, k_scales=ks,
                                        v_scales=vs)
        name = "ragged_paged_attention" + counter + ("_int8" if quant
                                                     else "")
        assert tk.LAUNCHES[name] == 1 and sum(tk.LAUNCHES.values()) == 1
        exact = chip_smoke._rpa_f64(torch, tk, q, kp, vp, pt, lens, ks, vs)
        plain = chip_smoke._rpa_plain(tk, q, kp, vp, pt, lens, ks, vs)
        print(f"{form} {'int8' if quant else 'fp32'}: kernel vs float64 "
              f"{chip_smoke._rpa_share(out, exact)}, fp32 plain vs float64 "
              f"{chip_smoke._rpa_share(plain, exact)}, kernel vs fp32 plain "
              f"{chip_smoke._rpa_share(out, plain)} (max abs, share of "
              f"RPA_TOL's limit)")
        torch.testing.assert_close(out.double(), exact, **RPA_TOL)
        outs[form] = out
    assert torch.equal(outs["3d"][:, None], outs["4d_w1"])


def test_cpu_tensors_launch_nothing():
    tk.reset_launch_counts()
    for quant in (False, True):
        q, kp, vp, pt, lens, ks, vs = _inputs("serving", quant)
        t = [None if a is None else torch.from_numpy(a)
             for a in (q, kp, vp, pt, lens, ks, vs)]
        out = tk.ragged_paged_attention(*t[:5], k_scales=t[5],
                                        v_scales=t[6])
        assert out.shape == q.shape and torch.isfinite(out).all()
    assert tk.LAUNCHES == dict.fromkeys(tk.LAUNCHES, 0)
