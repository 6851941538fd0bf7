"""The design of the bfloat16 forms of the flash and LayerNorm kernels
(`mxtt_flash_fwd_bf16`, `mxtt_flash_bwd_bf16`, `mxtt_flash_bwd_dq_bf16`,
`mxtt_layer_norm_bf16`), checked on the CPU: their launch plans against
the .cu's shared-memory formulas, and what the build binds. The kernels
run only on the card: the `card` test holds each against its plain
version there, within chip_smoke.py's bf16 limits (this file imports no
JAX, so it runs on the card's machine: `python3 -m pytest --noconftest
-m card tests/test_torch_bf16_design.py`).
"""
from pathlib import Path

import pytest
import torch

from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as tk

CSRC = Path(tk.__file__).resolve().parent / "csrc"


def test_bf16_sources_and_entries_are_built():
    """The bf16 header is hashed into the build's name with the sources,
    and the four bf16 entries are bound with the arguments of their fp32
    forms (LayerNorm's with gamma's dtype and the 16-byte flag)."""
    assert "bf16_mma.cuh" in _build.HEADERS
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
    head = (CSRC / "bf16_mma.cuh").read_text()
    assert "m16n8k16.row.col.f32.bf16.bf16.f32" in head
    # the plans' byte formulas are the kernels' (rows of DP + 8 bf16)
    assert "bf16_pitch(int DP) { return DP + 8; }" in head
    assert ("return sizeof(bf16) * ((size_t)kWarpRows * rw + 4 * ks * BK) *"
            in (CSRC / "flash_fwd.cu").read_text())
    bwd = (CSRC / "flash_bwd.cu").read_text()
    assert "(dq ? sizeof(bf16) * (size_t)kBQ * (BK + 8) : 0)" in bwd
    assert "sizeof(float) * 2 * kDqBQ;" in bwd


def test_bf16_plans_halve_the_tiles():
    """`flash_fwd_plan` / `flash_bwd_plan` in bf16: the same tiling as in
    fp32 (a function of the shape alone), shared bytes from rows of DP +
    8 bf16 (the .cu's `bf16_pitch`) with fp32 lse / delta and, fused,
    a bf16 dS; the forward takes a wider key split where fp32's would
    not fit."""
    bf = torch.bfloat16
    for bh, sq, sk, d in ((8, 128, 128, 64), (192, 512, 512, 64),
                          (256, 64, 64, 64), (4, 1024, 1024, 128)):
        a, b = tk.flash_fwd_plan(bh, sq, sk, d), tk.flash_fwd_plan(
            bh, sq, sk, d, bf)
        assert (a["rw"], a["bk"], a["dp"]) == (b["rw"], b["bk"], b["dp"])
        assert b["smem"] == 2 * (16 * b["rw"] + 4 * b["ks"] * b["bk"]) \
            * (b["dp"] + 8) <= 227 * 1024
    for sk, d in ((64, 64), (512, 64), (100, 128), (300, 30)):
        a, b = tk.flash_bwd_plan(sk, d), tk.flash_bwd_plan(sk, d, bf)
        assert (a["path"], a["bk"]) == (b["path"], b["bk"])
        row = 2 * (b["dp"] + 8)
        ds = 2 * 32 * (b["bk"] + 8) if b["path"] == "fused" else 0
        assert b["smem"] == (2 * b["bk"] + 4 * 32) * row + 16 * 32 + ds
        assert b["dq_smem"] in (None, 6 * 64 * row + 8 * 64)
    assert tk.flash_fwd_plan(8, 128, 128, 128, bf)["ks"] >= \
        tk.flash_fwd_plan(8, 128, 128, 128)["ks"]


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
        torch.bfloat16) for _ in range(4))
    vl = torch.tensor([300, 77], dtype=torch.int32, device=dev)
    tk.reset_launch_counts()
    out, lse = tk.flash_attention_fwd(q, k, v, kv_lengths=vl)
    delta = (out.float() * do.float()).sum(-1).reshape(8, 300)
    got = tk.flash_attention_bwd(q, k, v, do, lse, delta, kv_lengths=vl)
    x = torch.randn((64, 768), generator=g).to(dev).to(torch.bfloat16)
    ga = torch.ones(768, device=dev, dtype=torch.bfloat16)
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
