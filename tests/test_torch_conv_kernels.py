"""The ResNet slice's kernels of the port on the CPU: `conv1x1_bn_stats`
(its plain version) against the JAX package's Pallas kernel, and the
pure parts of `mx.rtc` (signature parsing, argument packing) with the
CPU refusals of both.

The JAX kernel runs in interpret mode (`MXTPU_PALLAS_INTERPRET=1`, as
tests/test_pallas.py sets it), which runs its body on the CPU, zero
padding of the last row block included. The CUDA kernels run only on
the card; `chip_smoke.py` holds them against these plain versions
there."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as jk
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as tk

# the tolerances of tests/test_pallas.py:237-244 (fp32 y, fp32 stats)
Y_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm", [(300, 64, 128, 256), (50, 77, 33, None)],
                         ids=["m300-bm256", "odd"])
def test_conv1x1_bn_stats_matches_jax_pallas_interpret(interpret, dtype, m,
                                                       k, n, bm):
    """y, mean and meansq of the port == the JAX Pallas kernel's, with an
    M that leaves the last row block part full and odd K, N."""
    rng = np.random.RandomState(7)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    assert jk._HAS_PALLAS and jk._interpret()      # the kernel runs
    jargs = [jnp.asarray(a).astype(dtype) for a in (x, w)]
    jy, jmean, jmsq = jk.conv1x1_bn_stats(*jargs, **({"bm": bm} if bm
                                                     else {}))
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(tdt) for a in (x, w)]
    ty, tmean, tmsq = tk.conv1x1_bn_stats(*targs, **({"bm": bm} if bm
                                                     else {}))
    assert ty.dtype == tdt and ty.shape == (m, n)
    assert tmean.dtype == tmsq.dtype == torch.float32
    want = np.asarray(jy.astype(jnp.float32))
    got = ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **Y_TOL)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), **STATS_TOL)
    np.testing.assert_allclose(tmsq.numpy(), np.asarray(jmsq), **STATS_TOL)
    assert tk.LAUNCHES["conv1x1_bn_stats"] == 0
    assert tk.LAUNCHES["conv1x1_bn_stats_bf16"] == 0


def test_conv1x1_bn_stats_refuses_what_the_kernel_does_not_take():
    """The wrapper checks layouts and dtypes on CPU tensors too, so the
    CPU tests catch what the card would refuse."""
    x, w = torch.ones(4, 3), torch.ones(3, 5)
    for bad_x, bad_w, match in [
            (torch.ones(2, 4, 3), w, "takes x"),
            (x, torch.ones(4, 5), "agree on K"),
            (x, w.bfloat16(), "one dtype"),
            (x.half(), w.half(), "float32 or bfloat16"),
            (torch.ones(3, 4).t(), w, "contiguous"),
            (x, torch.ones(5, 3).t(), "contiguous"),
            (torch.ones(0, 3), w, "empty"),
            (x, torch.ones(3, 5, device="meta"), "different devices")]:
        with pytest.raises(MXNetError, match=match):
            tk.conv1x1_bn_stats(bad_x, bad_w)
    assert all(v == 0 for v in tk.LAUNCHES.values())


@pytest.mark.parametrize("m,n", [(300, 50), (401408, 256), (6272, 2048),
                                 (100352, 128), (25088, 256), (1, 1)])
def test_conv1x1_grid_is_a_function_of_the_shape(m, n):
    """The kernel's row-tile groups (and the scratch rows it sums in a
    fixed order) depend on the shape and dtype only, never exceed the row
    tiles, and put one block on each of an H100's 132 SMs as far as whole
    column strips allow (`conv1x1_plan`)."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = tk.conv1x1_plan(m, 64, n, dtype)
        g = plan["grid_m"]
        tiles_m, tiles_n = -(-m // plan["bm"]), -(-n // plan["bn"])
        assert plan["tiles_n"] == tiles_n
        assert 1 <= g <= tiles_m and plan == tk.conv1x1_plan(m, 64, n, dtype)
        assert g * tiles_n <= tk._CARD_SMS
        assert g == tiles_m or g * tiles_n > tk._CARD_SMS - tiles_n


# ---------------------------------------------------------------------------
# rtc
# ---------------------------------------------------------------------------
def test_rtc_parse_signature():
    params = rtc.parse_signature("const float *x, float* y , int n, "
                                 "__nv_bfloat16 a, int64_t")
    assert [(p.name, p.ctype, p.dtype, p.pointer, p.const)
            for p in params] == [
        ("x", "float", torch.float32, True, True),
        ("y", "float", torch.float32, True, False),
        ("n", "int", torch.int32, False, False),
        ("a", "__nv_bfloat16", torch.bfloat16, False, False),
        ("arg4", "int64_t", torch.int64, False, False)]
    for bad, match in [("", "non-empty"), ("const *x", "invalid"),
                       ("float **x", "invalid"), ("unsigned int n", "invalid"),
                       ("long n", "unsupported"), ("float x,", "invalid")]:
        with pytest.raises(MXNetError, match=match):
            rtc.parse_signature(bad)


def test_rtc_pack_arguments():
    params = rtc.parse_signature("const float *x, __half *h, int n, "
                                 "double s, __half hs, uint8_t b, bool f")
    x = torch.arange(4, dtype=torch.float32)
    h = mx.nd.array(np.zeros(3, np.float16), ctx=mx.cpu())
    packed = rtc.pack_arguments(params, [x, h, 7, 0.5, 1.5, 255, True],
                                "cpu")
    assert packed[0].value == x.data_ptr()
    assert packed[1].value == h._data.data_ptr()
    assert isinstance(packed[2], ctypes.c_int32) and packed[2].value == 7
    assert isinstance(packed[3], ctypes.c_double) and packed[3].value == 0.5
    assert packed[4].value == 0x3E00          # 1.5 as an IEEE half
    assert packed[5].value == 255 and packed[6].value is True
    good = [x, h, 7, 0.5, 1.5, 255, True]
    for i, bad, match in [
            (None, None, "takes 7 arguments"),
            (0, torch.zeros(4, dtype=torch.float64), "takes torch.float32"),
            (0, torch.zeros(4, 2).t(), "contiguous"),
            (0, np.zeros(4, np.float32), "NDArray or a tensor"),
            (0, torch.zeros(4, device="meta"), "the launch is on cpu"),
            (2, 2.5, "integer"),
            (2, 2 ** 31, "out of range"),
            (2, torch.tensor(3), "Python number"),
            (5, 256, "out of range"),
            (6, 2, "True or False"),
            (3, "x", "Python number")]:
        args = list(good)
        if i is None:
            args = args[:-1]
        else:
            args[i] = bad
        with pytest.raises(MXNetError, match=match):
            rtc.pack_arguments(params, args, "cpu")


def test_rtc_has_no_cpu_path():
    """Without a card, compiling and launching raise (no fallback); the
    JAX package's Pallas entry points point at CudaModule."""
    src = ('extern "C" __global__ void axpy(const float *x, float *y, '
           'int n) { int i = threadIdx.x; if (i < n) y[i] += 2 * x[i]; }')
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.rtc.CudaModule(src)
    kern = rtc.CudaKernel(None, "axpy", "axpy",
                          rtc.parse_signature("const float *x, float *y, "
                                              "int n"))
    x = torch.zeros(4)
    with pytest.raises(MXNetError, match="launches on a card"):
        kern.launch([x, x, 4], mx.cpu(), (1,), (4,))
    with pytest.raises(MXNetError, match="CudaModule"):
        mx.rtc.TpuModule("def f(x_ref, o_ref):\n    o_ref[...] = x_ref[...]\n")
    with pytest.raises(MXNetError, match="CudaModule"):
        mx.rtc.TpuKernel()
    assert tk.LAUNCHES["rtc"] == 0
