"""`mx.nd.save` / `load` / `load_frombuffer` of the port against the JAX
package's (`mxnet_tpu/ndarray/utils.py`): files cross both packages,
lists and dicts keep their form, bfloat16 keeps its bits, and the write
runs on the engine ordered against loads of the same file."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 5).astype(np.float32),
            "b": rng.randn(5).astype(np.float16),
            "ids": rng.randint(-9, 9, size=(2, 4)).astype(np.int32),
            "n": np.full((), 7, np.uint8)}


def _bf16(seed=1):
    """A bf16 tensor with values away from every simple grid."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(4, 6, generator=g) * 3.7).to(torch.bfloat16)


@pytest.mark.parametrize("form", ["list", "dict"])
def test_port_files_load_in_the_jax_package(tmp_path, form):
    arrs = _arrays()
    path = str(tmp_path / "p.nd")
    if form == "list":
        mx.nd.save(path, [mx.nd.array(a, ctx=CPU) for a in arrs.values()])
    else:
        mx.nd.save(path, {k: mx.nd.array(a, ctx=CPU)
                          for k, a in arrs.items()})
    mx.engine.wait_for_all()
    got = jmx.nd.load(path)
    if form == "list":
        assert isinstance(got, list) and len(got) == len(arrs)
        pairs = zip(arrs.values(), got)
    else:
        assert sorted(got) == sorted(arrs)
        pairs = ((arrs[k], got[k]) for k in arrs)
    for a, g in pairs:
        assert g.asnumpy().dtype == a.dtype
        np.testing.assert_array_equal(g.asnumpy(), a)


@pytest.mark.parametrize("form", ["list", "dict"])
def test_jax_files_load_in_the_port(tmp_path, form):
    arrs = _arrays(2)
    path = str(tmp_path / "j.nd")
    if form == "list":
        jmx.nd.save(path, [jmx.nd.array(a, dtype=a.dtype)
                           for a in arrs.values()])
    else:
        jmx.nd.save(path, {k: jmx.nd.array(a, dtype=a.dtype)
                           for k, a in arrs.items()})
    jmx.engine.wait_for_all()
    got = mx.nd.load(path, ctx=CPU)
    items = got if form == "list" else [got[k] for k in arrs]
    for a, g in zip(arrs.values(), items):
        assert g.dtype == a.dtype and g.context == CPU
        np.testing.assert_array_equal(g.asnumpy(), a)


def test_bfloat16_keeps_its_bits_both_ways(tmp_path):
    """The port writes bf16 as float32 holding its values exactly (as
    `save_parameters` does): the JAX package loads it and its cast to
    bf16 has the same bits; the JAX package's bf16 entries (ml_dtypes,
    stored as 2-byte void) load in the port as bf16, bit for bit."""
    t = _bf16()
    bits = t.view(torch.int16)
    port = str(tmp_path / "port.npz")
    mx.nd.save(port, {"w": mx.nd.NDArray(t)})
    back = mx.nd.load(port, ctx=CPU)["w"]
    assert back.dtype == np.float32
    assert torch.equal(back._data.to(torch.bfloat16).view(torch.int16), bits)
    jax_back = jmx.nd.load(port)["w"].astype("bfloat16")
    assert np.array_equal(np.asarray(jax_back.asnumpy()).view(np.int16),
                          bits.numpy())
    jax = str(tmp_path / "jax.npz")
    jmx.nd.save(jax, {"w": jmx.nd.array(t.float().numpy()).astype(
        "bfloat16")})
    jmx.engine.wait_for_all()
    got = mx.nd.load(jax, ctx=CPU)["w"]
    assert got._data.dtype == torch.bfloat16
    assert torch.equal(got._data.view(torch.int16), bits)


def test_load_frombuffer_matches_load(tmp_path):
    arrs = _arrays(3)
    path = str(tmp_path / "b.npz")
    mx.nd.save(path, [mx.nd.array(a, ctx=CPU) for a in arrs.values()])
    mx.engine.wait_for_all()
    blob = open(path, "rb").read()
    a = mx.nd.load(path, ctx=CPU)
    b = mx.nd.load_frombuffer(blob, ctx=CPU)
    jb = jmx.nd.load_frombuffer(blob)
    for x, y, z in zip(a, b, jb):
        np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
        np.testing.assert_array_equal(x.asnumpy(), z.asnumpy())


def test_save_snapshots_then_writes_on_the_engine(tmp_path):
    """`save` copies the values before it returns: an in-place update
    right after it does not reach the file, and a load of the same path
    orders after the write (its file var) with no global wait."""
    path = str(tmp_path / "s")            # np.savez appends .npz
    x = mx.nd.array(np.arange(6, dtype=np.float32), ctx=CPU)
    for step in range(3):
        mx.nd.save(path, [x])
        x._data.add_(100.0)
        got = mx.nd.load(path, ctx=CPU)[0].asnumpy()
        np.testing.assert_array_equal(got, np.arange(6) + 100.0 * step)


def test_bad_inputs_raise(tmp_path):
    with pytest.raises(TypeError):
        mx.nd.save(str(tmp_path / "x.npz"), 3)
    import mxnet_tpu_torch.context as ctx_mod
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            ctx_mod.resolve_device(None)
