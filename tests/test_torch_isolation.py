"""The port stands alone: `mxnet_tpu_torch` and `chip_smoke.py` import
neither JAX, nor ml_dtypes, nor PIL (the card's machine has none of
them), nor the JAX package, and the port's entry points run on the card
unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "mxnet_tpu_torch"


def test_import_pulls_in_no_jax():
    """Importing the package and every submodule, in a fresh
    interpreter, loads no `jax*`, `ml_dtypes`, `PIL` or `mxnet_tpu`
    module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mxnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,\n"
        "                               'mxnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'PIL', 'mxnet_tpu'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('mxnet_tpu_torch')]), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.split(maxsplit=1)
    assert int(n_mods) >= 20          # every submodule was imported
    assert bad.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(p for p in PKG.rglob("*.py")
                                        if "_build" not in p.parts)
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    """AST scan: no `import jax...`, no `ml_dtypes`, no `PIL` and no
    `mxnet_tpu` / `mxnet_tpu.*` import anywhere in the port or in
    chip_smoke.py."""
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "PIL",
                           "mxnet_tpu"), (path, name)


# the input pipeline, IO and checkpoint modules (ROADMAP.md Queue 1 [6b])
# and the image pipeline's ([6c])
IO_MODULES = ("recordio", "prefetch", "checkpoint", "log", "fault/retry",
              "fault/preemption", "ndarray/utils", "gluon/data/dataset",
              "gluon/data/dataloader", "image", "io", "contrib/io",
              "_imcodec", "gluon/data/vision/datasets")


@pytest.mark.parametrize("name", IO_MODULES)
def test_io_modules_are_scanned_and_stand_alone(name):
    """Each IO module is one of the files the AST scan above covers, and
    imports no JAX, no PIL and nothing of the JAX package; the native
    RecordIO reader and the image codec are the port's own sources,
    built from the port's directory."""
    path = PKG / f"{name}.py"
    assert path in set(PKG.rglob("*.py"))
    for imported in _imports(path):
        assert imported.split(".")[0] not in ("jax", "jaxlib", "ml_dtypes",
                                              "PIL", "mxnet_tpu"), imported
    if name == "_imcodec":
        src = PKG / "csrc" / "imcodec.cc"
        assert src.exists() and "mxnet_tpu/" not in src.read_text(
        ).replace("mxnet_tpu_torch/", "")
        from mxnet_tpu_torch import _imcodec
        assert _imcodec._SRC == src and _imcodec._BUILD_DIR == PKG / "_build"
    if name == "recordio":
        src = PKG / "csrc" / "recordio.cc"
        assert src.exists() and "mxnet_tpu/" not in src.read_text(
        ).replace("mxnet_tpu_torch/", "")
        assert "csrc" in path.read_text() and "_build" in path.read_text()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_by_default(no_cuda, tmp_path,
                                                monkeypatch):
    """Without a CUDA device and without an explicit CPU request, every
    entry point raises instead of carrying on on the CPU."""
    kw = dict(units=16, hidden=16, num_layers=1, num_heads=2, max_length=16)
    # a Gluon block is built uninitialised; initialize() and
    # initialize(ctx=None) after a seed default to mx.gpu(0)
    with pytest.raises(MXNetError, match="CUDA"):
        mx.models.TransformerNMT(20, **kw).initialize()
    mx.random.seed(0)
    with pytest.raises(MXNetError, match="CUDA"):
        mx.models.TransformerNMT(20, **kw).initialize(ctx=None)
    with pytest.raises(MXNetError, match="CUDA"):
        mx.nd.array(np.zeros(3, np.float32))
    with pytest.raises(MXNetError, match="CUDA"):
        mx.nd.zeros((2, 2))
    model = mx.models.TransformerNMT(20, **kw)
    model.initialize(ctx=mx.cpu())
    assert model.device.type == "cpu"
    with pytest.raises(MXNetError, match="CUDA"):
        mx.serve.Server(model, engine_driven=False)
    with pytest.raises(MXNetError, match="CUDA"):
        mx.serve.Server(model, engine_driven=False, device=mx.gpu(0))
    from mxnet_tpu_torch.models.transformer import (decoder_weights,
                                                    encoder_weights)
    snap = [{k: (v.numpy() if isinstance(v, torch.Tensor) else
                 [{n: tuple(np.asarray(t) if isinstance(t, torch.Tensor)
                            else t for t in leaf)
                   for n, leaf in layer.items()} for layer in v]
                 if k == "layers" else v)
             for k, v in fn(model).items()}
            for fn in (encoder_weights, decoder_weights)]
    with pytest.raises(MXNetError, match="CUDA"):
        mx.convert.from_jax_weights(*snap)
    # the explicit CPU request is honoured
    again = mx.convert.from_jax_weights(*snap, device=mx.cpu())
    assert again.device.type == "cpu"
    srv = mx.serve.Server(model, engine_driven=False, device="cpu",
                          max_src_len=8, max_new_tokens=2)
    assert srv.runtime.k_pages.device.type == "cpu"
    assert len(srv.submit([4, 5, 6]).result()) == 2
    srv.close()
    # loading a parameter file lands on ctx (None = mx.gpu(0)) too
    model.save_parameters(str(tmp_path / "m.params"))
    fresh = mx.models.TransformerNMT(20, **kw)
    with pytest.raises(MXNetError, match="CUDA"):
        fresh.load_parameters(str(tmp_path / "m.params"))
    fresh.load_parameters(str(tmp_path / "m.params"), ctx=mx.cpu())
    assert fresh.device.type == "cpu"
    # sequence parallelism: the default group is NCCL on the card, and a
    # mesh or a `_sharded` entry without one forms it
    for name in ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS",
                 "MXTPU_WORKER_ID", "DMLC_PS_ROOT_URI", "DMLC_NUM_WORKER",
                 "DMLC_WORKER_ID"):
        monkeypatch.delenv(name, raising=False)
    q = torch.zeros((1, 2, 8, 4))
    with pytest.raises(MXNetError, match="CUDA"):
        mx.kvstore.init_distributed()
    with pytest.raises(MXNetError, match="CUDA"):
        mx.parallel.make_mesh({"sp": 1})
    with pytest.raises(MXNetError, match="CUDA"):
        mx.parallel.ring_attention_sharded(q, q, q, None)
    with pytest.raises(MXNetError, match="CUDA"):
        mx.parallel.ulysses_attention_sharded(q, q, q, None)
    # the explicit CPU request forms a gloo group of one
    mx.kvstore.init_distributed(device="cpu")
    try:
        mesh = mx.parallel.make_mesh({"sp": 1})
        assert mesh.device_type == "cpu"
        assert mx.parallel.ring_attention_sharded(q, q, q, mesh).shape \
            == q.shape
    finally:
        mx.kvstore.reset_distributed()


def test_engine_and_data_modules_stand_alone(no_cuda):
    """The dependency engine builds from the port's own copy of the C++
    source (`mxnet_tpu_torch/csrc/engine.cc`, not `cpp/`) into the port's
    build directory; the new entry points run on the card unless asked
    for the CPU: a default `Server(model)` (engine-driven) and a
    `DataLoader` without `ctx` raise without a card."""
    from mxnet_tpu_torch import _native
    assert _native._SRC == PKG / "csrc" / "engine.cc"
    assert _native._BUILD_DIR == PKG / "_build"
    assert "mxnet_tpu/" not in _native._SRC.read_text().replace(
        "mxnet_tpu_torch/", "")
    model = mx.models.TransformerNMT(20, units=16, hidden=16, num_layers=1,
                                     num_heads=2, max_length=16)
    model.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="CUDA"):
        mx.serve.Server(model)
    ds = mx.gluon.data.ArrayDataset(np.zeros((4, 2), np.float32))
    with pytest.raises(MXNetError, match="CUDA"):
        mx.gluon.data.DataLoader(ds, batch_size=2)
    loader = mx.gluon.data.DataLoader(ds, batch_size=2, ctx=mx.cpu())
    assert [b.context.type for b in loader] == ["cpu", "cpu"]
    for name in ("engine", "metric", "lr_scheduler", "gluon.data",
                 "gluon.data.vision", "models.mlp", "serve.engine_bridge"):
        mod = mx
        for part in name.split("."):
            mod = getattr(mod, part)
        assert mod.__name__ == f"mxnet_tpu_torch.{name}"
