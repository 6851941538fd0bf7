"""Build and load the port's hand-written CUDA kernels.

The sources under `ops/csrc/` have a plain C interface (no PyTorch
headers), so each compiles in seconds. At first use `library()` starts
one `nvcc` per source, all together, for `sm_90a`, links the objects
into one shared library under `mxnet_tpu_torch/_build/` (listed in
.gitignore) and loads it with `ctypes`. The file name carries a hash of
the sources, the headers they include and the flags, so an edited
source or header is never served by a stale build. Nothing here runs at import time: the CPU tests import every
module, and the CPU machine has no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ..base import MXNetError

__all__ = ["library", "build_info", "SOURCES", "HEADERS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "ragged_paged_attention.cu",
           "layer_norm.cu", "conv1x1_bn_stats.cu")
# headers the sources include: hashed with them, never compiled alone
HEADERS = ("tf32_mma.cuh",)
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: registers, shared memory and spills of each kernel land in
# the build log (`build_info()["log"]`)
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, kv_len, out, lse, B, H, Sq, Sk, D, causal, sm_scale, BK,
    # row warps, key-split warps, vec, smem bytes, stream
    "mxtt_flash_fwd_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           ctypes.c_float, _I, _I, _I, _I, _L, _P],
    # q, k, v, dO, lse, delta, kv_len, dq, dk, dv, B, H, Sq, Sk, D, causal,
    # sm_scale, BK, with_dq, vec, smem bytes, stream
    "mxtt_flash_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _L,
                           _P],
    # q, k, v, dO, lse, delta, kv_len, dq, B, H, Sq, Sk, D, causal,
    # sm_scale, vec, smem bytes, stream
    "mxtt_flash_bwd_dq_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, ctypes.c_float, _I, _L, _P],
    # x, gamma, beta, y, mean, rstd, rows, D, eps, stream
    "mxtt_layer_norm_f32": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float,
                            _P],
    # q, k_pages, v_pages, page_tables, lengths, out, S, H, dh, psize,
    # npages, stride_page, stride_row, stride_head, sm_scale, stream
    "mxtt_rpa_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _L, _L, _L, ctypes.c_float, _P],
    # q, k_pages, v_pages, k_scales, v_scales, page_tables, lengths, out,
    # S, H, dh, psize, npages, stride_page, stride_row, stride_head,
    # sm_scale, stream
    "mxtt_rpa_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _L, _L, _L, ctypes.c_float, _P],
    # q, k_pages, v_pages, page_tables, lengths, out, S, W, H, dh, psize,
    # npages, stride_page, stride_row, stride_head, sm_scale, stream
    "mxtt_rpa_multi_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _L, _L, _L, ctypes.c_float, _P],
    # q, k_pages, v_pages, k_scales, v_scales, page_tables, lengths, out,
    # S, W, H, dh, psize, npages, stride_page, stride_row, stride_head,
    # sm_scale, stream
    "mxtt_rpa_multi_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _L, _L, _L, ctypes.c_float, _P],
    # x, w, y, part_s, part_q, mean, meansq, M, K, N, BN, grid_m, vec,
    # smem bytes, stream
    "mxtt_conv1x1_stats_f32": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                               _I, _I, _L, _P],
    "mxtt_conv1x1_stats_bf16": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                                _I, _I, _L, _P],
}

_lock = threading.Lock()
_lib = None
_info = {"seconds": None, "log": "", "path": None, "cached": None}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise MXNetError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                     "cannot be built")


def _digest():
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(target):
    """One nvcc per source, started together; then one link. The
    library appears at `target` atomically (rename), so a concurrent or
    interrupted build never leaves a half-written file there."""
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        tmp = Path(tmp)
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            log = open(tmp / (name + ".log"), "w")
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(_CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, log,
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for name, _obj, log, proc in procs:
            rc = proc.wait()
            log.close()
            text = (tmp / (name + ".log")).read_text()
            logs.append(f"== {name}\n{text}")
            if rc != 0:
                failed.append(name)
        if failed:
            raise MXNetError(f"nvcc failed for {failed}:\n"
                             + "\n".join(logs))
        so_tmp = tmp / "lib.so"
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", *(str(o) for _, o, _, _ in procs),
             "-o", str(so_tmp)], capture_output=True, text=True)
        if link.returncode != 0:
            raise MXNetError(f"nvcc link failed:\n{link.stdout}"
                             f"{link.stderr}")
        os.replace(so_tmp, target)
    return "\n".join(logs)


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            target = _BUILD_DIR / f"libmxtt_kernels_{_digest()}.so"
            cached = target.exists()
            log = "" if cached else _compile(target)
            lib = ctypes.CDLL(str(target))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _info.update(seconds=time.perf_counter() - t0, log=log,
                         path=str(target), cached=cached)
            _lib = lib
        return _lib


def build_info():
    """{seconds, log, path, cached} of the build `library()` did (the log
    holds nvcc's -Xptxas -v report; empty when a cached build was
    loaded)."""
    return dict(_info)
