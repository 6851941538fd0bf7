"""Runtime compilation of CUDA C++ (counterpart of `mxnet_tpu/rtc.py`;
reference: python/mxnet/rtc.py).

The JAX package turns the reference's `CudaModule` away and compiles
Pallas kernel bodies instead (`TpuModule`). On the card the reference
API is the right one again: `CudaModule` compiles user CUDA C++ at run
time and `CudaKernel.launch` runs it on PyTorch's current stream.

    mod = mx.rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float *x, float *y, int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) y[i] += 2.0f * x[i];
    }''')
    k = mod.get_kernel("axpy", "const float *x, float *y, int n")
    k.launch([x, y, n], mx.gpu(0), (blocks, 1, 1), (256, 1, 1))

The route is NVRTC, loaded with ctypes (`libnvrtc`, from the CUDA
toolkit: `$CUDA_HOME/lib64`, then `/usr/local/cuda/lib64`, then the
`nvidia/cuda_nvrtc` wheel that PyTorch installs, then the loader's
path). It compiles to a cubin for the card's architecture (`sm_90a` on
Hopper); CUDA's `cu*` API (`libcuda`) loads it into the device's primary
context and launches it. Names listed in `exports` go through
`nvrtcAddNameExpression`, so C++ (non-`extern "C"`) kernels and template
instances work, as in the reference. Every NVRTC or `CUresult` status that
is not success raises `MXNetError`, a compile error with NVRTC's log.
There is no CPU path: on a machine without a card, `CudaModule` raises.

`parse_signature` and `pack_arguments` are pure functions (no CUDA), so
the argument checks are testable anywhere. Each launch adds one to
`ops.kernels.LAUNCHES["rtc"]`.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import numbers
import os
import re
import threading
from collections import namedtuple
from pathlib import Path

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from .ops.kernels import LAUNCHES

__all__ = ["CudaModule", "CudaKernel", "TpuModule", "TpuKernel",
           "parse_signature", "pack_arguments"]

# C type -> (tensor dtype a pointer of that type takes, ctypes type of a
# scalar; for the 16-bit floats the scalar is passed as its bit pattern)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "bool": (torch.bool, ctypes.c_bool),
}
_INT_RANGE = {torch.int32: (-2 ** 31, 2 ** 31 - 1),
              torch.int64: (-2 ** 63, 2 ** 63 - 1),
              torch.int8: (-128, 127), torch.uint8: (0, 255)}
_ARG = re.compile(r"^\s*(const\s+)?([A-Za-z_]\w*)\s*(\*)?\s*([A-Za-z_]\w*)?"
                  r"\s*$")

Param = namedtuple("Param", "name ctype dtype pointer const")


def parse_signature(signature):
    """The parameters of a kernel prototype such as `"const float *x,
    float *y, int n"`: one `Param(name, ctype, dtype, pointer, const)`
    each, in order. A parameter is `[const] type [*] [name]` with a type
    of `_TYPES`; anything else raises `MXNetError`."""
    if not isinstance(signature, str) or not signature.strip():
        raise MXNetError("rtc: a kernel signature is a non-empty string "
                         "such as 'const float *x, float *y, int n'")
    params = []
    for i, arg in enumerate(re.sub(r"\s+", " ", signature).split(",")):
        match = _ARG.match(arg)
        if not match or match.group(2) == "const":
            raise MXNetError(f"rtc: invalid parameter {arg.strip()!r}: it "
                             f"must be '[const] type [*] [name]'")
        const, ctype, star, name = match.groups()
        if ctype not in _TYPES:
            raise MXNetError(f"rtc: unsupported parameter type {ctype!r}; "
                             f"supported: {sorted(_TYPES)}")
        params.append(Param(name or f"arg{i}", ctype, _TYPES[ctype][0],
                            bool(star), bool(const)))
    return params


def _scalar(param, value):
    """The ctypes value of a scalar argument, checked against its type."""
    dtype, ctype = param.dtype, _TYPES[param.ctype][1]
    if isinstance(value, (torch.Tensor, NDArray)) or not isinstance(
            value, numbers.Number):
        raise MXNetError(f"rtc: argument {param.name!r} ({param.ctype}) "
                         f"takes a Python number, got {type(value).__name__}")
    if dtype == torch.bool:
        if not isinstance(value, (bool, int)) or value not in (0, 1):
            raise MXNetError(f"rtc: argument {param.name!r} (bool) takes "
                             f"True or False, got {value!r}")
        return ctype(bool(value))
    if dtype in _INT_RANGE:
        if isinstance(value, bool) or not isinstance(value, numbers.Integral):
            raise MXNetError(f"rtc: argument {param.name!r} "
                             f"({param.ctype}) takes an integer, got "
                             f"{value!r}")
        lo, hi = _INT_RANGE[dtype]
        if not lo <= int(value) <= hi:
            raise MXNetError(f"rtc: argument {param.name!r} "
                             f"({param.ctype}) out of range: {value}")
        return ctype(int(value))
    if not isinstance(value, numbers.Real):
        raise MXNetError(f"rtc: argument {param.name!r} ({param.ctype}) "
                         f"takes a real number, got {value!r}")
    if ctype is ctypes.c_uint16:        # __half / __nv_bfloat16 bits
        bits = torch.tensor([float(value)], dtype=dtype).view(torch.int16)
        return ctype(int(bits.item()) & 0xFFFF)
    return ctype(float(value))


def pack_arguments(params, args, device):
    """The ctypes values of a launch's arguments: a data pointer for each
    pointer parameter (an NDArray or a tensor on `device`, of the
    pointer's dtype, contiguous) and a checked scalar for each other.
    A wrong count, type, dtype or device raises `MXNetError`."""
    device = torch.device(device)
    if len(args) != len(params):
        raise MXNetError(f"rtc: the kernel takes {len(params)} arguments "
                         f"({', '.join(p.name for p in params)}), got "
                         f"{len(args)}")
    packed = []
    for param, arg in zip(params, args):
        if not param.pointer:
            packed.append(_scalar(param, arg))
            continue
        t = arg._data if isinstance(arg, NDArray) else arg
        if not isinstance(t, torch.Tensor):
            raise MXNetError(f"rtc: argument {param.name!r} "
                             f"({param.ctype} *) takes an NDArray or a "
                             f"tensor, got {type(arg).__name__}")
        if t.device != device:
            raise MXNetError(f"rtc: argument {param.name!r} is on "
                             f"{t.device}, the launch is on {device}")
        if t.dtype != param.dtype:
            raise MXNetError(f"rtc: argument {param.name!r} "
                             f"({param.ctype} *) takes {param.dtype}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"rtc: argument {param.name!r} must be "
                             f"contiguous")
        packed.append(ctypes.c_void_p(t.data_ptr()))
    return packed


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise MXNetError(f"rtc: {what} must be 1 to 3 positive integers, "
                         f"got {dims}")
    return dims + (1,) * (3 - len(dims))


# ---------------------------------------------------------------------------
# NVRTC and libcuda's `cu*` API, through ctypes
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_libs = {}


def _nvrtc_candidates():
    dirs = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        dirs.append(Path(home) / "lib64")
    dirs.append(Path("/usr/local/cuda/lib64"))
    try:
        import nvidia.cuda_nvrtc
        dirs += [Path(p) / "lib" for p in nvidia.cuda_nvrtc.__path__]
    except ImportError:
        pass
    for d in dirs:
        for path in sorted(glob.glob(str(d / "libnvrtc.so*"))):
            yield path
    for name in ("libnvrtc.so.12", "libnvrtc.so",
                 ctypes.util.find_library("nvrtc")):
        if name:
            yield name


def _load_nvrtc():
    tried = []
    for path in _nvrtc_candidates():
        try:
            folder = os.path.dirname(path)
            # NVRTC opens its builtins library by name at compile time:
            # load it from the same folder first, so that name resolves
            for builtins in sorted(glob.glob(
                    os.path.join(folder, "libnvrtc-builtins.so*"))
                    if folder else []):
                ctypes.CDLL(builtins, mode=ctypes.RTLD_GLOBAL)
            lib = ctypes.CDLL(path)
        except OSError as e:
            tried.append(f"{path}: {e}")
            continue
        _P, _S = ctypes.c_void_p, ctypes.c_size_t
        for fn, args in (
                ("nvrtcCreateProgram", [ctypes.POINTER(_P), ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_int, _P,
                                        _P]),
                ("nvrtcAddNameExpression", [_P, ctypes.c_char_p]),
                ("nvrtcCompileProgram", [_P, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcGetProgramLogSize", [_P, ctypes.POINTER(_S)]),
                ("nvrtcGetProgramLog", [_P, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize", [_P, ctypes.POINTER(_S)]),
                ("nvrtcGetCUBIN", [_P, ctypes.c_char_p]),
                ("nvrtcGetLoweredName", [_P, ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcDestroyProgram", [ctypes.POINTER(_P)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.path = path
        return lib
    raise MXNetError("rtc: libnvrtc not found (CUDA_HOME/lib64, "
                     "/usr/local/cuda/lib64, the nvidia-cuda-nvrtc wheel, "
                     "the loader path): " + "; ".join(tried))


def _load_cuda():
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise MXNetError(f"rtc: libcuda.so.1 cannot be loaded: "
                         f"{e}") from e
    _P, _U = ctypes.c_void_p, ctypes.c_uint
    for fn, args in (
            ("cuInit", [_U]),
            ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int), ctypes.c_int]),
            ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(_P), ctypes.c_int]),
            ("cuCtxSetCurrent", [_P]),
            ("cuModuleLoadData", [ctypes.POINTER(_P), ctypes.c_char_p]),
            ("cuModuleGetFunction", [ctypes.POINTER(_P), _P,
                                     ctypes.c_char_p]),
            ("cuFuncSetAttribute", [_P, ctypes.c_int, ctypes.c_int]),
            ("cuLaunchKernel", [_P, _U, _U, _U, _U, _U, _U, _U, _P,
                                ctypes.POINTER(_P), ctypes.POINTER(_P)]),
            ("cuGetErrorString", [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_char_p)])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _lib(name):
    with _lock:
        if name not in _libs:
            _libs[name] = _load_nvrtc() if name == "nvrtc" else _load_cuda()
        return _libs[name]


def _nvrtc_check(rc, what):
    if rc != 0:
        msg = _lib("nvrtc").nvrtcGetErrorString(rc).decode()
        raise MXNetError(f"rtc: {what} failed: {msg} ({rc})")


def _cu_check(rc, what):
    if rc != 0:
        text = ctypes.c_char_p()
        _lib("cuda").cuGetErrorString(rc, ctypes.byref(text))
        msg = text.value.decode() if text.value else "unknown error"
        raise MXNetError(f"rtc: {what} failed: {msg} ({rc})")


_ctx_cache = {}


def _make_current(index):
    """Make card `index`'s primary context (the one PyTorch uses) current
    on this thread."""
    cu = _lib("cuda")
    with _lock:
        if index not in _ctx_cache:
            _cu_check(cu.cuInit(0), "cuInit")
            dev = ctypes.c_int()
            _cu_check(cu.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _cu_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                      "cuDevicePrimaryCtxRetain")
            _ctx_cache[index] = ctx
    _cu_check(cu.cuCtxSetCurrent(_ctx_cache[index]), "cuCtxSetCurrent")


def _require_card(what):
    if not torch.cuda.is_available():
        raise MXNetError(f"mx.rtc.{what} compiles and launches CUDA C++ on a "
                         f"card, and no CUDA device is available (there is "
                         f"no CPU path)")


def _arch(index):
    major, minor = torch.cuda.get_device_capability(index)
    # Hopper's wgmma and setmaxnreg exist only for the sm_90a target
    return f"sm_{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")


def _compile(source, options, exports, arch):
    """(cubin bytes, {export: lowered name}) of `source`."""
    nvrtc = _lib("nvrtc")
    prog = ctypes.c_void_p()
    _nvrtc_check(nvrtc.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"mx_rtc.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _nvrtc_check(nvrtc.nvrtcAddNameExpression(prog, name.encode()),
                         f"nvrtcAddNameExpression({name!r})")
        opts = list(options)
        if not any(o.startswith(("--gpu-architecture", "-arch"))
                   for o in opts):
            opts.insert(0, f"--gpu-architecture={arch}")
        c_opts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        rc = nvrtc.nvrtcCompileProgram(prog, len(opts), c_opts)
        size = ctypes.c_size_t()
        nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        nvrtc.nvrtcGetProgramLog(prog, log)
        if rc != 0:
            msg = nvrtc.nvrtcGetErrorString(rc).decode()
            raise MXNetError(f"rtc: compiling the module failed ({msg}); "
                             f"options {opts}; NVRTC log:\n"
                             f"{log.value.decode(errors='replace')}")
        _nvrtc_check(nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(nvrtc.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _nvrtc_check(nvrtc.nvrtcGetLoweredName(prog, name.encode(),
                                                   ctypes.byref(out)),
                         f"nvrtcGetLoweredName({name!r})")
            lowered[name] = out.value.decode()
        return cubin.raw, lowered
    finally:
        nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))


class CudaModule:
    """User CUDA C++ compiled at run time for the card (reference:
    `mxnet.rtc.CudaModule(source, options=(), exports=())`).

    `options` are NVRTC options (the card's `--gpu-architecture` is added
    unless one is given); `exports` name kernels to look up by their C++
    name (overloads, templates, namespaces). An `extern "C"` kernel can be
    fetched by its name without being exported."""

    def __init__(self, source, options=(), exports=()):
        _require_card("CudaModule")
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._index = torch.cuda.current_device()
        self.arch = _arch(self._index)
        self._cubin, self._lowered = _compile(source, tuple(options),
                                              tuple(exports), self.arch)
        self._modules = {}          # device index -> CUmodule

    def _function(self, index, symbol):
        if _arch(index) != self.arch:
            raise MXNetError(f"rtc: the module was compiled for {self.arch},"
                             f" cuda:{index} is {_arch(index)}")
        _make_current(index)
        cu = _lib("cuda")
        if index not in self._modules:
            mod = ctypes.c_void_p()
            _cu_check(cu.cuModuleLoadData(ctypes.byref(mod), self._cubin),
                      "cuModuleLoadData")
            self._modules[index] = mod
        fn = ctypes.c_void_p()
        _cu_check(cu.cuModuleGetFunction(ctypes.byref(fn),
                                         self._modules[index],
                                         symbol.encode()),
                  f"cuModuleGetFunction({symbol!r})")
        return fn

    def get_kernel(self, name, signature):
        """The kernel `name` with the parameters of `signature` (for
        example `"const float *x, float *y, int n"`)."""
        params = parse_signature(signature)
        symbol = self._lowered.get(name, name)
        self._function(self._index, symbol)     # raises if it is missing
        return CudaKernel(self, name, symbol, params)


class CudaKernel:
    """One kernel of a `CudaModule` (reference: `mxnet.rtc.CudaKernel`)."""

    def __init__(self, module, name, symbol, params):
        self._module = module
        self.name = name
        self._symbol = symbol
        self.params = params
        self._functions = {}

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on `ctx` (a card) over `grid_dims` blocks of
        `block_dims` threads with `shared_mem` bytes of dynamic shared
        memory, on PyTorch's current stream of that card; asynchronous,
        as any kernel launch. `args` follow the signature: NDArrays or
        tensors for pointers, Python numbers for scalars."""
        dev = torch.device(ctx)
        if dev.type != "cuda":
            raise MXNetError(f"rtc: CudaKernel {self.name!r} launches on a "
                             f"card, not on {dev}")
        _require_card("CudaKernel.launch")
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        dev = torch.device("cuda", index)
        grid, block = _dims(grid_dims, "grid_dims"), _dims(block_dims,
                                                           "block_dims")
        packed = pack_arguments(self.params, args, dev)
        cu = _lib("cuda")
        if index not in self._functions:
            self._functions[index] = self._module._function(index,
                                                            self._symbol)
        fn = self._functions[index]
        _make_current(index)
        if shared_mem > 48 * 1024:
            # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
            _cu_check(cu.cuFuncSetAttribute(fn, 8, int(shared_mem)),
                      "cuFuncSetAttribute")
        ptrs = (ctypes.c_void_p * len(packed))(
            *[ctypes.addressof(v) for v in packed])
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cu_check(cu.cuLaunchKernel(fn, *grid, *block, int(shared_mem),
                                    stream, ptrs, None),
                  f"cuLaunchKernel({self.name!r})")
        LAUNCHES["rtc"] += 1


class TpuModule:
    """The JAX package's Pallas entry point; the port compiles CUDA."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("mx.rtc.TpuModule compiles Pallas kernel bodies for "
                         "the TPU; on the card use mx.rtc.CudaModule with "
                         "CUDA C++ source")


TpuKernel = TpuModule
