"""NDArray: the imperative tensor (counterpart of
`mxnet_tpu/ndarray/ndarray.py`).

An NDArray wraps a `torch.Tensor` (`_data`), as the JAX one wraps a
`jax.Array`. Every op goes through `_apply`, the single imperative
dispatch point: it puts the op's variables on the autograd tape while
recording and runs the op with torch's grad mode on only then (see
`autograd.py`). Arithmetic in place (`x += 1`) rebinds the wrapper to
the new tensor, as the JAX package does; the tensor it held is not
written.

This slice carries the surface that Gluon training needs; the rest of
`mx.nd` (sparse arrays, the long tail of operators) is in ROADMAP.md.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, from_numpy, numpy_dtype, torch_dtype
from ..context import resolve_device

__all__ = ["NDArray", "array", "zeros", "ones", "_apply", "CaptureHostRead"]


class CaptureHostRead(MXNetError):
    """A host read of an array (`asnumpy`, `asscalar`, `float()`) inside
    a training step that is being captured (`cachedop.CachedStep`): a
    CUDA graph cannot wait for the host, so the step falls back to the
    imperative path with the reason `trace_error:CaptureHostRead`."""


# set by `cachedop.CachedStep` while it builds a step: host reads raise
_capturing = [False]


def _host_read(what):
    if _capturing[0]:
        raise CaptureHostRead(f"{what} reads the device from the host inside "
                              f"a captured training step")


def _apply(fn, nd_inputs):
    """Run `fn` over the inputs' tensors; wrap its output."""
    recording = autograd.is_recording()
    if recording:
        autograd._note_inputs(nd_inputs)
    with torch.set_grad_enabled(recording):
        return NDArray(fn(*[x._data for x in nd_inputs]))


def _binary(fn, a, b):
    if isinstance(b, NDArray):
        return _apply(fn, [a, b])
    if isinstance(b, numbers.Number):
        return _apply(lambda x: fn(x, b), [a])
    raise TypeError(f"cannot operate NDArray with {type(b)}")


def _rbinary(fn, a, b):
    if isinstance(b, numbers.Number):
        return _apply(lambda x: fn(b, x), [a])
    raise TypeError(f"cannot operate NDArray with {type(b)}")


class NDArray:
    """Multi-dimensional array on a device (a `torch.Tensor` inside)."""
    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")
    __array_priority__ = 100.0

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor; use nd.array() "
                             "for other sources")
        self._data = data
        self._grad = None
        self._grad_req = "null"

    # ---------------------------------------------------------------- meta
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._data.device

    ctx = context

    @property
    def grad(self):
        return self._grad

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __float__(self):
        _host_read("float()")
        return float(self._data)

    def __hash__(self):
        return id(self)

    # ----------------------------------------------------------- transfers
    def asnumpy(self):
        """Copy to a numpy array (waits for the device). numpy has no
        bfloat16: a bfloat16 array comes back as float32 holding the same
        values exactly, where the JAX package gives an ml_dtypes bfloat16
        array."""
        _host_read("asnumpy()")
        t = self._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def asscalar(self):
        _host_read("asscalar()")
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self._data.detach().reshape(()).item()

    item = asscalar

    def astype(self, dtype):
        """A copy in `dtype` (a numpy dtype, a name such as "bfloat16",
        or a torch dtype), differentiable."""
        dt = torch_dtype(dtype)
        return _apply(lambda a: a.to(dt), [self])

    def detach(self):
        return NDArray(self._data.detach())

    # ------------------------------------------------------------ autograd
    def attach_grad(self, grad_req="write"):
        """Make this array a variable: `backward()` then writes (or with
        grad_req="add" adds) its gradient into `.grad`."""
        self._data = self._data.detach().requires_grad_(grad_req != "null")
        self._grad = NDArray(torch.zeros_like(self._data))
        self._grad_req = grad_req

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ---------------------------------------------------------- arithmetic
    def __add__(self, other):
        return _binary(torch.add, self, other)
    __radd__ = __add__

    def __sub__(self, other):
        return _binary(torch.sub, self, other)

    def __rsub__(self, other):
        return _rbinary(torch.sub, self, other)

    def __mul__(self, other):
        return _binary(torch.mul, self, other)
    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(torch.div, self, other)

    def __rtruediv__(self, other):
        return _rbinary(torch.div, self, other)

    def __pow__(self, other):
        return _binary(torch.pow, self, other)

    def __matmul__(self, other):
        return _binary(torch.matmul, self, other)

    def __neg__(self):
        return _apply(torch.neg, [self])

    def __iadd__(self, other):
        return self._assign(self + other)

    def __isub__(self, other):
        return self._assign(self - other)

    def __imul__(self, other):
        return self._assign(self * other)

    def __itruediv__(self, other):
        return self._assign(self / other)

    def _assign(self, out):
        self._data = out._data
        return self

    # ---------------------------------------------------------- shape ops
    def reshape(self, *shape, **kwargs):
        """MXNet's reshape: a tuple or separate ints; 0 copies the input's
        dimension at that place and -1 is inferred."""
        if kwargs.get("shape") is not None:
            shape = tuple(kwargs["shape"])
        elif len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        out = tuple(self.shape[i] if int(s) == 0 else int(s)
                    for i, s in enumerate(shape))
        return _apply(lambda a: a.reshape(out), [self])

    def transpose(self, *axes):
        """The axes permuted (reversed where none are given), as a new
        array in the permuted order."""
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        axes = axes or tuple(reversed(range(self.ndim)))
        return _apply(lambda a: a.permute(*axes).contiguous(), [self])

    def flatten(self):
        """(N, ...) -> (N, prod(...))."""
        return _apply(lambda a: a.reshape(a.shape[0], -1), [self])

    def slice_axis(self, axis, begin, end):
        """Elements `begin` to `end` (None = to the end) along `axis`."""
        def cut(a):
            idx = [slice(None)] * a.dim()
            idx[axis] = slice(begin, end)
            return a[tuple(idx)]
        return _apply(cut, [self])

    # ---------------------------------------------------------- reductions
    def _reduce(self, name, axis, keepdims):
        if axis is None and not keepdims:
            return _apply(lambda a: getattr(a, name)(), [self])
        dims = tuple(range(self.ndim)) if axis is None else axis
        return _apply(lambda a: getattr(a, name)(dims, keepdim=keepdims),
                      [self])

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)


# ---------------------------------------------------------------------------
# creation: every one resolves ctx=None to mx.gpu(0)
# ---------------------------------------------------------------------------
def array(source_array, ctx=None, dtype=None):
    """An NDArray on `ctx` (None = `mx.gpu(0)`, which raises without a
    card) holding a copy of `source_array`. float64 sources become
    float32 unless `dtype` says otherwise; `dtype` may be "bfloat16", and
    a bfloat16 numpy array (ml_dtypes') keeps its dtype."""
    dev = resolve_device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    arr = np.asarray(source_array)
    if dtype is None:
        dtype = np.float32 if arr.dtype == np.float64 else arr.dtype
    if torch_dtype(dtype) == torch.bfloat16:
        return NDArray(from_numpy(arr).to(torch.bfloat16).to(dev))
    return NDArray(torch.as_tensor(np.array(arr, dtype=dtype)).to(dev))


def zeros(shape, ctx=None, dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype or np.float32),
                               device=resolve_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.ones(shape, dtype=torch_dtype(dtype or np.float32),
                              device=resolve_device(ctx)))
