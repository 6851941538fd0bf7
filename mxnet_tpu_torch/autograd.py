"""Imperative autograd: record / pause / train_mode / backward
(counterpart of `mxnet_tpu/autograd.py:419-580`).

The JAX package records a tape of pure functions and replays it through
`jax.vjp`. Here torch's autograd builds the graph as the ops run, and
this module keeps MXNet's contract on top of it:

  * torch's grad mode is on only inside `record()`: every NDArray op and
    every Block call runs under `torch.set_grad_enabled(is_recording())`,
    so nothing outside a recording scope builds a graph;
  * the training flag (Dropout) is kept apart from recording, as in
    MXNet: `record()` trains by default, `train_mode()` trains without
    recording, `pause()` / `predict_mode()` turn it off;
  * the tape of a recording scope lists the variables (arrays with a
    gradient buffer: `attach_grad`, `mark_variables`, Gluon parameters)
    that its ops read; `backward()` takes the gradient of the heads with
    respect to those and writes (`grad_req="write"`) or adds (`"add"`)
    it into each variable's `.grad` buffer. A variable on the tape that
    the heads do not reach gets a zero gradient under "write", as the
    JAX tape's vjp gives it.

`autograd.grad`, `autograd.Function` and `get_symbol` belong to a later
slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.tape = None
        _state.last_tape = None
    return _state


class _Tape:
    """The variables a recording scope's ops read, in first-use order."""

    def __init__(self):
        self.variables = {}              # id -> NDArray

    def note(self, arrays):
        for x in arrays:
            if x._grad_req != "null":
                self.variables.setdefault(id(x), x)


class _RecordingScope:
    """Sets the recording / training flags on enter and restores them on
    exit. The scope that starts recording makes the tape; when it exits,
    the tape is kept in `last_tape` so `backward()` can run after the
    `with` block."""

    def __init__(self, recording, training):
        self._rec = recording
        self._train = training
        self._created_tape = False

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
            if self._rec and st.tape is None:
                st.tape = _Tape()
                self._created_tape = True
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._prev
        if self._created_tape:
            st.last_tape = st.tape
            st.tape = None


def record(train_mode=True):
    """Scope in which imperative ops are recorded for `backward()`."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    """Scope in which recording (and by default training) is paused."""
    return _RecordingScope(False, train_mode)


def train_mode():
    """Scope forcing training mode (Dropout active) without recording."""
    return _RecordingScope(None, True)


def predict_mode():
    """Scope forcing inference mode."""
    return _RecordingScope(None, False)


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def _note_inputs(arrays):
    """Put the variables among an op's inputs on the active tape (called
    by the NDArray op dispatch while recording)."""
    tape = _st().tape
    if tape is not None:
        tape.note(arrays)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make arrays variables with the given gradient buffers."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._data = var._data.detach().requires_grad_(req != "null")
        var._grad = g
        var._grad_req = req


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of `heads` with respect to every variable on the tape
    of the last recording scope, written or added into their `.grad`."""
    from .ndarray.ndarray import NDArray
    heads = heads if isinstance(heads, (list, tuple)) else [heads]
    st = _st()
    tape = st.tape if st.tape is not None else st.last_tape
    if tape is None:
        raise MXNetError("backward() called with no recorded computation "
                         "(wrap the forward in autograd.record())")
    for h in heads:
        if not h._data.requires_grad:
            raise MXNetError("head array was not computed inside the "
                             "recorded scope")
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    cots = [torch.ones_like(h._data) if g is None else
            (g._data if isinstance(g, NDArray) else
             torch.as_tensor(g, dtype=h._data.dtype, device=h._data.device))
            for h, g in zip(heads, head_grads)]
    variables = [v for v in tape.variables.values()
                 if v._grad is not None and v._data.requires_grad]
    if variables:
        grads = torch.autograd.grad(
            [h._data for h in heads], [v._data for v in variables],
            grad_outputs=cots, retain_graph=retain_graph, allow_unused=True)
        with torch.no_grad():
            for var, g in zip(variables, grads):
                buf = var._grad._data
                if g is None:
                    if var._grad_req != "add":
                        buf.zero_()
                elif var._grad_req == "add":
                    buf.add_(g)
                else:
                    buf.copy_(g)
    if not retain_graph and st.tape is None:
        st.last_tape = None
