"""Carry a TransformerNMT's weights across from the JAX package.

`from_jax_weights(enc_w, dec_w)` takes the JAX package's structured
snapshots — `encoder_weights(model)` / `decoder_weights(model)` with
every array already converted to numpy (for example
`jax.tree.map(np.asarray, decoder_weights(model))`; this module never
touches JAX) — and returns a port `TransformerNMT` whose
`encoder_weights()` / `decoder_weights()` hold the same values.

The snapshots are used rather than `collect_params()` names, which
carry process-global counters (`transformernmt0_...`) that change with
every model a process builds. Dense weights are `(out, in)` in both
frameworks; the embedding is tied (encoder, decoder and projection
share it), so the port keeps it as one tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .models.transformer import TransformerNMT

__all__ = ["from_jax_weights"]

_ENC_DENSE = ("qkv", "proj", "ffn1", "ffn2")
_ENC_LN = ("ln1", "ln2")
_DEC_DENSE = ("qkv", "sproj", "q", "kv", "cproj", "ffn1", "ffn2")
_DEC_LN = ("ln1", "ln2", "ln3")


def _put(param, value):
    value = np.array(value, np.float32)       # a private, writable copy
    if tuple(param.shape) != value.shape:
        raise MXNetError(f"shape mismatch: parameter {tuple(param.shape)} "
                         f"vs snapshot {value.shape}")
    param.copy_(torch.from_numpy(value))


def _load_layer(layer, snap, dense_keys, ln_keys):
    for key in dense_keys:
        w, b = snap[key]
        dense = getattr(layer, key)
        _put(dense.weight, w)
        if b is None:
            raise MXNetError(f"dense {key!r} without a bias is not "
                             f"supported")
        _put(dense.bias, b)
    for key in ln_keys:
        g, b, eps = snap[key]
        ln = getattr(layer, key)
        _put(ln.gamma, g)
        _put(ln.beta, b)
        ln.epsilon = float(eps)


def from_jax_weights(enc_w, dec_w, device=None):
    """Build a port `TransformerNMT` on `device` (None = `mx.gpu(0)`)
    holding the JAX snapshots' values. Every array in `enc_w` / `dec_w`
    must be a numpy array (or convertible by `numpy.asarray`)."""
    if "embed_scale" in dec_w or "embed_scale" in enc_w:
        raise MXNetError("int8 weight snapshots are not ported yet "
                         "(ROADMAP.md, Queue 1: int8 serving)")
    embed = np.asarray(dec_w["embed"])
    if not np.array_equal(embed, np.asarray(enc_w["embed"])):
        raise MXNetError("encoder and decoder snapshots must share the "
                         "tied embedding")
    vocab, units = embed.shape
    layers = dec_w["layers"]
    if len(enc_w["layers"]) != len(layers):
        raise MXNetError("encoder and decoder layer counts differ")
    hidden = np.asarray(layers[0]["ffn1"][0]).shape[0]
    max_length = np.asarray(dec_w["pos"]).shape[0]
    model = TransformerNMT(vocab, units=units, hidden=hidden,
                           num_layers=len(layers),
                           num_heads=int(dec_w["num_heads"]),
                           max_length=max_length, device=device,
                           seed=None)
    with torch.no_grad():
        _put(model.embed, embed)
        for layer, snap in zip(model.encoder_layers, enc_w["layers"]):
            _load_layer(layer, snap, _ENC_DENSE, _ENC_LN)
        for layer, snap in zip(model.decoder_layers, layers):
            _load_layer(layer, snap, _DEC_DENSE, _DEC_LN)
        _put(model.pos, dec_w["pos"])
    return model
