"""Carry weights across from the JAX package.

`load_jax_parameters(block, arrays)` takes what the JAX package's
`save_parameters` writes — `{structural name: numpy array}`, for
example `dict(np.load("net.params"))` — and puts it into a port block of
the same architecture (TransformerNMT, or a zoo ResNet in either layout,
BatchNorm's `running_mean` / `running_var` included). The name sets
must match exactly and every shape must agree.
(`block.load_parameters(filename)` reads such a file directly.)

`from_jax_weights(enc_w, dec_w)` takes the JAX package's serving
snapshots — `encoder_weights(model)` / `decoder_weights(model)` with
every array already converted to numpy (for example
`jax.tree.map(np.asarray, decoder_weights(model))`; this module never
touches JAX) — and returns a port `TransformerNMT` whose
`encoder_weights()` / `decoder_weights()` hold the same values. Dense
weights are `(out, in)` in both frameworks.

`from_jax_snapshot(weights)` carries one such snapshot, as numpy, into
the port's snapshot layout directly — torch tensors in the same dict
structure — and takes the int8 snapshots of the JAX package's
`serve.quant` too (dense leaves `(w_int8, b, scale)` and the
`embed_scale` row scales), which no model holds. A port `DecodeRuntime`
runs on the result, so both packages' runtimes can be fed one identical
int8 snapshot.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .models.transformer import TransformerNMT

__all__ = ["load_jax_parameters", "from_jax_weights", "from_jax_snapshot"]

_ENC_DENSE = {"qkv": "attn.qkv", "proj": "attn.proj", "ffn1": "ffn.ffn1",
              "ffn2": "ffn.ffn2"}
_DEC_DENSE = {"qkv": "self_attn.qkv", "sproj": "self_attn.proj",
              "q": "cross_attn.q", "kv": "cross_attn.kv",
              "cproj": "cross_attn.proj", "ffn1": "ffn.ffn1",
              "ffn2": "ffn.ffn2"}


def load_jax_parameters(block, arrays, ctx=None):
    """Put `{structural name: array}` into `block`'s parameters on `ctx`
    (None = `mx.gpu(0)`): no name may be missing or extra, and every
    shape must match."""
    block._load_arrays(arrays, ctx, allow_missing=False, ignore_extra=False)


def _stack_arrays(prefix, snaps, dense_keys, ln_keys):
    """(structural name -> array, LayerNorm epsilons in layer order)."""
    arrays, eps = {}, []
    for i, snap in enumerate(snaps):
        base = f"{prefix}.layers.{i}."
        for key, path in dense_keys.items():
            w, b = snap[key]
            if b is None:
                raise MXNetError(f"dense {key!r} without a bias is not "
                                 f"supported")
            arrays[base + path + ".weight"] = np.asarray(w, np.float32)
            arrays[base + path + ".bias"] = np.asarray(b, np.float32)
        for key in ln_keys:
            g, b, e = snap[key]
            arrays[base + key + ".gamma"] = np.asarray(g, np.float32)
            arrays[base + key + ".beta"] = np.asarray(b, np.float32)
            eps.append(float(e))
    return arrays, eps


def from_jax_weights(enc_w, dec_w, device=None):
    """Build a port `TransformerNMT` on `device` (None = `mx.gpu(0)`)
    holding the JAX snapshots' values. Every array in `enc_w` / `dec_w`
    must be a numpy array (or convertible by `numpy.asarray`)."""
    if "embed_scale" in dec_w or "embed_scale" in enc_w:
        raise MXNetError("an int8 weight snapshot has no fp32 weights to "
                         "build a model from; use from_jax_snapshot")
    embed = np.asarray(dec_w["embed"], np.float32)
    if not np.array_equal(embed, np.asarray(enc_w["embed"])):
        raise MXNetError("encoder and decoder snapshots must share the "
                         "tied embedding")
    vocab, units = embed.shape
    layers = dec_w["layers"]
    if len(enc_w["layers"]) != len(layers):
        raise MXNetError("encoder and decoder layer counts differ")
    hidden = np.asarray(layers[0]["ffn1"][0]).shape[0]
    pos = np.asarray(dec_w["pos"], np.float32)
    model = TransformerNMT(vocab, units=units, hidden=hidden,
                           num_layers=len(layers),
                           num_heads=int(dec_w["num_heads"]),
                           max_length=pos.shape[0], dropout=0.0)
    arrays = {"embed.weight": embed}
    enc, enc_eps = _stack_arrays("encoder", enc_w["layers"], _ENC_DENSE,
                                 ("ln1", "ln2"))
    dec, dec_eps = _stack_arrays("decoder", layers, _DEC_DENSE,
                                 ("ln1", "ln2", "ln3"))
    arrays.update(enc)
    arrays.update(dec)
    load_jax_parameters(model, arrays, ctx=device)
    for stack, snap_pos, eps, names in (
            (model.encoder, enc_w["pos"], enc_eps, ("ln1", "ln2")),
            (model.decoder, pos, dec_eps, ("ln1", "ln2", "ln3"))):
        stack._pos = np.array(snap_pos, np.float32)
        lns = [getattr(layer, n) for layer in stack.layers for n in names]
        for ln, e in zip(lns, eps):
            ln._epsilon = e
    return model


def from_jax_snapshot(weights, device=None):
    """A JAX `encoder_weights` / `decoder_weights` snapshot (fp32 or the
    int8 one of `serve.quant`), every array as numpy, as the port's
    snapshot dict on `device` (None = `mx.gpu(0)`): arrays become tensors
    of the same dtype, tuples and lists keep their structure, and
    `scale` / `num_heads` / LayerNorm epsilons stay Python numbers."""
    device = resolve_device(device)

    def carry(x):
        if isinstance(x, dict):
            return {k: carry(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(carry(v) for v in x)
        if isinstance(x, (int, float)) or x is None:
            return x
        if isinstance(x, np.generic):
            return x.item()
        return torch.from_numpy(np.array(x)).to(device)

    return carry(weights)
