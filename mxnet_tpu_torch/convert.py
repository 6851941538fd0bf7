"""Carry weights across from the JAX package.

`load_jax_parameters(block, arrays)` takes what the JAX package's
`save_parameters` writes — `{structural name: numpy array}`, for
example `dict(np.load("net.params"))` — and puts it into a port block of
the same architecture (TransformerNMT, a zoo ResNet in either layout,
with the 7x7 stem or the space-to-depth one, which has its name and
shape, BatchNorm's `running_mean` / `running_var` included, or a BERT:
`BERTModel` and the `BERTForPretraining` / `BERTClassifier` /
`BERTRegression` heads, with the learned `encoder.position_weight`,
`mlm_bias`, and the MLM projection tied to `word_embed.weight`, one
parameter under one name). The name sets must match exactly and every
shape must agree.
(`block.load_parameters(filename)` reads such a file directly.)

`from_jax_weights(enc_w, dec_w)` takes the JAX package's serving
snapshots — `encoder_weights(model)` / `decoder_weights(model)` with
every array already converted to numpy (for example
`jax.tree.map(np.asarray, decoder_weights(model))`; this module never
touches JAX) — and returns a port `TransformerNMT` whose
`encoder_weights()` / `decoder_weights()` hold the same values. Dense
weights are `(out, in)` in both frameworks.

The JAX package's bfloat16 arrays (after `model.cast("bfloat16")`) come
over as numpy hands them out, ml_dtypes' bfloat16, and are read through
their 16-bit patterns (`base.from_numpy`): this module imports neither
JAX nor ml_dtypes. `load_jax_parameters` casts each value to its
parameter's dtype (cast the port block first to keep bfloat16);
`from_jax_weights` returns a bfloat16 model for bfloat16 snapshots.

`from_jax_snapshot(weights)` carries one such snapshot, as numpy, into
the port's snapshot layout directly — torch tensors in the same dict
structure — and takes the int8 snapshots of the JAX package's
`serve.quant` too (dense leaves `(w_int8, b, scale)` and the
`embed_scale` row scales), which no model holds. A port `DecodeRuntime`
runs on the result, so both packages' runtimes can be fed one identical
int8 snapshot.

`composite_params_from_jax(tree)` and `moe_params_from_jax(tree)` take
the parameter pytrees of the JAX package's `parallel.composite` and
`parallel.moe` as numpy arrays and return the port's trees (global, on
the device), every leaf checked against the port's `init_*`.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError, from_numpy
from .context import resolve_device
from .models.transformer import TransformerNMT

__all__ = ["load_jax_parameters", "from_jax_weights", "from_jax_snapshot",
           "composite_params_from_jax", "moe_params_from_jax"]

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


def _as_f32(x):
    """A float32 numpy copy of `x`, exact for a bfloat16 array."""
    return from_numpy(x).float().numpy()


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
            arrays[base + path + ".weight"] = _as_f32(w)
            arrays[base + path + ".bias"] = _as_f32(b)
        for key in ln_keys:
            g, b, e = snap[key]
            arrays[base + key + ".gamma"] = _as_f32(g)
            arrays[base + key + ".beta"] = _as_f32(b)
            eps.append(float(e))
    return arrays, eps


def from_jax_weights(enc_w, dec_w, device=None):
    """Build a port `TransformerNMT` on `device` (None = `mx.gpu(0)`)
    holding the JAX snapshots' values. Every array in `enc_w` / `dec_w`
    must be a numpy array (or convertible by `numpy.asarray`)."""
    if "embed_scale" in dec_w or "embed_scale" in enc_w:
        raise MXNetError("an int8 weight snapshot has no fp32 weights to "
                         "build a model from; use from_jax_snapshot")
    embed = _as_f32(dec_w["embed"])
    if not np.array_equal(embed, _as_f32(enc_w["embed"])):
        raise MXNetError("encoder and decoder snapshots must share the "
                         "tied embedding")
    vocab, units = embed.shape
    layers = dec_w["layers"]
    if len(enc_w["layers"]) != len(layers):
        raise MXNetError("encoder and decoder layer counts differ")
    hidden = np.asarray(layers[0]["ffn1"][0]).shape[0]
    pos = _as_f32(dec_w["pos"])
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
        stack._pos = _as_f32(snap_pos)
        lns = [getattr(layer, n) for layer in stack.layers for n in names]
        for ln, e in zip(lns, eps):
            ln._epsilon = e
    if np.asarray(dec_w["embed"]).dtype.name == "bfloat16":
        model.cast("bfloat16")
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
        return from_numpy(x).to(device)

    return carry(weights)


# ---------------------------------------------------------------------------
# the parallel package's parameter pytrees
# ---------------------------------------------------------------------------
def _tree_from_jax(tree, want, device, what):
    """`tree` (nested dicts of numpy arrays) as tensors on `device`,
    checked leaf by leaf against `want` ({name: shape}, nested alike):
    the same names, each shape, and one float dtype for every leaf."""
    dev = resolve_device(device)
    dtypes = set()

    def one(t, w, path):
        if isinstance(w, dict):
            if not isinstance(t, dict) or set(t) != set(w):
                got = sorted(t) if isinstance(t, dict) else type(t).__name__
                raise MXNetError(f"{what}: {path or 'the tree'} holds "
                                 f"{got}, want {sorted(w)}")
            return {k: one(t[k], w[k], f"{path}/{k}") for k in w}
        x = from_numpy(t)
        if tuple(x.shape) != tuple(w):
            raise MXNetError(f"{what}: {path} has shape {tuple(x.shape)}, "
                             f"want {tuple(w)}")
        dtypes.add(x.dtype)
        return x
    out = one(tree, want, "")
    if len(dtypes) != 1 or not next(iter(dtypes)).is_floating_point:
        raise MXNetError(f"{what}: the leaves' dtypes "
                         f"{sorted(map(str, dtypes))} are not one float dtype")

    def move(t):
        return {k: move(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(dev)
    return move(out)


def composite_params_from_jax(tree, device=None):
    """The JAX package's `init_composite_params` tree, every leaf a numpy
    array (`jax.tree.map(np.asarray, params)`), as the port's tree on
    `device` (None = `mx.gpu(0)`): the configuration is read off the
    leaves' shapes and every leaf is checked against the shapes of the
    port's `init_composite_params` for it."""
    from .parallel.composite import CompositeConfig, _param_shapes
    try:
        b = tree["blocks"]
        n_layers, d_model, n_heads, d_head = np.shape(b["wq"])
        cfg = CompositeConfig(
            vocab=np.shape(tree["embed"])[0], d_model=d_model,
            n_heads=n_heads, d_head=d_head, d_ff=np.shape(b["w1"])[2],
            n_experts=np.shape(b["wi_e"])[1],
            d_expert_ff=np.shape(b["wi_e"])[3], n_layers=n_layers,
            seq_len=np.shape(tree["pos"])[0])
    except (KeyError, TypeError, ValueError, IndexError) as e:
        raise MXNetError(f"composite params: not a composite tree ({e!r})")
    want = _param_shapes(cfg)

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    return _tree_from_jax(tree, shapes(want), device, "composite params")


def moe_params_from_jax(tree, device=None):
    """The JAX package's `init_moe_params` dict as numpy arrays, as the
    port's on `device` (None = `mx.gpu(0)`), checked against the shapes
    of the port's `init_moe_params`: gate (D, E), wi (E, D, F), wo (E,
    F, D)."""
    try:
        d, e = np.shape(tree["gate"])
        f = np.shape(tree["wi"])[2]
    except (KeyError, TypeError, ValueError, IndexError) as e:
        raise MXNetError(f"moe params: not a MoE tree ({e!r})")
    return _tree_from_jax(tree, {"gate": (d, e), "wi": (e, d, f),
                                 "wo": (e, f, d)}, device, "moe params")
