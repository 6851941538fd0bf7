"""Transformer NMT (counterpart of `mxnet_tpu/models/transformer.py`).

The Sockeye / gluonnlp transformer_en_de encoder-decoder as the JAX
package's Gluon block tree: a tied embedding shared by encoder, decoder
and output projection, fused-QKV self-attention, fused-KV
cross-attention, post-LN residual blocks. The tree gives the JAX
package's structural parameter names (`embed.weight`,
`encoder.layers.0.attn.qkv.weight`, ..., 193 of them for
`transformer_base`), so a JAX `save_parameters` file loads into it and
back.

Training runs the teacher-forcing `hybrid_forward(F, src, tgt,
src_valid_length)` under `autograd.record()`: every attention is
`flash_attention` (the flash kernels forward and backward on the card)
and every LayerNorm `fused_layer_norm` (the LayerNorm kernel).

Serving runs on weight SNAPSHOTS, as in the JAX package:
`encoder_weights(model)` / `decoder_weights(model)` read this tree into
plain dicts of tensors (dense leaves `(w (out, in), b)`, LayerNorm leaves
`(gamma, beta, eps)`), and the functions below are pure functions of
those dicts — `encode_memory` (the prefill; its attention is the flash
kernel) and the factored decode core (`decode_embed`, `decoder_layer_*`,
`decode_project`) that `serve.decode` composes around the
ragged-paged-attention kernel. An int8 snapshot (`serve.quant`) holds
its dense leaves as `(w_int8, b, scale)` and its embedding as int8 rows
with an `embed_scale` per row; the same functions take it.

`beam_search`, `beam_search_cached` and `decode_step` are not ported yet
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import _apply
from ..ops.kernels import flash_attention, single_query_cached_attention
from ..ops.nn_ops import promote

__all__ = ["SelfAttention", "CrossAttention", "EncoderLayer", "DecoderLayer",
           "TransformerEncoder", "TransformerDecoder", "TransformerNMT",
           "transformer_base", "sinusoid_table", "encoder_weights",
           "decoder_weights", "encode_memory", "precompute_memory_kv",
           "decode_embed", "decode_project", "decoder_layer_qkv",
           "decoder_layer_self_post", "decoder_layer_cross",
           "decoder_layer_cross_multi", "decoder_layer_ffn"]


def sinusoid_table(max_len, units):
    pos = np.arange(max_len)[:, None]
    dim = np.arange(units)[None, :]
    angle = pos / np.power(10000, (2 * (dim // 2)) / units)
    table = np.zeros((max_len, units), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _split_heads(x, n_heads):
    """(B, S, U) -> contiguous (B, H, S, U/H) (the kernels take
    contiguous inputs)."""
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2) \
        .contiguous()


def _merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _kv_len(maybe_vl):
    return maybe_vl[0].to(torch.int32).contiguous() if maybe_vl else None


# ---------------------------------------------------------------------------
# the block tree
# ---------------------------------------------------------------------------
class SelfAttention(HybridBlock):
    """Fused-QKV self-attention; `causal=True` for the decoder."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads != 0:
            raise MXNetError("units must be divisible by num_heads")
        self._h = num_heads
        self._causal = causal
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, flatten=False, in_units=units,
                                prefix="qkv_")
            self.proj = nn.Dense(units, flatten=False, in_units=units,
                                 prefix="proj_")
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, valid_length=None):
        h, causal = self._h, self._causal

        def attn(qkv, *maybe_vl):
            q, k, v = (_split_heads(t, h) for t in qkv.chunk(3, dim=-1))
            return _merge_heads(flash_attention(
                q, k, v, causal=causal, kv_lengths=_kv_len(maybe_vl)))

        inputs = [self.qkv(x)] + \
            ([valid_length] if valid_length is not None else [])
        return self.dropout(self.proj(_apply(attn, inputs)))


class CrossAttention(HybridBlock):
    """Decoder-to-encoder attention with a fused KV projection."""

    def __init__(self, units, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self._h = num_heads
        with self.name_scope():
            self.q = nn.Dense(units, flatten=False, in_units=units,
                              prefix="q_")
            self.kv = nn.Dense(2 * units, flatten=False, in_units=units,
                               prefix="kv_")
            self.proj = nn.Dense(units, flatten=False, in_units=units,
                                 prefix="proj_")
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, memory, mem_valid_length=None):
        h = self._h

        def attn(q_raw, kv_raw, *maybe_vl):
            k, v = (_split_heads(t, h) for t in kv_raw.chunk(2, dim=-1))
            return _merge_heads(flash_attention(
                _split_heads(q_raw, h), k, v, kv_lengths=_kv_len(maybe_vl)))

        inputs = [self.q(x), self.kv(memory)]
        if mem_valid_length is not None:
            inputs.append(mem_valid_length)
        return self.dropout(self.proj(_apply(attn, inputs)))


class _FFN(HybridBlock):
    def __init__(self, units, hidden, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn1 = nn.Dense(hidden, flatten=False, in_units=units,
                                 activation="relu", prefix="ffn1_")
            self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden,
                                 prefix="ffn2_")
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x):
        return self.dropout(self.ffn2(self.ffn1(x)))


class EncoderLayer(HybridBlock):
    def __init__(self, units, hidden, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attn = SelfAttention(units, num_heads, dropout)
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ffn = _FFN(units, hidden, dropout)
            self.ln2 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, valid_length=None):
        x = self.ln1(x + self.attn(x, valid_length))
        return self.ln2(x + self.ffn(x))


class DecoderLayer(HybridBlock):
    def __init__(self, units, hidden, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.self_attn = SelfAttention(units, num_heads, dropout,
                                           causal=True)
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.cross_attn = CrossAttention(units, num_heads, dropout)
            self.ln2 = nn.LayerNorm(in_channels=units)
            self.ffn = _FFN(units, hidden, dropout)
            self.ln3 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, memory, self_valid_length=None,
                       mem_valid_length=None):
        x = self.ln1(x + self.self_attn(x, self_valid_length))
        x = self.ln2(x + self.cross_attn(x, memory, mem_valid_length))
        return self.ln3(x + self.ffn(x))


class _Stack(HybridBlock):
    """What the encoder and the decoder share: the sinusoid table, the
    embedding scale, the input dropout and the layer stack."""

    def __init__(self, layer_cls, num_layers, units, hidden, num_heads,
                 max_length, dropout, **kwargs):
        super().__init__(**kwargs)
        self._pos = sinusoid_table(max_length, units)
        self._pos_on = {}                # device -> the table there
        self._scale = math.sqrt(units)
        with self.name_scope():
            self.dropout = nn.Dropout(dropout)
            self.layers = nn.HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for _ in range(num_layers):
                    self.layers.add(layer_cls(units, hidden, num_heads,
                                              dropout))

    def pos_table(self, device):
        table = self._pos_on.get(device)
        if table is None:
            table = self._pos_on[device] = torch.from_numpy(self._pos).to(
                device)
        return table

    def _embed_positions(self, x):
        s = x.shape[1]
        pos = self.pos_table(x.context)[:s][None]
        return self.dropout(_apply(lambda a: a * self._scale + pos, [x]))


class TransformerEncoder(_Stack):
    def __init__(self, num_layers, units, hidden, num_heads, max_length=512,
                 dropout=0.0, **kwargs):
        super().__init__(EncoderLayer, num_layers, units, hidden, num_heads,
                         max_length, dropout, **kwargs)

    def hybrid_forward(self, F, x, valid_length=None):
        x = self._embed_positions(x)
        for layer in self.layers:
            x = layer(x, valid_length)
        return x


class TransformerDecoder(_Stack):
    def __init__(self, num_layers, units, hidden, num_heads, max_length=512,
                 dropout=0.0, **kwargs):
        super().__init__(DecoderLayer, num_layers, units, hidden, num_heads,
                         max_length, dropout, **kwargs)

    def hybrid_forward(self, F, x, memory, self_valid_length=None,
                       mem_valid_length=None):
        x = self._embed_positions(x)
        for layer in self.layers:
            x = layer(x, memory, self_valid_length, mem_valid_length)
        return x


class TransformerNMT(HybridBlock):
    """Seq2seq NMT model. `model(src, tgt, src_valid_length=None)` ->
    logits over the target vocabulary (teacher forcing). Source and
    target embeddings and the output projection share one weight matrix
    (Sockeye's weight-tying=src_trg_softmax).

    As every Gluon block, it is built uninitialised: call
    `initialize(ctx=...)` (None = `mx.gpu(0)`, which raises without a
    card; `ctx=mx.cpu()` for the CPU), after `mx.random.seed(s)` for
    reproducible weights, or load weights."""

    def __init__(self, vocab_size, units=512, hidden=2048, num_layers=6,
                 num_heads=8, max_length=512, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self.vocab_size = vocab_size
        self._units = units
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, units, prefix="embed_")
            self.encoder = TransformerEncoder(num_layers, units, hidden,
                                              num_heads, max_length, dropout)
            self.decoder = TransformerDecoder(num_layers, units, hidden,
                                              num_heads, max_length, dropout)

    @property
    def device(self):
        """Where the weights live."""
        return self.embed.weight.data().context

    def encode(self, src, src_valid_length=None):
        return (self.encoder(self.embed(src), src_valid_length),
                src_valid_length)

    def project(self, x):
        """Tied output projection: logits = x @ embed.weight^T, in the
        promoted dtype of the two (fp32 logits for a cast model, whose
        activations are fp32 after the positional add), as the JAX
        package's einsum computes them."""
        def tied(a, w):
            a, w = promote(a, w)
            return a @ w.T
        return _apply(tied, [x, self.embed.weight.data()])

    def hybrid_forward(self, F, src, tgt, src_valid_length=None):
        memory, mem_vl = self.encode(src, src_valid_length)
        out = self.decoder(self.embed(tgt), memory, None, mem_vl)
        return self.project(out)


def transformer_base(vocab_size=36548, **kwargs):
    """WMT16 En-De base config (Sockeye transformer parity): units 512,
    hidden 2048, 6 + 6 layers, 8 heads."""
    return TransformerNMT(vocab_size, units=512, hidden=2048, num_layers=6,
                          num_heads=8, **kwargs)


# ---------------------------------------------------------------------------
# weight snapshots
# ---------------------------------------------------------------------------
def _dense_w(dense):
    w = dense.weight.data()._data.detach()
    b = dense.bias.data()._data.detach() if dense.bias is not None else None
    return w, b


def _ln_w(ln):
    return (ln.gamma.data()._data.detach(), ln.beta.data()._data.detach(),
            float(ln._epsilon))


def _snapshot(model, stack, layers, num_heads):
    embed = model.embed.weight.data()._data.detach()
    return dict(embed=embed, layers=layers,
                pos=stack.pos_table(embed.device), scale=float(stack._scale),
                num_heads=num_heads)


def decoder_weights(model):
    """Snapshot the decoder's weights as a dict of tensors for the pure
    decode functions (same structure as the JAX package's)."""
    dec = model.decoder
    layers = [dict(qkv=_dense_w(layer.self_attn.qkv),
                   sproj=_dense_w(layer.self_attn.proj),
                   q=_dense_w(layer.cross_attn.q),
                   kv=_dense_w(layer.cross_attn.kv),
                   cproj=_dense_w(layer.cross_attn.proj),
                   ffn1=_dense_w(layer.ffn.ffn1),
                   ffn2=_dense_w(layer.ffn.ffn2),
                   ln1=_ln_w(layer.ln1), ln2=_ln_w(layer.ln2),
                   ln3=_ln_w(layer.ln3))
              for layer in dec.layers]
    return _snapshot(model, dec, layers, dec.layers[0].self_attn._h)


def encoder_weights(model):
    """Snapshot the encoder's weights as a dict of tensors for the pure
    `encode_memory` (the serving prefill)."""
    enc = model.encoder
    layers = [dict(qkv=_dense_w(layer.attn.qkv),
                   proj=_dense_w(layer.attn.proj),
                   ffn1=_dense_w(layer.ffn.ffn1),
                   ffn2=_dense_w(layer.ffn.ffn2),
                   ln1=_ln_w(layer.ln1), ln2=_ln_w(layer.ln2))
              for layer in enc.layers]
    return _snapshot(model, enc, layers, enc.layers[0].attn._h)


# ---------------------------------------------------------------------------
# pure functions of the snapshots
# ---------------------------------------------------------------------------
def _ln_apply(x, lnw):
    g, b, eps = lnw
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g + b


def _matmul_t(x, w):
    """x @ w.T in the promoted dtype of the two, as `jnp.matmul` computes
    a product of two dtypes: a cast model's bf16 weights meet the fp32
    activations its fp32 positional table makes, and the product is
    fp32."""
    if w.dtype != x.dtype:
        x, w = promote(x, w)
    return x @ w.T


def _affine(x, wb):
    # a 3-tuple is a per-output-channel int8 weight (serve.quant): the
    # product runs over the int8 values converted to x's type and the
    # scale is one multiply per output column
    if len(wb) == 3:
        wq, b, s = wb
        y = (x @ wq.T.to(x.dtype)) * s.to(x.dtype)
    else:
        w, b = wb
        y = _matmul_t(x, w)
    return y + b if b is not None else y


def _embed_rows(weights, idx):
    """Embedding gather; an int8 embedding dequantizes the gathered rows
    with their per-row scales."""
    e = weights["embed"][idx]
    es = weights.get("embed_scale")
    if es is not None:
        e = e.to(weights["pos"].dtype) * es[idx][..., None]
    return e


@functools.lru_cache(maxsize=None)
def _weak_scalar(value, dtype):
    """A Python float as the JAX package applies it to an array of
    `dtype`: weakly typed, so rounded to a 16-bit dtype first."""
    if dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(value, dtype=dtype))
    return value


def _embed_scaled(weights, idx):
    """The embedded rows times the embedding scale, in the positional
    table's dtype (the activations'). For a cast model's bf16 rows this
    is what the JAX package's compiled prefill and decode compute: the
    scale rounds to bf16 (a weakly typed Python float), and XLA forms
    the product in fp32 without rounding it back (its excess precision),
    where it is exact."""
    e = _embed_rows(weights, idx)
    return e.to(weights["pos"].dtype) * _weak_scalar(weights["scale"],
                                                     e.dtype)


def _heads(x, h):
    b, u = x.shape
    return x.reshape(b, h, 1, u // h)


def encode_memory(weights, src, src_vl=None):
    """Encoder forward (inference, no dropout): src (B, S) int64 ->
    memory (B, S, U). The self-attention is `flash_attention` with the
    source lengths as key lengths — the flash kernel on the card."""
    h = weights["num_heads"]
    s = src.shape[1]
    x = _embed_scaled(weights, src) + weights["pos"][:s][None]
    kv_len = src_vl.to(torch.int32) if src_vl is not None else None
    for L in weights["layers"]:
        qkv = _affine(x, L["qkv"])
        q, k, v = (_split_heads(t, h) for t in qkv.chunk(3, dim=-1))
        a = _merge_heads(flash_attention(q, k, v, kv_lengths=kv_len))
        x = _ln_apply(x + _affine(a, L["proj"]), L["ln1"])
        f = torch.relu(_affine(x, L["ffn1"]))
        x = _ln_apply(x + _affine(f, L["ffn2"]), L["ln2"])
    return x


def precompute_memory_kv(weights, memory):
    """Cross-attention K/V for every layer, computed once per sequence:
    list of (k (B, H, S, dh), v (B, H, S, dh))."""
    out = []
    h = weights["num_heads"]
    for L in weights["layers"]:
        k, v = _affine(memory, L["kv"]).chunk(2, dim=-1)
        out.append((_split_heads(k, h), _split_heads(v, h)))
    return out


def decode_embed(weights, tok_t, t):
    """Embed the current token(s) at position(s) t: tok_t and t int64 of
    the same shape, (B,) or (B, W) -> (B, U) or (B, W, U)."""
    return _embed_scaled(weights, tok_t) + weights["pos"][t]


def decode_project(weights, x):
    """Tied output projection for the decode path: (..., U) -> (..., V).
    With an int8 embedding the per-row `embed_scale` is the projection's
    per-output-column scale."""
    es = weights.get("embed_scale")
    if es is not None:
        return (x @ weights["embed"].T.to(x.dtype)) * es.to(x.dtype)
    return _matmul_t(x, weights["embed"])


def decoder_layer_qkv(L, x):
    """Fused self-attention QKV projection: (B, U) -> three (B, U)."""
    return _affine(x, L["qkv"]).chunk(3, dim=-1)


def decoder_layer_self_post(L, x, attn):
    """Residual + proj + LN after self-attention. attn: (B, U) merged."""
    return _ln_apply(x + _affine(attn, L["sproj"]), L["ln1"])


def decoder_layer_cross(L, h, x, mk, mv, mem_vl=None):
    """Cross-attention over precomputed memory K/V (mk/mv (B, H, S, dh))
    for one decode token x (B, U), including residual + LN."""
    qc = _heads(_affine(x, L["q"]), h)
    keep = None
    if mem_vl is not None:
        pos = torch.arange(mk.shape[2], device=mk.device)
        keep = (pos[None, :] < mem_vl.long()[:, None])[:, None, None, :]
    attn = _merge_heads(
        single_query_cached_attention(qc, mk, mv, keep))[:, 0]
    return _ln_apply(x + _affine(attn, L["cproj"]), L["ln2"])


def decoder_layer_cross_multi(L, h, x, mk, mv, mem_vl=None):
    """Cross-attention over precomputed memory K/V for a window of decode
    tokens (the widened verify step): x (B, W, U), mk/mv (B, H, S, dh).
    Each window row runs the math `decoder_layer_cross` runs for one
    token."""
    qc = _split_heads(_affine(x, L["q"]), h)          # (B, H, W, dh)
    keep = None
    if mem_vl is not None:
        pos = torch.arange(mk.shape[2], device=mk.device)
        keep = (pos[None, :] < mem_vl.long()[:, None])[:, None, None, :]
    attn = _merge_heads(single_query_cached_attention(qc, mk, mv, keep))
    return _ln_apply(x + _affine(attn, L["cproj"]), L["ln2"])


def decoder_layer_ffn(L, x):
    """Position-wise FFN + residual + LN."""
    f = torch.relu(_affine(x, L["ffn1"]))
    return _ln_apply(x + _affine(f, L["ffn2"]), L["ln3"])
