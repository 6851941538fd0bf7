"""Transformer NMT for serving (counterpart of
`mxnet_tpu/models/transformer.py`).

`TransformerNMT` is an `nn.Module` that holds the parameters of the
Sockeye / gluonnlp transformer_en_de encoder-decoder: a tied embedding
shared by encoder, decoder and output projection, fused-QKV
self-attention, fused-KV cross-attention, post-LN residual blocks.

Serving runs on weight SNAPSHOTS, as in the JAX package:
`encoder_weights(model)` / `decoder_weights(model)` return plain dicts
of tensors (dense leaves are `(w (out, in), b)`, LayerNorm leaves
`(gamma, beta, eps)`), and the functions below are pure functions of
those dicts — `encode_memory` (the prefill; its attention is the
flash kernel) and the factored decode core (`decode_embed`,
`decoder_layer_*`, `decode_project`) that `serve.decode` composes
around the ragged-paged-attention kernel.

The teacher-forcing `forward`, beam search and `decode_step` belong to
the training slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..ops.kernels import flash_attention, single_query_cached_attention

__all__ = ["TransformerNMT", "transformer_base", "sinusoid_table",
           "encoder_weights", "decoder_weights", "encode_memory",
           "precompute_memory_kv", "decode_embed", "decode_project",
           "decoder_layer_qkv", "decoder_layer_self_post",
           "decoder_layer_cross", "decoder_layer_ffn"]


def sinusoid_table(max_len, units):
    pos = np.arange(max_len)[:, None]
    dim = np.arange(units)[None, :]
    angle = pos / np.power(10000, (2 * (dim // 2)) / units)
    table = np.zeros((max_len, units), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class _Dense(nn.Module):
    """Parameters of one dense layer: weight (out, in), bias (out,)."""

    def __init__(self, units, in_units, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(units, in_units, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(units, device=device),
                                 requires_grad=False)


class _LayerNorm(nn.Module):
    def __init__(self, units, device, epsilon=1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(units, device=device),
                                  requires_grad=False)
        self.beta = nn.Parameter(torch.empty(units, device=device),
                                 requires_grad=False)
        self.epsilon = float(epsilon)


class _EncoderLayer(nn.Module):
    def __init__(self, units, hidden, device):
        super().__init__()
        self.qkv = _Dense(3 * units, units, device)
        self.proj = _Dense(units, units, device)
        self.ln1 = _LayerNorm(units, device)
        self.ffn1 = _Dense(hidden, units, device)
        self.ffn2 = _Dense(units, hidden, device)
        self.ln2 = _LayerNorm(units, device)


class _DecoderLayer(nn.Module):
    def __init__(self, units, hidden, device):
        super().__init__()
        self.qkv = _Dense(3 * units, units, device)
        self.sproj = _Dense(units, units, device)
        self.ln1 = _LayerNorm(units, device)
        self.q = _Dense(units, units, device)
        self.kv = _Dense(2 * units, units, device)
        self.cproj = _Dense(units, units, device)
        self.ln2 = _LayerNorm(units, device)
        self.ffn1 = _Dense(hidden, units, device)
        self.ffn2 = _Dense(units, hidden, device)
        self.ln3 = _LayerNorm(units, device)


class TransformerNMT(nn.Module):
    """Seq2seq NMT model parameters. Source/target embeddings and the
    output projection share one weight matrix (Sockeye's
    weight-tying=src_trg_softmax).

    device: where the parameters live — None means `mx.gpu(0)` (raises
    without a CUDA device); pass `device="cpu"` for the CPU. seed: the
    parameters are drawn from `numpy.random.RandomState(seed)` — dense
    and embedding weights uniform in [-0.07, 0.07] (MXNet's default
    initializer), biases 0, LayerNorm gamma 1 and beta 0; `seed=None`
    leaves them unset, for a loader that fills every one
    (`convert.from_jax_weights`). `dropout` is accepted for signature
    parity; serving runs without it."""

    def __init__(self, vocab_size, units=512, hidden=2048, num_layers=6,
                 num_heads=8, max_length=512, dropout=0.1, device=None,
                 seed=0):
        super().__init__()
        if units % num_heads:
            raise MXNetError("units must be divisible by num_heads")
        device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.units = int(units)
        self.num_heads = int(num_heads)
        self.dropout = float(dropout)
        self.embed = nn.Parameter(torch.empty(vocab_size, units,
                                              device=device),
                                  requires_grad=False)
        self.encoder_layers = nn.ModuleList(
            _EncoderLayer(units, hidden, device) for _ in range(num_layers))
        self.decoder_layers = nn.ModuleList(
            _DecoderLayer(units, hidden, device) for _ in range(num_layers))
        pos = torch.from_numpy(sinusoid_table(max_length, units))
        self.register_buffer("pos", pos.to(device))
        self.scale = math.sqrt(units)
        if seed is not None:
            self.initialize(seed)

    @property
    def device(self):
        return self.embed.device

    def initialize(self, seed=0):
        """Fill every parameter from `numpy.random.RandomState(seed)`
        (see the class docstring), in registration order."""
        rng = np.random.RandomState(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("bias", "beta"):
                    p.zero_()
                elif leaf == "gamma":
                    p.fill_(1.0)
                else:
                    p.copy_(torch.from_numpy(rng.uniform(
                        -0.07, 0.07, tuple(p.shape)).astype(np.float32)))

    def forward(self, *args, **kwargs):
        raise MXNetError("the teacher-forcing forward belongs to the "
                         "training slice (ROADMAP.md, Queue 1)")


def transformer_base(vocab_size=36548, **kwargs):
    """WMT16 En-De base config (Sockeye transformer parity): units 512,
    hidden 2048, 6 + 6 layers, 8 heads."""
    return TransformerNMT(vocab_size, units=512, hidden=2048, num_layers=6,
                          num_heads=8, **kwargs)


# ---------------------------------------------------------------------------
# weight snapshots
# ---------------------------------------------------------------------------
def _dense_w(dense):
    return dense.weight.detach(), dense.bias.detach()


def _ln_w(ln):
    return ln.gamma.detach(), ln.beta.detach(), ln.epsilon


def decoder_weights(model):
    """Snapshot the decoder's weights as a dict of tensors for the pure
    decode functions (same structure as the JAX package's)."""
    layers = []
    for layer in model.decoder_layers:
        layers.append(dict(
            qkv=_dense_w(layer.qkv), sproj=_dense_w(layer.sproj),
            q=_dense_w(layer.q), kv=_dense_w(layer.kv),
            cproj=_dense_w(layer.cproj),
            ffn1=_dense_w(layer.ffn1), ffn2=_dense_w(layer.ffn2),
            ln1=_ln_w(layer.ln1), ln2=_ln_w(layer.ln2),
            ln3=_ln_w(layer.ln3)))
    return dict(embed=model.embed.detach(), layers=layers, pos=model.pos,
                scale=float(model.scale), num_heads=model.num_heads)


def encoder_weights(model):
    """Snapshot the encoder's weights as a dict of tensors for the pure
    `encode_memory` (the serving prefill)."""
    layers = []
    for layer in model.encoder_layers:
        layers.append(dict(
            qkv=_dense_w(layer.qkv), proj=_dense_w(layer.proj),
            ffn1=_dense_w(layer.ffn1), ffn2=_dense_w(layer.ffn2),
            ln1=_ln_w(layer.ln1), ln2=_ln_w(layer.ln2)))
    return dict(embed=model.embed.detach(), layers=layers, pos=model.pos,
                scale=float(model.scale), num_heads=model.num_heads)


# ---------------------------------------------------------------------------
# pure functions of the snapshots
# ---------------------------------------------------------------------------
def _split_heads(x, n_heads):
    """(B, S, U) -> contiguous (B, H, S, U/H) (the kernels take
    contiguous inputs)."""
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2) \
        .contiguous()


def _merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _ln_apply(x, lnw):
    g, b, eps = lnw
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g + b


def _affine(x, wb):
    w, b = wb
    y = x @ w.T
    return y + b if b is not None else y


def _heads(x, h):
    b, u = x.shape
    return x.reshape(b, h, 1, u // h)


def encode_memory(weights, src, src_vl=None):
    """Encoder forward (inference, no dropout): src (B, S) int64 ->
    memory (B, S, U). The self-attention is `flash_attention` with the
    source lengths as key lengths — the flash kernel on the card."""
    h = weights["num_heads"]
    s = src.shape[1]
    x = weights["embed"][src] * weights["scale"] + weights["pos"][:s][None]
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
    """Embed the current token(s) at position(s) t: tok_t (B,) int64,
    t (B,) int64 -> (B, U)."""
    return weights["embed"][tok_t] * weights["scale"] + weights["pos"][t]


def decode_project(weights, x):
    """Tied output projection for the decode path: (B, U) -> (B, V)."""
    return x @ weights["embed"].T


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


def decoder_layer_ffn(L, x):
    """Position-wise FFN + residual + LN."""
    f = torch.relu(_affine(x, L["ffn1"]))
    return _ln_apply(x + _affine(f, L["ffn2"]), L["ln3"])
