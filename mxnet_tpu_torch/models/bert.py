"""BERT for MLM + NSP pretraining (counterpart of
`mxnet_tpu/models/bert.py`; GluonNLP's bert_12_768_12 / bert_24_1024_16).

The same Gluon block tree as the JAX package, so its structural
parameter names (`bert.word_embed.weight`, `bert.encoder.position_weight`,
`bert.encoder.layers.0.attention.qkv.weight`, ..., `nsp.weight`) match
and a JAX `save_parameters` file loads into it and back:

  * fused QKV self-attention through `ops.kernels.flash_attention`, the
    padding mask passed as per-row key lengths (`valid_length` as int32
    `kv_lengths`): the flash kernels forward and backward on the card,
    no dense (B, 1, 1, S) mask;
  * post-LN encoder layers whose LayerNorms are `fused_layer_norm` (the
    LayerNorm kernel at D = 768, 1024 for `bert_large`), a GELU FFN (the
    tanh approximation, as `jax.nn.gelu`), learned positions;
  * a static-shape MLM head: `masked_positions` (B, P) gathered, a GELU
    transform and LayerNorm, then a projection tied to
    `word_embed.weight` plus `mlm_bias`, so the embedding takes gradient
    from both uses. The projection `bpd,vd->bpv` is a plain product, as
    the JAX package left it to XLA.

Only the eager path is ported: `hybridize()` is accepted and the blocks
run eagerly; the symbolic-export path waits for `symbol/` (ROADMAP.md,
Queue 1 [8]).

After `model.cast("bfloat16")` (`bench_bert.py:43`) every parameter is
bf16 and so is every activation: the embeddings, the learned positions,
the Dense layers (cuBLAS bf16 products), the GELUs, the bf16 forms of the
flash and LayerNorm kernels, and the heads with the tied projection; the
key lengths stay int32. A caller takes the loss on logits cast to fp32,
as `bench_bert.py:60-61` does.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import _apply
from ..ops.kernels import flash_attention
from ..ops.nn_ops import promote
from .transformer import _kv_len, _merge_heads, _split_heads

__all__ = ["BERTModel", "BERTEncoder", "BERTEncoderLayer",
           "MultiHeadSelfAttention", "PositionwiseFFN", "BERTForPretraining",
           "BERTClassifier", "BERTRegression", "bert_base", "bert_large",
           "get_bert"]


class MultiHeadSelfAttention(HybridBlock):
    """Self-attention with fused QKV and flash attention."""

    def __init__(self, units, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads != 0:
            raise MXNetError("units must be divisible by num_heads")
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, flatten=False, in_units=units,
                                prefix="qkv_")
            self.proj = nn.Dense(units, flatten=False, in_units=units,
                                 prefix="proj_")
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, valid_length=None):
        h = self._num_heads

        def attn(qkv, *maybe_vl):
            q, k, v = (_split_heads(t, h) for t in qkv.chunk(3, dim=-1))
            return _merge_heads(flash_attention(
                q, k, v, kv_lengths=_kv_len(maybe_vl)))

        inputs = [self.qkv(x)] + \
            ([valid_length] if valid_length is not None else [])
        return self.dropout(self.proj(_apply(attn, inputs)))


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn1 = nn.Dense(hidden_size, flatten=False, in_units=units,
                                 activation=activation, prefix="ffn1_")
            self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden_size,
                                 prefix="ffn2_")
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x):
        return self.dropout(self.ffn2(self.ffn1(x)))


class BERTEncoderLayer(HybridBlock):
    """Post-LN transformer layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadSelfAttention(units, num_heads, dropout)
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout)
            self.ln2 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, valid_length=None):
        x = self.ln1(x + self.attention(x, valid_length))
        return self.ln2(x + self.ffn(x))


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 max_length=512, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        with self.name_scope():
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), init="zeros")
            self.dropout = nn.Dropout(dropout)
            self.ln = nn.LayerNorm(in_channels=units)
            self.layers = nn.HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for _ in range(num_layers):
                    self.layers.add(BERTEncoderLayer(
                        units, hidden_size, num_heads, dropout))

    def hybrid_forward(self, F, x, valid_length=None, position_weight=None):
        seq_len = x.shape[1]
        x = _apply(lambda a, p: a + p[:seq_len][None], [x, position_weight])
        x = self.dropout(self.ln(x))
        for layer in self.layers:
            x = layer(x, valid_length)
        return x


class BERTModel(HybridBlock):
    """Token/segment embeddings + encoder + pooler + tied MLM decoder.

    forward(token_ids, segment_ids, valid_length=None, masked_positions=None)
      -> (sequence_output, pooled_output[, mlm_scores])
    matching gluonnlp's BERTModel output contract.

    As every Gluon block, it is built uninitialised: `initialize(ctx=...)`
    (None = `mx.gpu(0)`, which raises without a card) after
    `mx.random.seed(s)`, or load weights."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self.vocab_size = vocab_size
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units,
                                           prefix="word_embed_")
            self.token_type_embed = nn.Embedding(2, units,
                                                 prefix="token_type_embed_")
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, max_length, dropout)
            self.pooler = nn.Dense(units, flatten=False, activation="tanh",
                                   in_units=units, prefix="pooler_")
            # MLM head: transform + LN; decoder shares word_embed weight
            self.mlm_dense = nn.Dense(units, flatten=False, activation="gelu",
                                      in_units=units, prefix="mlm_dense_")
            self.mlm_ln = nn.LayerNorm(in_channels=units, prefix="mlm_ln_")
            self.mlm_bias = self.params.get("mlm_bias", shape=(vocab_size,),
                                            init="zeros")

    def hybrid_forward(self, F, token_ids, segment_ids, valid_length=None,
                       masked_positions=None, mlm_bias=None):
        # mlm_bias arrives as a registered-param kwarg; decode_mlm reads it
        # through Parameter.data(), as the JAX package does
        x = self.word_embed(token_ids) + self.token_type_embed(segment_ids)
        seq = self.encoder(x, valid_length)
        pooled = self.pooler(seq.slice_axis(axis=1, begin=0, end=1)
                             .reshape((0, -1)))
        if masked_positions is None:
            return seq, pooled
        return seq, pooled, self.decode_mlm(seq, masked_positions)

    def decode_mlm(self, seq, masked_positions):
        """Gather (B, P) positions, transform, project to the vocabulary
        with the tied embedding matrix: (B, P, vocab)."""
        def gather(s, pos):
            return torch.take_along_dim(s, pos.long()[:, :, None], dim=1)

        at = _apply(gather, [seq, masked_positions])
        h = self.mlm_ln(self.mlm_dense(at))
        w = self.word_embed.weight.data()
        b = self.mlm_bias.data()

        def project(hh, ww, bb):
            # float16 AMP leaves the tied embedding fp32 and h float16:
            # the product promotes as `jnp.einsum` does
            hh, ww = promote(hh, ww)
            return torch.matmul(hh, ww.T) + bb
        return _apply(project, [h, w, b])


class BERTForPretraining(HybridBlock):
    """MLM + NSP heads on BERTModel (gluonnlp BERTForPretrain contract):
    forward(token_ids, segment_ids, valid_length, masked_positions) ->
    (mlm scores (B, P, vocab), nsp scores (B, 2))."""

    def __init__(self, bert: BERTModel, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bert = bert
            self.nsp = nn.Dense(2, flatten=False, in_units=bert._units,
                                prefix="nsp_")

    def hybrid_forward(self, F, token_ids, segment_ids, valid_length,
                       masked_positions):
        _seq, pooled, mlm = self.bert(token_ids, segment_ids, valid_length,
                                      masked_positions)
        return mlm, self.nsp(pooled)


class BERTClassifier(HybridBlock):
    """Sentence(-pair) classification head on the pooled output
    (gluonnlp BERTClassifier contract: dropout -> dense(num_classes))."""

    def __init__(self, bert: BERTModel, num_classes=2, dropout=0.1,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bert = bert
            self.dropout = nn.Dropout(dropout) if dropout else None
            self.classifier = nn.Dense(num_classes, flatten=False,
                                       in_units=bert._units,
                                       prefix="classifier_")

    def hybrid_forward(self, F, token_ids, segment_ids, valid_length=None):
        _, pooled = self.bert(token_ids, segment_ids, valid_length)
        if self.dropout is not None:
            pooled = self.dropout(pooled)
        return self.classifier(pooled)


class BERTRegression(HybridBlock):
    """Single-value regression head on the pooled output (gluonnlp
    BERTRegression contract)."""

    def __init__(self, bert: BERTModel, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bert = bert
            self.dropout = nn.Dropout(dropout) if dropout else None
            self.regression = nn.Dense(1, flatten=False,
                                       in_units=bert._units,
                                       prefix="regression_")

    def hybrid_forward(self, F, token_ids, segment_ids, valid_length=None):
        _, pooled = self.bert(token_ids, segment_ids, valid_length)
        if self.dropout is not None:
            pooled = self.dropout(pooled)
        return self.regression(pooled)


_SPECS = {
    # name: (num_layers, units, hidden, heads)
    "bert_12_768_12": (12, 768, 3072, 12),
    "bert_24_1024_16": (24, 1024, 4096, 16),
}


def get_bert(model_name="bert_12_768_12", vocab_size=30522, max_length=512,
             dropout=0.1, **kwargs):
    if model_name not in _SPECS:
        raise MXNetError(f"unknown bert spec {model_name}")
    layers, units, hidden, heads = _SPECS[model_name]
    return BERTModel(vocab_size=vocab_size, units=units, hidden_size=hidden,
                     num_layers=layers, num_heads=heads, max_length=max_length,
                     dropout=dropout, **kwargs)


def bert_base(**kwargs):
    return get_bert("bert_12_768_12", **kwargs)


def bert_large(**kwargs):
    return get_bert("bert_24_1024_16", **kwargs)
