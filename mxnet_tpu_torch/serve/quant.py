"""Int8 weight snapshots for serving and the KV-page byte accounting
(counterpart of `mxnet_tpu/serve/quant.py`).

The model keeps its full-precision parameters: a server with
`weight_dtype="int8"` quantizes a SNAPSHOT of the decode / encode weight
dicts at construction. Each dense leaf `(w, b)` becomes
`(w_int8, b, scale)` with one symmetric scale per output channel
(`contrib.quantization.quantize_channelwise(axis=0)`); the tied
embedding quantizes per vocabulary row (`embed_scale`). LayerNorm
parameters stay fp32. `models.transformer._affine` / `decode_project`
take the 3-tuple: the product runs over the int8 values converted to
fp32 and the scale is one multiply per output column.

`kv_page_bytes` is what one KV page costs in device memory (int8 pages
include their per-page scale rows), `pages_for_budget` turns a byte
budget into a page count (`Server(kv_hbm_bytes=...)`) and
`token_capacity` is the number of cached tokens that budget holds.
"""
from __future__ import annotations

from ..base import MXNetError
from ..contrib.quantization import quantize_channelwise

__all__ = ["quantize_decoder_weights", "quantize_encoder_weights",
           "kv_page_bytes", "pages_for_budget", "token_capacity"]

# the dense leaves of one decoder / encoder layer dict (the LayerNorm
# leaves ln1/ln2/ln3 stay fp32)
_DEC_DENSE = ("qkv", "sproj", "q", "kv", "cproj", "ffn1", "ffn2")
_ENC_DENSE = ("qkv", "proj", "ffn1", "ffn2")


def _quant_dense(wb):
    """(w, b) -> (w_int8, b, scale): per-output-channel symmetric int8."""
    w, b = wb
    wq, scale = quantize_channelwise(w, axis=0)
    return (wq, b, scale)


def _quant_tree(weights, dense_keys):
    out = dict(weights)
    embed_q, embed_scale = quantize_channelwise(weights["embed"], axis=0)
    out["embed"] = embed_q
    out["embed_scale"] = embed_scale      # per vocabulary row
    out["layers"] = [
        {k: (_quant_dense(v) if k in dense_keys else v)
         for k, v in layer.items()}
        for layer in weights["layers"]]
    return out


def quantize_decoder_weights(weights):
    """Per-channel int8 snapshot of a `decoder_weights(model)` dict (the
    decode path of `Server(weight_dtype="int8")`). The input dict and
    the model's weights are not modified."""
    return _quant_tree(weights, _DEC_DENSE)


def quantize_encoder_weights(weights):
    """Per-channel int8 snapshot of an `encoder_weights(model)` dict (the
    prefill path of `Server(weight_dtype="int8")`)."""
    return _quant_tree(weights, _ENC_DENSE)


_KV_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def kv_page_bytes(n_layers, page_size, num_heads, head_dim,
                  kv_dtype="float32"):
    """Device bytes ONE KV page costs: K + V across all decoder layers,
    plus (int8 mode) the per-page/per-head f32 scale rows the page drags
    along."""
    kv_dtype = str(kv_dtype).replace("torch.", "")
    if kv_dtype not in _KV_ITEMSIZE:
        raise MXNetError(f"unknown kv_dtype {kv_dtype!r} (one of "
                         f"{sorted(_KV_ITEMSIZE)})")
    per_side = n_layers * page_size * num_heads * head_dim \
        * _KV_ITEMSIZE[kv_dtype]
    scale = n_layers * num_heads * 4 if kv_dtype == "int8" else 0
    return 2 * (per_side + scale)


def pages_for_budget(budget_bytes, n_layers, page_size, num_heads,
                     head_dim, kv_dtype="float32"):
    """Pool size (num_pages, INCLUDING the reserved null page) a fixed
    device byte budget affords."""
    per_page = kv_page_bytes(n_layers, page_size, num_heads, head_dim,
                             kv_dtype)
    num_pages = int(budget_bytes) // per_page
    if num_pages < 2:
        raise MXNetError(
            f"kv_hbm_bytes={budget_bytes} affords {num_pages} page(s) of "
            f"{per_page} bytes — the pool needs at least 2 (one usable + "
            f"the reserved null page)")
    return num_pages


def token_capacity(budget_bytes, n_layers, page_size, num_heads, head_dim,
                   kv_dtype="float32"):
    """Usable cached tokens the budget holds (null page excluded)."""
    return (pages_for_budget(budget_bytes, n_layers, page_size, num_heads,
                             head_dim, kv_dtype) - 1) * page_size
