"""KV-page byte accounting (the pure-arithmetic part of
`mxnet_tpu/serve/quant.py`).

`kv_page_bytes` is what one KV page costs in device memory and
`pages_for_budget` turns a byte budget into a page count
(`Server(kv_hbm_bytes=...)`). The int8 weight and KV-cache snapshots of
the JAX module are a later slice (ROADMAP.md); only their byte sizes
are known here.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["kv_page_bytes", "pages_for_budget"]

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
