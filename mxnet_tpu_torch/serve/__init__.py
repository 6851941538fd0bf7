"""mx.serve — the inference subsystem (counterpart of `mxnet_tpu/serve`):
continuous batching over a paged KV cache on the card.

Pieces:

  * `kv_pages.PagePool` — host-side REFCOUNTED allocator over the fixed
    device page pools (page 0 reserved as the null page).
  * `prefix_cache.PrefixCache` — content-hashed radix index of full
    prompt pages: matching requests adopt cached pages and skip that
    prefill; LRU eviction under page pressure.
  * `speculate.propose_ngram` — the n-gram/prompt-lookup draft proposer
    (its widened verify step is a later slice).
  * `decode.DecodeRuntime` — the device state and the two steps:
    prefill (encoder, flash kernel, cross-attention K/V into a slot) and
    decode (in-place paged K/V writes + ONE ragged-paged-attention
    launch per layer for all slots).
  * `scheduler.Scheduler` — continuous batching: admit into free slots
    every step, evict finished requests immediately, bounded admission
    queue with `ServeOverloaded` backpressure, page-exhaustion
    preemption, `serve.admit`/`serve.decode` fault points with bounded
    retries.
  * `server.Server` — the request-level API: `submit` / `stream` /
    `wait` / `throughput`.
"""
from __future__ import annotations

from . import kv_pages
from . import prefix_cache
from . import speculate
from . import quant
from . import decode
from . import scheduler
from . import server
from .kv_pages import PagePool, PageAllocError
from .prefix_cache import PrefixCache
from .scheduler import (Request, Scheduler, ServeDeadlineExceeded,
                        ServeError, ServeOverloaded)
from .server import Server

__all__ = ["Server", "Request", "Scheduler", "PagePool", "PageAllocError",
           "PrefixCache", "ServeError", "ServeOverloaded",
           "ServeDeadlineExceeded", "kv_pages", "prefix_cache",
           "speculate", "quant", "decode", "scheduler", "server"]
