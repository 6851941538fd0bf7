"""Request-level serving API: `serve.Server` (counterpart of
`mxnet_tpu/serve/server.py`, same signature plus `device=`).

    model = transformer_base(vocab_size=...)
    model.initialize(ctx=mx.gpu(0))                  # or load_parameters
    srv = mx.serve.Server(model, slots=8, page_size=16,
                          engine_driven=False)
    h = srv.submit([5, 9, 11], max_new_tokens=32)   # source token ids
    print(h.result())                               # generated ids
    for tok in srv.stream([5, 9, 11]):              # or stream them
        ...
    srv.close()

One `Server` owns: the weight snapshots (`decoder_weights` /
`encoder_weights`) on its device, the device-resident paged KV state and
the prefill / decode steps (`serve.decode.DecodeRuntime`), the page
allocator (`serve.kv_pages.PagePool`) and the continuous-batching
scheduler. `engine_driven=False` runs the crank inline in
`result()`/`stream()`/`wait()` — the deterministic single-threaded mode.

Settings that need a later slice raise `MXNetError` naming the ROADMAP
item instead of falling back: `engine_driven=True` (the dependency
engine), `speculative_k > 0` (the widened decode step and
`_rpa_multi_kernel`), `kv_dtype="int8"` (the RPA int8 page path) and
`weight_dtype="int8"` (int8 weight snapshots).

Observability: per-request TTFT/latency histograms
(`serve_ttft_seconds`, `serve_request_seconds`), `serve_tokens`, the
`serve_tokens_per_s` gauge via `throughput()`, queue/slot gauges,
decode-step times (`serve_decode_step_seconds`) and KV-page accounting
from the pool.
"""
from __future__ import annotations

import threading
import time

from ..base import MXNetError
from ..context import resolve_device
from ..models.transformer import decoder_weights, encoder_weights
from ..observability import registry as _obs_registry
from .decode import DecodeRuntime
from .kv_pages import PagePool
from .quant import kv_page_bytes, pages_for_budget
from .scheduler import Scheduler

__all__ = ["Server"]


def _to(weights, device):
    """A snapshot dict with every tensor on `device` (no copy when it is
    already there)."""
    def move(x):
        if hasattr(x, "to"):
            return x.to(device)
        if isinstance(x, tuple):
            return tuple(move(t) for t in x)
        if isinstance(x, list):
            return [move(t) for t in x]
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return x
    return move(weights)


def _unported(setting, item):
    return MXNetError(f"Server({setting}) is not ported yet (ROADMAP.md, "
                      f"{item})")


class Server:
    """Continuous-batching inference server for a `TransformerNMT`.

    slots: max concurrent decoding requests; page_size: tokens per KV
    page; num_pages: device pool size INCLUDING the reserved null page;
    max_src_len: static source padding length; max_new_tokens: per-slot
    generation cap; max_prompt_len: per-slot decoder-prompt cap (page-
    budget denominator is prompt + generation); prefix_cache: share full
    prompt pages across requests through the content-hashed radix index;
    kv_hbm_bytes: size the pool from a device byte budget instead of a
    page count. device: where the server runs — None means `mx.gpu(0)`
    (raises without a CUDA device); `device="cpu"` runs the plain
    versions of the kernels on the CPU. The model's weights are
    snapshotted onto that device."""

    def __init__(self, model, slots=8, page_size=16, num_pages=None,
                 max_src_len=32, max_new_tokens=32, max_prompt_len=0,
                 speculative_k=0, prefix_cache=True, bos_id=2, eos_id=3,
                 max_queue=64, max_retries=1, static_batching=False,
                 engine_driven=True, kv_dtype=None, weight_dtype=None,
                 kv_hbm_bytes=None, device=None):
        device = resolve_device(device)
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if speculative_k < 0:
            raise MXNetError("speculative_k must be >= 0")
        if speculative_k > 0:
            raise _unported("speculative_k>0", "Queue 1: serving fast "
                            "path, with _rpa_multi_kernel in Queue 2")
        if kv_dtype not in (None, "float32"):
            raise _unported(f"kv_dtype={kv_dtype!r}",
                            "Queue 2: the RPA int8 page path")
        if weight_dtype not in (None, "float32"):
            raise _unported(f"weight_dtype={weight_dtype!r}",
                            "Queue 1: int8 serving")
        if engine_driven:
            raise _unported("engine_driven=True", "Queue 1: the dependency "
                            "engine; pass engine_driven=False")
        self.max_new_tokens = int(max_new_tokens)
        self.max_prompt_len = int(max_prompt_len)
        self.speculative_k = 0
        self.kv_dtype = None
        self.weight_dtype = None
        self.device = device
        dec_w = _to(decoder_weights(model), device)
        enc_w = _to(encoder_weights(model), device)
        u = dec_w["embed"].shape[1]
        h = dec_w["num_heads"]
        n_layers = len(dec_w["layers"])
        budget_tokens = int(max_new_tokens) + self.max_prompt_len
        if num_pages is None:
            if kv_hbm_bytes is not None:
                num_pages = pages_for_budget(
                    kv_hbm_bytes, n_layers, int(page_size), h, u // h,
                    dec_w["pos"].dtype)
            else:
                # every slot can hold a full-length request + null page
                num_pages = slots * \
                    (-(-budget_tokens // int(page_size))) + 1
        elif kv_hbm_bytes is not None:
            raise MXNetError("pass num_pages OR kv_hbm_bytes, not both")
        pbytes = kv_page_bytes(n_layers, int(page_size), h, u // h,
                               dec_w["pos"].dtype)
        self._pool = PagePool(num_pages, page_size, page_bytes=pbytes)
        pages_per_slot = self._pool.pages_for(budget_tokens)
        self._rt = DecodeRuntime(
            dec_w, enc_w, slots=slots,
            num_pages=num_pages, page_size=page_size,
            max_pages_per_slot=pages_per_slot, max_src_len=max_src_len)
        self._sched = Scheduler(self._rt, self._pool, bos_id=bos_id,
                                eos_id=eos_id, max_queue=max_queue,
                                max_retries=max_retries,
                                static_batching=static_batching,
                                prefix_cache=prefix_cache)
        self._closed = False
        # serialises submit() against close(): a submit that slips past
        # the closed check after shutdown drained the queue would strand
        # its handle forever
        self._close_lock = threading.Lock()
        self._t_start = time.perf_counter()
        self._m_tps = _obs_registry().gauge("serve_tokens_per_s")

    # ------------------------------------------------------------- API
    @property
    def scheduler(self):
        return self._sched

    @property
    def runtime(self):
        return self._rt

    @property
    def pool(self):
        return self._pool

    @property
    def prefix_cache(self):
        """The radix prefix cache (None when disabled)."""
        return self._sched.prefix_cache

    def submit(self, src_tokens, max_new_tokens=None, prompt_tokens=None,
               deadline_ms=None):
        """Enqueue a request; returns its `Request` handle immediately.
        Raises `ServeOverloaded` under backpressure. The handle's
        `.result(timeout)` / `.stream(timeout)` / `.done()` consume it
        (and crank the scheduler inline).

        `prompt_tokens` is a decoder-side prompt (system prompt /
        few-shot template) teacher-forced before generation; its full KV
        pages are shared across requests through the content-hashed
        radix prefix cache, so a matching prefix skips that part of
        prefill. `deadline_ms` bounds the request END-TO-END (queue wait
        included): when it elapses the scheduler evicts the request —
        queued or mid-decode — with a clean `ServeDeadlineExceeded`,
        frees its KV pages, and counts it into `serve_deadline_expired`."""
        if prompt_tokens is not None \
                and len(prompt_tokens) > self.max_prompt_len:
            raise MXNetError(
                f"prompt of {len(prompt_tokens)} tokens exceeds this "
                f"server's max_prompt_len {self.max_prompt_len} (size "
                f"the server with max_prompt_len= to accept prompts)")
        with self._close_lock:
            if self._closed:
                raise MXNetError("Server is closed")
            req = self._sched.submit(
                src_tokens, max_new_tokens if max_new_tokens is not None
                else self.max_new_tokens, prompt_tokens=prompt_tokens,
                deadline_ms=deadline_ms)
            req._inline_sched = self._sched
            return req

    def stream(self, src_tokens, max_new_tokens=None, prompt_tokens=None,
               timeout=None, deadline_ms=None):
        """Submit + yield generated token ids as they are produced."""
        req = self.submit(src_tokens, max_new_tokens,
                          prompt_tokens=prompt_tokens,
                          deadline_ms=deadline_ms)
        yield from req.stream(timeout=timeout)

    def wait(self, handles=None, timeout=None):
        """Crank the scheduler until `handles` (or ALL traffic when None)
        finish. Returns True when everything asked for finished (failed
        counts as finished), False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def expired():
            return deadline is not None and time.monotonic() > deadline

        if handles is None:
            while self._sched.pending_work():
                if expired():
                    return False
                self._sched.step()
            return True
        for h in handles:
            while not h.done():
                if expired():
                    return False
                self._sched.step()
        return True

    def throughput(self):
        """THIS server's generated tokens/s since construction — counted
        per scheduler instance, so concurrent servers don't pollute each
        other (also sets the `serve_tokens_per_s` gauge, last-writer-
        wins across servers)."""
        dt = max(time.perf_counter() - self._t_start, 1e-9)
        tps = self._sched.tokens_generated / dt
        self._m_tps.set(tps)
        return tps

    def close(self):
        """FAIL any still-pending requests (their handles unblock with
        `ServeError`, their pages return to the pool) — close never
        strands a held `Request`."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._sched.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
