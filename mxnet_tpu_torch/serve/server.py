"""Request-level serving API: `serve.Server` (counterpart of
`mxnet_tpu/serve/server.py`, same signature plus `device=`).

    model = transformer_base(vocab_size=...)
    model.initialize(ctx=mx.gpu(0))                  # or load_parameters
    srv = mx.serve.Server(model, slots=8, page_size=16)
    h = srv.submit([5, 9, 11], max_new_tokens=32)   # source token ids
    print(h.result())                               # generated ids
    for tok in srv.stream([5, 9, 11]):              # or stream them
        ...
    srv.close()

One `Server` owns: the weight snapshots (`decoder_weights` /
`encoder_weights`) on its device, the device-resident paged KV state and
the prefill / decode steps (`serve.decode.DecodeRuntime`), the page
allocator (`serve.kv_pages.PagePool`), the continuous-batching
scheduler, and an engine-driven decode loop
(`serve.engine_bridge.EngineLoop`, the default): submissions from any
thread kick the loop, and decoding happens on the dependency engine's
worker threads under the server's device. `engine_driven=False` runs the
crank inline in `result()`/`stream()`/`wait()` instead — the
deterministic single-threaded mode.

The serving fast path: `speculative_k=k` drafts up to k tokens a turn
and verifies them in one widened step; `kv_dtype="int8"` stores the KV
pages in int8 with per-page scales (about 4x the tokens in the same
bytes); `weight_dtype="int8"` serves from per-channel int8 weight
snapshots.

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
from .engine_bridge import EngineLoop
from .kv_pages import PagePool
from .quant import (kv_page_bytes, pages_for_budget,
                    quantize_decoder_weights, quantize_encoder_weights)
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


class Server:
    """Continuous-batching inference server for a `TransformerNMT`.

    slots: max concurrent decoding requests; page_size: tokens per KV
    page; num_pages: device pool size INCLUDING the reserved null page;
    max_src_len: static source padding length; max_new_tokens: per-slot
    generation cap; max_prompt_len: per-slot decoder-prompt cap (page-
    budget denominator is prompt + generation); prefix_cache: share full
    prompt pages across requests through the content-hashed radix index;
    kv_hbm_bytes: size the pool from a device byte budget instead of a
    page count; speculative_k: tokens drafted per turn and verified in
    one widened step (0 = one-token turns). device: where the server
    runs — None means `mx.gpu(0)` (raises without a CUDA device);
    `device="cpu"` runs the plain versions of the kernels on the CPU.
    The model's weights are snapshotted onto that device.

    Low precision: `kv_dtype="int8"` stores K/V pages int8 with
    per-page/per-head scales; `weight_dtype="int8"` runs the decode and
    prefill products over per-output-channel int8 weight snapshots (the
    model's weights stay fp32). A quantized server keeps a lazily built
    full-precision twin: a `serve.quant` fault degrades that request to
    it, with the output of an fp32 server."""

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
        if weight_dtype not in (None, "float32", "int8"):
            raise MXNetError(f"weight_dtype must be None/'float32'/"
                             f"'int8', got {weight_dtype!r}")
        self.max_new_tokens = int(max_new_tokens)
        self.max_prompt_len = int(max_prompt_len)
        self.speculative_k = int(speculative_k)
        self.kv_dtype = kv_dtype if kv_dtype != "float32" else None
        self.weight_dtype = weight_dtype if weight_dtype != "float32" \
            else None
        self.device = device
        dec_w = _to(decoder_weights(model), device)
        enc_w = _to(encoder_weights(model), device)
        if self.weight_dtype == "int8":
            dec_w = quantize_decoder_weights(dec_w)
            enc_w = quantize_encoder_weights(enc_w)
        u = dec_w["embed"].shape[1]
        h = dec_w["num_heads"]
        n_layers = len(dec_w["layers"])
        page_dtype = self.kv_dtype or dec_w["pos"].dtype
        budget_tokens = int(max_new_tokens) + self.max_prompt_len
        if num_pages is None:
            if kv_hbm_bytes is not None:
                num_pages = pages_for_budget(
                    kv_hbm_bytes, n_layers, int(page_size), h, u // h,
                    page_dtype)
            else:
                # every slot can hold a full-length request + null page
                num_pages = slots * \
                    (-(-budget_tokens // int(page_size))) + 1
        elif kv_hbm_bytes is not None:
            raise MXNetError("pass num_pages OR kv_hbm_bytes, not both")
        pbytes = kv_page_bytes(n_layers, int(page_size), h, u // h,
                               page_dtype)
        self._pool = PagePool(num_pages, page_size, page_bytes=pbytes)
        pages_per_slot = self._pool.pages_for(budget_tokens)
        self._rt = DecodeRuntime(
            dec_w, enc_w, slots=slots,
            num_pages=num_pages, page_size=page_size,
            max_pages_per_slot=pages_per_slot, max_src_len=max_src_len,
            width=self.speculative_k + 1, kv_dtype=self.kv_dtype)
        # a quantized server keeps the model so a serve.quant fault can
        # degrade a request to a lazily built full-precision twin
        self._model = model if (self.kv_dtype or self.weight_dtype) \
            else None
        self._fp_twin = None
        self._fp_lock = threading.Lock()
        quant_fallback = self._full_precision_decode if \
            self._model is not None else None
        self._sched = Scheduler(self._rt, self._pool, bos_id=bos_id,
                                eos_id=eos_id, max_queue=max_queue,
                                max_retries=max_retries,
                                static_batching=static_batching,
                                prefix_cache=prefix_cache,
                                quant_fallback=quant_fallback)
        self._engine_driven = bool(engine_driven)
        self._loop = EngineLoop(self._sched, device) \
            if self._engine_driven else None
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
        (engine-driven, they wait on the loop; inline, they crank the
        scheduler themselves).

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
            if self._loop is not None:
                self._loop.kick()
            else:
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
        """Await completion of `handles` (or ALL traffic when None):
        inline mode cranks the scheduler up to the deadline; engine mode
        waits on the loop / the handles' events. Returns True when
        everything asked for finished (failed counts as finished), False
        on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def expired():
            return deadline is not None and time.monotonic() > deadline

        if handles is None:
            if self._loop is not None:
                return self._loop.wait_idle(timeout)
            while self._sched.pending_work():
                if expired():
                    return False
                self._sched.step()
            return True
        for h in handles:
            if self._loop is None:
                while not h.done():
                    if expired():
                        return False
                    self._sched.step()
            else:
                rem = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if not h._done.wait(rem):
                    return False
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

    def _full_precision_decode(self, src, prompt, max_new,
                               deadline=None):
        """The serve.quant degradation path: decode ONE request through a
        lazily built full-precision twin server (1 slot, inline, no
        prefix cache, no speculation) on this server's device, so its
        greedy output is an fp32 `Server`'s, and the request never
        touches the quantized state or this server's page pool. The twin
        is built at the first fault only. `deadline` is the request's
        absolute monotonic deadline: the remaining budget becomes the
        twin request's `deadline_ms`, so expiry surfaces as the same
        `ServeDeadlineExceeded` as on the normal path."""
        deadline_ms = None
        if deadline is not None:
            deadline_ms = max(0.0, (deadline - time.monotonic()) * 1e3)
        with self._fp_lock:
            if self._fp_twin is None:
                self._fp_twin = Server(
                    self._model, slots=1,
                    page_size=self._pool.page_size,
                    max_src_len=self._rt.max_src_len,
                    max_new_tokens=self.max_new_tokens,
                    max_prompt_len=self.max_prompt_len,
                    bos_id=self._sched.bos_id, eos_id=self._sched.eos_id,
                    prefix_cache=False, engine_driven=False,
                    device=self.device)
            h = self._fp_twin.submit(
                src, max_new,
                prompt_tokens=prompt if len(prompt) else None,
                deadline_ms=deadline_ms)
            return h.result(timeout=600)

    def close(self):
        """Stop the loop (its queued task is cancelled, the running one
        drained) and FAIL any still-pending requests (their handles
        unblock with `ServeError`, their pages return to the pool) —
        close never strands a held `Request`."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if self._loop is not None:
            self._loop.close()
        self._sched.shutdown()
        if self._rt.kv_quant:
            # the gauge is last-writer-wins across servers (like
            # serve_tokens_per_s); a closed pool's scale bytes are gone
            _obs_registry().gauge("kv_page_scale_bytes").set(0)
        with self._fp_lock:
            if self._fp_twin is not None:
                self._fp_twin.close()
                self._fp_twin = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
