"""Continuous (inflight) batching scheduler (host-side copy of
`mxnet_tpu/serve/scheduler.py`).

Every `step()` is one turn of the serving crank:

  1. ADMIT — pop queued requests into free decode slots while pages are
     available (all-or-nothing first-page grant), running the runtime's
     prefill per admission;
  2. DECODE — one shared decode step for ALL active slots (mixed
     lengths share the ragged-paged-attention launch), growing each
     active request by one token and one cache position, allocating a
     fresh page exactly when a request crosses a page boundary;
  3. EVICT — requests that emitted EOS or hit their token budget leave
     their slot and return every page to the pool immediately, so the
     NEXT step can admit into the freed capacity. No drain barriers:
     short requests never wait for long ones (`static_batching=True`
     flips exactly this off — admission only into an EMPTY batch).

Backpressure: the admission queue is bounded (`max_queue`); a submit into
a full queue raises `ServeOverloaded` (counted) instead of buffering
unboundedly. A request that cannot get its next page mid-decode is
PREEMPTED — pages freed, requeued at the front — rather than deadlocking
the pool (`serve_page_preemptions`).

The serving fast path stacks two optimisations on the same
crank:

  * PREFIX CACHE — requests may carry a decoder-side `prompt_tokens`
    sequence (system prompt / few-shot template) that is teacher-forced
    into the paged KV cache before generation. Full prompt pages are
    indexed in a content-hashed radix tree (`prefix_cache.PrefixCache`);
    a later request with the same source and a matching prompt prefix
    ADOPTS those pages (refcounted sharing, never a copy) and skips that
    part of prefill. Under page pressure admission evicts LRU cache-only
    pages instead of failing (`serve_prefix_evictions`).
  * SPECULATIVE DECODING — with `width > 1` (Server(speculative_k=k)),
    each turn drafts up to k tokens by n-gram prompt lookup over the
    request's own committed history and verifies the whole window with
    ONE pass through the widened decode step; the accepted run +
    one corrective token commit together. Greedy output is IDENTICAL to
    the 1-wide loop — drafts only change how many turns it takes.

Fault discipline (fault/injection.py points `serve.admit` /
`serve.decode` / `serve.prefix` / `serve.speculate`): an admit-time
fault fails ONLY the request being admitted. A decode-time fault kills
the whole in-flight batch — every active request frees its pages and is
retried from scratch (bounded by `max_retries`) or failed cleanly;
either way `kv_pages_in_use` returns to baseline. An error raised by
the decode step itself
additionally resets the page pools AND clears the prefix cache (their
contents are no longer trustworthy after a partial in-place step). A
`serve.prefix` or `serve.speculate` fault merely DEGRADES — cache
lookup/insert skipped, turn runs unspeculated — with bitwise-identical
request output.
"""
from __future__ import annotations

import collections
import threading
import time

from ..base import MXNetError
from ..fault import injection as _finj
from ..observability import registry as _obs_registry
from ..observability import tracer as _tracer
from .kv_pages import NULL_PAGE, PageAllocError
from .prefix_cache import PrefixCache, content_key
from .speculate import propose_ngram

__all__ = ["Request", "Scheduler", "ServeError", "ServeOverloaded",
           "ServeDeadlineExceeded", "StepResult"]

_STREAM_END = object()


class ServeError(MXNetError):
    """A request failed inside the serving engine."""


class ServeOverloaded(ServeError):
    """Admission queue full — backpressure; retry later."""


class ServeDeadlineExceeded(ServeError):
    """The request's `deadline_ms` elapsed before it finished: it was
    evicted (queued or mid-decode), its pages freed, and
    `serve_deadline_expired` counted it."""


class Request:
    """One inference request + its result/stream plumbing. Create via
    `Server.submit`; consume via `.result()` / `.stream()` / `.tokens`."""

    def __init__(self, rid, src, max_new_tokens, prompt=None,
                 deadline_ms=None):
        self.id = rid
        self.src = src
        # decoder-side prompt: tokens teacher-forced into the
        # paged KV cache before free-running generation — the shared-
        # system-prompt material the radix prefix cache deduplicates
        self.prompt = [] if prompt is None else [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        # absolute monotonic deadline: survives retries/preemptions (the
        # budget is end-to-end, not per-attempt)
        self.deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1e3
        self.state = "queued"       # queued|running|done|failed
        self.tokens = []            # generated ids (EOS included if hit)
        self.error = None
        self._exc = None            # typed failure (ServeDeadlineExceeded)
        self.retries = 0            # fault retries (budget: max_retries)
        self.preemptions = 0        # page-pressure requeues (own budget)
        self.t_submit = time.perf_counter()
        self.t_first_token = None
        self.t_done = None
        self._slot = None
        self._pages = []
        self.known = None           # [BOS] + prompt + committed tokens
        self._n_table = 0           # valid page-table entries this attempt
        self._cache_done = False    # prompt pages offered to the cache
        self.prompt_cached_tokens = 0   # adopted prefix length (positions)
        self._content_key = None    # memoized source hash (Scheduler)
        self._admit_bypassed = 0    # warm-preference skips of THIS head
        self._done = threading.Event()
        self._chunks = collections.deque()  # streamed tokens + sentinel
        self._chunk_cv = threading.Condition()
        self._inline_sched = None   # set by Server(engine_driven=False)
        self._on_finish = None      # one-shot scheduler bookkeeping hook

    # ------------------------------------------------------- consumer
    @property
    def ttft(self):
        """Seconds from submit to first generated token (None until)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def latency(self):
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block until the request finishes; returns the generated token
        list, or raises `ServeError` if it failed. In inline mode
        (Server(engine_driven=False)) this call cranks the scheduler,
        still honouring the deadline."""
        wait_timeout = timeout
        if self._inline_sched is not None:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while not self._done.is_set():
                if deadline is not None and time.monotonic() > deadline:
                    break
                self._inline_sched.step()
            if deadline is not None:
                # the crank spent (part of) the budget; only the
                # remainder may be slept away below
                wait_timeout = max(0.0, deadline - time.monotonic())
        if not self._done.wait(wait_timeout):
            raise ServeError(f"request {self.id} timed out after "
                             f"{timeout}s")
        if self.state == "failed":
            if self._exc is not None:
                raise self._exc
            raise ServeError(f"request {self.id} failed: {self.error}")
        return list(self.tokens)

    def stream(self, timeout=None):
        """Yield generated token ids as they are produced; raises
        `ServeError` at the end if the request failed. `timeout` bounds
        the wait for EACH token (inline mode cranks the scheduler up to
        that per-token deadline)."""
        while True:
            with self._chunk_cv:
                item = self._chunks.popleft() if self._chunks else None
            if item is None:
                if self._inline_sched is not None:
                    deadline = None if timeout is None \
                        else time.monotonic() + timeout
                    while True:
                        with self._chunk_cv:
                            if self._chunks:
                                break
                        if deadline is not None and \
                                time.monotonic() > deadline:
                            raise ServeError(
                                f"request {self.id}: no token within "
                                f"{timeout}s")
                        self._inline_sched.step()
                    continue
                with self._chunk_cv:
                    while not self._chunks:
                        if not self._chunk_cv.wait(timeout):
                            raise ServeError(
                                f"request {self.id}: no token within "
                                f"{timeout}s")
                    item = self._chunks.popleft()
            if item is _STREAM_END:
                if self.state == "failed":
                    if self._exc is not None:
                        raise self._exc
                    raise ServeError(
                        f"request {self.id} failed: {self.error}")
                return
            yield item

    # ------------------------------------------------------- producer
    def _emit(self, tok):
        self.tokens.append(tok)
        with self._chunk_cv:
            self._chunks.append(tok)
            self._chunk_cv.notify_all()

    def _finish(self, state, error=None):
        self.state = state
        self.error = error
        self.t_done = time.perf_counter()
        cb, self._on_finish = self._on_finish, None
        if cb is not None:
            cb()
        with self._chunk_cv:
            self._chunks.append(_STREAM_END)
            self._chunk_cv.notify_all()
        self._done.set()


class StepResult:
    """What one scheduler turn did (truthy = progress was made)."""
    __slots__ = ("admitted", "decoded", "completed", "preempted", "retried")

    def __init__(self, admitted=0, decoded=0, completed=0, preempted=0,
                 retried=0):
        self.admitted = admitted
        self.decoded = decoded
        self.completed = completed
        self.preempted = preempted
        self.retried = retried

    def __bool__(self):
        return bool(self.admitted or self.decoded)


class Scheduler:
    def __init__(self, runtime, pool, bos_id=2, eos_id=3, max_queue=64,
                 max_retries=1, max_preemptions=8, static_batching=False,
                 prefix_cache=True, spec_ngram=2, quant_fallback=None):
        import numpy as np
        self._np = np
        self._rt = runtime
        self._pool = pool
        # speculative decoding rides the runtime's widened executable:
        # width = spec_k + 1 (window = current token + k drafts)
        self.width = int(getattr(runtime, "width", 1))
        self.spec_k = self.width - 1
        self.spec_ngram = int(spec_ngram)
        if prefix_cache is True:
            self._cache = PrefixCache(pool)
        elif prefix_cache:
            self._cache = prefix_cache      # caller-supplied instance
        else:
            self._cache = None
        self.bos_id = int(bos_id)
        self.eos_id = int(eos_id)
        self.max_queue = int(max_queue)
        self.max_retries = int(max_retries)
        # page-pressure preemptions are legitimate queueing, not faults —
        # they get their own (laxer) restart budget so transient capacity
        # pressure cannot burn a request's fault retries
        self.max_preemptions = int(max_preemptions)
        self.static_batching = bool(static_batching)
        # low-precision degradation path: on a `serve.quant`
        # fault, a quantized server routes THAT request through this
        # full-precision callback instead of the int8 executables —
        # identical greedy output to an fp32 server, no pages touched
        self._quant_fallback = quant_fallback
        s = runtime.slots
        self._slots = [None] * s                       # Request per slot
        self._page_tables = np.full(
            (s, runtime.max_pages_per_slot), NULL_PAGE, np.int32)
        self._lens = np.zeros((s,), np.int32)
        self._queue = collections.deque()
        self._lock = threading.Lock()
        # live admitted requests carrying a deadline — gates the per-turn
        # expiry sweep so deadline-free workloads never pay the O(queue)
        # scan (same idiom as engine._admit's _deadline_queued gate)
        self._deadline_live = 0
        self._deadline_lock = threading.Lock()
        # serialises whole turns: step() (engine loop or inline result()
        # cranks from several threads), defrag()'s device remap, and
        # shutdown() must never interleave mid-turn
        self._step_lock = threading.Lock()
        self._next_id = 0
        self.tokens_generated = 0   # per-instance (the registry counter
                                    # below is process-global)
        reg = _obs_registry()
        self._m_queue = reg.gauge("serve_queue_depth")
        self._m_queue.set(0)
        self._m_active = reg.gauge("serve_active_slots")
        self._m_active.set(0)
        self._m_tokens = reg.counter("serve_tokens")
        self._m_ok = reg.counter("serve_requests", result="ok")
        self._m_failed = reg.counter("serve_requests", result="failed")
        self._m_rejected = reg.counter("serve_requests", result="rejected")
        self._m_retries = reg.counter("serve_decode_retries")
        self._m_preempt = reg.counter("serve_page_preemptions")
        self._m_deadline = reg.counter("serve_deadline_expired")
        self._m_ttft = reg.histogram("serve_ttft_seconds")
        self._m_latency = reg.histogram("serve_request_seconds")
        self._m_step = reg.histogram("serve_decode_step_seconds")
        # speculative decoding telemetry: the acceptance
        # distribution is the regression signal — profiler.dumps() shows
        # it as a [serve-spec] row
        self._m_spec_hist = reg.histogram("serve_spec_accepted_tokens")
        self._m_spec_drafted = reg.counter("serve_spec_drafted")
        self._m_spec_accepted = reg.counter("serve_spec_accepted")
        self._m_spec_degraded = reg.counter("serve_spec_degraded")
        self._m_prefix_degraded = reg.counter("serve_prefix_degraded")
        self._m_quant_degraded = reg.counter("serve_quant_degraded")
        self._m_warm_pref = reg.counter("serve_prefix_admit_preferred")
        # per-instance tallies (registry counters are process-global)
        self.decode_turns = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

    # ------------------------------------------------------------ API
    @property
    def prefix_cache(self):
        """The radix prefix cache (None when disabled)."""
        return self._cache

    def submit(self, src_tokens, max_new_tokens, prompt_tokens=None,
               deadline_ms=None):
        """Enqueue a request; returns the `Request` handle. Raises
        `ServeOverloaded` when the bounded admission queue is full and
        `ServeError` when the `serve.admit` fault point fires.
        `prompt_tokens` is a decoder-side prompt teacher-
        forced before generation begins — its full KV pages are shared
        through the radix prefix cache, so a later request with the same
        source and a matching prompt prefix adopts them and skips that
        part of prefill. `deadline_ms` bounds the request END-TO-END
        (queue wait included): once it elapses the request is evicted
        wherever it is — queued or mid-decode — with
        `ServeDeadlineExceeded`, its pages freed and
        `serve_deadline_expired` counting the eviction."""
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        prompt = [] if prompt_tokens is None else [
            int(t) for t in self._np.asarray(prompt_tokens,
                                             self._np.int32).reshape(-1)]
        budget = self._rt.max_pages_per_slot * self._rt.page_size
        if len(prompt) + max_new > budget:
            raise MXNetError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the per-slot page budget "
                f"({self._rt.max_pages_per_slot} pages x "
                f"{self._rt.page_size})")
        need = self._pool.pages_for(len(prompt) + max_new)
        if need > self._pool.capacity:
            # doomed even with the pool to itself: reject at submit time
            # instead of burning prefills + retries on guaranteed
            # mid-decode page exhaustion
            raise MXNetError(
                f"prompt + max_new_tokens ({len(prompt)} + {max_new}) "
                f"needs {need} pages but the pool only has "
                f"{self._pool.capacity} total")
        src = self._np.asarray(src_tokens, self._np.int32).reshape(-1)
        if src.size == 0:
            raise MXNetError("src_tokens must be non-empty (an empty "
                             "source has no cross-attention context)")
        if src.size > self._rt.max_src_len:
            raise MXNetError(f"source length {src.size} exceeds the "
                             f"server's max_src_len "
                             f"{self._rt.max_src_len}")
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        req = Request(rid, src, max_new, prompt=prompt,
                      deadline_ms=deadline_ms)
        try:
            if _finj.ENABLED:
                _finj.check("serve.admit", context=f"request {rid}")
        except Exception as e:
            self._m_failed.inc()
            req._finish("failed", f"admit fault: {e!r}")
            raise ServeError(f"request {rid} rejected at admission: "
                             f"{e}") from e
        with self._lock:
            if len(self._queue) >= self.max_queue:
                self._m_rejected.inc()
                req._finish("failed", "admission queue full")
                raise ServeOverloaded(
                    f"admission queue full ({self.max_queue}); retry "
                    "later")
            self._queue.append(req)
            self._m_queue.set(len(self._queue))
            if req.deadline is not None:
                with self._deadline_lock:
                    self._deadline_live += 1
                req._on_finish = self._dec_deadline_live
        if _tracer.ACTIVE:
            _tracer.instant("serve.submit", args={"id": rid})
        return req

    def pending_work(self):
        with self._lock:
            return bool(self._queue) or any(
                r is not None for r in self._slots)

    def active_count(self):
        return sum(1 for r in self._slots if r is not None)

    # ----------------------------------------------------------- step
    def step(self):
        """One serving turn: admit -> decode -> evict. Returns a
        `StepResult` (truthy when any progress was made). Turns are
        serialised on an internal lock (inline handles may crank from
        several threads; `defrag`/`shutdown` take the same lock)."""
        with self._step_lock:
            return self._step_locked()

    def _step_locked(self):
        res = StepResult()
        self._expire_deadlines()
        res.admitted = self._admit()
        active = [(s, r) for s, r in enumerate(self._slots)
                  if r is not None]
        if not active:
            self._m_active.set(0)
            return res
        t0 = time.perf_counter()
        try:
            if _finj.ENABLED:
                _finj.check("serve.decode",
                            context=f"{len(active)} active")
            plans = self._plan_turn(active, res)
            active = [(s, r) for s, r in enumerate(self._slots)
                      if r is not None]
            if not active:
                return res
            next_tok = self._decode(active, plans)
        except _finj.FaultInjected as e:
            self._fail_inflight(active, res, e, reset_pages=False)
            return res
        except Exception as e:  # step error: pages untrustworthy
            self._fail_inflight(active, res, e, reset_pages=True)
            return res
        self._m_step.observe(time.perf_counter() - t0)
        res.decoded = len(active)
        self.decode_turns += 1
        now = time.perf_counter()
        for s, r in active:
            window, f = plans[s]
            q = len(window)
            g = next_tok[s]                    # (width,) host int32
            L = int(self._lens[s])
            commits = []
            accepted = 0
            if L + f == len(r.known):
                # the window reaches the generation frontier: g[f-1] is
                # the greedy token after the last known one, and each
                # accepted draft (window[i+1] == g[i]) validates one
                # more greedy commit — EXACTLY the tokens the 1-wide
                # loop would have produced over as many turns
                i = f - 1
                while True:
                    tok = int(g[i])
                    commits.append(tok)
                    if tok == self.eos_id or \
                            len(r.tokens) + len(commits) \
                            >= r.max_new_tokens:
                        break
                    if i + 1 < q and window[i + 1] == tok:
                        i += 1
                        continue
                    break
                accepted = i - (f - 1)
                self._lens[s] = L + f + accepted
            else:
                # pure prompt turn: every window token was forced, every
                # prediction is for a position we already know
                self._lens[s] = L + q
            if q > f:
                drafted = q - f
                self._m_spec_drafted.inc(drafted)
                self.spec_drafted += drafted
                self._m_spec_accepted.inc(accepted)
                self.spec_accepted += accepted
                self._m_spec_hist.observe(accepted)
            self._offer_prompt_pages(s, r)
            if not commits:
                continue
            if r.t_first_token is None:
                r.t_first_token = now
            r.known.extend(commits)
            for tok in commits:
                r._emit(tok)
            if commits[-1] == self.eos_id \
                    or len(r.tokens) >= r.max_new_tokens:
                self._evict(s, r, "done")
                res.completed += 1
        self._m_active.set(self.active_count())
        return res

    def defrag(self):
        """Compact the page pool: renumber live pages into the low ids,
        remap the device pools (one gather dispatch) and every active
        slot's page table + request page list. Takes the step lock, so
        it is safe to call from any thread while the engine loop is
        decoding; a no-op when the pool is already compact. Returns the
        number of pages that moved."""
        with self._step_lock:
            return self._defrag_locked()

    def _defrag_locked(self):
        mapping = self._pool.defrag()
        if not mapping:
            return 0
        self._rt.remap_pages(mapping)
        np = self._np
        remap = np.arange(self._rt.num_pages)
        for old, new in mapping.items():
            remap[old] = new
        self._page_tables = remap[self._page_tables].astype(np.int32)
        for r in self._slots:
            if r is not None:
                r._pages = [mapping.get(p, p) for p in r._pages]
        if self._cache is not None:
            self._cache.remap(mapping)
        return len(mapping)

    def shutdown(self, reason="server closed"):
        """Fail every queued and in-flight request (pages freed, events
        set) — `Server.close()` calls this so held handles can never
        block forever on a stopped loop."""
        with self._step_lock:
            self._shutdown_locked(reason)

    def _shutdown_locked(self, reason):
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
            self._m_queue.set(0)
        for r in queued:
            self._m_failed.inc()
            r._finish("failed", reason)
        for s, r in enumerate(self._slots):
            if r is not None:
                self._release_slot(s, r)
                self._m_failed.inc()
                r._finish("failed", reason)
        if self._cache is not None:
            self._cache.clear()
        self._m_active.set(0)

    def run_until_idle(self, max_steps=100000):
        """Drive `step()` until queue and slots drain (tests/bench)."""
        for _ in range(max_steps):
            if not self.pending_work():
                return
            self.step()
        raise MXNetError("scheduler failed to drain")

    # ------------------------------------------------------- internals
    def _dec_deadline_live(self):
        with self._deadline_lock:
            self._deadline_live -= 1

    def _expire_deadlines(self):
        """Evict every request whose end-to-end deadline has elapsed —
        queued requests leave the admission queue, running ones leave
        their slot with pages freed — finishing each with a clean
        `ServeDeadlineExceeded` (serve_deadline_expired counts them).
        Gated on the live deadline count: a deadline-free workload pays
        one lock acquire per turn, not an O(queue) sweep."""
        with self._deadline_lock:
            if not self._deadline_live:
                return
        now = time.monotonic()
        expired = []
        with self._lock:
            stale = [r for r in self._queue
                     if r.deadline is not None and now > r.deadline]
            if stale:
                stale_ids = {id(r) for r in stale}   # O(n) rebuild, not
                keep = collections.deque(r for r in self._queue  # O(n*k)
                                         if id(r) not in stale_ids)
                self._queue = keep
                self._m_queue.set(len(keep))
                expired.extend(stale)
        for s, r in enumerate(self._slots):
            if r is not None and r.deadline is not None \
                    and now > r.deadline:
                self._release_slot(s, r)
                expired.append(r)
        for r in expired:
            self._m_deadline.inc()
            self._m_failed.inc()
            r._exc = ServeDeadlineExceeded(
                f"request {r.id} exceeded its deadline "
                f"({len(r.tokens)} token(s) generated)")
            r._finish("failed", "deadline exceeded")
            if _tracer.ACTIVE:
                _tracer.instant("serve.deadline_expired",
                                args={"id": r.id})
        if expired:
            self._m_active.set(self.active_count())

    def _admit(self):
        admitted = 0
        while True:
            # static mode: admit only into an EMPTY batch — but fill the
            # whole batch in that one turn (requests admitted THIS call
            # don't close the window, or "static" would degenerate to
            # sequential batch-size-1 decoding)
            if self.static_batching and self.active_count() > admitted:
                break
            free = [s for s, r in enumerate(self._slots) if r is None]
            if not free:
                break
            with self._lock:
                if not self._queue:
                    break
                req = self._pop_next_locked()
                self._m_queue.set(len(self._queue))
            # serve.quant fault: degrade THIS request to the
            # full-precision path before it touches pages or slots —
            # leak-freedom is structural (nothing was allocated yet)
            if self._quant_fallback is not None and _finj.ENABLED:
                try:
                    _finj.check("serve.quant",
                                context=f"request {req.id}")
                except _finj.FaultInjected:
                    self._degrade_quant(req)
                    continue
            psize = self._pool.page_size
            known = [self.bos_id] + req.prompt
            # prefix-cache adoption: the longest cached chain
            # of FULL prompt pages under this source's content hash is
            # adopted (shared, never copied) — those positions skip
            # teacher-forced prefill entirely. Capped so the next input
            # token is still a KNOWN one (the page after the adopted run
            # starts with prompt material).
            hit = []
            if self._cache is not None and len(req.prompt) >= psize:
                try:
                    if _finj.ENABLED:
                        _finj.check("serve.prefix",
                                    context=f"lookup request {req.id}")
                    hit = self._cache.lookup(self._src_key(req), known,
                                             len(req.prompt) // psize)
                except _finj.FaultInjected:
                    # degrade to the cold path: same output, no reuse
                    self._m_prefix_degraded.inc()
                    hit = []
                if hit:
                    # the adopter's reference FIRST: pressure eviction
                    # below must never reap the pages just handed out
                    self._pool.share(hit)
            try:
                first = self._alloc_pages(1)
            except PageAllocError:
                # no first page -> push back and stop admitting; decode
                # progress on the current actives will free pages
                if hit:
                    self._pool.free(hit)
                with self._lock:
                    self._queue.appendleft(req)
                    self._m_queue.set(len(self._queue))
                break
            pages = hit + first
            s = free[0]
            try:
                self._rt.prefill(s, req.src)
            except Exception as e:
                # the runtime writes only this slot's memory in place, so
                # a failed prefill costs only this request (the JAX
                # runtime's donated buffers could take every slot's)
                self._pool.free(pages)
                self._m_failed.inc()
                req._finish("failed", f"prefill error: {e!r}")
                continue
            req.state = "running"
            req._slot = s
            req._pages = pages
            req.known = known
            req.prompt_cached_tokens = len(hit) * psize
            req._cache_done = False
            self._slots[s] = req
            self._page_tables[s, :] = NULL_PAGE
            for i, p in enumerate(pages):
                self._page_tables[s, i] = p
            req._n_table = len(pages)
            self._lens[s] = len(hit) * psize
            admitted += 1
        if admitted:
            self._m_active.set(self.active_count())
        return admitted

    # a cold queue head is bypassed by warm-preferred admissions at most
    # this many times before FIFO order reasserts itself — bounds
    # starvation under sustained warm traffic
    MAX_ADMIT_BYPASS = 4

    def _pop_next_locked(self):
        """Cache-aware admission order: FIFO normally, but when pages
        are TIGHT (the head's full cold working set no longer fits the
        free pool) prefer the queued request with the LONGEST warm
        cached prefix — it admits at a smaller fresh-page cost, which
        cuts the mid-decode preemptions page pressure would otherwise
        cause. A head bypassed `MAX_ADMIT_BYPASS` times is admitted
        regardless (no starvation under sustained warm arrivals). Probes
        use `PrefixCache.peek` (no metrics, no LRU touch);
        `serve_prefix_admit_preferred` counts reorders. Caller holds
        `self._lock`."""
        if self._cache is None or len(self._queue) <= 1:
            return self._queue.popleft()
        head = self._queue[0]
        if head._admit_bypassed >= self.MAX_ADMIT_BYPASS \
                or self._pool.available() >= self._pool.pages_for(
                    len(head.prompt) + head.max_new_tokens):
            return self._queue.popleft()
        psize = self._pool.page_size
        best_i, best_warm = 0, -1
        for i, r in enumerate(self._queue):
            warm = 0
            if len(r.prompt) >= psize:
                warm = self._cache.peek(self._src_key(r),
                                        [self.bos_id] + r.prompt,
                                        len(r.prompt) // psize)
            if warm > best_warm:
                best_i, best_warm = i, warm
        if best_i == 0:
            return self._queue.popleft()
        head._admit_bypassed += 1
        req = self._queue[best_i]
        del self._queue[best_i]
        self._m_warm_pref.inc()
        return req

    @staticmethod
    def _src_key(req):
        """Memoized content hash of the request's source (immutable per
        request; the admission hot path probes it repeatedly)."""
        if req._content_key is None:
            req._content_key = content_key(req.src)
        return req._content_key

    def _alloc_pages(self, n):
        """`pool.alloc` with prefix-cache pressure relief: when the pool
        is dry, evict least-recently-used CACHE-ONLY pages (nothing in
        flight adopted them) and retry, so cached prefixes cost capacity
        only while it is spare — admission never fails because of them."""
        try:
            return self._pool.alloc(n)
        except PageAllocError:
            if self._cache is None or not self._cache.evict(n):
                raise
            return self._pool.alloc(n)

    def _plan_turn(self, active, res):
        """Build every active slot's token window for this turn — the
        FORCED tokens first (known-but-uncached prompt / committed
        tokens), then up to `spec_k` n-gram drafts once the window
        reaches the generation frontier — and allocate the pages those
        positions need. A slot whose current page is full when the pool
        is dry is preempted (pages freed, requeued) exactly like the
        1-wide path; a slot that can only fit part of its window just
        runs a shorter window (ragged qlens are free — same executable,
        same dispatch)."""
        psize = self._rt.page_size
        budget = self._rt.max_pages_per_slot * psize
        width = self.width
        draft_ok = self.spec_k > 0
        if draft_ok and _finj.ENABLED:
            try:
                _finj.check("serve.speculate", context="draft window")
            except _finj.FaultInjected:
                # degrade: run the turn unspeculated — committed output
                # is IDENTICAL, only turns/token suffers
                self._m_spec_degraded.inc()
                draft_ok = False
        plans = {}
        for s, r in active:
            L = int(self._lens[s])
            window = list(r.known[L:L + width])
            f = len(window)
            if draft_ok and f < width:
                window.extend(propose_ngram(r.known, width - f,
                                            self.spec_ngram))
            del window[budget - L:]     # never write past the page budget
            need_idx = (L + len(window) - 1) // psize
            while r._n_table <= need_idx:
                try:
                    page = self._alloc_pages(1)[0]
                except PageAllocError:
                    del window[r._n_table * psize - L:]
                    break
                r._pages.append(page)
                self._page_tables[s, r._n_table] = page
                r._n_table += 1
            if not window:
                self._m_preempt.inc()
                self._requeue(s, r, "page pool exhausted mid-decode",
                              preempted=True)
                res.preempted += 1
                continue
            plans[s] = (window, min(f, len(window)))
        return plans

    def _decode(self, active, plans):
        np = self._np
        width = self.width
        mask = np.zeros((self._rt.slots,), np.int32)
        toks = np.zeros((self._rt.slots, width), np.int32)
        qlens = np.ones((self._rt.slots,), np.int32)
        for s, r in active:
            window, _f = plans[s]
            mask[s] = 1
            toks[s, :len(window)] = window
            qlens[s] = len(window)

        def launch():
            if width == 1:
                out, _ = self._rt.decode(self._page_tables, self._lens,
                                         toks[:, 0], mask)
                return out.reshape(-1, 1)
            out, _ = self._rt.decode_multi(self._page_tables, self._lens,
                                           toks, qlens, mask)
            return out

        if _tracer.ACTIVE:
            with _tracer.span("serve.decode_step", cat="serve",
                              args={"active": len(active)}):
                return launch()
        return launch()

    def _offer_prompt_pages(self, s, r):
        """Once a request's prompt positions are fully cached, index its
        FULL prompt pages in the radix cache (the cache takes its own
        reference; chunks another request already cached keep theirs).
        One-shot per admission attempt; a `serve.prefix` fault degrades
        to not caching — the request itself is unaffected."""
        if self._cache is None or r._cache_done:
            return
        psize = self._rt.page_size
        ncache = (len(r.prompt) + 1) // psize   # [BOS] + prompt chunks
        if ncache == 0:
            r._cache_done = True
            return
        if int(self._lens[s]) < ncache * psize:
            return
        r._cache_done = True
        try:
            if _finj.ENABLED:
                _finj.check("serve.prefix",
                            context=f"insert request {r.id}")
        except _finj.FaultInjected:
            self._m_prefix_degraded.inc()
            return
        pages = [int(p) for p in self._page_tables[s, :ncache]]
        self._cache.insert(self._src_key(r), r.known, pages)

    def _degrade_quant(self, req):
        """Run one request through the full-precision fallback (a
        `serve.quant` fault fired at its admission): greedy output is
        IDENTICAL to an fp32 server's, the quantized executables and the
        page pool are never touched for it, and the handle's stream/
        result plumbing behaves normally (tokens arrive in one burst).
        The request's end-to-end deadline stays in force — the remaining
        budget rides into the fallback, and expiry surfaces as the same
        `ServeDeadlineExceeded` the normal path raises."""
        self._m_quant_degraded.inc()
        req.state = "running"
        try:
            toks = self._quant_fallback(req.src, req.prompt,
                                        req.max_new_tokens,
                                        deadline=req.deadline)
        except ServeDeadlineExceeded:
            self._m_deadline.inc()
            self._m_failed.inc()
            req._exc = ServeDeadlineExceeded(
                f"request {req.id} exceeded its deadline (degraded "
                f"full-precision attempt)")
            req._finish("failed", "deadline exceeded")
            return
        except Exception as e:
            self._m_failed.inc()
            req._finish("failed", f"quant degrade failed: {e!r}")
            return
        now = time.perf_counter()
        if toks and req.t_first_token is None:
            req.t_first_token = now
        for tok in toks:
            req._emit(tok)
        self._m_ok.inc()
        self._m_tokens.inc(len(req.tokens))
        self.tokens_generated += len(req.tokens)
        if req.ttft is not None:
            self._m_ttft.observe(req.ttft)
        self._m_latency.observe(time.perf_counter() - req.t_submit)
        req._finish("done")
        if _tracer.ACTIVE:
            _tracer.instant("serve.quant_degraded",
                            args={"id": req.id, "tokens": len(req.tokens)})

    def _release_slot(self, s, r):
        if r._pages:
            self._pool.free(r._pages)
        r._pages = []
        r._slot = None
        r._n_table = 0
        self._slots[s] = None
        self._page_tables[s, :] = NULL_PAGE
        self._lens[s] = 0

    def _evict(self, s, r, state):
        self._release_slot(s, r)
        self._m_ok.inc()
        # token/TTFT metrics land ONCE, at completion — per-step counting
        # would double-report any request a fault or preemption restarted
        self._m_tokens.inc(len(r.tokens))
        self.tokens_generated += len(r.tokens)
        if r.ttft is not None:
            self._m_ttft.observe(r.ttft)
        self._m_latency.observe(time.perf_counter() - r.t_submit)
        r._finish(state)
        if _tracer.ACTIVE:
            _tracer.instant("serve.request_done", args={
                "id": r.id, "tokens": len(r.tokens),
                "ttft_ms": round((r.ttft or 0) * 1e3, 3)})

    def _requeue(self, s, r, why, preempted=False):
        """Restart a request from scratch (pages freed, queued at the
        front); fail it cleanly when the relevant restart budget is
        spent (fault retries and page preemptions count separately). The
        stream restarts too: undelivered chunks from the aborted attempt
        are dropped and TTFT re-arms, so consumers see one clean token
        sequence (tokens a live streamer already pulled before the fault
        are superseded by the retry — inherent to streaming + retry)."""
        self._release_slot(s, r)
        if preempted:
            r.preemptions += 1
            exhausted = r.preemptions > self.max_preemptions
        else:
            r.retries += 1
            exhausted = r.retries > self.max_retries
        r.tokens = []
        r.known = None              # rebuilt (and re-adopted) at admission
        r._cache_done = False
        r.prompt_cached_tokens = 0
        r.t_first_token = None
        with r._chunk_cv:
            r._chunks.clear()
        if exhausted:
            self._m_failed.inc()
            r._finish("failed", why)
            return False
        r.state = "queued"
        with self._lock:
            self._queue.appendleft(r)
            self._m_queue.set(len(self._queue))
        return True

    def _fail_inflight(self, active, res, exc, reset_pages):
        """A decode-time fault killed the whole in-flight batch: every
        active request retries from scratch or fails cleanly; page
        accounting returns to baseline either way."""
        self._m_retries.inc()
        for s, r in active:
            if self._requeue(s, r, f"decode fault: {exc!r}"):
                res.retried += 1
        if reset_pages:
            self._rt.reset_pages()
            if self._cache is not None:
                # page CONTENTS are no longer trustworthy — cached
                # prefixes must not be adopted into fresh requests
                self._cache.clear()
        self._m_active.set(self.active_count())
