"""The port's engine-driven `serve.Server` (the default, `engine_driven=
True`: the decode loop runs as dependency-engine tasks,
`serve/engine_bridge.py`) on the CPU against the JAX package's
engine-driven server and the port's inline one. A tiny TransformerNMT
built by `mxnet_tpu` (vocab 50, units 32, 2 layers, 4 heads, as
`tests/test_torch_serve.py` builds it) is carried across with
`convert.from_jax_weights`. Greedy tokens must match exactly. Also:
`deadline_ms`, `close()`, an injected `engine.task` fault the loop
survives, and a background TaskGroup flood under which every request
completes. Every wait is bounded (`result(timeout=...)`)."""
import threading
import time

import jax
import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serve import Server as JaxServer
from mxnet_tpu_torch import engine, serve
from mxnet_tpu_torch.convert import from_jax_weights
from mxnet_tpu_torch.fault import injection
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.ops.kernels import LAUNCHES
from mxnet_tpu_torch.serve.engine_bridge import EngineLoop

KW = dict(slots=2, page_size=4, max_src_len=16, max_new_tokens=10)
T = 60          # seconds: the bound of every wait


@pytest.fixture(scope="module")
def models():
    """(jax model, port model on the CPU) with the same weights, drawn
    from a numpy seed at scales where greedy decoding does not just
    repeat one token."""
    mxj.random.seed(11)
    m = jt.TransformerNMT(50, units=32, hidden=64, num_layers=2,
                          num_heads=4, max_length=32, dropout=0.0)
    m.initialize()
    rng = np.random.RandomState(0)
    for name, p in sorted(m.collect_params().items()):
        shp = p.shape
        if name.endswith("gamma"):
            val = np.ones(shp)
        elif name.endswith(("beta", "bias")):
            val = np.zeros(shp)
        elif "embed" in name:
            val = rng.randn(*shp) * 0.05
        else:
            val = rng.randn(*shp) * (4.0 / np.sqrt(shp[-1]))
        p.set_data(mxj.nd.array(val.astype(np.float32)))
    ew = jax.tree.map(np.asarray, jt.encoder_weights(m))
    dw = jax.tree.map(np.asarray, jt.decoder_weights(m))
    return m, from_jax_weights(ew, dw, device="cpu")


def _sources(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(4, 50, int(rng.randint(3, 14))).tolist()
            for _ in range(n)]


def test_default_server_is_engine_driven_and_matches_jax(models):
    """`Server(model, device="cpu")` with no `engine_driven` argument
    decodes on the engine (an EngineLoop, handles waiting rather than
    cranking) and gives the JAX engine-driven server's tokens and the
    port's inline server's, request by request; the CPU launches
    nothing."""
    jm, pm = models
    srcs = _sources(7)
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    with serve.Server(pm, device="cpu", **KW) as srv:
        assert isinstance(srv._loop, EngineLoop)
        hs = [srv.submit(s) for s in srcs]
        assert all(h._inline_sched is None for h in hs)
        got = [h.result(timeout=T) for h in hs]
        assert srv.wait(timeout=T)
        assert srv.pool.in_use() == 0
    with serve.Server(pm, device="cpu", engine_driven=False, **KW) as srv:
        inline = [srv.submit(s).result(timeout=T) for s in srcs]
    jsrv = JaxServer(jm, **KW)
    try:
        want = [h.result(timeout=T) for h in [jsrv.submit(s) for s in srcs]]
    finally:
        jsrv.close()
    assert got == inline == want
    assert len({tuple(t) for t in got}) > 1
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)
    assert engine.native_engine_loaded()


def test_stream_and_threads_submit(models):
    """Requests submitted from several threads and streamed stream the
    tokens their results hold."""
    _jm, pm = models
    srcs = _sources(6, seed=6)
    with serve.Server(pm, device="cpu", engine_driven=False, **KW) as srv:
        want = [srv.submit(s).result(timeout=T) for s in srcs]
    out = [None] * len(srcs)
    with serve.Server(pm, device="cpu", **KW) as srv:
        def client(i):
            out[i] = list(srv.stream(srcs[i], timeout=T))
        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(srcs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(T)
    assert out == want


def test_deadline_expires_on_the_engine(models):
    """A request whose deadline passes is evicted with
    ServeDeadlineExceeded; the others complete and the pool drains."""
    _jm, pm = models
    exp = registry().counter("serve_deadline_expired")
    base = exp.value
    with serve.Server(pm, device="cpu", slots=1, page_size=4,
                      max_src_len=16, max_new_tokens=10) as srv:
        gate = threading.Event()
        # hold the loop's var behind a task so the request stays queued
        engine.push(lambda: gate.wait(T), write_vars=[srv._loop._var])
        h = srv.submit([5, 6, 7], deadline_ms=1)
        ok = srv.submit([8, 9, 10])
        time.sleep(0.05)
        gate.set()
        with pytest.raises(serve.ServeDeadlineExceeded):
            h.result(timeout=T)
        assert len(ok.result(timeout=T)) == 10
        assert srv.wait(timeout=T)
        assert srv.pool.in_use() == 0
    assert exp.value == base + 1


def test_close_cancels_the_loop_and_fails_pending(models):
    """close() cancels the queued loop task through its group, drains
    the running one and fails every pending request (no handle is
    stranded); later submits raise."""
    _jm, pm = models
    srv = serve.Server(pm, device="cpu", **KW)
    gate = threading.Event()
    engine.push(lambda: gate.wait(T), write_vars=[srv._loop._var])
    hs = [srv.submit(s) for s in _sources(4, seed=7)]
    closer = threading.Thread(target=srv.close)
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(T)
    assert not closer.is_alive()
    for h in hs:
        with pytest.raises(serve.ServeError):
            h.result(timeout=T)
    assert srv._loop._group.live() == 0
    assert srv.pool.in_use() == 0
    with pytest.raises(Exception, match="closed"):
        srv.submit([5, 6])


def test_loop_survives_an_engine_task_fault(models):
    """An injected `engine.task` fault kills one loop task: the failure
    lands in engine.failures(), the loop re-arms on a fresh var
    (restarts >= 1, serve_loop_restarts moves) and every request still
    completes with the fault-free tokens."""
    _jm, pm = models
    srcs = _sources(4, seed=8)
    with serve.Server(pm, device="cpu", engine_driven=False, **KW) as srv:
        want = [srv.submit(s).result(timeout=T) for s in srcs]
    counter = registry().counter("serve_loop_restarts")
    base = counter.value
    engine.clear_failures()
    with serve.Server(pm, device="cpu", **KW) as srv:
        var0 = srv._loop._var
        injection.inject("engine.task", times=1)
        try:
            got = [h.result(timeout=T)
                   for h in [srv.submit(s) for s in srcs]]
        finally:
            injection.clear("engine.task")
        assert srv._loop.restarts >= 1 and srv._loop._var is not var0
    assert got == want
    assert counter.value >= base + 1
    assert any("FaultInjected" in f["error"] for f in engine.failures())
    engine.clear_failures()


def test_requests_complete_under_a_background_flood(models):
    """A flood of PRIORITY_BACKGROUND host tasks in a TaskGroup does not
    hold the PRIORITY_HIGH loop back: every request completes, with the
    flood-free tokens; the flood is then cancelled and drained."""
    _jm, pm = models
    srcs = _sources(6, seed=9)
    with serve.Server(pm, device="cpu", engine_driven=False, **KW) as srv:
        want = [srv.submit(s).result(timeout=T) for s in srcs]
    flood = engine.TaskGroup("test.flood")
    stop = threading.Event()

    def busy():          # holds a worker 20 ms (as host IO would)
        stop.wait(0.02)

    for _ in range(2000):
        flood.push(busy, priority=engine.PRIORITY_BACKGROUND)
    try:
        with serve.Server(pm, device="cpu", **KW) as srv:
            got = [h.result(timeout=T)
                   for h in [srv.submit(s) for s in srcs]]
            pending = flood.pending()
    finally:
        stop.set()
        flood.cancel()
        assert flood.drain(timeout=T)
    assert got == want
    assert pending > 0                 # the flood was still queued
    assert engine.active_groups() == 0


def test_exit_hook_closes_live_loops(models):
    """The interpreter-exit hook closes every loop still open, so no
    queued loop task launches once shutdown has begun."""
    from mxnet_tpu_torch.serve import engine_bridge
    _jm, pm = models
    srv = serve.Server(pm, device="cpu", **KW)
    try:
        assert srv._loop in engine_bridge._LIVE
        assert engine_bridge._close_live_loops in engine._exit_hooks
        engine_bridge._close_live_loops()
        assert srv._loop._closed and srv._loop not in engine_bridge._LIVE
    finally:
        srv.close()
