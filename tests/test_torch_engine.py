"""The port's dependency engine (`mxnet_tpu_torch/engine.py`, the native
engine `csrc/engine.cc` through `_native.py`, and `_PyEngine`) against
the JAX package's (`mxnet_tpu/engine.py`).

Part 1: the same push schedules, run through both packages' facades on
the same kind of inner engine (native or Python), give the same
outcomes: orderings, results, poisoning, `CANCELLED` / `EXPIRED`, queue
policies and the `failures()` report (the same callables are pushed to
both, so the failure sites match by name). Part 2: every semantic of
`tests/test_engine.py` on the port, for both inner engines where the
reference test covers both, except `file_var`'s save / load / recordio
users, which tests/test_torch_nd_io.py, test_torch_recordio.py and
test_torch_checkpoint.py hold (ROADMAP.md, Queue 1 [6b]). Every wait on
a thread is bounded, so a hang fails a test instead of stalling the
suite.
"""
import contextlib
import threading
import time

import pytest

from mxnet_tpu import engine as jeng
from mxnet_tpu_torch import engine
from mxnet_tpu_torch import _native as pnative
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.engine import Var, _PyEngine

KINDS = ["py", "native"]
T = 10          # seconds: the bound of every wait


def _make(mod, kind, workers=4, aging_ms=None):
    """A fresh inner engine of `kind` from package `mod`'s engine module."""
    if kind == "py":
        return mod._PyEngine(workers, aging_ms=aging_ms)
    native = pnative if mod is engine else __import__(
        "mxnet_tpu._native", fromlist=["NativeEngine"])
    eng = native.NativeEngine(workers)
    if aging_ms is not None:
        eng.set_aging_ms(aging_ms)
    return eng


@contextlib.contextmanager
def _facade(mod, kind, workers=4, aging_ms=None):
    """`mod`'s facade driving a fresh inner engine of `kind` (restored
    and closed after)."""
    eng = _make(mod, kind, workers, aging_ms)
    old = (mod._engine, mod._native)
    mod._engine, mod._native = eng, kind == "native"
    try:
        yield eng
    finally:
        mod._engine, mod._native = old
        try:
            eng.wait_for_all()
        except BaseException:
            pass
        eng.close()


@pytest.fixture(params=KINDS)
def kind(request):
    return request.param


@pytest.fixture
def facade(kind):
    """The port's facade on a fresh inner engine of each kind."""
    with _facade(engine, kind) as eng:
        yield eng


# ---------------------------------------------------------------------------
# part 1: the same schedules through both packages
# ---------------------------------------------------------------------------
def _boom():
    raise ValueError("boom")


def _outcome(fut):
    """A future's outcome in package-neutral terms."""
    try:
        res = fut.result(timeout=T)
    except Exception as exc:            # noqa: BLE001 — the outcome
        return ("raised", type(exc).__name__, str(exc))
    return ("ok", repr(res))


def _gate(E, var, priority=None):
    """A task holding `var`'s write slot until the returned event is set
    (waits until it is running)."""
    gate, started = threading.Event(), threading.Event()

    def hold():
        started.set()
        gate.wait(T)
    E.push(hold, write_vars=[var], priority=priority)
    assert started.wait(T)
    return gate


def sched_ordering(E):
    """Writers serialise; each reader between two writes sees the writes
    before it and none after."""
    v, log = E.Var(), []
    for i in range(5):
        E.push(lambda i=i: log.append(("w", i)), write_vars=[v])
        E.push(lambda i=i: log.append(
            ("r", i, sum(1 for x in list(log) if x[0] == "w"))),
            read_vars=[v])
    E.wait_for_var(v)
    return ([x for x in log if x[0] == "w"],
            sorted(x for x in log if x[0] == "r"))


def sched_poisoning(E):
    """A failed writer poisons its var's later readers and writers (they
    re-raise its error), not other vars; wait_for_var re-raises; the
    failure report holds the root cause once."""
    E.clear_failures()
    v, u = E.Var(), E.Var()
    futs = [E.push(_boom, write_vars=[v]),
            E.push(lambda: 1, read_vars=[v]),
            E.push(lambda: 2, write_vars=[v]),
            E.push(lambda: 3, write_vars=[u]),
            E.push(lambda: 4, read_vars=[u], write_vars=[v])]
    out = [_outcome(f) for f in futs]
    try:
        E.wait_for_var(v)
        waited = "clean"
    except ValueError as exc:
        waited = str(exc)
    fails = [(f["site"], f["error"]) for f in E.failures()]
    E.clear_failures()
    return out, waited, fails


def sched_group_cancel(E):
    """TaskGroup.cancel skips the queued members (CANCELLED, in order),
    the running one finishes, nothing is poisoned or reported."""
    E.clear_failures()
    v, ran = E.Var(), []
    g = E.TaskGroup("parity.cancel")
    started, gate = threading.Event(), threading.Event()

    def inflight():
        started.set()
        gate.wait(T)
        ran.append("inflight")
        return "done"
    first = g.push(inflight, write_vars=[v])
    assert started.wait(T)
    queued = [g.push(lambda i=i: ran.append(i), write_vars=[v])
              for i in range(4)]
    n = g.cancel()
    gate.set()
    drained = g.drain(timeout=T)
    after = E.push(lambda: 7, write_vars=[v])
    return (n, drained, _outcome(first), [_outcome(f) for f in queued],
            [E.skipped(f.result(timeout=T)) for f in queued], ran,
            _outcome(after), g.live(), E.failures())


def sched_deadline(E):
    """A task whose deadline passes while it is queued resolves EXPIRED;
    its var stays clean."""
    v = E.Var()
    gate = _gate(E, v)
    fut = E.push(lambda: "ran", write_vars=[v], deadline_ms=20)
    time.sleep(0.1)
    gate.set()
    late = E.push(lambda: 9, write_vars=[v])
    return _outcome(fut), E.skipped(fut.result(timeout=T)), _outcome(late)


def sched_reject(E):
    """reject: the over-limit push raises EngineQueueFull; the admitted
    ones run."""
    v = E.Var()
    gate = _gate(E, v)
    pri = E.PRIORITY_BACKGROUND
    prev = E.set_queue_limit(pri, 2, "reject")
    try:
        futs = [E.push(lambda i=i: i, read_vars=[v], priority=pri)
                for i in range(2)]
        try:
            E.push(lambda: 3, read_vars=[v], priority=pri)
            third = "admitted"
        except E.EngineQueueFull as exc:
            third = type(exc).__name__
        limit = E.get_queue_limit(pri)
    finally:
        E.set_queue_limit(pri, *prev)
        gate.set()
    return [_outcome(f) for f in futs], third, limit


def sched_shed(E):
    """shed_oldest: the oldest queued task resolves CANCELLED."""
    v = E.Var()
    gate = _gate(E, v)
    pri = E.PRIORITY_BACKGROUND
    prev = E.set_queue_limit(pri, 2, "shed_oldest")
    try:
        futs = [E.push(lambda c=c: c, read_vars=[v], priority=pri)
                for c in "abc"]
    finally:
        E.set_queue_limit(pri, *prev)
        gate.set()
    return [_outcome(f) for f in futs]


def sched_inline(E):
    """inline_future: a result, and a failure recorded like a task's."""
    E.clear_failures()
    ok = E.inline_future(lambda: 5)
    bad = E.inline_future(_boom, site="parity.inline")
    v = E.Var()
    E.push(_boom, write_vars=[v])
    try:
        E.wait_for_var(v)
    except ValueError:
        pass
    poisoned = E.inline_future(lambda: 1, write_vars=[v])
    out = (_outcome(ok), _outcome(bad), _outcome(poisoned),
           [(f["site"], f["error"]) for f in E.failures()])
    E.clear_failures()
    return out


def sched_skip_helpers(E):
    return (repr(E.CANCELLED), repr(E.EXPIRED), bool(E.CANCELLED),
            E.skipped(E.skipped_future().result()),
            _outcome(E.failed_future(ValueError("x"))),
            E.skipped(None), E.PRIORITY_NAMES, E.NUM_PRIORITIES)


SCHEDULES = [sched_ordering, sched_poisoning, sched_group_cancel,
             sched_deadline, sched_reject, sched_shed, sched_inline,
             sched_skip_helpers]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda f: f.__name__)
def test_schedules_match_the_jax_engine(kind, sched):
    """The same schedule through the JAX package's facade and the port's,
    each on a fresh inner engine of the same kind: equal outcomes."""
    with _facade(jeng, kind):
        want = sched(jeng)
    with _facade(engine, kind):
        got = sched(engine)
    assert got == want


def test_priority_order_matches_the_jax_engine(kind):
    """On a one-worker engine with aging off, queued tasks of the three
    classes dispatch high, normal, background, FIFO within a class, in
    both packages."""
    def sched(E):
        order, gate, started = [], threading.Event(), threading.Event()

        def hold():
            started.set()
            gate.wait(T)
        E.push(hold)
        assert started.wait(T)
        for i in range(3):
            for pri in (E.PRIORITY_BACKGROUND, E.PRIORITY_NORMAL,
                        E.PRIORITY_HIGH):
                E.push(lambda i=i, p=pri: order.append((p, i)), priority=pri)
        gate.set()
        E.wait_for_all()
        return order

    with _facade(jeng, kind, workers=1, aging_ms=0):
        want = sched(jeng)
    with _facade(engine, kind, workers=1, aging_ms=0):
        got = sched(engine)
    assert got == want == sorted(want)


# ---------------------------------------------------------------------------
# part 2: tests/test_engine.py's semantics on the port
# ---------------------------------------------------------------------------
@pytest.fixture
def eng(kind):
    """A fresh inner engine of each kind, used directly."""
    e = _make(engine, kind)
    yield e
    try:
        e.wait_for_all()
    except BaseException:
        pass
    e.close()


def test_native_engine_builds_and_loads():
    """g++ builds `csrc/engine.cc` into `_build/` and the facade runs on
    it (the card's check fails unless this holds)."""
    assert engine.native_engine_loaded()
    assert type(engine._get()).__name__ == "NativeEngine"
    assert pnative._SRC.name == "engine.cc" \
        and pnative._SRC.parent.name == "csrc"
    assert str(pnative._build_lib()).startswith(str(pnative._BUILD_DIR))


def test_write_read_ordering(eng):
    order = []
    a, b = Var(), Var()

    def op(tag, t):
        def f():
            time.sleep(t)
            order.append(tag)
            return tag
        return f

    eng.push(op("w1", 0.05), write_vars=[a])
    eng.push(op("r1", 0.01), read_vars=[a])
    eng.push(op("r2", 0.01), read_vars=[a])
    eng.push(op("w2", 0.01), write_vars=[a], read_vars=[b])
    eng.wait_for_var(a)
    assert order[0] == "w1" and order[-1] == "w2"
    assert set(order) == {"w1", "r1", "r2", "w2"}


def test_error_poisons_dependents(eng):
    v = Var()

    def boom():
        raise RuntimeError("boom")

    futs = [eng.push(boom, write_vars=[v]),
            eng.push(lambda: 1, read_vars=[v]),
            eng.push(lambda: 2, write_vars=[v])]
    for f in futs:
        assert isinstance(f.exception(timeout=T), RuntimeError)
    with pytest.raises(RuntimeError, match="boom"):
        eng.wait_for_var(v)


def test_wait_for_var_raises_failed_reader(eng):
    v = Var()
    eng.push(lambda: 1, write_vars=[v])

    def boom():
        raise RuntimeError("reader-boom")

    eng.push(boom, read_vars=[v])
    with pytest.raises(RuntimeError, match="reader-boom"):
        eng.wait_for_var(v)


def test_duplicate_vars_no_deadlock(eng):
    v, r = Var(), Var()
    assert eng.push(lambda: 42, read_vars=[r, r],
                    write_vars=[v, v]).result(timeout=T) == 42
    assert eng.push(lambda: 7, write_vars=[v]).result(timeout=T) == 7


def test_throughput_many_ops(eng):
    vs = [Var() for _ in range(50)]
    futs = [eng.push(lambda i=i: i, write_vars=[vs[i % 50]])
            for i in range(1000)]
    assert sum(f.result(timeout=T) for f in futs) == sum(range(1000))


def test_concurrent_reads_overlap(eng):
    v = Var()
    eng.push(lambda: time.sleep(0.01), write_vars=[v])
    t0 = time.time()
    f1 = eng.push(lambda: time.sleep(0.2), read_vars=[v])
    f2 = eng.push(lambda: time.sleep(0.2), read_vars=[v])
    f1.result(timeout=T)
    f2.result(timeout=T)
    assert time.time() - t0 < 0.38           # serial would be >= 0.4


def test_instance_failures_parity(eng):
    eng.clear_failures()
    v = Var()

    def boom():
        raise RuntimeError("qos-boom")

    eng.push(boom, write_vars=[v])
    dep = eng.push(lambda: 1, read_vars=[v])
    assert dep.exception(timeout=T) is not None
    fails = eng.failures()
    assert len(fails) == 1 and "qos-boom" in fails[0]["error"]
    eng.clear_failures()
    assert eng.failures() == []


def test_priority_preempts_queued_background(kind):
    e = _make(engine, kind, workers=1, aging_ms=100)
    try:
        order, gate = [], threading.Event()
        e.push(gate.wait)
        time.sleep(0.02)
        for i in range(6):
            e.push(lambda i=i: order.append(("bg", i)), priority=2)
        e.push(lambda: order.append(("hi", 0)), priority=0)
        gate.set()
        e.wait_for_all()
        assert order[0] == ("hi", 0)
        assert [x for x in order if x[0] == "bg"] == [("bg", i)
                                                      for i in range(6)]
    finally:
        e.close()


def test_aging_prevents_starvation(kind):
    e = _make(engine, kind, workers=1, aging_ms=40)
    try:
        order, gate = [], threading.Event()
        e.push(gate.wait, priority=1)
        time.sleep(0.02)
        e.push(lambda: order.append("bg-aged"), priority=2)
        time.sleep(0.25)
        e.push(lambda: order.append("norm"), priority=1)
        e.push(lambda: order.append("hi"), priority=0)
        gate.set()
        e.wait_for_all()
        assert order == ["hi", "bg-aged", "norm"]
    finally:
        e.close()


def _native_debug():
    e = pnative.NativeEngine(4)
    e.set_debug(True)
    return e


@pytest.mark.parametrize("hazard", ["write-write", "read-write"])
def test_debug_hazard_detected(hazard):
    """A bypass-push (a simulated scheduler bug) runs a second writer
    beside a running writer or reader of one var: the detector names
    it."""
    e = _native_debug()
    try:
        v, gate = Var(), threading.Event()
        if hazard == "write-write":
            e.push(gate.wait, write_vars=[v])
        else:
            e.push(gate.wait, read_vars=[v])
        time.sleep(0.05)
        e._debug_bypass_push(gate.wait, write_vars=[v])
        time.sleep(0.05)
        assert e.debug_check() == 1
        assert f"{hazard} hazard" in e.last_error()
        gate.set()
        e.wait_for_all()
        e.clear_error()
    finally:
        e.close()


def test_debug_self_dependency_deadlock_detected():
    e = _native_debug()
    try:
        v, ran = Var(), []
        e._debug_push_raw(lambda: ran.append(1), read_vars=[v],
                          write_vars=[v]).result(timeout=T)
        assert ran == [1]
        assert "deadlock" in e.last_error()
        assert "self-dependency" in e.last_error()
    finally:
        e.close()


def test_debug_stall_watchdog(kind):
    e = _make(engine, kind)
    try:
        e.set_debug(True)
        gate = threading.Event()
        e.push(gate.wait, write_vars=[Var()])
        assert e.wait_for_all_timeout(150) == 1
        assert "stall" in e.last_error()
        gate.set()
        e.wait_for_all()
        assert e.wait_for_all_timeout(1000) == 0
    finally:
        e.close()


def test_debug_clean_under_concurrent_load():
    """Dependency-respecting traffic from many threads trips nothing;
    a real hazard amid that load is still caught."""
    e = _native_debug()
    try:
        vs = [Var() for _ in range(8)]
        barrier = threading.Barrier(4)

        def pusher(tid):
            barrier.wait(T)
            for i in range(100):
                e.push(lambda: None, read_vars=[vs[(tid + i) % 8]],
                       write_vars=[vs[(tid + i + 1) % 8]])

        threads = [threading.Thread(target=pusher, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
        e.wait_for_all()
        assert e.debug_check() == 0 and e.last_error() == ""
        v_bug, gate = Var(), threading.Event()
        e.push(gate.wait, write_vars=[v_bug])
        for i in range(50):
            e.push(lambda: None, read_vars=[vs[i % 4]],
                   write_vars=[vs[(i + 1) % 4]])
        time.sleep(0.05)
        e._debug_bypass_push(gate.wait, write_vars=[v_bug])
        time.sleep(0.05)
        assert e.debug_check() == 1
        gate.set()
        e.wait_for_all()
    finally:
        e.close()


def test_debug_facade_and_env(monkeypatch):
    monkeypatch.setenv("MXTPU_ENGINE_DEBUG", "1")
    e = _PyEngine(2)
    try:
        assert e.debug_enabled()
        v = Var()
        e.push(lambda: None, read_vars=[v], write_vars=[v]).result(T)
        assert e.debug_check() == 1 and "deadlock" in e.last_error()
        e.clear_error()
        assert e.debug_check() == 0
    finally:
        e.close()


def test_facade_push_wait(facade):
    v = Var()
    fut = engine.push(lambda: 42, write_vars=[v])
    engine.wait_for_var(v)
    assert fut.result(timeout=T) == 42
    engine.wait_for_all()
    assert engine.num_workers() == 4


def test_task_group_cancel_skips_queued_poisons_nothing(facade):
    engine.set_debug(True)
    engine.clear_error()
    base = len(engine.failures())
    v, gate, started, ran = Var(), threading.Event(), threading.Event(), []
    g = engine.TaskGroup("test.cancel")

    def inflight():
        started.set()
        gate.wait(T)
        ran.append("inflight")

    g.push(inflight, write_vars=[v])
    assert started.wait(T)
    queued = [g.push(lambda i=i: ran.append(i), write_vars=[v])
              for i in range(4)]
    assert g.cancel() == 4
    gate.set()
    assert g.drain(timeout=T)
    assert all(f.result(timeout=T) is engine.CANCELLED for f in queued)
    assert ran == ["inflight"]
    assert engine.push(lambda: 7, write_vars=[v]).result(timeout=T) == 7
    assert len(engine.failures()) == base
    assert engine.debug_check() == 0, engine.last_error()
    assert g.live() == 0 and engine.active_groups() == 0
    engine.set_debug(False)


def test_bounded_queue_policies_and_counters(facade):
    """reject counts into engine_queue_rejections{class} and moves the
    high-water gauge; block waits for room; shed_oldest cancels the
    oldest."""
    from mxnet_tpu_torch.observability import registry
    rej = registry().counter("engine_queue_rejections",
                             **{"class": "background"})
    pri = engine.PRIORITY_BACKGROUND
    base = rej.value
    v = Var()
    gate = _gate(engine, v)
    prev = engine.set_queue_limit(pri, 2, "reject")
    try:
        f = [engine.push(lambda i=i: i, read_vars=[v], priority=pri)
             for i in range(2)]
        with pytest.raises(engine.EngineQueueFull):
            engine.push(lambda: 3, read_vars=[v], priority=pri)
        assert rej.value == base + 1
    finally:
        engine.set_queue_limit(pri, *prev)
        gate.set()
    assert [x.result(timeout=T) for x in f] == [0, 1]
    assert registry().gauge("engine_queue_high_water",
                            **{"class": "background"}).value >= 2
    # block
    gate = _gate(engine, v)
    prev = engine.set_queue_limit(pri, 1, "block")
    done = []
    try:
        engine.push(lambda: done.append(1), read_vars=[v], priority=pri)

        def over_limit():
            engine.push(lambda: done.append(2), read_vars=[v],
                        priority=pri).result(timeout=T)
        t = threading.Thread(target=over_limit)
        t.start()
        time.sleep(0.1)
        assert not done and t.is_alive()
        gate.set()
        t.join(T)
        assert not t.is_alive()
    finally:
        engine.set_queue_limit(pri, *prev)
        gate.set()
    engine.wait_for_all()
    assert sorted(done) == [1, 2]


def test_deadline_expires_queued_task_without_poisoning(facade):
    from mxnet_tpu_torch.observability import registry
    exp = registry().counter("engine_deadline_expired")
    base = exp.value
    v = Var()
    gate = _gate(engine, v)
    fut = engine.push(lambda: "ran", write_vars=[v], deadline_ms=30)
    report = engine.pending_report()
    time.sleep(0.12)
    assert any(p["overdue"] and p["state"] == "queued"
               for p in engine.pending_report())
    gate.set()
    assert fut.result(timeout=T) is engine.EXPIRED
    assert exp.value == base + 1
    assert engine.push(lambda: 9, write_vars=[v]).result(timeout=T) == 9
    assert {p["class"] for p in report} <= set(engine.PRIORITY_NAMES)


def test_inline_future_records_failure_and_serializes(facade):
    from mxnet_tpu_torch.observability import registry
    cnt = registry().counter("engine_task_failures")
    base_n, base_c = len(engine.failures()), cnt.value
    f = engine.inline_future(lambda: 1 / 0, site="test.inline_save")
    assert isinstance(f.exception(), ZeroDivisionError)
    assert engine.failures()[-1]["site"] == "test.inline_save"
    assert len(engine.failures()) == base_n + 1
    assert cnt.value == base_c + 1
    with pytest.raises(MXNetError, match="at most one write var"):
        engine.inline_future(lambda: 1, write_vars=[Var(), Var()])
    v, inflight, peak, lock = Var(), [0], [0], threading.Lock()

    def tracked(i):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        time.sleep(0.1)
        with lock:
            inflight[0] -= 1
        return i

    futs = [None, None]

    def degraded(i):
        futs[i] = engine.inline_future(lambda: tracked(i), write_vars=[v])

    ts = [threading.Thread(target=degraded, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(T)
    assert sorted(x.result() for x in futs) == [0, 1] and peak[0] == 1
    engine.wait_for_var(v)
    engine.clear_failures()


def test_group_cancel_racing_push_keeps_admission_accounting(facade):
    pri = engine.PRIORITY_BACKGROUND
    prev = engine.set_queue_limit(pri, 2, "reject")
    g = engine.TaskGroup("race")
    stop = threading.Event()

    def pusher():
        while not stop.is_set():
            try:
                g.push(lambda: None, priority=pri)
            except engine.EngineQueueFull:
                pass

    threads = [threading.Thread(target=pusher) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for _ in range(200):
            g.cancel()
        time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(T)
        g.cancel_and_drain(timeout=T)
        engine.set_queue_limit(pri, *prev)
    engine.wait_for_all()
    assert engine._queued_count[pri] == 0
    assert engine.push(lambda: 7, priority=pri).result(timeout=T) == 7
    assert engine.active_groups() == 0


def test_shed_bookkeeping_stays_bounded_behind_pinned_head(facade):
    pri = engine.PRIORITY_BACKGROUND
    v = Var()
    gate = _gate(engine, v)
    limit = 8
    prev = engine.set_queue_limit(pri, limit, "shed_oldest")
    try:
        head = engine.push(lambda: "head", read_vars=[v], priority=pri)
        for _ in range(200):
            engine.push(lambda: None, priority=pri).result(timeout=T)
        assert len(engine._queued_records[pri]) <= 4 * limit + 16
    finally:
        engine.set_queue_limit(pri, *prev)
        gate.set()
    assert head.result(timeout=T) == "head"


def test_push_failure_after_admission_rolls_back_qos_state(facade):
    prev = engine.set_queue_limit(engine.PRIORITY_BACKGROUND, 1, "reject")
    g = engine.TaskGroup("test.rollback")
    try:
        for _ in range(3):
            with pytest.raises(Exception):
                engine.push(lambda: None, read_vars=["not-a-var"],
                            priority=engine.PRIORITY_BACKGROUND, group=g)
        f = engine.push(lambda: 7, priority=engine.PRIORITY_BACKGROUND,
                        group=g)
        assert f.result(timeout=T) == 7
        assert g.drain(timeout=T) and engine.active_groups() == 0
        assert not [p for p in engine.pending_report()
                    if p.get("group") == "test.rollback"]
    finally:
        engine.set_queue_limit(engine.PRIORITY_BACKGROUND, *prev)


def test_engine_task_fault_point_is_recorded(facade):
    """An injected `engine.task` fault fails the task before its fn
    runs and lands in failures() at the dispatch site."""
    from mxnet_tpu_torch.fault import injection
    engine.clear_failures()
    ran = []
    injection.inject("engine.task", times=1)
    try:
        fut = engine.push(lambda: ran.append(1))
        assert isinstance(fut.exception(timeout=T), injection.FaultInjected)
    finally:
        injection.clear("engine.task")
    assert ran == [] and len(engine.failures()) == 1
    assert engine.push(lambda: 3).result(timeout=T) == 3
    engine.clear_failures()


def test_malformed_aging_env_keeps_default_on_both_engines(monkeypatch):
    cases = [("fast", 100), ("0", 0), ("250", 250), ("250 ", 100),
             ("1_0", 100), (" 250", 250), (str(2 ** 31), 100)]
    for raw, want in cases:
        monkeypatch.setenv("MXTPU_ENGINE_AGING_MS", raw)
        for e in (_PyEngine(1), pnative.NativeEngine(1)):
            try:
                assert e.get_aging_ms() == want, (raw, type(e).__name__)
            finally:
                e.close()


def test_use_after_close_raises(kind):
    e = _make(engine, kind, workers=1)
    assert e.push(lambda: 1).result(timeout=T) == 1
    e.wait_for_all()
    e.close()
    with pytest.raises(MXNetError):
        e.push(lambda: 2)
    e.close()
    e.wait_for_all()


def test_default_engines_never_single_worker():
    assert engine.num_workers() >= 2
    for e in (_PyEngine(), pnative.NativeEngine()):
        try:
            assert e.workers >= 4
        finally:
            e.close()


def test_file_var_is_one_var_per_path(tmp_path):
    """file_var keeps its contract: one var a path (its IO users, [6b],
    order on it)."""
    a = engine.file_var(tmp_path / "x.bin")
    assert engine.file_var(str(tmp_path / "x.bin")) is a
    assert engine.file_var(tmp_path / "y.bin") is not a
    assert engine.push(lambda: 1, write_vars=[a]).result(timeout=T) == 1
    engine.wait_for_var(a)


def test_bulk_size_knob_is_kept():
    prev = engine.set_bulk_size(0)
    try:
        assert engine.get_bulk_size() == 0
        with engine.bulk(8):
            assert engine.get_bulk_size() == 64 << 20
        assert engine.get_bulk_size() == 0
    finally:
        engine.set_bulk_size(prev)


def test_exit_hooks_run_before_the_drain(monkeypatch):
    """At interpreter exit the hooks run first, then the engine drains
    (the serving loops cancel their queued tasks there)."""
    calls = []
    monkeypatch.setattr(engine, "_exit_hooks",
                        [lambda: calls.append("hook")])

    class _Eng:
        def wait_for_all(self):
            calls.append("drain")
    monkeypatch.setattr(engine, "_engine", _Eng())
    engine._drain_at_exit()
    assert calls == ["hook", "drain"]
