"""The serving fast path, whole `Server` runs on the CPU, port against
the JAX package: speculative decoding, int8 KV pages and int8 weights,
with the models and requests of tests/test_serve.py's fast-path tests
(`_tiny_model(max_length=48)` and `_int8_model()`), carried across with
`convert.from_jax_weights`. The JAX tests are the oracles; faults are
injected through each package's own `fault.injection`."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.models import transformer as jt
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_weights
from mxnet_tpu_torch.fault import injection as finj
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.ops.kernels import LAUNCHES
from mxnet_tpu_torch.serve.quant import kv_page_bytes, token_capacity

KW = dict(slots=2, page_size=4, max_src_len=16, max_new_tokens=12,
          engine_driven=False)


@pytest.fixture(autouse=True)
def _clear_faults():
    finj.clear()
    yield
    finj.clear()


def _models(vocab, units, layers, heads, seed):
    """A JAX TransformerNMT as tests/test_serve.py's `_tiny_model` builds
    it, and its port twin on the CPU."""
    mxj.random.seed(seed)
    m = jt.TransformerNMT(vocab, units=units, hidden=2 * units,
                          num_layers=layers, num_heads=heads, max_length=48,
                          dropout=0.0)
    m.initialize()
    ew = jax.tree.map(np.asarray, jt.encoder_weights(m))
    dw = jax.tree.map(np.asarray, jt.decoder_weights(m))
    return m, from_jax_weights(ew, dw, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _models(50, 32, 2, 4, 11)


@pytest.fixture(scope="module")
def int8m():
    return _models(40, 16, 1, 2, 13)


def _drain(srv, *submits, max_steps=500):
    handles = [srv.submit(s, max_new_tokens=m, prompt_tokens=p)
               for s, m, p in submits]
    srv.scheduler.run_until_idle(max_steps=max_steps)
    return [h.result(timeout=60) for h in handles]


def _serve(model, *reqs, jax_side=False, **kw):
    """Drain `reqs` through a fresh server with `kw` on top of KW:
    (outputs, server) — closed, with the pool checked first."""
    kw = dict(KW, **kw)
    srv = mxj.serve.Server(model, **kw) if jax_side else \
        tserve.Server(model, device="cpu", **kw)
    try:
        out = _drain(srv, *reqs)
        if srv.prefix_cache is not None:
            held = srv.prefix_cache.pages_held()
            assert srv.pool.in_use() == held == srv.pool.total_refs()
    finally:
        srv.close()
    assert srv.pool.in_use() == 0
    return out, srv


def _match_rate(ref, out):
    matched = sum(sum(1 for x, y in zip(a, b) if x == y)
                  for a, b in zip(ref, out))
    total = sum(max(len(a), len(b)) for a, b in zip(ref, out))
    return matched / max(total, 1)


def _lp_requests(n=5, seed=3):
    """tests/test_serve.py's `_lp_requests`: mixed sources, every other
    request prompted, and a repeat of a prompted one (prefix-warm)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        src = rng.randint(4, 40, (int(rng.randint(3, 10)),)).astype(
            np.int32)
        prompt = rng.randint(4, 40, (8,)).astype(np.int32) if i % 2 \
            else None
        reqs.append((src, int(rng.choice([4, 6, 8])), prompt))
    return reqs + [r for r in reqs if r[2] is not None][:1]


def _spec_requests():
    """The requests of test_serve.py's fast-path contract tests: one
    prompted (:937) and one solo free-running (:986)."""
    rng = np.random.RandomState(5)
    src = rng.randint(4, 50, (7,)).astype(np.int32)
    prompt = rng.randint(4, 50, (9,)).astype(np.int32)
    return [(src, 8, prompt)], [(src, 12, None)]


@pytest.fixture(scope="module")
def spec_ref(tiny):
    """The JAX package's tokens for the speculative requests at k = 0
    and k = 2, 3, 8 (the oracle; k = 8 is a window of 9 rows)."""
    m = tiny[0]
    prompted, solo = _spec_requests()
    kw = dict(max_new_tokens=12, max_prompt_len=12, num_pages=16)
    return {k: (_serve(m, *prompted, jax_side=True, speculative_k=k,
                       **kw)[0],
                _serve(m, *solo, jax_side=True, speculative_k=k, **kw)[0])
            for k in (0, 2, 3, 8)}


@pytest.mark.parametrize("k", [2, 3, 8])
def test_speculative_tokens_match_k0_and_jax(tiny, spec_ref, k):
    """Speculation changes how many turns a request takes, never its
    tokens: the port at k equals the port at k = 0 and the JAX server at
    k, for a prompted request (prompt chunks run widened) and a solo one;
    on the solo request drafts get accepted and it takes fewer decode
    turns than tokens (test_serve.py:986); profiler.dumps() shows the
    acceptance row. k = 8 verifies a window of 9 rows, wider than the
    JAX kernel's 8-row tile."""
    pm = tiny[1]
    prompted, solo = _spec_requests()
    kw = dict(max_new_tokens=12, max_prompt_len=12, num_pages=16)
    base_p, _ = _serve(pm, *prompted, **kw)
    base_s, _ = _serve(pm, *solo, **kw)
    got_p, _ = _serve(pm, *prompted, speculative_k=k, **kw)
    hist0 = registry().histogram("serve_spec_accepted_tokens").count
    got_s, srv = _serve(pm, *solo, speculative_k=k, **kw)
    assert got_p == base_p == spec_ref[0][0] == spec_ref[k][0]
    assert got_s == base_s == spec_ref[0][1] == spec_ref[k][1]
    assert srv.runtime.width == k + 1
    assert srv.scheduler.spec_accepted > 0
    assert srv.scheduler.decode_turns < len(got_s[0])
    assert registry().histogram("serve_spec_accepted_tokens").count > hist0
    text = profiler.dumps()
    assert "[serve-spec] accepted/turn" in text
    assert "[dispatch] serve_decode=" in text
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)


def test_speculative_preemption_with_prompt_no_leak(tiny):
    """Page pressure under speculation and prompts (test_serve.py:1071):
    requests restart, complete, and the pool returns to the cache-held
    baseline; the output equals the uncontended run's."""
    pm = tiny[1]
    pre0 = registry().counter("serve_page_preemptions").value
    rng = np.random.RandomState(11)
    src = rng.randint(4, 50, (5,)).astype(np.int32)
    reqs = [(src, 8, rng.randint(4, 50, (6,)).astype(np.int32))
            for _ in range(2)]
    kw = dict(max_new_tokens=8, max_prompt_len=8, speculative_k=2)
    tight, _ = _serve(pm, *reqs, num_pages=7, **kw)    # capacity 6
    roomy, _ = _serve(pm, *reqs, **kw)
    assert registry().counter("serve_page_preemptions").value > pre0
    assert tight == roomy


def test_prefix_and_speculate_faults_degrade_identically(tiny):
    """Injected cache-lookup/insert and draft faults degrade (cold path,
    unspeculated turn) with identical output, no leaked pages and no
    stuck references (test_serve.py:1033)."""
    pm = tiny[1]
    rng = np.random.RandomState(8)
    reqs = [(rng.randint(4, 50, (6,)).astype(np.int32), 5,
             rng.randint(4, 50, (9,)).astype(np.int32)) for _ in range(3)]
    reqs.append(reqs[0])
    kw = dict(max_new_tokens=6, max_prompt_len=12, num_pages=24,
              speculative_k=2)
    clean, _ = _serve(pm, *reqs, **kw)
    finj.inject("serve.prefix", prob=0.5, seed=13)
    finj.inject("serve.speculate", prob=0.5, seed=14)
    chaos, _ = _serve(pm, *reqs, **kw)
    assert finj.fires("serve.prefix") + finj.fires("serve.speculate") > 0
    assert chaos == clean


@pytest.fixture(scope="module")
def lp_ref(int8m):
    """The JAX package's tokens for `_lp_requests()`: fp32 at k = 0, and
    int8 KV at k = 0, 2, 3, 8."""
    m = int8m[0]
    reqs = _lp_requests()
    out = {"fp32": _serve(m, *reqs, jax_side=True, max_prompt_len=8)[0]}
    for k in (0, 2, 3, 8):
        out[k] = _serve(m, *reqs, jax_side=True, max_prompt_len=8,
                        kv_dtype="int8", speculative_k=k)[0]
    return out


@pytest.mark.parametrize("k", [0, 2, 3, 8])
def test_int8_kv_matches_jax_and_fp32(int8m, lp_ref, k):
    """Int8 KV pages across prefix-cache cold/warm traffic at k = 0, 2,
    3, 8 (a window of 9 rows): the port's tokens equal the JAX server's
    with the same settings, and match fp32 at >= 0.99
    (test_serve.py:1235); the pool accounting stays exact."""
    pm = int8m[1]
    reqs = _lp_requests()
    fp, _ = _serve(pm, *reqs, max_prompt_len=8)
    out, srv = _serve(pm, *reqs, max_prompt_len=8, kv_dtype="int8",
                      speculative_k=k)
    assert fp == lp_ref["fp32"]
    assert out == lp_ref[k]
    assert _match_rate(fp, out) >= 0.99
    assert srv.runtime.k_pages.dtype == torch.int8
    assert registry().gauge("kv_page_scale_bytes").value == 0   # closed


def test_int8_pages_carry_scales_through_radix_cache(int8m):
    """A warm request adopting cached int8 prompt pages sees the cold
    request's content AND scales: identical output
    (test_serve.py:1256)."""
    pm = int8m[1]
    rng = np.random.RandomState(7)
    src = rng.randint(4, 40, (6,)).astype(np.int32)
    prompt = rng.randint(4, 40, (8,)).astype(np.int32)
    srv = tserve.Server(pm, device="cpu", **dict(KW, max_prompt_len=8,
                                                 kv_dtype="int8"))
    try:
        assert registry().gauge("kv_page_scale_bytes").value == \
            2 * srv.runtime.k_scales.numel() * 4
        cold = _drain(srv, (src, 8, prompt))[0]
        cache = srv.prefix_cache
        pages = [n.page for n in cache._nodes]
        assert pages, "prompt pages were not cached"
        assert torch.all(srv.runtime.k_scales[:, pages] > 0)
        assert torch.all(srv.runtime.v_scales[:, pages] > 0)
        hits0 = cache.hits
        warm = _drain(srv, (src, 8, prompt))[0]
        assert cache.hits == hits0 + 1
        assert warm == cold
    finally:
        srv.close()
    assert srv.pool.in_use() == 0


def test_int8_kv_fixed_budget_capacity(int8m):
    """A fixed byte budget holds >= 1.9x the fp32 tokens in int8 pages
    (scales included), and `Server(kv_hbm_bytes=)` sizes its pool to
    exactly that (test_serve.py:1282)."""
    pm = int8m[1]
    geo = dict(n_layers=1, page_size=4, num_heads=2, head_dim=8)
    budget = 32 * kv_page_bytes(kv_dtype="float32", **geo)
    cap_fp = token_capacity(budget, kv_dtype="float32", **geo)
    cap_q = token_capacity(budget, kv_dtype="int8", **geo)
    assert cap_q / cap_fp >= 1.9
    kw = dict(KW, kv_dtype="int8", kv_hbm_bytes=budget, max_new_tokens=8)
    srv = tserve.Server(pm, device="cpu", **kw)
    assert srv.pool.capacity * srv.pool.page_size == cap_q
    assert srv.runtime.kv_bytes_per_page() == kv_page_bytes(
        kv_dtype="int8", **geo)
    srv.close()
    with pytest.raises(MXNetError):
        tserve.Server(pm, device="cpu", num_pages=8, **kw)


def test_quant_fault_degrades_to_full_precision(int8m):
    """A `serve.quant` fault degrades THAT request to the full-precision
    twin: output identical to an fp32 server's, nothing leaked, no
    reference above 1; the next request runs quantized
    (test_serve.py:1304)."""
    pm = int8m[1]
    rng = np.random.RandomState(9)
    req = (rng.randint(4, 40, (6,)).astype(np.int32), 8,
           rng.randint(4, 40, (8,)).astype(np.int32))
    ref, _ = _serve(pm, req, max_prompt_len=8)
    srv = tserve.Server(pm, device="cpu", **dict(
        KW, max_prompt_len=8, kv_dtype="int8", weight_dtype="int8"))
    deg = registry().counter("serve_quant_degraded")
    deg0 = deg.value
    try:
        finj.inject("serve.quant", times=1)
        degraded = _drain(srv, req)[0]
        assert degraded == ref[0]
        assert deg.value == deg0 + 1
        assert srv._fp_twin is not None
        assert srv._fp_twin.device == srv.device
        assert srv.pool.in_use() == srv.prefix_cache.pages_held()
        turns0 = srv.scheduler.decode_turns
        again = _drain(srv, req)[0]
        assert len(again) == len(ref[0])
        assert deg.value == deg0 + 1
        assert srv.scheduler.decode_turns > turns0
        assert all(srv.pool.ref_count(p) <= 1
                   for p in range(1, srv.pool.num_pages))
    finally:
        srv.close()
    assert srv.pool.in_use() == 0 and srv._fp_twin is None


def test_quant_degrade_honours_deadline(int8m):
    """A deadline_ms request hit by a `serve.quant` fault gets no
    amnesty: the remaining budget rides into the twin, and expiry is the
    normal path's `ServeDeadlineExceeded`, counted; nothing leaks
    (test_serve.py:1401)."""
    pm = int8m[1]
    rng = np.random.RandomState(4)
    src = rng.randint(4, 40, (6,)).astype(np.int32)
    srv = tserve.Server(pm, device="cpu", **dict(KW, kv_dtype="int8"))
    exp = registry().counter("serve_deadline_expired")
    exp0 = exp.value
    try:
        finj.inject("serve.quant", times=1)
        h = srv.submit(src, max_new_tokens=8, deadline_ms=0.5)
        with pytest.raises(tserve.ServeDeadlineExceeded):
            h.result(timeout=60)
        assert exp.value > exp0
        assert len(_drain(srv, (src, 4, None))[0]) >= 1
    finally:
        srv.close()
    assert srv.pool.in_use() == 0


def test_weight_int8_matches_jax_and_fp32(int8m):
    """Per-channel int8 weight snapshots: dense leaves (int8, bias,
    per-output-channel scale), the embedding with per-row scales, the
    model's weights untouched; tokens equal the JAX int8-weight server's
    and match fp32 at >= 0.99 (test_serve.py:1341)."""
    m, pm = int8m
    reqs = _lp_requests(n=4, seed=5)
    want, _ = _serve(m, *reqs, jax_side=True, max_prompt_len=8,
                     weight_dtype="int8")
    fp, _ = _serve(pm, *reqs, max_prompt_len=8)
    out, srv = _serve(pm, *reqs, max_prompt_len=8, weight_dtype="int8")
    w = srv.runtime._w
    assert w["embed"].dtype == torch.int8 and "embed_scale" in w
    wq, _b, s = w["layers"][0]["qkv"]
    assert wq.dtype == torch.int8 and s.shape == (wq.shape[0],)
    assert srv.runtime._ew["embed"].dtype == torch.int8
    assert pm.embed.weight.data()._data.dtype == torch.float32
    assert out == want
    assert _match_rate(fp, out) >= 0.99


def test_fast_path_needs_a_card_unless_cpu_is_asked(int8m):
    """Without a CUDA device a fast-path server must be asked for the
    CPU: `device=None` means the card, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card")
    with pytest.raises(MXNetError, match="CUDA"):
        tserve.Server(int8m[1], speculative_k=3, kv_dtype="int8",
                      weight_dtype="int8", **KW)
