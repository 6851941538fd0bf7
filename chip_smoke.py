#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`mxnet_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure raises and the script exits non-zero):

  1. build   — `nvcc` builds the port's kernels from `mxnet_tpu_torch/
               ops/csrc/` for sm_90a (one nvcc per source, in parallel);
               TF32 is switched off for matmuls and cuDNN.
  2. kernels — each kernel against its plain PyTorch version on the card,
               on the same inputs, at the serving shapes and a few edge
               shapes; kernel, plain-version and library times.
  3. serve   — full-width `transformer_base(36548)` (random weights from
               a numpy seed) behind `serve.Server(slots=8, page_size=16,
               max_src_len=128, max_new_tokens=32)`: 16 mixed-length
               requests with continuous-batching backfill. The launch
               counters are zeroed just before and read just after: every
               prefill must launch the flash kernel once per encoder
               layer, every decode turn the paged kernel once per decoder
               layer.
     Then the first 8 requests again under torch.profiler: the device's
     busy share and the kernels that take the time.
  4. card vs CPU — three of those requests through a `device="cpu"`
               server with the same weights (the plain versions): the
               first-step logits must agree within the stated tolerance
               and the greedy tokens must be identical (unless the top
               two CPU logits at the first divergent step are closer than
               that tolerance, which is printed).

Output: progress lines, then `nvidia-smi`'s name and power limit, then
one JSON line `{"kernels": [...]}`, then the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or without the `mxnet_tpu_torch` package beside
this file, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet):
# memory bandwidth, and the fp32 rate outside the tensor cores — both
# kernels compute in fp32 FMAs
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

FLASH_TOL = dict(rtol=2e-4, atol=2e-5)   # kernel vs plain: fp32, sums in
RPA_TOL = dict(rtol=2e-5, atol=2e-6)     # another order than torch's
# card vs CPU logits: fp32 through 12 layers (cuBLAS vs the CPU BLAS sum
# in different orders; TF32 off)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)

BOS, EOS = 2, 3


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events around the whole run; warmed up first)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, iters=20):
    """Device time per call with the host's launch cost taken out:
    `calls` calls captured in one CUDA graph, replayed `iters` times
    between CUDA events. A failed capture raises: the kernels line's
    `ms` is device time and has no other source."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * calls)


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(mx, torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    from mxnet_tpu_torch.ops import _build
    _build.library()
    info = _build.build_info()
    log(f"build: {info['seconds']:.2f} s (cached={info['cached']}) "
        f"sources={list(_build.SOURCES)} -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")


def phase_flash(mx, torch):
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)

    def qkv(b, h, sq, sk, d):
        return [torch.randn(shape, generator=g).to(dev) for shape in
                ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]

    # (B, H, Sq, Sk, D, causal, kv_lengths); the first is the serving
    # prefill: one request padded to max_src_len=128, 77 real tokens
    cases = [(1, 8, 128, 128, 64, False, [77]),
             (2, 8, 128, 128, 64, False, [128, 5]),
             (2, 8, 100, 100, 64, False, [37, 100]),
             (1, 8, 128, 128, 64, True, None),
             (1, 8, 128, 128, 64, True, [90]),
             (1, 4, 64, 128, 64, False, [100]),
             (2, 2, 48, 48, 128, False, [0, 48]),
             (1, 2, 33, 33, 32, True, None)]
    worst = 0.0
    for b, h, sq, sk, d, causal, lens in cases:
        q, k, v = qkv(b, h, sq, sk, d)
        vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        out, lse = K.flash_attention_fwd(q, k, v, causal=causal,
                                         kv_lengths=vl)
        ref, ref_lse = K._flash_plain(q, k, v, causal, 1 / d ** 0.5, vl)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(torch.isfinite(out).all().item(), f"flash {lens} not finite")
        check(torch.allclose(out, ref, **FLASH_TOL),
              f"flash kernel vs plain: max abs err {err} at "
              f"{(b, h, sq, sk, d, causal, lens)}")
        check(torch.allclose(lse, ref_lse, **FLASH_TOL),
              f"flash lse vs plain at {(b, h, sq, sk, d, causal, lens)}")
        if lens is not None and 0 in lens:
            check(out[lens.index(0)].abs().max().item() == 0.0,
                  "a zero-length row must be zeros")
        worst = max(worst, err)
        log(f"flash {(b, h, sq, sk, d)} causal={causal} lens={lens}: "
            f"max abs err {err:.3e} (tol rtol={FLASH_TOL['rtol']} "
            f"atol={FLASH_TOL['atol']})")

    # timing at the serving prefill shape
    b, h, s, d, kv_len = 1, 8, 128, 64, 77
    q, k, v = qkv(b, h, s, s, d)
    vl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    scale = 1 / d ** 0.5
    mask = (torch.arange(s, device=dev)[None, :] < vl[:, None].long())
    mask = mask[:, None, None, :]
    fns = {"kernel": lambda: K.flash_attention_fwd(q, k, v, kv_lengths=vl),
           "plain": lambda: K._flash_plain(q, k, v, False, scale, vl),
           "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, attn_mask=mask)}
    call = {name: cuda_ms(fn) for name, fn in fns.items()}
    dev_ms = {name: graph_ms(fn) for name, fn in fns.items()}
    # the kernel never loads K/V rows at or past kv_len: count the live
    # rows only, in the bytes (q, live k/v, out, lse, len) as in the flops
    nbytes = 4 * (2 * b * h * s * d + 2 * b * h * kv_len * d + b * h * s + b)
    flops = 4 * b * h * s * kv_len * d                 # QK^T + PV
    bms, by = bound(nbytes, flops)
    log(f"flash serving shape {(b, h, s, d)} kv_len={kv_len}: per call "
        f"(host launch included) {call}; device (CUDA graph) {dev_ms}; "
        f"bound {bms:.6f} ms ({by})")
    return dict(name="flash_fwd", route="cuda",
                source="mxnet_tpu_torch/ops/csrc/flash_fwd.cu",
                replaces="mxnet_tpu/ops/pallas_kernels.py:219",
                max_abs_err=worst, ms=dev_ms["kernel"],
                plain_ms=dev_ms["plain"], bound_ms=bms, bound_by=by,
                library_ms=dev_ms["sdpa"], call_ms=call["kernel"])


def phase_rpa(mx, torch):
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(1)
    L, H, dh, psize = 6, 8, 64, 16

    def make(P, tables, lens):
        # a 5-D (L, P, psize, H, dh) pool as the runtime holds it; the
        # kernel reads one layer slice in place
        kp = torch.randn((L, P, psize, H, dh), generator=g).to(dev)
        vp = torch.randn((L, P, psize, H, dh), generator=g).to(dev)
        q = torch.randn((len(lens), H, dh), generator=g).to(dev)
        pt = torch.tensor(tables, dtype=torch.int32, device=dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        return q, kp[2], vp[2], pt, ln

    # serving shape: 8 slots, 2 pages each (max_new_tokens 32 / psize 16),
    # pool 17 pages; slot 0 is length 1 on the null page
    serve_tables = [[0, 0]] + [[1 + 2 * i, 2 + 2 * i] for i in range(7)]
    serve_lens = [1, 5, 16, 17, 32, 9, 24, 2]
    long_tables = [[(7 * s + j) % 80 + 1 for j in range(10)]
                   for s in range(8)]
    cases = [(17, serve_tables, serve_lens),
             (81, long_tables, [160, 1, 0, 33, 100, 64, 15, 159])]
    worst = 0.0
    for P, tables, lens in cases:
        q, kp, vp, pt, ln = make(P, tables, lens)
        out = K.ragged_paged_attention(q, kp, vp, pt, ln)
        ref = K._paged_attention_plain(q, kp, vp, pt, ln)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(torch.isfinite(out).all().item(), "rpa not finite")
        check(torch.allclose(out, ref, **RPA_TOL),
              f"rpa kernel vs plain: max abs err {err} at lens {lens}")
        if 0 in lens:
            check(out[lens.index(0)].abs().max().item() == 0.0,
                  "a zero-length slot must be zeros")
        worst = max(worst, err)
        log(f"rpa P={P} lens={lens}: max abs err {err:.3e} "
            f"(tol rtol={RPA_TOL['rtol']} atol={RPA_TOL['atol']})")

    q, kp, vp, pt, ln = make(17, serve_tables, serve_lens)
    fns = {"kernel": lambda: K.ragged_paged_attention(q, kp, vp, pt, ln),
           "plain": lambda: K._paged_attention_plain(q, kp, vp, pt, ln)}
    call = {name: cuda_ms(fn) for name, fn in fns.items()}
    dev_ms = {name: graph_ms(fn) for name, fn in fns.items()}
    S, live = len(serve_lens), sum(serve_lens)
    nbytes = 4 * (2 * S * H * dh + 2 * live * H * dh + pt.numel() + S)
    flops = 4 * live * H * dh
    bms, by = bound(nbytes, flops)
    log(f"rpa serving shape S={S} H={H} dh={dh} psize={psize} "
        f"lens={serve_lens}: per call (host launch included) {call}; "
        f"device (CUDA graph) {dev_ms}; bound {bms:.6f} ms ({by})")
    return dict(name="ragged_paged_attention", route="cuda",
                source="mxnet_tpu_torch/ops/csrc/ragged_paged_attention.cu",
                replaces="mxnet_tpu/ops/pallas_kernels.py:872",
                max_abs_err=worst, ms=dev_ms["kernel"],
                plain_ms=dev_ms["plain"], bound_ms=bms, bound_by=by,
                library_ms=None, call_ms=call["kernel"])


def phase_serve(mx, torch):
    K = mx.ops.kernels
    reg = mx.observability.registry()
    t0 = time.perf_counter()
    model = mx.models.transformer_base(36548, seed=0)      # on mx.gpu(0)
    n_params = sum(p.numel() for p in model.parameters())
    srv = mx.serve.Server(model, slots=8, page_size=16, max_src_len=128,
                          max_new_tokens=32, engine_driven=False)
    torch.cuda.synchronize()
    log(f"serve: transformer_base(36548) {n_params / 1e6:.1f} M params, "
        f"server up in {time.perf_counter() - t0:.2f} s on "
        f"{srv.runtime.k_pages.device}")
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(4, 36548, rng.randint(5, 129)).astype(np.int32),
             int(rng.randint(4, 33))) for _ in range(16)]
    srv.submit(reqs[0][0], max_new_tokens=2).result()       # warm-up
    torch.cuda.synchronize()

    K.reset_launch_counts()
    reg.histogram("serve_decode_step_seconds").reset()
    prefills0 = mx.profiler.dispatch_count("serve_prefill")
    turns0 = srv.scheduler.decode_turns
    t0 = time.perf_counter()
    handles = [srv.submit(src, max_new_tokens=n) for src, n in reqs]
    check(srv.wait(timeout=600), "serving did not finish within 600 s")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    prefills = mx.profiler.dispatch_count("serve_prefill") - prefills0
    turns = srv.scheduler.decode_turns - turns0

    for h, (src, n) in zip(handles, reqs):
        check(h.state == "done", f"request {h.id} {h.state}: {h.error}")
        check(len(h.tokens) == n or (h.tokens and h.tokens[-1] == EOS),
              f"request {h.id}: {len(h.tokens)} tokens for budget {n}")
        check(all(0 <= t < 36548 for t in h.tokens), "token out of range")
    check(srv.pool.in_use() == 0, f"{srv.pool.in_use()} pages leaked")
    check(prefills == len(reqs), f"{prefills} prefills for {len(reqs)}")
    check(launches["flash_fwd"] == 6 * prefills > 0,
          f"flash launches {launches['flash_fwd']} != 6 x {prefills}")
    check(launches["ragged_paged_attention"] == 6 * turns > 0,
          f"rpa launches {launches['ragged_paged_attention']} != "
          f"6 x {turns}")
    tokens = sum(len(h.tokens) for h in handles)
    step = reg.histogram("serve_decode_step_seconds")
    ttft = sorted(h.ttft for h in handles)
    summary = dict(requests=len(reqs), tokens=tokens, wall_s=wall,
                   tokens_per_s=tokens / wall, decode_turns=turns,
                   mean_step_ms=step.mean * 1e3, max_step_ms=step.max * 1e3,
                   mean_active_slots=tokens / turns, prefills=prefills,
                   ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
                   launches=launches,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("serving " + json.dumps(summary))
    return model, srv, reqs, handles, launches


def phase_profile(mx, torch, srv, reqs):
    """Where the serving time goes: the first 8 requests again under
    torch.profiler (CPU + CUDA activity). The device's busy share is the
    summed kernel time over the window's wall clock (one stream, so
    kernels do not overlap); the profiler's own cost lengthens the wall
    clock, so the idle share it gives is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    turns0 = srv.scheduler.decode_turns
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for src, n in reqs[:8]:
                srv.submit(src, max_new_tokens=n)
            srv.wait(timeout=600)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: an aten op's row repeats the time of
        # the kernels it launched
        rows = []
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            rows.append((dev_us, ev.count, ev.key))
    except RuntimeError as e:
        log(f"profile: not measured ({e})")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    turns = srv.scheduler.decode_turns - turns0
    log(f"profile: window {wall_us / 1e3:.1f} ms, {turns} decode turns, "
        f"{sum(r[1] for r in rows)} device kernels, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} %), idle "
        f"{100 * (1 - busy / wall_us):.1f} % (upper bound)")
    for dev_us, count, key in rows[:12]:
        log(f"profile:   {dev_us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")

    # host syncs: torch's sync debug mode warns at every call that makes
    # the host wait for the device; the design has one per decode turn
    # (next_tok to the host) plus the host->device copies of the inputs
    import warnings
    turns0 = srv.scheduler.decode_turns
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for src, n in reqs[:2]:
                srv.submit(src, max_new_tokens=n)
            srv.wait(timeout=600)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    kinds = {}
    for w in caught:
        text = str(w.message).split("\n")[0][:60]
        kinds[text] = kinds.get(text, 0) + 1
    log(f"syncs: {srv.scheduler.decode_turns - turns0} decode turns, "
        f"2 prefills; synchronizing calls {kinds}")


def _greedy_logits(rt, src, steps):
    """Greedy decode of one request through slot 0 of runtime `rt`:
    (tokens, per-step logits as numpy)."""
    rt.prefill(0, src)
    pt = np.zeros((rt.slots, rt.max_pages_per_slot), np.int32)
    pt[0] = np.arange(1, rt.max_pages_per_slot + 1)
    lens = np.zeros(rt.slots, np.int32)
    tok = np.zeros(rt.slots, np.int32)
    active = np.zeros(rt.slots, np.int32)
    tok[0], active[0] = BOS, 1
    toks, logits = [], []
    for _ in range(steps):
        nxt, lg = rt.decode(pt, lens, tok, active)
        toks.append(int(nxt[0]))
        logits.append(lg[0].float().cpu().numpy())
        tok[0] = nxt[0]
        lens[0] += 1
    return toks, logits


def phase_card_vs_cpu(mx, torch, model, srv, reqs, handles):
    cpu_srv = mx.serve.Server(model, slots=2, page_size=16, max_src_len=128,
                              max_new_tokens=32, engine_driven=False,
                              device="cpu")
    for i in range(3):
        src, n = reqs[i]
        _, lg_gpu = _greedy_logits(srv.runtime, src, 1)
        _, lg_cpu = _greedy_logits(cpu_srv.runtime, src, 1)
        check(np.isfinite(lg_gpu[0]).all() and lg_gpu[0].shape == (36548,),
              "card logits not finite / wrong shape")
        err = float(np.abs(lg_gpu[0] - lg_cpu[0]).max())
        check(np.allclose(lg_gpu[0], lg_cpu[0], **LOGITS_TOL),
              f"request {i}: first-step logits card vs CPU max abs err "
              f"{err}")
        cpu_toks = cpu_srv.submit(src, max_new_tokens=n).result()
        gpu_toks = handles[i].tokens
        if cpu_toks == gpu_toks:
            log(f"card vs cpu request {i} (src {len(src)}, {n} tokens): "
                f"first-step logits max abs err {err:.3e} (tol "
                f"{LOGITS_TOL}), greedy tokens identical")
            continue
        j = next(t for t, (a, b) in enumerate(zip(cpu_toks, gpu_toks))
                 if a != b)
        _, lg = _greedy_logits(cpu_srv.runtime, src, j + 1)
        top2 = np.sort(lg[j])[-2:]
        gap = float(top2[1] - top2[0])
        check(gap < LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * abs(top2[1]),
              f"request {i}: greedy tokens diverge at step {j} with a top-2"
              f" logit gap of {gap} (card {gpu_toks} vs cpu {cpu_toks})")
        log(f"card vs cpu request {i}: tokens diverge at step {j}, where "
            f"the CPU's top two logits are {gap:.3e} apart (within tol)")
    cpu_srv.close()


def main():
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import mxnet_tpu_torch as mx
    except ImportError as e:
        print(f"chip_smoke: the mxnet_tpu_torch package is not beside "
              f"this script: {e}", file=sys.stderr)
        return 1
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        mx.__file__)))
    if pkg_root != HERE:
        print(f"chip_smoke: mxnet_tpu_torch was imported from {pkg_root}, "
              f"not from this checkout", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build(mx, torch)
    kernels = [phase_flash(mx, torch), phase_rpa(mx, torch)]
    model, srv, reqs, handles, launches = phase_serve(mx, torch)
    phase_profile(mx, torch, srv, reqs)
    phase_card_vs_cpu(mx, torch, model, srv, reqs, handles)
    srv.close()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "call_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
