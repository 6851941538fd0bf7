#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`mxnet_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --ranks N   # sequence parallelism on N cards

Phases (any failure raises and the script exits non-zero):

  1. build     — `nvcc` builds the port's kernels from `mxnet_tpu_torch/
                 ops/csrc/` for sm_90a (one nvcc per source, in parallel);
                 TF32 is switched off for matmuls and cuDNN.
  2. kernels   — each kernel against its plain PyTorch version on the
                 card, on the same inputs, at the shapes its path gives it
                 and a few edge shapes; kernel, plain-version and library
                 times, and the least time the card could take (bound):
                 flash forward (serving and training shapes, causal
                 with Sq != Sk both ways, S = 512 and 1024 at every
                 padded width, zero-length rows, a misaligned q; every
                 case at every plan the kernel takes, and out / lse
                 also against float64, no further from it than 10x the
                 plain version; timed at each plan), ragged
                 paged attention (serving shapes), its int8 1-wide, fp32
                 widened and int8 widened forms (the fast path's serving
                 shape: 8 slots, W = 4, H = 8, dh = 64, psize 16, with
                 length-0 slots, rows past the page budget and a long
                 table), the flash backward (training shapes on its fused
                 path, edge shapes, and Sk above one block on its split
                 path, causal with Sq != Sk on each; also against
                 float64 autograd and a repeated launch, bit for bit)
                 and LayerNorm (every width its
                 paths give it: 512, BERT's 768, 1024, 200, and 1032,
                 4096, 8192 on its one-block-a-row form; timed at each
                 under `per_shape`). The long-sequence path drives
                 `flash_attention` forward and backward at B=4, H=8,
                 S=1024, D=64, causal and not (counters zeroed just
                 before, read just after: 2 launches of the forward, the
                 fused and the dQ kernel each), and times the split path
                 against SDPA's backward.
  2b. conv1x1  — the conv1x1 + BN-stats kernel, fp32 and bf16, against a
                 float64 evaluation on the card at the probe's four
                 ResNet-50 shapes (batch 128) and an odd shape (fp32 also
                 no further from it than 10x the plain version), two calls
                 bit-identical in mean / meansq; kernel, plain and
                 library (`torch.matmul` + the two means) times.
  2c. rtc      — `mx.rtc.CudaModule` compiles an axpy and a templated
                 block sum (dynamic shared memory) with NVRTC; both launch
                 (counters zeroed just before, read just after) and match
                 `2 * x + y` and `x.sum()`; a syntax error raises with the
                 compiler's log; axpy timed against `torch.add`.
  3. serve     — full-width `transformer_base(36548)` (random weights from
                 a seed) behind `serve.Server(slots=8, page_size=16,
                 max_src_len=128, max_new_tokens=32)`: 16 mixed-length
                 requests with continuous-batching backfill. The launch
                 counters are zeroed just before and read just after: every
                 prefill must launch the flash kernel once per encoder
                 layer, every decode turn the paged kernel once per decoder
                 layer.
       Then the first 8 requests again under torch.profiler: the device's
       busy share and the kernels that take the time.
  4. card vs CPU (serving) — three of those requests through a
                 `device="cpu"` server with the same weights (the plain
                 versions): the first-step logits must agree within the
                 stated tolerance and the greedy tokens must be identical
                 (unless the top two CPU logits at the first divergent step
                 are closer than that tolerance, which is printed).
  4b. fast path — the serving fast path on the weights of phase 3, all
                 with `slots=8, page_size=16, max_src_len=128,
                 max_new_tokens=32, max_prompt_len=16`: 16 requests from
                 numpy seed 0, half of them sharing one decoder prompt
                 (prefix cache, widened prompt chunks), through a k = 0
                 fp32 reference server and servers (a) speculative_k=3,
                 (b) kv_dtype="int8" + weight_dtype="int8", (c)
                 speculative_k=3 + kv_dtype="int8". Counters zeroed just
                 before and read just after each: every decode turn must
                 launch the widened, the int8 and the widened int8 paged
                 kernel respectively once per decoder layer, and no other
                 paged kernel. Tokens/s, turns per token, draft
                 acceptance, step ms, page bytes, the int8 / fp32
                 capacity ratio, the token-match rate against the
                 reference, and one profiled turn each. (a) must give the
                 reference's greedy tokens, (b) and (c) a `device="cpu"`
                 server's on three requests, unless the first divergence
                 is a near tie (stated tolerances).
  5. train     — the Gluon loop of examples/nmt_translate.py at full
                 width: `transformer_base(36548, max_length=64,
                 dropout=0.0)`, `initialize(ctx=mx.gpu(0))`, Adam at 3e-4,
                 SoftmaxCrossEntropyLoss, `autograd.record()`,
                 `loss.backward()`, `trainer.step(B)`, 10 steps on one
                 fixed batch of B=32, S=64 + 64 (bench_nmt.py's shape).
                 The counters are zeroed just before and read just after:
                 every step must launch 18 flash forwards, 18 fused
                 backwards, no dQ kernel and 30 LayerNorms. Tokens/s
                 (src + tgt) over steps 3-10, step ms, peak memory, then
                 one step under torch.profiler (with the rows of the
                 port's kernels).
  6. card vs CPU (training) — the initial weights go to a CPU model
                 through save_parameters / load_parameters, and one step
                 at full width (B=2, S=16) must give the card's loss and
                 every gradient within the stated tolerances.
  7. resnet train — `gluon.model_zoo.vision.get_model("resnet50_v1",
                 layout="NHWC")` at full width and depth, Xavier (gaussian,
                 in, 2) from `mx.random.seed(0)`, SGD (lr 0.1, momentum
                 0.9, wd 1e-4) through `gluon.Trainer`, 10 steps at B=128
                 on synthetic 224 x 224 images and labels 0-999 from numpy
                 seed 0. The loss must stay finite, every running
                 statistic must move, and no port kernel may launch (the
                 JAX ResNet runs no Pallas kernel either). Images/s and
                 step ms over steps 3-10, peak memory, the cuDNN settings,
                 then one step under torch.profiler.
  8. resnet conv1x1 — one training-mode forward of that net at B=128
                 with a hook on each of the 30 stride-1 1x1 convolutions
                 (their shapes must be RESNET_CONV1X1's nine);
                 with the counters zeroed, each one's input and weight go
                 through the conv1x1 kernel as (B*H*W, Cin) @ (Cin, Cout)
                 in fp32 and in bf16 (30 launches each); y must match the
                 Conv2D's own output and the statistics float64 ones.
  9. resnet card vs CPU — one SGD step at B=4 from the same initial
                 weights (a saved file) on the card and on the CPU: the
                 loss, every gradient and every running statistic agree
                 within the stated limits.
 10. bert attention — the flash kernels at BERT-base's attention shape
                 (B=16, H=12, S=512, D=64) with key lengths mid-block
                 (300), on a block edge (384), full (512), very short (3)
                 and from numpy seed 0 in [256, 512]: the forward against
                 its plain version, the backward on its split path (the
                 fused kernel for dK / dV, then the dQ kernel) against
                 its plain version and float64 autograd, dK / dV exactly
                 0 past each length; the forward, the kernel pair, each
                 kernel and SDPA timed there (the rows' `per_shape`).
 11. bert train — examples/bert_pretrain.py's Gluon loop on full-width
                 `BERTForPretraining(bert_base(max_length=512,
                 dropout=0.0))`, fp32, `initialize(ctx=mx.gpu(0))` after
                 `mx.random.seed(0)`, Adam at 1e-4, the MLM + NSP
                 SoftmaxCrossEntropyLoss, 10 steps on one batch at
                 bench_bert.py's shape (B=16, S=512, 76 masked positions;
                 lengths, segment ids and labels from numpy seed 0). The
                 counters are zeroed just before and read just after:
                 every step must launch 12 flash forwards, 12 fused and
                 12 dQ backward kernels and 26 LayerNorms. Tokens/s (B*S
                 over each step's wall time, steps 3-10) and its spread,
                 peak memory, then one step under torch.profiler.
 12. bert card vs CPU — phase 11's initial weights, cut to 2 layers at
                 full width, one step at B=2, S=512, lengths (300, 512)
                 on the card and on the CPU: the loss and every gradient
                 within phase 6's limits.
 13. long context — examples/long_context.py at its full size (B=1,
                 S=2048, H=8, D=64, causal, fp32, numpy seed 0) on a
                 one-rank NCCL group (`kvstore.init_distributed`,
                 `parallel.make_mesh({"sp": 1})`): (a) Ulysses and ring
                 forward and backward through their `_sharded` entries
                 (counters zeroed just before, read just after: 2
                 launches each of `flash_block`, the forward, the fused
                 and the dQ kernel), held against `flash_attention` over
                 the whole sequence (FLASH_TOL, BWD_TOL, and float64 at
                 most BWD_F64_RATIO x the plain version's distance);
                 (b) `flash_block_attention` against its plain version
                 and float64 at that shape, causal and not, with a
                 nonzero lse cotangent; (c) a ring of four ranks on the
                 one card, each query shard of 512 meeting the key
                 blocks its rank would through the ring's `_ring_step`
                 (10 block forwards and 10 split backwards), against
                 `flash_attention`; (d) the block's forward and forward
                 + backward timed beside the plain versions and SDPA;
                 (e) `flash_attention_fwd` / `_bwd` against float64 at
                 S = 512, 1024, 2048, 4096 (B=1, H=8), causal and not: out /
                 lse within FLASH_F64_RATIO and dQ / dK / dV within
                 BWD_F64_RATIO of the plain version's distance.

`--ranks N` (N > 1 cards) runs phase 13 (a) over N NCCL ranks instead,
one process a card: each rank's Ulysses and ring output and gradients
against `flash_attention` over the whole sequence on its card
(FLASH_TOL, BWD_TOL, float64), its launches checked (Ulysses one block,
the ring the blocks at or before its shard), then a
`{"sp_ranks": [...]}` line in place of the kernels line.

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
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet):
# memory bandwidth, and the fp32 rate outside the tensor cores: the
# kernels' work is fp32
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# fp32-class products on the tensor cores in split TF32 (the flash
# kernels and the fp32 conv1x1 kernel run them so): three TF32 products
# for each fp32 one, so the dense TF32 tensor-core rate over 3. The least
# time of every fp32 attention and conv1x1 product, whatever unit its
# kernel uses
PEAK_TF32X3_FLOPS = 495e12 / 3
# the dense bf16 tensor-core rate: the least time of the bf16 conv1x1
# product (its kernel runs on the tensor cores)
PEAK_BF16_FLOPS = 989e12

FLASH_TOL = dict(rtol=2e-4, atol=2e-5)   # kernel vs plain: fp32, sums in
RPA_TOL = dict(rtol=2e-5, atol=2e-6)     # another order than torch's
BWD_TOL = dict(rtol=2e-4, atol=2e-5)     # (the flash backward pair and
LN_TOL = dict(rtol=1e-5, atol=1e-5)      # LayerNorm likewise)
# the flash backward against float64 autograd: fp32 rounding (the
# kernels' products in split TF32, fp32-class) of sums over at most 512
# keys or queries
BWD_F64_TOL = dict(rtol=2e-4, atol=2e-5)
# and the kernels' distance from float64 at most this multiple of the fp32
# plain version's: split TF32 drops the small x small part of each
# product, and measured 1.4x to 7.2x of the plain version's distance over
# the backward cases here (NVIDIA H100 80GB HBM3, 700 W)
BWD_F64_RATIO = 10.0
# the flash forward against float64: its out and lse at most this
# multiple of the fp32 plain version's distance from float64, as for the
# backward (the forward's products run in split TF32 too)
FLASH_F64_RATIO = 10.0
# card vs CPU logits: fp32 through 12 layers (cuBLAS vs the CPU BLAS sum
# in different orders; TF32 off)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# card vs CPU training step: the loss, and every gradient (kernel vs
# plain and cuBLAS vs CPU BLAS summation orders)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# near ties of the int8-KV servers, card vs CPU: a K/V value within fp32
# rounding of a .5 quantization boundary rounds one way on the card and
# the other on the CPU, and that one-step change of an int8 code (the
# page scale, about 1 % of the page's range) moves the logits by far
# more than fp32 summation order does; and the gap is read from a
# token-by-token replay, whose page scales grow in other steps than a
# widened run's
INT8_TIE_TOL = dict(rtol=1e-3, atol=1e-2)

VOCAB = 36548
# slot lengths of the paged kernels' serving shape (8 slots, 2 pages each)
SERVE_LENS = [1, 5, 16, 17, 32, 9, 24, 2]
SPEC_K = 3                       # drafts per turn of the fast-path phase
FAST_KW = dict(slots=8, page_size=16, max_src_len=128, max_new_tokens=32,
               max_prompt_len=16, engine_driven=False)
CARD_VS_CPU = (0, 1, 3)          # fast-path requests also run on the CPU
TRAIN_B, TRAIN_S = 32, 64        # bench_nmt.py's seq: 64 src + 64 tgt
# the flash backward's long-sequence path (Sk above one block: the fused
# kernel for dK / dV, then the dQ kernel)
LONG_B, LONG_H, LONG_S = 4, 8, 1024
# the LayerNorm kernel's timed shapes (rows, D): TransformerNMT's training
# shape first (the row's own numbers), then BERT-base's (B=16 x S=512
# rows of 768), bert_large's width, a width no multiple of 128, and the
# one-block-a-row form at 4096 and 8192
LN_TIMED = [(TRAIN_B * TRAIN_S, 512), (16 * 512, 768), (16 * 512, 1024),
            (4099, 200), (2048, 4096), (1024, 8192)]

# the conv1x1 kernel: the probe's four ResNet-50 shapes at batch 128
# (tools/probe_fused_convbn.py:121-126) and an odd one
CONV1X1_SHAPES = [(128 * 56 * 56, 64, 256), (128 * 28 * 28, 512, 128),
                  (128 * 14 * 14, 1024, 256), (128 * 7 * 7, 512, 2048)]
CONV1X1_ODD = (300, 77, 50)
# phase 8: the 30 stride-1 1x1 convolutions of ResNet-50 v1 at B = 128,
# (B*H*W, Cin, Cout) -> how many (tests/test_torch_conv1x1_design.py
# holds it against the model)
RESNET_CONV1X1 = {(401408, 64, 64): 1, (401408, 256, 64): 2,
                  (401408, 64, 256): 4, (100352, 128, 512): 4,
                  (100352, 512, 128): 3, (25088, 256, 1024): 6,
                  (25088, 1024, 256): 5, (6272, 512, 2048): 3,
                  (6272, 2048, 512): 2}
# conv1x1 kernel vs float64 on the card: fp32 y within 1e-5 x max|y| (fp32
# sums of at most 2048 products); mean and meansq within 1e-5 x
# max|meansq| + 1e-6, the JAX test's rtol / atol (tests/test_pallas.py:
# 240-244) on the scale of the statistics; bf16 y within one bf16 ulp of
# the float64 value plus the fp32 limit
CONV1X1_Y_RTOL = 1e-5
CONV1X1_STATS_RTOL, CONV1X1_STATS_ATOL = 1e-5, 1e-6
# and the fp32 kernel's y, mean and meansq at most this multiple of the
# fp32 plain version's distance from float64, as FLASH_F64_RATIO holds the
# flash kernels (its products run in split TF32 too)
CONV1X1_F64_RATIO = 10.0
# rtc: axpy is exact up to one fp32 rounding of 2x + y (|x|, |y| < 6);
# the block sum is fp32 sums over 2^24 values in another order
RTC_N = 1 << 24
RTC_AXPY_ATOL = 2e-6
RTC_SUM_RTOL = 1e-5
RESNET_B, RESNET_STEPS = 128, 10
# ResNet-50 card vs CPU, one step at B=4 (phase_resnet_card_vs_cpu): the
# loss through 53 convolutions and BatchNorms in fp32, cuDNN's algorithms
# against oneDNN's (TF32 off), within 1e-4; each gradient and running
# statistic, in norm, within 10x what a one-thread CPU run differs from
# the default one (the net's own fp32 conditioning; that parameter's or
# the median of its kind, the larger), or 10x the floor: 1e-4 for
# gradients, 1e-5 for the statistics (one forward pass)
RESNET_LOSS_RTOL = 1e-4
RESNET_SPREAD_FACTOR = 10
RESNET_GRAD_FLOOR, RESNET_STAT_FLOOR = 1e-4, 1e-5

# BERT-base MLM pretraining at bench_bert.py's shape: batch 16
# (bench_bert.py:113), seq 512 and 76 masked positions (:25), fp32
BERT_VOCAB, BERT_B, BERT_S, BERT_H, BERT_P = 30522, 16, 512, 12, 76
BERT_STEPS = 10
# long-context attention at examples/long_context.py's full size (B=1,
# S=2048, H=8, D=64), and the ranks of the ring run on one card
LC_B, LC_S, LC_H, LC_D = 1, 2048, 8, 64
LC_RING = 4
# the flash kernels' distance from float64 along long walks (B=1, H=8,
# D=64, causal and not): tf32_mma.cuh's tile sums keep it within the
# float64 ratios where the tensor cores' running accumulation had let it
# grow to 13-19x the plain version's at S = 2048-4096
F64_SWEEP_S = (512, 1024, 2048, 4096)

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


def bound(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(mx, torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; cudnn "
        f"{torch.backends.cudnn.version()} benchmark="
        f"{torch.backends.cudnn.benchmark} deterministic="
        f"{torch.backends.cudnn.deterministic}")
    from mxnet_tpu_torch.ops import _build
    _build.library()
    info = _build.build_info()
    log(f"build: {info['seconds']:.2f} s (cached={info['cached']}) "
        f"sources={list(_build.SOURCES)} -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")


def _train_attention_cases():
    """The attentions of a training step at B=32, H=8, S=64, D=64, as
    (B, H, Sq, Sk, D, causal, kv_lengths): the decoder's causal
    self-attention, the encoder's self-attention with key lengths 5-64,
    and a rectangular cross-attention (Sq=48, Sk=80) with lengths 5-80,
    both drawn from numpy seed 0."""
    B, H, S, D = TRAIN_B, 8, TRAIN_S, 64
    lens64 = [int(x) for x in np.random.RandomState(0).randint(5, 65, B)]
    lens80 = [int(x) for x in np.random.RandomState(0).randint(5, 81, B)]
    return [(B, H, S, S, D, True, None), (B, H, S, S, D, False, lens64),
            (B, H, 48, 80, D, False, lens80)]


def _attention_f64(torch, q, k, v, causal, scale, lens):
    """(out, lse (B*H, Sq), live (B*H, Sq)) of softmax attention in
    float64 on the CPU with the kernels' mask; a row with no visible key
    (live False) is zeros, the kernels' convention, and its lse is not
    compared."""
    q, k, v = (t.detach().cpu().double() for t in (q, k, v))
    b, h, sq, _ = q.shape
    s = q @ k.transpose(-1, -2) * scale
    allowed = torch.ones(s.shape, dtype=torch.bool)
    if lens is not None:
        keys = torch.arange(s.shape[-1])[None, :] < torch.tensor(lens)[:, None]
        allowed &= keys[:, None, None, :]
    if causal:
        allowed &= torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    live = allowed.any(-1, keepdim=True)
    s = torch.where(allowed, s, torch.tensor(-torch.inf, dtype=s.dtype))
    s = torch.where(live, s, torch.zeros_like(s))
    out = torch.softmax(s, -1) * live @ v
    return (out, torch.logsumexp(s, -1).reshape(b * h, sq),
            live.reshape(b * h, sq))


def _fwd_check(torch, K, q, k, v, causal, lens, what):
    """The forward kernel's (out, lse) against `_flash_plain` (FLASH_TOL)
    and float64 (no further than FLASH_F64_RATIO times the plain
    version); a zero-length row exactly 0. Returns the errors."""
    dev = q.device
    d = q.shape[-1]
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    out, lse = K.flash_attention_fwd(q, k, v, causal=causal, kv_lengths=vl)
    ref, ref_lse = K._flash_plain(q, k, v, causal, d ** -0.5, vl)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(torch.isfinite(out).all().item(), f"flash {what} not finite")
    check(torch.allclose(out, ref, **FLASH_TOL),
          f"flash kernel vs plain: max abs err {err} at {what}")
    check(torch.allclose(lse, ref_lse, **FLASH_TOL),
          f"flash lse vs plain at {what}: max abs err "
          f"{(lse - ref_lse).abs().max().item()}")
    for bi, n in enumerate(lens or []):
        if n == 0:
            check(out[bi].abs().max().item() == 0.0,
                  f"a zero-length row must be zeros at {what}")
    o64, l64, live = _attention_f64(torch, q, k, v, causal, d ** -0.5, lens)
    errs64 = {"out": (out.cpu().double() - o64).abs().max().item(),
              "lse": (lse.cpu().double() - l64)[live].abs().max().item()}
    plain64 = {"out": (ref.cpu().double() - o64).abs().max().item(),
               "lse": (ref_lse.cpu().double() - l64)[live].abs().max()
               .item()}
    for name in ("out", "lse"):
        check(errs64[name] <= FLASH_F64_RATIO * plain64[name],
              f"flash {name} {errs64[name]} from float64, more than "
              f"{FLASH_F64_RATIO}x the plain version's {plain64[name]} at "
              f"{what}")
    return err, errs64, plain64


def _fwd_plan_fns(K, q, k, v, causal, scale, vl):
    """The forward kernel at other plans than `flash_fwd_plan`'s (rw row
    warps x ks key-split warps of bk-key tiles), to check and time
    beside its choice."""
    b, h, sq, d = q.shape
    plan = K.flash_fwd_plan(b * h, sq, k.shape[2], d)
    fns = {}
    for rw, ks, bk in ((4, 1, 32), (4, 1, 16), (2, 2, 32), (2, 4, 16),
                       (1, 4, 32), (1, 8, 16), (1, 4, 16)):
        smem = 4 * (16 * rw + 4 * ks * bk) * (plan["dp"] + 4)
        if smem > 227 * 1024:
            continue                  # more than a block's memory
        p = dict(plan, rw=rw, ks=ks, bk=bk, warps=rw * ks, rows=16 * rw,
                 smem=smem)
        fns[f"rw{rw}_ks{ks}_bk{bk}"] = (
            lambda p=p: K._flash_cuda(q, k, v, causal, scale, vl, p))
    return fns


def _fwd_bound(b, h, sq, d, ends_sum, pairs):
    """The forward's least time: q, the live K / V rows and the lengths
    read once, out and lse written once; 4 * pairs * D operations (QK^T,
    PV) at the split-TF32 rate."""
    nbytes = 4 * (2 * b * h * sq * d + 2 * h * ends_sum * d + b * h * sq
                  + b)
    return bound(nbytes, 4 * pairs * d, PEAK_TF32X3_FLOPS)


def phase_flash(mx, torch):
    """The forward kernel against `_flash_plain` and float64 at the
    serving and training shapes and cases that stress its design (each
    case also at every plan the kernel takes): causal
    with Sq != Sk both ways (the top-left mask), S = 512 and 1024 at
    every padded width and at D no multiple of 4, lengths that end
    inside a tile, zero-length rows and a misaligned q (float-by-float
    copies). Then timed at the serving prefill (the row's own numbers)
    and the training shape (`per_shape`), with SDPA, each plan the
    kernel takes, and the achieved TFLOP/s."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)

    def qkv(b, h, sq, sk, d):
        return [torch.randn(shape, generator=g).to(dev) for shape in
                ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]

    # (B, H, Sq, Sk, D, causal, kv_lengths); the first is the serving
    # prefill: one request padded to max_src_len=128, 77 real tokens; the
    # training shapes follow it
    cases = [(1, 8, 128, 128, 64, False, [77]), *_train_attention_cases(),
             (2, 8, 128, 128, 64, False, [128, 5]),
             (2, 8, 100, 100, 64, False, [37, 100]),
             (1, 8, 128, 128, 64, True, None),
             (1, 8, 128, 128, 64, True, [90]),
             (1, 4, 64, 128, 64, False, [100]),
             (2, 2, 48, 48, 128, False, [0, 48]),
             (1, 2, 33, 33, 32, True, None),
             # causal with Sq != Sk both ways, with and without lengths
             (1, 4, 64, 200, 64, True, None),
             (1, 4, 64, 200, 64, True, [150]),
             (1, 4, 200, 64, 64, True, None),
             (1, 4, 200, 64, 64, True, [40]),
             # zero-length rows beside a length inside a tile, several
             # query blocks
             (3, 2, 200, 200, 64, False, [0, 131, 200]),
             (2, 2, 70, 90, 96, True, [0, 61])]
    # S = 512 (lengths inside a tile) and 1024 (causal) at every padded
    # width and at D no multiple of 4
    for d in (32, 64, 96, 128, 18, 30):
        cases += [(2, 2, 512, 512, d, False, [300, 512]),
                  (1, 2, 1024, 1024, d, True, None)]
    worst = 0.0
    for b, h, sq, sk, d, causal, lens in cases:
        q, k, v = qkv(b, h, sq, sk, d)
        what = f"{(b, h, sq, sk, d)} causal={causal} lens={lens}"
        err, errs64, plain64 = _fwd_check(torch, K, q, k, v, causal, lens,
                                          what)
        # every plan the kernel takes, not only the one chosen here
        vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        ref, ref_lse = K._flash_plain(q, k, v, causal, d ** -0.5, vl)
        for name, fn in _fwd_plan_fns(K, q, k, v, causal, d ** -0.5,
                                      vl).items():
            out, lse = fn()
            err = max(err, (out - ref).abs().max().item())
            check(torch.allclose(out, ref, **FLASH_TOL)
                  and torch.allclose(lse, ref_lse, **FLASH_TOL),
                  f"flash plan {name} vs plain at {what}: max abs errs "
                  f"{(out - ref).abs().max().item()} / "
                  f"{(lse - ref_lse).abs().max().item()}")
        worst = max(worst, err)
        log(f"flash {what}: plan {K.flash_fwd_plan(b * h, sq, sk, d)}; max "
            f"abs err {err:.3e} (tol rtol={FLASH_TOL['rtol']} "
            f"atol={FLASH_TOL['atol']}); vs float64 {errs64} (at most "
            f"{FLASH_F64_RATIO}x the plain version's {plain64})")
    # a q whose storage starts 4 bytes past a 16-byte boundary: the
    # kernel copies its rows float by float
    b, h, s, d = 2, 2, 100, 64
    base = torch.randn(b * h * s * d + 1, generator=g).to(dev)
    q = base[1:].view(b, h, s, d)
    _, k, v = qkv(b, h, s, s, d)
    check(q.is_contiguous() and q.data_ptr() % 16 != 0, "q not misaligned")
    err, errs64, plain64 = _fwd_check(torch, K, q, k, v, False, [70, 100],
                                      "misaligned q")
    worst = max(worst, err)
    log(f"flash misaligned q {(b, h, s, s, d)}: max abs err {err:.3e}; vs "
        f"float64 {errs64} (plain {plain64})")

    def timed(b, h, s, d, lens):
        """Device ms of the kernel (as planned and at every plan it
        takes), the plain version and SDPA, and the bound."""
        q, k, v = qkv(b, h, s, s, d)
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = 1 / d ** 0.5
        mask = (torch.arange(s, device=dev)[None, :]
                < vl[:, None].long())[:, None, None, :]
        fns = {"kernel": lambda: K.flash_attention_fwd(q, k, v,
                                                       kv_lengths=vl),
               "plain": lambda: K._flash_plain(q, k, v, False, scale, vl),
               "sdpa": lambda: torch.nn.functional
               .scaled_dot_product_attention(q, k, v, attn_mask=mask)}
        plan = K.flash_fwd_plan(b * h, s, s, d)
        fns.update(_fwd_plan_fns(K, q, k, v, False, scale, vl))
        call = {"kernel": cuda_ms(fns["kernel"])}
        dev_ms = {name: graph_ms(fn) for name, fn in fns.items()}
        ends = sum(min(n, s) for n in lens)
        pairs = h * s * ends
        bms, by = _fwd_bound(b, h, s, d, ends, pairs)
        tflops = 4 * pairs * d / (dev_ms["kernel"] * 1e-3) / 1e12
        log(f"flash timed {(b, h, s, d)} lens {lens[:4]}...: plan {plan}; "
            f"per call (host launch included) {call}; device (CUDA graph) "
            f"{dev_ms}; bound {bms:.6f} ms ({by}); kernel / SDPA "
            f"{dev_ms['kernel'] / dev_ms['sdpa']:.3f}; achieved "
            f"{tflops:.2f} TFLOP/s ({4 * pairs * d} FLOP)")
        return dict(shape=[b, h, s, s, d], lens=lens, ms=dev_ms["kernel"],
                    plain_ms=dev_ms["plain"], bound_ms=bms, bound_by=by,
                    library_ms=dev_ms["sdpa"], call_ms=call["kernel"],
                    tflops=tflops)

    # the serving prefill shape is the row's own; the training shape's
    # lengths case (12 of a step's 18 forwards) goes to `per_shape`
    serve = timed(1, 8, 128, 64, [77])
    train = _train_attention_cases()[1]
    per_shape = [timed(train[0], train[1], train[2], train[4], train[6])]
    return dict(name="flash_fwd", route="cuda",
                source="mxnet_tpu_torch/ops/csrc/flash_fwd.cu",
                replaces="mxnet_tpu/ops/pallas_kernels.py:219",
                max_abs_err=worst, ms=serve["ms"],
                plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
                bound_by=serve["bound_by"], library_ms=serve["library_ms"],
                call_ms=serve["call_ms"], per_shape=per_shape)


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
    serve_lens = SERVE_LENS
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
    bms, by = bound(nbytes, flops, PEAK_TF32X3_FLOPS)
    log(f"rpa serving shape S={S} H={H} dh={dh} psize={psize} "
        f"lens={serve_lens}: per call (host launch included) {call}; "
        f"device (CUDA graph) {dev_ms}; bound {bms:.6f} ms ({by})")
    return dict(name="ragged_paged_attention", route="cuda",
                source="mxnet_tpu_torch/ops/csrc/ragged_paged_attention.cu",
                replaces="mxnet_tpu/ops/pallas_kernels.py:872",
                max_abs_err=worst, ms=dev_ms["kernel"],
                plain_ms=dev_ms["plain"], bound_ms=bms, bound_by=by,
                library_ms=None, call_ms=call["kernel"])


def phase_rpa_fastpath(mx, torch):
    """The int8 1-wide, fp32 widened and int8 widened paged kernels
    against their plain versions at the serving shape of the fast path
    (8 slots, W = 4, H = 8, dh = 64, psize 16, a 5-D pool), with the
    same edge cases as `phase_rpa`: slots of length 0, rows past the page
    budget (row i sees lengths + i keys, clamped to the table), and the
    long-table case."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(4)
    L, H, dh, psize, W = 6, 8, 64, 16, SPEC_K + 1

    def make(P, tables, lens, wide, quant):
        # a 5-D (L, P, psize, H, dh) pool and (L, P, H) scales as the
        # runtime holds them; the kernels read one layer slice in place
        shape = (L, P, psize, H, dh)
        if quant:
            kp, vp = (torch.randint(-127, 128, shape, generator=g,
                                    dtype=torch.int8).to(dev)
                      for _ in range(2))
            ks, vs = ((torch.rand((L, P, H), generator=g) * 0.05 + 1e-3)
                      .to(dev)[2] for _ in range(2))
        else:
            kp, vp = (torch.randn(shape, generator=g).to(dev)
                      for _ in range(2))
            ks = vs = None
        qshape = (len(lens), W, H, dh) if wide else (len(lens), H, dh)
        q = torch.randn(qshape, generator=g).to(dev)
        pt = torch.tensor(tables, dtype=torch.int32, device=dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        return q, kp[2], vp[2], pt, ln, ks, vs

    def plain(q, kp, vp, pt, ln, ks, vs):
        run = K._paged_attention_plain_multi if q.dim() == 4 \
            else K._paged_attention_plain
        return run(q, kp, vp, pt, ln, ks, vs)

    serve_tables = [[0, 0]] + [[1 + 2 * i, 2 + 2 * i] for i in range(7)]
    long_tables = [[(7 * s + j) % 80 + 1 for j in range(10)]
                   for s in range(8)]
    cases = [(17, serve_tables, SERVE_LENS),
             (17, serve_tables, [0, 31, 32, 17, 30, 29, 0, 2]),
             (81, long_tables, [160, 1, 0, 33, 100, 64, 15, 159])]
    rows = []
    for name, wide, quant, line in (
            ("ragged_paged_attention_int8", False, True, "872 (quant)"),
            ("ragged_paged_attention_multi", True, False, "1014"),
            ("ragged_paged_attention_multi_int8", True, True,
             "1014 (quant)")):
        worst = 0.0
        for P, tables, lens in cases:
            q, kp, vp, pt, ln, ks, vs = make(P, tables, lens, wide, quant)
            out = K.ragged_paged_attention(q, kp, vp, pt, ln, k_scales=ks,
                                           v_scales=vs)
            ref = plain(q, kp, vp, pt, ln, ks, vs)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(torch.isfinite(out).all().item(), f"{name} not finite")
            check(torch.allclose(out, ref, **RPA_TOL),
                  f"{name} kernel vs plain: max abs err {err} at lens "
                  f"{lens}")
            if 0 in lens:
                # row 0 of a length-0 slot sees no key
                zero = out[lens.index(0)]
                check((zero[0] if wide else zero).abs().max().item() == 0.0,
                      f"{name}: a row with no visible key must be zeros")
            worst = max(worst, err)
            log(f"{name} P={P} W={W if wide else 1} lens={lens}: max abs "
                f"err {err:.3e} (tol rtol={RPA_TOL['rtol']} "
                f"atol={RPA_TOL['atol']})")

        args = make(17, serve_tables, SERVE_LENS, wide, quant)
        q, kp, vp, pt, ln, ks, vs = args
        fns = {"kernel": lambda: K.ragged_paged_attention(
                   q, kp, vp, pt, ln, k_scales=ks, v_scales=vs),
               "plain": lambda: plain(*args)}
        call = {k: cuda_ms(fn) for k, fn in fns.items()}
        dev_ms = {k: graph_ms(fn) for k, fn in fns.items()}
        # this run's data: row i of slot s reads min(len + i, 32) keys,
        # so a slot's live K/V rows are those of its longest row; int8
        # pages are 1 byte an element plus one f32 scale per (page, head)
        # they touch, dequantized by one multiply an element
        w = W if wide else 1
        S, npages = len(SERVE_LENS), pt.shape[1]
        vis = [[min(n + i, npages * psize) for i in range(w)]
               for n in SERVE_LENS]
        live = sum(v[-1] for v in vis)
        item = 1 if quant else 4
        pages = sum(-(-v[-1] // psize) for v in vis)
        nbytes = (2 * 4 * S * w * H * dh + 2 * item * live * H * dh
                  + (2 * 4 * pages * H if quant else 0) + 4 * pt.numel()
                  + 4 * S)
        flops = 4 * sum(map(sum, vis)) * H * dh \
            + (2 * live * H * dh if quant else 0)
        bms, by = bound(nbytes, flops, PEAK_TF32X3_FLOPS)
        log(f"{name} serving shape S={S} W={w} H={H} dh={dh} psize={psize}"
            f" lens={SERVE_LENS}: per call (host launch included) {call}; "
            f"device (CUDA graph) {dev_ms}; bound {bms:.6f} ms ({by}); "
            f"library: none (no single PyTorch call gathers pages)")
        rows.append(dict(
            name=name, route="cuda",
            source="mxnet_tpu_torch/ops/csrc/ragged_paged_attention.cu",
            replaces=f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            max_abs_err=worst, ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
            bound_ms=bms, bound_by=by, library_ms=None,
            call_ms=call["kernel"]))
    return rows


def phase_serve(mx, torch):
    K = mx.ops.kernels
    reg = mx.observability.registry()
    t0 = time.perf_counter()
    mx.random.seed(0)
    model = mx.models.transformer_base(36548)
    model.initialize(ctx=mx.gpu(0))
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
    check(launches["flash_bwd"] == launches["flash_bwd_dq"]
          == launches["layer_norm"] == 0,
          f"serving launched a training kernel: {launches}")
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


def device_profile(torch, work):
    """Run `work()` under torch.profiler (CPU + CUDA activity), ending in
    a synchronize: (window wall us, device rows (us, count, name) sorted
    by time), or None where the profiler cannot trace the card. The
    device's busy share is the summed kernel time over the window's wall
    clock (one stream, so kernels do not overlap); the profiler's own
    cost lengthens the wall clock, so the idle share it gives is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
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
        return None
    rows.sort(reverse=True)
    return wall_us, rows


def log_profile(tag, wall_us, rows, what):
    busy = sum(r[0] for r in rows)
    log(f"{tag}: window {wall_us / 1e3:.1f} ms, {what}, "
        f"{sum(r[1] for r in rows)} device kernels, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} %), idle "
        f"{100 * (1 - busy / wall_us):.1f} % (upper bound)")
    for dev_us, count, key in rows[:12]:
        log(f"{tag}:   {dev_us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    return busy / wall_us


def phase_profile(mx, torch, srv, reqs):
    """Where the serving time goes: the first 8 requests again under
    torch.profiler."""
    turns0 = srv.scheduler.decode_turns

    def work():
        for src, n in reqs[:8]:
            srv.submit(src, max_new_tokens=n)
        srv.wait(timeout=600)
    got = device_profile(torch, work)
    if got is None:
        return
    log_profile("profile", *got,
                f"{srv.scheduler.decode_turns - turns0} decode turns")

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


def phase_card_vs_cpu(mx, torch, model, srv, reqs, handles):
    cpu_srv = mx.serve.Server(model, slots=2, page_size=16, max_src_len=128,
                              max_new_tokens=32, engine_driven=False,
                              device="cpu")
    for i in range(3):
        src, n = reqs[i]
        lg_gpu = _forced_logits(srv.runtime, src, [BOS])
        lg_cpu = _forced_logits(cpu_srv.runtime, src, [BOS])
        check(np.isfinite(lg_gpu).all() and lg_gpu.shape == (VOCAB,),
              "card logits not finite / wrong shape")
        err = float(np.abs(lg_gpu - lg_cpu).max())
        check(np.allclose(lg_gpu, lg_cpu, **LOGITS_TOL),
              f"request {i}: first-step logits card vs CPU max abs err "
              f"{err}")
        cpu_toks = cpu_srv.submit(src, max_new_tokens=n).result()
        how = _same_or_near_tie(cpu_srv.runtime, (src, n, None),
                                handles[i].tokens, cpu_toks, LOGITS_TOL,
                                f"request {i} card vs cpu")
        log(f"card vs cpu request {i} (src {len(src)}, {n} tokens): "
            f"first-step logits max abs err {err:.3e} (tol {LOGITS_TOL}), "
            f"{how}")
    cpu_srv.close()


def _fastpath_requests():
    """16 requests from numpy seed 0, sources of 5-128 tokens and
    budgets of 4-32: the even ones without a prompt, the odd ones sharing
    one 16-token decoder prompt over two sources, so that the prefix
    cache adopts prompt pages and the prompts run in widened chunks."""
    rng = np.random.RandomState(0)
    prompt = rng.randint(4, VOCAB, 16).astype(np.int32)
    shared = [rng.randint(4, VOCAB, rng.randint(5, 129)).astype(np.int32)
              for _ in range(2)]
    reqs = []
    for i in range(16):
        n = int(rng.randint(4, 33))
        if i % 2:
            reqs.append((shared[(i // 2) % 2], n, prompt))
        else:
            src = rng.randint(4, VOCAB, rng.randint(5, 129))
            reqs.append((src.astype(np.int32), n, None))
    return reqs


def _match_rate(ref, out):
    """Share of token positions where two runs' outputs agree (the JAX
    package's tests/test_serve.py measure)."""
    matched = sum(sum(1 for x, y in zip(a, b) if x == y)
                  for a, b in zip(ref, out))
    total = sum(max(len(a), len(b)) for a, b in zip(ref, out))
    return matched / max(total, 1)


def _forced_logits(rt, src, known):
    """Feed `known` (BOS first) one token a step through slot 0 of the
    runtime `rt` after prefilling `src`; the logits of the last step (the
    prediction of the token after `known`) as numpy. Overwrites the
    runtime's pages 1..max_pages_per_slot: use on a server that serves
    nothing afterwards."""
    rt.prefill(0, src)
    pt = np.zeros((rt.slots, rt.max_pages_per_slot), np.int32)
    pt[0] = np.arange(1, rt.max_pages_per_slot + 1)
    lens = np.zeros(rt.slots, np.int32)
    tok = np.zeros(rt.slots, np.int32)
    active = np.zeros(rt.slots, np.int32)
    active[0] = 1
    for t, token in enumerate(known):
        tok[0], lens[0] = token, t
        _, lg = rt.decode(pt, lens, tok, active)
    return lg[0].float().cpu().numpy()


def _same_or_near_tie(rt, req, got, want, tol, what):
    """`got` must equal `want`, or differ first at a step where the top
    two logits of `rt` (fed the common prefix) are within `tol`."""
    if got == want:
        return "greedy tokens identical"
    src, _n, prompt = req
    j = next(t for t, (a, b) in enumerate(zip(got, want)) if a != b)
    known = [BOS] + ([] if prompt is None else [int(t) for t in prompt]) \
        + want[:j]
    top2 = np.sort(_forced_logits(rt, src, known))[-2:]
    gap = float(top2[1] - top2[0])
    check(gap < tol["atol"] + tol["rtol"] * abs(top2[1]),
          f"{what}: greedy tokens diverge at step {j} with a top-2 logit "
          f"gap of {gap} ({got} vs {want})")
    return f"tokens diverge at step {j}, where the top two logits are " \
           f"{gap:.3e} apart (within {tol})"


def _fast_run(mx, torch, model, reqs, tag, expect, **extra):
    """Serve `reqs` at once on a card server with the fast path's
    settings; the launch counters are zeroed just before and read just
    after, and every decode turn must launch the `expect` paged kernel
    once per decoder layer and no other paged kernel."""
    K = mx.ops.kernels
    reg = mx.observability.registry()
    srv = mx.serve.Server(model, **FAST_KW, **extra)
    srv.submit(reqs[0][0], max_new_tokens=2).result()       # warm-up
    torch.cuda.synchronize()
    sched = srv.scheduler
    K.reset_launch_counts()
    reg.histogram("serve_decode_step_seconds").reset()
    prefills0 = mx.profiler.dispatch_count("serve_prefill")
    turns0 = sched.decode_turns
    drafted0, accepted0 = sched.spec_drafted, sched.spec_accepted
    t0 = time.perf_counter()
    handles = [srv.submit(src, max_new_tokens=n, prompt_tokens=prompt)
               for src, n, prompt in reqs]
    check(srv.wait(timeout=600), f"{tag}: not finished within 600 s")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    prefills = mx.profiler.dispatch_count("serve_prefill") - prefills0
    turns = sched.decode_turns - turns0

    for h, (src, n, _p) in zip(handles, reqs):
        check(h.state == "done", f"{tag}: request {h.id} {h.state}: "
              f"{h.error}")
        check(len(h.tokens) == n or (h.tokens and h.tokens[-1] == EOS),
              f"{tag}: request {h.id}: {len(h.tokens)} tokens for {n}")
        check(all(0 <= t < VOCAB for t in h.tokens), "token out of range")
    held = srv.prefix_cache.pages_held()
    check(srv.pool.in_use() == held,
          f"{tag}: {srv.pool.in_use()} pages in use, the cache holds {held}")
    check(prefills == len(reqs), f"{tag}: {prefills} prefills")
    check(launches["flash_fwd"] == 6 * prefills,
          f"{tag}: flash launches {launches['flash_fwd']} != 6 x "
          f"{prefills}")
    for name, n in launches.items():
        if name.startswith("ragged_paged_attention"):
            want = 6 * turns if name == expect else 0
            check(n == want and turns > 0,
                  f"{tag}: {name} launched {n} times in {turns} turns")
        elif name != "flash_fwd":
            check(n == 0, f"{tag}: serving launched {name}")
    tokens = sum(len(h.tokens) for h in handles)
    drafted = sched.spec_drafted - drafted0
    accepted = sched.spec_accepted - accepted0
    summary = dict(
        server=tag, settings=extra, tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, decode_turns=turns,
        turns_per_token=turns / tokens, spec_drafted=drafted,
        spec_accepted=accepted,
        acceptance=accepted / drafted if drafted else None,
        mean_step_ms=reg.histogram("serve_decode_step_seconds").mean * 1e3,
        kv_bytes_per_page=srv.runtime.kv_bytes_per_page(),
        prompt_cached_tokens=sum(h.prompt_cached_tokens for h in handles),
        kernel=expect, launches=launches[expect])
    return srv, handles, summary, launches


def _profile_turn(torch, srv, reqs, tag):
    """Where one decode turn's time goes: 8 requests admitted and
    prefilled in a first turn, then one turn of the slots still active
    under torch.profiler; the rest drains unprofiled."""
    for src, n, prompt in reqs[:8]:
        srv.submit(src, max_new_tokens=n, prompt_tokens=prompt)
    srv.scheduler.step()
    active = srv.scheduler.active_count()
    got = device_profile(torch, srv.scheduler.step)
    if got is not None:
        log_profile(tag, *got, f"1 decode turn, {active} active slots")
    check(srv.wait(timeout=600), f"{tag}: not drained")


def phase_fastpath(mx, torch, model):
    """The serving fast path on the weights of phase 3: a k = 0 fp32
    reference server with the fast path's settings, then servers (a)
    speculative_k=3 on fp32, (b) int8 KV and int8 weights at k = 0 and
    (c) speculative_k=3 on int8 KV, each serving the 16 requests of
    `_fastpath_requests`. (a) must give the reference's greedy tokens;
    (b) and (c) are held against a `device="cpu"` server with the same
    settings on three requests. Both allow a divergence only at a near
    tie. Returns the paged kernels' launches summed over (a), (b), (c)."""
    reqs = _fastpath_requests()
    ref_srv, ref_h, ref_sum, _ = _fast_run(
        mx, torch, model, reqs, "reference k=0 fp32",
        "ragged_paged_attention")
    ref = [list(h.tokens) for h in ref_h]
    log("fastpath " + json.dumps(ref_sum))
    quant = mx.serve.quant
    budget = 2 ** 30
    geo = dict(n_layers=6, page_size=16, num_heads=8, head_dim=64)
    capacity = (quant.token_capacity(budget, kv_dtype="int8", **geo)
                / quant.token_capacity(budget, kv_dtype="float32", **geo))
    log(f"fastpath: int8 / fp32 token capacity in {budget} bytes of KV "
        f"pages: {capacity:.4f}")
    check(capacity >= 1.9, f"int8 capacity ratio {capacity}")
    total = {}
    for tag, extra, expect in (
            ("a", dict(speculative_k=SPEC_K), "ragged_paged_attention_multi"),
            ("b", dict(kv_dtype="int8", weight_dtype="int8"),
             "ragged_paged_attention_int8"),
            ("c", dict(speculative_k=SPEC_K, kv_dtype="int8"),
             "ragged_paged_attention_multi_int8")):
        srv, handles, summary, launches = _fast_run(mx, torch, model, reqs,
                                                    tag, expect, **extra)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        got = [list(h.tokens) for h in handles]
        summary["match_vs_fp32_k0"] = _match_rate(ref, got)
        log("fastpath " + json.dumps(summary))
        _profile_turn(torch, srv, reqs, f"fastpath ({tag}) profile")
        if tag == "a":
            # the bitwise-greedy contract: speculation changes how many
            # turns a request takes, never its tokens
            for i, req in enumerate(reqs):
                how = _same_or_near_tie(ref_srv.runtime, req, got[i],
                                        ref[i], LOGITS_TOL,
                                        f"(a) vs k=0 request {i}")
                if how != "greedy tokens identical":
                    log(f"fastpath (a) request {i}: {how}")
            log("fastpath (a): every request's tokens match the k=0 fp32 "
                "server's (near ties above, if any)")
        else:
            cpu = mx.serve.Server(model, **FAST_KW, device="cpu", **extra)
            cpu_toks = [cpu.submit(reqs[i][0], max_new_tokens=reqs[i][1],
                                   prompt_tokens=reqs[i][2]).result()
                        for i in CARD_VS_CPU]
            for i, want in zip(CARD_VS_CPU, cpu_toks):
                how = _same_or_near_tie(cpu.runtime, reqs[i], got[i], want,
                                        INT8_TIE_TOL,
                                        f"({tag}) card vs cpu request {i}")
                log(f"fastpath ({tag}) card vs cpu request {i} (src "
                    f"{len(reqs[i][0])}, prompt "
                    f"{0 if reqs[i][2] is None else len(reqs[i][2])}, "
                    f"{reqs[i][1]} tokens): {how}")
            cpu.close()
        srv.close()
    ref_srv.close()
    return total


def _bwd_case(torch, K, g, b, h, sq, sk, d, causal, lens):
    """Inputs of one backward case and the forward's lse and delta. The
    forward kernel's out and lse are held against `_flash_plain` first:
    both the backward kernels and their plain version take this lse, so
    a wrong one would not show in their comparison."""
    dev = torch.device("cuda", 0)
    q, k, v, do = [torch.randn(shape, generator=g).to(dev) for shape in
                   ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                    (b, h, sq, d))]
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    out, lse = K.flash_attention_fwd(q, k, v, causal, d ** -0.5, vl)
    ref, ref_lse = K._flash_plain(q, k, v, causal, d ** -0.5, vl)
    check(torch.allclose(out, ref, **FLASH_TOL)
          and torch.allclose(lse, ref_lse, **FLASH_TOL),
          f"flash forward out / lse vs plain at "
          f"{(b, h, sq, sk, d, causal)}: max abs errs "
          f"{(out - ref).abs().max().item()} / "
          f"{(lse - ref_lse).abs().max().item()}")
    delta = (out * do).sum(-1).reshape(b * h, sq)
    return q, k, v, do, vl, out, lse, delta


def _attention_grads_f64(torch, q, k, v, do, causal, scale, lens):
    """(dQ, dK, dV) of softmax attention by autograd in float64 on the
    CPU; a row with no visible key is zeros, the kernels' convention."""
    q, k, v = (t.detach().cpu().double().requires_grad_(True)
               for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    allowed = torch.ones(s.shape, dtype=torch.bool)
    if lens is not None:
        keys = torch.arange(s.shape[-1])[None, :] < torch.tensor(lens)[:, None]
        allowed &= keys[:, None, None, :]
    if causal:
        allowed &= torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    live = allowed.any(-1, keepdim=True)
    s = torch.where(allowed, s, torch.tensor(-torch.inf, dtype=s.dtype))
    p = torch.softmax(torch.where(live, s, torch.zeros_like(s)), -1) * live
    return torch.autograd.grad(p @ v, (q, k, v), do.cpu().double())


def _within(torch, g, ref, tol, scaled):
    """allclose(g, ref, **tol); with `scaled`, the absolute part of the
    limit is multiplied by each (b, h) slice's largest |ref|, at least
    1 (see `phase_bert_attention`)."""
    if not scaled:
        return torch.allclose(g, ref, **tol)
    scale = ref.abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1.0)
    return bool(((g - ref).abs()
                 <= tol["atol"] * scale + tol["rtol"] * ref.abs()).all())


def _bwd_check(torch, K, case, got, worst, tags, scaled=False):
    """One backward case's (dQ, dK, dV) against `_flash_bwd_plain` and
    float64 autograd (BWD_TOL, BWD_F64_TOL; `scaled`: their absolute
    part scaled per (b, h) slice, `_within`), and no further from float64
    than BWD_F64_RATIO times the plain version; exact zeros past kv_len.
    `tags` names the kernel that wrote each gradient, for the
    worst-error record."""
    q, k, v, do, vl, lse, delta, (b, h, sq, sk, d, causal, lens) = case
    refs = K._flash_bwd_plain(q, k, v, do, lse, delta, causal, d ** -0.5,
                              vl)
    torch.cuda.synchronize()
    errs = {}
    for name, g, ref in zip(("dq", "dk", "dv"), got, refs):
        check(torch.isfinite(g).all().item(), f"{name} not finite")
        check(ref.abs().max().item() > 0, f"plain {name} is all zeros")
        errs[name] = (g - ref).abs().max().item()
        check(_within(torch, g, ref, BWD_TOL, scaled),
              f"flash bwd {name} kernel vs plain: max abs err "
              f"{errs[name]} at {(b, h, sq, sk, d, causal)}")
    dq, dk, dv = got
    for bi, n in enumerate(lens or []):
        check(dk[bi, :, n:].abs().max().item() == 0.0
              and dv[bi, :, n:].abs().max().item() == 0.0
              if n < sk else True,
              f"dK/dV of keys past kv_len {n} must be exactly 0")
    # a second yardstick: torch autograd through float64 softmax
    # attention on the CPU (the fp32 plain version shares the kernels'
    # formula, so it would not show an error common to both); the plain
    # version's own distance from it is recorded beside the kernels'
    errs64, plain64 = {}, {}
    for name, g, p, ref in zip(("dq", "dk", "dv"), got, refs,
                               _attention_grads_f64(torch, q, k, v, do,
                                                    causal, d ** -0.5, lens)):
        g = g.cpu().double()
        errs64[name] = (g - ref).abs().max().item()
        plain64[name] = (p.cpu().double() - ref).abs().max().item()
        check(_within(torch, g, ref, BWD_F64_TOL, scaled),
              f"flash bwd {name} kernel vs float64 autograd: max abs err "
              f"{errs64[name]} at {(b, h, sq, sk, d, causal)}")
        check(errs64[name] <= BWD_F64_RATIO * plain64[name],
              f"flash bwd {name} kernel {errs64[name]} from float64, more "
              f"than {BWD_F64_RATIO}x the plain version's {plain64[name]} "
              f"at {(b, h, sq, sk, d, causal)}")
    for name, tag in zip(("dq", "dk", "dv"), tags):
        worst[tag] = max(worst[tag], errs[name])
    return errs, errs64, plain64


def _long_attention(mx, torch, g):
    """The path of long sequences: `flash_attention` forward and backward
    through its autograd Function at B=4, H=8, S=1024, D=64, causal and
    not (Sk above one block: the split path). The counters are zeroed
    just before and read just after; the gradients are then held against
    `_flash_bwd_plain`."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    B, H, S, D = LONG_B, LONG_H, LONG_S, 64
    check(K.flash_bwd_plan(S, D)["path"] == "split",
          f"S = {S} should take the split path")
    runs = []
    for causal in (False, True):
        q, k, v, do = [torch.randn((B, H, S, D), generator=g).to(dev)
                       for _ in range(4)]
        runs.append((causal, [t.clone().requires_grad_(True)
                              for t in (q, k, v)], do))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for causal, (q, k, v), do in runs:
        K.flash_attention(q, k, v, causal=causal).backward(do)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update(flash_fwd=2, flash_bwd=2, flash_bwd_dq=2)
    check(launches == want, f"long attention launches {launches} != {want}")
    for causal, (q, k, v), do in runs:
        q0, k0, v0 = (t.detach() for t in (q, k, v))
        out, lse = K._flash_plain(q0, k0, v0, causal, D ** -0.5, None)
        delta = (out * do).sum(-1).reshape(B * H, S)
        refs = K._flash_bwd_plain(q0, k0, v0, do, lse, delta, causal,
                                  D ** -0.5, None)
        for name, t, ref in zip(("dq", "dk", "dv"), (q, k, v), refs):
            err = (t.grad - ref).abs().max().item()
            check(torch.isfinite(t.grad).all().item()
                  and torch.allclose(t.grad, ref, **BWD_TOL),
                  f"long attention causal={causal} {name}: max abs err "
                  f"{err}")
        log(f"long attention {(B, H, S, D)} causal={causal}: gradients "
            f"within BWD_TOL of the plain version")
    return launches


def _long_attention_times(mx, torch, g):
    """Device ms of the split path at B=4, H=8, S=1024, D=64, causal and
    not: the whole backward, its two kernels alone, the plain version and
    SDPA's backward (fwd+bwd - fwd) in the same call; achieved TFLOP/s
    of the backward (10 * pairs * D). Returns the dQ kernel's numbers at
    the non-causal shape, for the kernels line."""
    K = mx.ops.kernels
    B, H, S, D = LONG_B, LONG_H, LONG_S, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for causal in (False, True):
        q, k, v, do, vl, _, lse, delta = _bwd_case(torch, K, g, B, H, S, S,
                                                   D, causal, None)
        args = (q, k, v, do, lse, delta, causal, D ** -0.5, None)
        plan = K.flash_bwd_plan(S, D)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(qg, kg, vg, is_causal=causal),
                                (qg, kg, vg), do)

        fns = {"split": lambda: K.flash_attention_bwd(*args),
               "fused_dkv": lambda: K._flash_bwd_fused_cuda(*args, plan),
               "dq": lambda: K._flash_bwd_dq_cuda(*args, plan),
               "plain": lambda: K._flash_bwd_plain(*args),
               "sdpa_fwd": lambda: sdpa(q, k, v, is_causal=causal),
               "sdpa_fwd_bwd": sdpa_fwd_bwd}
        dev_ms = {name: graph_ms(fn, calls=5, iters=10)
                  for name, fn in fns.items()}
        sdpa_bwd = dev_ms["sdpa_fwd_bwd"] - dev_ms["sdpa_fwd"]
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        tflops = {name: f * pairs * D / (dev_ms[name] * 1e-3) / 1e12
                  for name, f in (("split", 10), ("fused_dkv", 8),
                                  ("dq", 6))}
        rows[causal] = dict(dev_ms=dev_ms, sdpa_bwd=sdpa_bwd, pairs=pairs)
        log(f"flash bwd long {(B, H, S, D)} causal={causal} (split path): "
            f"device (CUDA graph) {dev_ms}; SDPA backward (fwd+bwd - fwd) "
            f"{sdpa_bwd:.5f} ms; split / SDPA backward "
            f"{dev_ms['split'] / sdpa_bwd:.3f}; achieved TFLOP/s {tflops}")
    row = rows[False]
    rows_q = 4 * B * H * S * D
    # q, dO, K, V, lse, delta read once, dQ written once; S, dP, dQ
    bms, by = bound(5 * rows_q + 2 * 4 * B * H * S, 6 * row["pairs"] * D,
                    PEAK_TF32X3_FLOPS)
    return dict(ms=row["dev_ms"]["dq"], plain_ms=row["dev_ms"]["plain"],
                bound_ms=bms, bound_by=by)


def phase_flash_bwd(mx, torch):
    """The backward kernels against `_flash_bwd_plain` and float64
    autograd at the training shapes (B=32, H=8, S=64, D=64: the decoder's
    causal self-attention, the encoder's self-attention with key lengths
    and a rectangular cross-attention, all on the fused path), a few edge
    shapes, and one case with Sk above one block (the split path) at each
    padded width; a repeated launch must give the same bits. The fused
    kernel is timed on the lengths case (12 of the 18 attentions of a
    training step) against SDPA's backward; then the long-sequence path
    (`_long_attention`) runs, as a path of its own, and is timed.
    Returns the kernel rows and that path's launches."""
    K = mx.ops.kernels
    g = torch.Generator(device="cpu").manual_seed(2)
    B, H, S, D = TRAIN_B, 8, TRAIN_S, 64
    train_cases = _train_attention_cases()
    lens64 = train_cases[1][-1]
    # Sk above one block at D padded to 32, 64, 96 and 128, and a D that
    # is no multiple of 4 (copies float by float) on either path
    # (the last, causal with Sq < Sk, and the fused path's causal case
    # with Sq > Sk: the top-left mask's tile skipping both ways)
    split_cases = [(2, 3, 130, 200, 64, False, [131, 200]),
                   (1, 2, 160, 160, 128, True, [97]),
                   (1, 2, 100, 100, 96, True, None),
                   (2, 2, 70, 140, 32, False, [140, 3]),
                   (1, 2, 50, 300, 18, False, [260]),
                   (2, 2, 130, 300, 64, True, [280, 300])]
    cases = [*train_cases, (2, 2, 33, 33, 128, True, [20, 33]),
             (2, 3, 100, 70, 32, False, [0, 70]),
             (2, 2, 45, 45, 30, True, [45, 17]),
             (2, 3, 100, 60, 64, True, [50, 60]), *split_cases]
    worst = {"flash_bwd": 0.0, "flash_bwd_dq": 0.0}
    for case in cases:
        b, h, sq, sk, d, causal, lens = case
        path = K.flash_bwd_plan(sk, d)["path"]
        check((path == "split") == (case in split_cases),
              f"{case}: plan path {path}")
        q, k, v, do, vl, _, lse, delta = _bwd_case(torch, K, g, *case)
        args = (q, k, v, do, lse, delta, causal, d ** -0.5, vl)
        before = dict(K.LAUNCHES)
        got = K.flash_attention_bwd(*args)
        again = K.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        counts = {n: K.LAUNCHES[n] - before[n]
                  for n in ("flash_bwd", "flash_bwd_dq")}
        want = {"flash_bwd": 2, "flash_bwd_dq": 2 * (path == "split")}
        check(counts == want, f"{case}: launches {counts} != {want}")
        check(all(torch.equal(a, r) for a, r in zip(got, again)),
              f"{case}: a repeated launch gave other bits")
        tags = ("flash_bwd_dq" if path == "split" else "flash_bwd",
                "flash_bwd", "flash_bwd")
        errs, errs64, plain64 = _bwd_check(
            torch, K, (q, k, v, do, vl, lse, delta, case), got, worst, tags)
        log(f"flash bwd {(b, h, sq, sk, d)} causal={causal} {path} "
            f"lens={None if lens is None else lens[:4]}...: max abs err "
            f"{errs} (tol rtol={BWD_TOL['rtol']} atol={BWD_TOL['atol']}); "
            f"vs float64 {errs64} (tol rtol={BWD_F64_TOL['rtol']} "
            f"atol={BWD_F64_TOL['atol']}, and at most {BWD_F64_RATIO}x the "
            f"plain version's {plain64}); repeat bit-identical")

    long_launches = _long_attention(mx, torch, g)

    q, k, v, do, vl, out, lse, delta = _bwd_case(torch, K, g, B, H, S, S, D,
                                                 False, lens64)
    scale = D ** -0.5
    args = (q, k, v, do, lse, delta, False, scale, vl)
    mask = (torch.arange(S, device=q.device)[None, :]
            < vl[:, None].long())[:, None, None, :]
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, attn_mask=mask), (qg, kg, vg),
                            do)

    plan = K.flash_bwd_plan(S, D)
    fns = {"fused": lambda: K._flash_bwd_fused_cuda(*args, plan),
           "plain": lambda: K._flash_bwd_plain(*args),
           "sdpa_fwd": lambda: sdpa(q, k, v, attn_mask=mask),
           "sdpa_fwd_bwd": sdpa_fwd_bwd}
    call = {name: cuda_ms(fn) for name, fn in fns.items()}
    dev_ms = {name: graph_ms(fn) for name, fn in fns.items()}
    library_ms = dev_ms["sdpa_fwd_bwd"] - dev_ms["sdpa_fwd"]
    # this run's data: the kernel never loads K/V rows at or past kv_len
    live = sum(min(n, S) for n in lens64)
    pairs = H * S * live                  # live (q, k) pairs over (b, h)
    rows_q = 4 * B * H * S * D            # bytes of one (B, H, Sq, D)
    rows_kv = 4 * H * live * D            # bytes of the live K (or V) rows
    # q, dO, live K / V, lse, delta, kv_len read; dQ, dK, dV written
    nbytes = 2 * rows_q + 2 * rows_kv + 2 * 4 * B * H * S + 4 * B \
        + 3 * rows_q
    bms, by = bound(nbytes, 10 * pairs * D, PEAK_TF32X3_FLOPS)
    log(f"flash bwd training shape {(B, H, S, D)} lens 5-64 (fused path): "
        f"per call (host launch included) {call}; device (CUDA graph) "
        f"{dev_ms}; SDPA backward (fwd+bwd - fwd) {library_ms:.5f} ms; "
        f"fused / SDPA backward {dev_ms['fused'] / library_ms:.3f}; bound "
        f"{bms:.6f} ms ({by}; 10 * pairs * D = {10 * pairs * D} FLOP, "
        f"{nbytes} bytes)")
    dq_row = _long_attention_times(mx, torch, g)
    src = "mxnet_tpu_torch/ops/csrc/flash_bwd.cu"
    rows = [dict(name="flash_bwd", route="cuda", source=src,
                 replaces="mxnet_tpu/ops/pallas_kernels.py:417",
                 max_abs_err=worst["flash_bwd"], ms=dev_ms["fused"],
                 plain_ms=dev_ms["plain"], bound_ms=bms, bound_by=by,
                 library_ms=library_ms, call_ms=call["fused"]),
            # timed at the long shape; no one PyTorch call computes dQ
            # alone (SDPA's backward at that shape is in the log)
            dict(name="flash_bwd_dq", route="cuda", source=src,
                 replaces="mxnet_tpu/ops/pallas_kernels.py:484",
                 max_abs_err=worst["flash_bwd_dq"], library_ms=None,
                 **dq_row)]
    return rows, long_launches


def phase_ln(mx, torch):
    """The LayerNorm kernel against `_ln_plain` at every width its paths
    give it and at edge shapes: TransformerNMT's training shape (rows =
    32 x 64, D = 512), BERT's (16 x 512 rows, D = 768), bert_large's
    (D = 1024), a width that is no multiple of 32 or 128 (D = 200) and
    widths past the one-warp form (1032, 4096, 8192), at row counts that
    leave a block part full. Each shape of LN_TIMED is timed (kernel,
    plain version, `F.layer_norm`) under `per_shape`; the row's own
    numbers stay those of the training shape."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(3)
    # the kernel's form at width d: one warp a row up to D = 1024, one
    # block a row above (kWarpMaxD in ops/csrc/layer_norm.cu)
    form = lambda d: "warp" if d <= 1024 else "row"  # noqa: E731
    worst = 0.0
    for rows, d in [*LN_TIMED, (7, 512), (1, 512), (4099, 512), (7, 768),
                    (1, 1024), (13, 200), (1000, 1032), (3, 8192),
                    (1, 33)]:
        x, ga, be = [torch.randn(shape, generator=g).to(dev)
                     for shape in ((rows, d), (d,), (d,))]
        x = 3 * x + 1
        got = K.layer_norm_fwd(x, ga, be, 1e-5)
        ref = K._ln_plain(x, ga, be, 1e-5)
        torch.cuda.synchronize()
        errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        check(all(torch.allclose(a, r, **LN_TOL) for a, r in zip(got, ref)),
              f"layer norm kernel vs plain at ({rows}, {d}): max abs errs "
              f"(y, mean, rstd) {errs}")
        worst = max(worst, *errs)
        log(f"layer norm ({rows}, {d}) {form(d)} form: max abs "
            f"err (y, mean, rstd) {errs} (tol rtol={LN_TOL['rtol']} "
            f"atol={LN_TOL['atol']})")
    per_shape = []
    for rows, d in LN_TIMED:
        x, ga, be = [torch.randn(shape, generator=g).to(dev)
                     for shape in ((rows, d), (d,), (d,))]
        fns = {"kernel": lambda: K.layer_norm_fwd(x, ga, be, 1e-5),
               "plain": lambda: K._ln_plain(x, ga, be, 1e-5),
               "torch": lambda: torch.nn.functional.layer_norm(
                   x, (d,), ga, be, 1e-5)}
        call = {name: cuda_ms(fn) for name, fn in fns.items()}
        dev_ms = {name: graph_ms(fn) for name, fn in fns.items()}
        # x and y once each, gamma and beta, mean and rstd; ~8 FLOP an
        # element
        bms, by = bound(4 * (2 * rows * d + 2 * d + 2 * rows), 8 * rows * d)
        per_shape.append(dict(shape=[rows, d], form=form(d),
                              ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                              library_ms=dev_ms["torch"], bound_ms=bms,
                              bound_by=by, call_ms=call["kernel"]))
        log(f"layer norm ({rows}, {d}) {form(d)} form: per call "
            f"(host launch included) {call}; device (CUDA graph) {dev_ms}; "
            f"bound {bms:.6f} ms ({by}); kernel / bound "
            f"{dev_ms['kernel'] / bms:.2f}, kernel / F.layer_norm "
            f"{dev_ms['kernel'] / dev_ms['torch']:.3f}")
    top = per_shape[0]
    return dict(name="layer_norm", route="cuda",
                source="mxnet_tpu_torch/ops/csrc/layer_norm.cu",
                replaces="mxnet_tpu/ops/pallas_kernels.py:1209",
                max_abs_err=worst, per_shape=per_shape,
                **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "call_ms")})


def _train_batch(mx, b, s, ctx):
    """One fixed batch from numpy seed 0: source and target tokens,
    labels, and source lengths 16..s (all of them s when s < 16)."""
    rng = np.random.RandomState(0)
    toks = [rng.randint(4, VOCAB, (b, s)).astype(np.int32) for _ in range(3)]
    lens = rng.randint(min(16, s), s + 1, b).astype(np.int32)
    return [mx.nd.array(a, ctx=ctx) for a in (*toks, lens)]


def _train_step(mx, model, trainer, ce, batch):
    src, tgt, lab, vl = batch
    with mx.autograd.record():
        logits = model(src, tgt, vl)
        loss = ce(logits.reshape((-1, VOCAB)), lab.reshape((-1,))).mean()
    loss.backward()
    if trainer is not None:
        trainer.step(src.shape[0])
    return loss


def phase_train(mx, torch, init_file):
    """examples/nmt_translate.py's Gluon loop at full width on the card.
    The initial weights go to `init_file` for the card-vs-CPU phase."""
    K = mx.ops.kernels
    mx.random.seed(0)
    model = mx.models.transformer_base(VOCAB, max_length=TRAIN_S,
                                       dropout=0.0)
    model.initialize(ctx=mx.gpu(0))
    model.save_parameters(init_file)
    n_params = sum(p.numel() for p in model.parameters())
    batch = _train_batch(mx, TRAIN_B, TRAIN_S, mx.gpu(0))
    trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": 3e-4})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    losses, per_step, t_window = [], [], None
    for step in range(10):
        before = dict(K.LAUNCHES)
        if step == 2:                  # steps 3-10 are timed
            torch.cuda.synchronize()
            t_window = time.perf_counter()
        losses.append(_train_step(mx, model, trainer, ce,
                                  batch)._data.detach())
        per_step.append({k: K.LAUNCHES[k] - before[k] for k in before})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_window
    launches = dict(K.LAUNCHES)

    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update(flash_fwd=18, flash_bwd=18, layer_norm=30)
    for i, counts in enumerate(per_step):
        check(counts == want, f"step {i + 1} launches {counts} != {want}")
    for name, p in model._collect_params_with_prefix().items():
        check(p.data()._data.is_cuda and p.grad()._data.is_cuda,
              f"{name} or its gradient is not on the card")
    tokens = 8 * TRAIN_B * TRAIN_S * 2          # steps 3-10, src + tgt
    summary = dict(params=n_params, batch=TRAIN_B, seq=TRAIN_S,
                   losses=losses, tokens_per_s=tokens / wall,
                   mean_step_ms=wall / 8 * 1e3, launches=launches,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("training " + json.dumps(summary))

    got = device_profile(torch, lambda: _train_step(mx, model, trainer, ce,
                                                    batch))
    if got is not None:
        log_profile("train profile", *got, "1 training step")
        for dev_us, count, key in got[1]:
            if "flash" in key or "layer_norm" in key:
                log(f"train profile: port kernel {dev_us / 1e3:.3f} ms "
                    f"{count}x {key[:70]}")
    return launches


def phase_train_card_vs_cpu(mx, torch, init_file):
    """One step at full width on B=2, S=16 from the same initial weights
    on the card and on the CPU: the loss and every gradient agree."""
    mx.random.seed(0)
    models = {}
    for tag, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        model = mx.models.transformer_base(VOCAB, max_length=TRAIN_S,
                                           dropout=0.0)
        model.load_parameters(init_file, ctx=ctx)
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        loss = _train_step(mx, model, None, ce, _train_batch(mx, 2, 16, ctx))
        models[tag] = (model, float(loss.asnumpy()))
    (card, card_loss), (cpu, cpu_loss) = models["card"], models["cpu"]
    check(abs(card_loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss),
          f"card vs CPU loss {card_loss} vs {cpu_loss}")
    worst, cpu_params = (0.0, ""), cpu._collect_params_with_prefix()
    for name, p in card._collect_params_with_prefix().items():
        got = p.grad().asnumpy()
        want = cpu_params[name].grad().asnumpy()
        err = float(np.abs(got - want).max())
        check(np.allclose(got, want, **TRAIN_GRAD_TOL),
              f"card vs CPU gradient of {name}: max abs err {err}")
        worst = max(worst, (err, name))
    log(f"train card vs cpu (B=2, S=16): loss {card_loss:.7f} vs "
        f"{cpu_loss:.7f} (rtol {TRAIN_LOSS_RTOL}); all "
        f"{len(cpu_params)} gradients within {TRAIN_GRAD_TOL}, worst max "
        f"abs err {worst[0]:.3e} ({worst[1]})")



# ---------------------------------------------------------------------------
# ResNet slice: conv1x1 + BN-stats kernel, rtc, ResNet-50 training
# ---------------------------------------------------------------------------
def _bf16_ulp(torch, v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    mag = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _conv1x1_errors(torch, x, w, got):
    """The kernel's (y, mean, meansq) against a float64 evaluation of the
    same product on the card: max abs errors, checked against the
    CONV1X1_* limits. Each bf16 y must be within one bf16 ulp of the
    float64 product of the bf16 operands, plus the fp32 limit (the fp32
    sum's own error, which decides the rounding of values near 0)."""
    y64 = x.double() @ w.double()
    mean64, msq64 = y64.mean(0), (y64 * y64).mean(0)
    y, mean, msq = got
    err_y = (y.double() - y64).abs()
    y_lim = CONV1X1_Y_RTOL * y64.abs().max().item()
    if y.dtype == torch.bfloat16:
        y_ok = bool((err_y <= _bf16_ulp(torch, y64) + y_lim).all())
        y_lim = f"one bf16 ulp + {y_lim:.3e}"
    else:
        y_ok = err_y.max().item() <= y_lim
    s_lim = CONV1X1_STATS_RTOL * msq64.abs().max().item() \
        + CONV1X1_STATS_ATOL
    errs = dict(y=err_y.max().item(),
                mean=(mean.double() - mean64).abs().max().item(),
                meansq=(msq.double() - msq64).abs().max().item())
    ok = (y_ok and errs["mean"] <= s_lim and errs["meansq"] <= s_lim
          and bool(torch.isfinite(y).all()))
    return ok, errs, (y_lim, s_lim)


def phase_conv1x1(mx, torch):
    """The conv1x1 + BN-stats kernel against a float64 evaluation on the
    card, fp32 and bf16, at the probe's four ResNet-50 shapes (batch 128)
    and an odd one: within the CONV1X1_* limits, the fp32 kernel also
    within CONV1X1_F64_RATIO times its plain version's distance from
    float64, and a second call's mean and meansq bit-identical to the
    first's. The kernel, its plain version and the library pair
    (`torch.matmul`, then the two means: the probe's `xla_conv_stats`)
    timed by CUDA-graph replay. `ms` in the row is the sum over the four
    probe shapes, as the probe's TOTAL line; so are the bound and the
    plain and library times. The fp32 bound takes the split-TF32 rate
    (PEAK_TF32X3_FLOPS); the SIMT rate's bound is logged beside it."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for dt, name, peak, replaces in (
            (torch.float32, "conv1x1_bn_stats", PEAK_TF32X3_FLOPS,
             "mxnet_tpu/ops/pallas_kernels.py:1305"),
            (torch.bfloat16, "conv1x1_bn_stats_bf16", PEAK_BF16_FLOPS,
             "tools/probe_fused_convbn.py:31")):
        item = torch.finfo(dt).bits // 8
        worst, per_shape = 0.0, []
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for m, k, n in [*CONV1X1_SHAPES, CONV1X1_ODD]:
            x = torch.randn((m, k), generator=g, device=dev).to(dt)
            w = (torch.randn((k, n), generator=g, device=dev) * 0.05).to(dt)
            got = K.conv1x1_bn_stats(x, w)
            again = K.conv1x1_bn_stats(x, w)
            torch.cuda.synchronize()
            ok, errs, lims = _conv1x1_errors(torch, x, w, got)
            check(ok, f"{name} ({m}, {k}, {n}) vs float64: max abs errs "
                      f"{errs}, limits (y, stats) {lims}")
            check(all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])),
                  f"{name} ({m}, {k}, {n}): a second call's mean / meansq "
                  f"differ from the first's")
            worst = max(worst, *errs.values())
            log(f"{name} ({m}, {k}, {n}): max abs err vs float64 {errs} "
                f"(limits: y {lims[0]}, stats {lims[1]:.3e}); two calls "
                f"bit-identical")
            if dt == torch.float32:
                _, plain64, _ = _conv1x1_errors(
                    torch, x, w, K._conv1x1_stats_plain(x, w))
                for key, e in errs.items():
                    check(e <= CONV1X1_F64_RATIO * plain64[key],
                          f"{name} ({m}, {k}, {n}) {key}: {e} from float64,"
                          f" over {CONV1X1_F64_RATIO}x the plain version's "
                          f"{plain64[key]}")
                ratios = {key: e / max(plain64[key], 1e-30)
                          for key, e in errs.items()}
                log(f"{name} ({m}, {k}, {n}): distance from float64 over "
                    f"the plain version's {ratios}")
            if (m, k, n) == CONV1X1_ODD:
                continue

            def library(x=x, w=w):
                yf = torch.matmul(x, w).float()
                return yf.mean(0), (yf * yf).mean(0)
            fns = {"kernel": lambda x=x, w=w: K.conv1x1_bn_stats(x, w),
                   "plain": lambda x=x, w=w: K._conv1x1_stats_plain(x, w),
                   "library": library}
            dev_ms = {key: graph_ms(fn, calls=5, iters=10)
                      for key, fn in fns.items()}
            # x, w read once, y written once, two (N,) fp32 outputs; the
            # product's 2MKN and the statistics' 3 FLOP an output
            nbytes = item * (m * k + k * n + m * n) + 8 * n
            flops = 2 * m * k * n + 3 * m * n
            bms, by = bound(nbytes, flops, peak)
            tflops = 2 * m * k * n / dev_ms["kernel"] / 1e9
            tot["ms"] += dev_ms["kernel"]
            tot["plain_ms"] += dev_ms["plain"]
            tot["library_ms"] += dev_ms["library"]
            tot["bound_ms"] += bms
            per_shape.append(dict(shape=[m, k, n], bound_by=by,
                                  bound_ms=bms, tflops=tflops, **dev_ms))
            simt = ("" if dt != torch.float32 else
                    f"; at the SIMT fp32 rate ({PEAK_FP32_FLOPS / 1e12:.0f} "
                    f"TFLOP/s) {bound(nbytes, flops)[0]:.6f} ms")
            log(f"{name} ({m}, {k}, {n}): device (CUDA graph) {dev_ms}; "
                f"bound {bms:.6f} ms ({by}){simt}; {tflops:.2f} TFLOP/s")
            del x, w, got, again
        # the summed bound is bound by what bounds most of it
        by_bytes = sum(r["bound_ms"] for r in per_shape
                       if r["bound_by"] == "bytes")
        rows.append(dict(name=name, route="cuda",
                         source="mxnet_tpu_torch/ops/csrc/conv1x1_bn_stats.cu",
                         replaces=replaces, max_abs_err=worst,
                         bound_by="bytes" if 2 * by_bytes > tot["bound_ms"]
                         else "operations",
                         per_shape=per_shape, call_ms=None, **tot))
    torch.cuda.empty_cache()
    return rows


RTC_SOURCE = r"""
extern "C" __global__ void axpy(const float *x, const float *y, float *o,
                                int n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i] + y[i];
}

// a C++ template, fetched through its exported name expression
template <typename T>
__global__ void block_sum(const T *x, T *out, int n) {
  extern __shared__ float part[];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += (float)x[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (T)part[0];
}
"""


def phase_rtc(mx, torch):
    """`mx.rtc`: compile the JAX test's axpy (o = 2x + y) and a templated
    block sum with an `int n` and dynamic shared memory; their launches
    (counted from zero) are held against `2 * x + y` and `x.sum()`; a
    source with a syntax error must raise with NVRTC's log; axpy timed
    against its plain version and `torch.add(y, x, alpha=2)`."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    t0 = time.perf_counter()
    mod = mx.rtc.CudaModule(RTC_SOURCE, exports=["block_sum<float>"])
    log(f"rtc: compiled in {time.perf_counter() - t0:.2f} s for {mod.arch} "
        f"with {mx.rtc._lib('nvrtc').path}")
    axpy = mod.get_kernel("axpy", "const float *x, const float *y, "
                                  "float *o, int n")
    bsum = mod.get_kernel("block_sum<float>", "const float *x, float *out, "
                                              "int n")
    n = RTC_N
    x = mx.nd.NDArray(torch.randn(n, generator=g, device=dev))
    y = mx.nd.NDArray(torch.randn(n, generator=g, device=dev))
    o = mx.nd.NDArray(torch.empty(n, device=dev))
    s = mx.nd.NDArray(torch.empty(1, device=dev))
    threads = 1024
    K.reset_launch_counts()
    axpy.launch([x, y, o, n], mx.gpu(0), (-(-n // 256), 1, 1), (256, 1, 1))
    bsum.launch([x, s, n], mx.gpu(0), (1, 1, 1), (threads, 1, 1),
                shared_mem=4 * threads)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches["rtc"] == 2 and sum(launches.values()) == 2,
          f"rtc launches {launches}")
    xt, yt = x._data, y._data
    err_axpy = (o._data - (2 * xt + yt)).abs().max().item()
    check(err_axpy <= RTC_AXPY_ATOL, f"rtc axpy: max abs err {err_axpy}")
    want = xt.double().sum().item()
    err_sum = abs(s._data.item() - want)
    lim_sum = RTC_SUM_RTOL * xt.abs().sum().item()
    check(err_sum <= lim_sum, f"rtc block_sum: {s._data.item()} vs {want}")
    log(f"rtc: axpy max abs err {err_axpy:.3e} (limit {RTC_AXPY_ATOL}); "
        f"block_sum {s._data.item():.6f} vs float64 {want:.6f} (limit "
        f"{lim_sum:.3e}); launches {launches['rtc']}")
    try:
        mx.rtc.CudaModule('extern "C" __global__ void bad(float *x) '
                          '{ x[0] = ; }')
        check(False, "rtc compiled a source with a syntax error")
    except mx.MXNetError as e:
        check("NVRTC log" in str(e) and "error" in str(e),
              f"rtc compile error without the log: {e}")
        log(f"rtc: syntax error refused: {str(e).splitlines()[-2:]}")

    fns = {"kernel": lambda: axpy.launch([x, y, o, n], mx.gpu(0),
                                         (-(-n // 256),), (256,)),
           "plain": lambda: 2 * xt + yt,
           "library": lambda: torch.add(yt, xt, alpha=2)}
    call = {key: cuda_ms(fn) for key, fn in fns.items()}
    dev_ms = {key: graph_ms(fn) for key, fn in fns.items()}
    bms, by = bound(3 * 4 * n, 2 * n)
    log(f"rtc axpy n={n}: per call (host launch included) {call}; device "
        f"(CUDA graph) {dev_ms}; bound {bms:.6f} ms ({by})")
    row = dict(name="rtc", route="cuda", source="mxnet_tpu_torch/rtc.py",
               replaces="mxnet_tpu/rtc.py:55", max_abs_err=err_axpy,
               ms=dev_ms["kernel"], plain_ms=dev_ms["plain"], bound_ms=bms,
               bound_by=by, library_ms=dev_ms["library"],
               call_ms=call["kernel"])
    return row, launches


def _resnet_batch(mx, b, ctx):
    """Synthetic NHWC images and labels 0-999 from numpy seed 0."""
    rng = np.random.RandomState(0)
    images = rng.rand(b, 224, 224, 3).astype(np.float32)
    labels = rng.randint(0, 1000, b).astype(np.int32)
    return mx.nd.array(images, ctx=ctx), mx.nd.array(labels, ctx=ctx)


def _resnet50(mx):
    return mx.gluon.model_zoo.vision.get_model("resnet50_v1", layout="NHWC")


def _resnet_step(mx, net, trainer, ce, x, y):
    with mx.autograd.record():
        loss = ce(net(x), y).mean()
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def _resnet_trainer(mx, net):
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4})


def phase_resnet_train(mx, torch, init_file):
    """Full-width ResNet-50 v1 (NHWC) through the Gluon loop at B=128 on
    the card: SGD with momentum, 10 steps. The initial weights go to
    `init_file` for the card-vs-CPU phase. The port's kernel counters
    must not move: the JAX ResNet runs no Pallas kernel either."""
    K = mx.ops.kernels
    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = _resnet50(mx)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    net(mx.nd.zeros((2, 224, 224, 3), ctx=ctx))   # the deferred shapes
    net.save_parameters(init_file)
    x, y = _resnet_batch(mx, RESNET_B, ctx)
    params = net._collect_params_with_prefix()
    stats0 = {n: p.data()._data.clone() for n, p in params.items()
              if n.endswith(("running_mean", "running_var"))}
    trainer = _resnet_trainer(mx, net)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, t_window = [], None
    for step in range(RESNET_STEPS):
        if step == 2:                  # steps 3-10 are timed
            torch.cuda.synchronize()
            t_window = time.perf_counter()
        losses.append(_resnet_step(mx, net, trainer, ce, x, y)._data
                      .detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_window
    launches = dict(K.LAUNCHES)
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(sum(launches.values()) == 0,
          f"the ResNet step launched a port kernel: {launches}")
    moved = sum(not torch.equal(p.data()._data, stats0[n])
                for n, p in params.items() if n in stats0)
    check(moved == len(stats0), f"{len(stats0) - moved} running statistics "
                                f"did not move")
    for name, p in params.items():
        check(p.data()._data.is_cuda, f"{name} is not on the card")
    steps = RESNET_STEPS - 2
    summary = dict(model="resnet50_v1", layout="NHWC", batch=RESNET_B,
                   params=sum(p.data().size for p in params.values()
                              if p.grad_req != "null"),
                   losses=losses, images_per_s=steps * RESNET_B / wall,
                   mean_step_ms=wall / steps * 1e3, launches=launches,
                   running_stats_moved=moved,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   cudnn=dict(benchmark=torch.backends.cudnn.benchmark,
                              deterministic=
                              torch.backends.cudnn.deterministic,
                              allow_tf32=torch.backends.cudnn.allow_tf32,
                              version=torch.backends.cudnn.version()))
    log("resnet training " + json.dumps(summary))
    got = device_profile(torch, lambda: _resnet_step(mx, net, trainer, ce,
                                                     x, y))
    if got is not None:
        log_profile("resnet profile", *got, "1 training step")
    return net, x, launches


def phase_resnet_conv1x1(mx, torch, net, x):
    """The conv1x1 kernel fed the live activations of the ResNet-50 of
    `phase_resnet_train`: one training-mode forward at B=128 with a hook
    on every stride-1 1x1 Conv2D (each feeds a BatchNorm in v1: 16
    expand, 13 reduce and the stage-1 downsample convolutions). With the
    counters zeroed, each hooked convolution's input goes through the
    kernel as (B*H*W, Cin) @ (Cin, Cout), in fp32 and in bf16; then y is
    held against the Conv2D's own output (fp32) or the float64 product
    of the bf16 operands, and the statistics against float64 ones."""
    K = mx.ops.kernels
    Conv2D = mx.gluon.nn.Conv2D
    convs = [m for m in net.modules() if isinstance(m, Conv2D)
             and m._kernel == (1, 1) and m._strides == (1, 1)]
    check(len(convs) == 30, f"{len(convs)} stride-1 1x1 convolutions")
    seen = []
    hooks = [c.register_forward_hook(
        lambda mod, args, out: seen.append(
            (args[0]._data.detach(), mod.weight.data()._data.detach(),
             out._data.detach()))) for c in convs]
    try:
        with mx.autograd.train_mode():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    check(len(seen) == 30, f"{len(seen)} hooked convolutions ran")
    live = {}
    for xin, w, _ in seen:
        shape = (xin.numel() // xin.shape[-1], xin.shape[-1], w.shape[0])
        live[shape] = live.get(shape, 0) + 1
    check(live == RESNET_CONV1X1,
          f"live 1x1 convolutions {live} != RESNET_CONV1X1")
    operands = []
    for xin, w, yconv in seen:
        cin, cout = xin.shape[-1], w.shape[0]
        x2d = xin.reshape(-1, cin).contiguous()
        w2d = w.reshape(cout, cin).t().contiguous()
        operands.append((x2d, w2d, yconv.reshape(-1, cout)))
    K.reset_launch_counts()
    outs = [(K.conv1x1_bn_stats(x2d, w2d),
             K.conv1x1_bn_stats(x2d.bfloat16(), w2d.bfloat16()))
            for x2d, w2d, _ in operands]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update(conv1x1_bn_stats=30, conv1x1_bn_stats_bf16=30)
    check(launches == want, f"live conv1x1 launches {launches} != {want}")
    worst = {"f32": {}, "bf16": {}}
    for (x2d, w2d, yconv), (f32, bf16) in zip(operands, outs):
        y64 = yconv.double()
        err_y = (f32[0].double() - y64).abs().max().item()
        y_lim = CONV1X1_Y_RTOL * y64.abs().max().item()
        msq64 = (y64 * y64).mean(0)
        s_lim = CONV1X1_STATS_RTOL * msq64.abs().max().item() \
            + CONV1X1_STATS_ATOL
        errs = dict(y=err_y,
                    mean=(f32[1].double() - y64.mean(0)).abs().max().item(),
                    meansq=(f32[2].double() - msq64).abs().max().item())
        shape = tuple(x2d.shape) + (w2d.shape[1],)
        check(err_y <= y_lim and errs["mean"] <= s_lim
              and errs["meansq"] <= s_lim,
              f"live conv1x1 {shape} fp32 vs the Conv2D output: {errs}, "
              f"limits y {y_lim}, stats {s_lim}")
        ok, errs16, lims = _conv1x1_errors(torch, x2d.bfloat16(),
                                           w2d.bfloat16(), bf16)
        check(ok, f"live conv1x1 {shape} bf16 vs float64: {errs16}, limits "
                  f"{lims}")
        for tag, e in (("f32", errs), ("bf16", errs16)):
            for key, v in e.items():
                worst[tag][key] = max(worst[tag].get(key, 0.0), v)
    shapes = sorted({tuple(o[0].shape) + (o[1].shape[1],) for o in operands})
    log(f"resnet conv1x1: 30 live stride-1 1x1 convolutions, {len(shapes)} "
        f"shapes {shapes}; worst max abs errs {worst}; launches {launches}")
    return launches


def _resnet_one_step(mx, ctx, init_file):
    """(loss, gradients, running statistics after the step) of one SGD
    step of full-width ResNet-50 v1 (NHWC) at B=4 from `init_file`."""
    net = _resnet50(mx)
    net.load_parameters(init_file, ctx=ctx)
    x, y = _resnet_batch(mx, 4, ctx)
    trainer = _resnet_trainer(mx, net)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = ce(net(x), y).mean()
    loss.backward()
    params = net._collect_params_with_prefix()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    trainer.step(4)
    stats = {n: p.data().asnumpy() for n, p in params.items()
             if p.grad_req == "null"}
    return float(loss.asnumpy()), grads, stats


def _norm_rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_resnet_card_vs_cpu(mx, torch, init_file):
    """One SGD step of full-width ResNet-50 v1 (NHWC) at B=4 from the same
    initial weights on the card and on the CPU: the loss, every gradient
    and every running statistic agree.

    At this random initialisation and batch the gradients are ill
    conditioned: BatchNorm over 196 values a channel in stage 4 and the
    ReLU kinks amplify fp32 rounding about 1e5 times, so two CPU runs
    that only split their sums differently (one thread, then all) already
    differ by about 1 % in some gradients' norm. So each gradient and
    running statistic is held, in norm, against that CPU-vs-CPU spread:
    the card may differ from the CPU by at most RESNET_SPREAD_FACTOR
    times the larger of its own spread and the median spread of its
    kind (a few kinks decide one parameter's spread, so it can be small
    by chance), or of the floor."""
    card = _resnet_one_step(mx, mx.gpu(0), init_file)
    cpu = _resnet_one_step(mx, mx.cpu(), init_file)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu1 = _resnet_one_step(mx, mx.cpu(), init_file)
    finally:
        torch.set_num_threads(threads)
    check(abs(card[0] - cpu[0]) <= RESNET_LOSS_RTOL * abs(cpu[0]),
          f"resnet card vs CPU loss {card[0]} vs {cpu[0]}")
    report = {}
    for i, kind, floor in ((1, "gradient", RESNET_GRAD_FLOOR),
                           (2, "running statistic", RESNET_STAT_FLOOR)):
        check(set(card[i]) == set(cpu[i]) == set(cpu1[i]) and cpu[i],
              f"resnet {kind} names differ")
        spread = {n: _norm_rel(cpu1[i][n], w) for n, w in cpu[i].items()}
        # a parameter's own spread, or the typical one where its own is
        # smaller by chance (a few kinks decide it)
        typical = float(np.median(list(spread.values())))
        worst = (0.0, "", 0.0, 0.0, 0.0)
        for name, want in cpu[i].items():
            err = _norm_rel(card[i][name], want)
            lim = RESNET_SPREAD_FACTOR * max(spread[name], typical, floor)
            check(err <= lim, f"resnet card vs CPU {kind} {name}: norm-"
                              f"relative error {err} > {lim} (CPU spread "
                              f"{spread[name]}, median {typical})")
            max_abs = float(np.abs(card[i][name] - want).max())
            worst = max(worst, (err / lim, name, err, spread[name], max_abs))
        report[kind] = dict(count=len(cpu[i]), worst_share=worst[0],
                            worst=worst[1], err=worst[2], spread=worst[3],
                            max_abs_err=worst[4], median_spread=typical,
                            max_spread=max(spread.values()),
                            max_err=max(_norm_rel(card[i][n], w)
                                        for n, w in cpu[i].items()))
    log(f"resnet card vs cpu (B=4): loss {card[0]:.7f} vs {cpu[0]:.7f} "
        f"(rtol {RESNET_LOSS_RTOL}), one-thread CPU {cpu1[0]:.7f}; norm-"
        f"relative errors within {RESNET_SPREAD_FACTOR} x max(CPU spread, "
        f"median spread, floor): " + json.dumps(report))


# ---------------------------------------------------------------------------
# BERT slice: BERT-base MLM pretraining through Gluon, fp32
# ---------------------------------------------------------------------------
def _bert_lengths(b):
    """BERT's attention shape's key lengths: one mid-block (300), one on
    a block edge (384), one full (512), one very short (3), the rest from
    numpy seed 0 in [256, 512], as examples/bert_pretrain.py draws
    them."""
    rest = np.random.RandomState(0).randint(BERT_S // 2, BERT_S + 1, b - 4)
    return [300, 384, BERT_S, 3] + [int(n) for n in rest]


def phase_bert_attention(mx, torch, rows):
    """The flash kernels at BERT-base's attention shape (B=16, H=12,
    S=512, D=64) with key lengths (`_bert_lengths`): the forward against
    `_flash_plain`, the backward on its split path (the fused kernel for
    dK / dV, then the dQ kernel) against `_flash_bwd_plain` and float64
    autograd, dK / dV exactly 0 at and past each length. Then the
    forward, the backward pair, each of its kernels, the plain versions
    and SDPA (forward, and backward as fwd+bwd - fwd) are timed at that
    shape and added to the `flash_fwd`, `flash_bwd` and `flash_bwd_dq`
    rows' `per_shape`."""
    K = mx.ops.kernels
    g = torch.Generator(device="cpu").manual_seed(7)
    B, H, S, D = BERT_B, BERT_H, BERT_S, 64
    lens = _bert_lengths(B)
    plan = K.flash_bwd_plan(S, D)
    check(plan["path"] == "split", f"S = {S} should take the split path")
    case = (B, H, S, S, D, False, lens)
    q, k, v, do, vl, out, lse, delta = _bwd_case(torch, K, g, *case)
    before = dict(K.LAUNCHES)
    got = K.flash_attention_bwd(q, k, v, do, lse, delta, False, D ** -0.5,
                                vl)
    torch.cuda.synchronize()
    counts = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
    check(counts == dict(dict.fromkeys(K.LAUNCHES, 0), flash_bwd=1,
                         flash_bwd_dq=1),
          f"bert attention backward launches {counts}")
    # The length-3 row puts all 512 queries' gradient on 3 keys: its
    # |dK|, |dV| reach about 19 and 31 where every other row's stay near
    # 1. The split-TF32 products err by about 5e-6 of a slice's largest
    # gradient on every row (the fp32 plain version by about 1e-6), so
    # that row's absolute errors reach 1e-4: BWD_TOL's and BWD_F64_TOL's
    # absolute part is scaled by each (b, h) slice's largest |gradient|
    # (at least 1, so the rows of scale <= 1 keep the unscaled limit)
    worst = {"flash_bwd": 0.0, "flash_bwd_dq": 0.0}
    errs, errs64, plain64 = _bwd_check(
        torch, K, (q, k, v, do, vl, lse, delta, case), got, worst,
        ("flash_bwd_dq", "flash_bwd", "flash_bwd"), scaled=True)
    scales = {name: t.abs().amax(dim=(-2, -1)).max().item()
              for name, t in zip(("dq", "dk", "dv"), got)}
    log(f"bert attention {(B, H, S, D)} split path lens {lens}: forward "
        f"out / lse within FLASH_TOL of the plain version; backward max abs "
        f"err {errs} (tol rtol={BWD_TOL['rtol']} atol={BWD_TOL['atol']} x "
        f"max(1, the (b, h) slice's largest |gradient|); largest "
        f"|gradient| {scales}); vs float64 {errs64} (the same with "
        f"BWD_F64_TOL, and at most {BWD_F64_RATIO}x the plain version's "
        f"{plain64}); dK / dV exactly 0 past each length")
    for name, err in worst.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    scale = D ** -0.5
    args = (q, k, v, do, lse, delta, False, scale, vl)
    mask = (torch.arange(S, device=q.device)[None, :]
            < vl[:, None].long())[:, None, None, :]
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, attn_mask=mask), (qg, kg, vg),
                            do)

    fns = {"fwd": lambda: K.flash_attention_fwd(q, k, v, kv_lengths=vl),
           "fwd_plain": lambda: K._flash_plain(q, k, v, False, scale, vl),
           "pair": lambda: K.flash_attention_bwd(*args),
           "fused_dkv": lambda: K._flash_bwd_fused_cuda(*args, plan),
           "dq": lambda: K._flash_bwd_dq_cuda(*args, plan),
           "bwd_plain": lambda: K._flash_bwd_plain(*args),
           "sdpa_fwd": lambda: sdpa(q, k, v, attn_mask=mask),
           "sdpa_fwd_bwd": sdpa_fwd_bwd,
           **_fwd_plan_fns(K, q, k, v, False, scale, vl)}
    dev_ms = {name: graph_ms(fn, calls=5, iters=10)
              for name, fn in fns.items()}
    sdpa_bwd = dev_ms["sdpa_fwd_bwd"] - dev_ms["sdpa_fwd"]
    # this run's data: no kernel loads K / V rows at or past a length
    live = sum(min(n, S) for n in lens)
    pairs = H * S * live                     # live (q, k) pairs
    rows_q = 4 * B * H * S * D               # bytes of one (B, H, S, D)
    rows_kv = 4 * H * live * D               # bytes of the live K (or V)
    stats = 4 * B * H * S                    # bytes of lse (or delta)
    shape = [B, H, S, S, D]
    # forward: q, live K / V, lengths read; out, lse written; QK^T + PV
    fwd_b = bound(2 * rows_q + 2 * rows_kv + stats + 4 * B, 4 * pairs * D,
                  PEAK_TF32X3_FLOPS)
    # the fused kernel on the split path: q, dO, live K / V, lse, delta
    # read, dK and dV written; S, dP, dV, dK
    dkv_b = bound(2 * rows_q + 2 * rows_kv + 2 * stats + 4 * B
                  + 2 * rows_q, 8 * pairs * D, PEAK_TF32X3_FLOPS)
    # the dQ kernel: the same reads, dQ written; S, dP, dQ
    dq_b = bound(2 * rows_q + 2 * rows_kv + 2 * stats + 4 * B + rows_q,
                 6 * pairs * D, PEAK_TF32X3_FLOPS)
    pair_b = bound(2 * rows_q + 2 * rows_kv + 2 * stats + 4 * B
                   + 3 * rows_q, 10 * pairs * D, PEAK_TF32X3_FLOPS)
    tflops = {name: f * pairs * D / (dev_ms[name] * 1e-3) / 1e12
              for name, f in (("fwd", 4), ("pair", 10), ("fused_dkv", 8),
                              ("dq", 6))}
    log(f"bert attention {(B, H, S, D)} lens {lens}: forward plan "
        f"{K.flash_fwd_plan(B * H, S, S, D)}; device (CUDA graph) "
        f"{dev_ms}; SDPA backward (fwd+bwd - fwd) {sdpa_bwd:.5f} ms; split "
        f"pair / SDPA backward {dev_ms['pair'] / sdpa_bwd:.3f}; forward / "
        f"SDPA forward {dev_ms['fwd'] / dev_ms['sdpa_fwd']:.3f}; bounds "
        f"fwd {fwd_b}, fused dK/dV {dkv_b}, dQ {dq_b}, pair {pair_b}; "
        f"achieved TFLOP/s {tflops}")
    rows["flash_fwd"].setdefault("per_shape", []).append(dict(
        shape=shape, lens=lens, ms=dev_ms["fwd"],
        plain_ms=dev_ms["fwd_plain"], bound_ms=fwd_b[0],
        bound_by=fwd_b[1], library_ms=dev_ms["sdpa_fwd"]))
    rows["flash_bwd"].setdefault("per_shape", []).append(dict(
        shape=shape, lens=lens, path="split", ms=dev_ms["fused_dkv"],
        bound_ms=dkv_b[0], bound_by=dkv_b[1], pair_ms=dev_ms["pair"],
        pair_bound_ms=pair_b[0], pair_bound_by=pair_b[1],
        plain_ms=dev_ms["bwd_plain"], library_ms=None,
        pair_library_ms=sdpa_bwd))
    rows["flash_bwd_dq"].setdefault("per_shape", []).append(dict(
        shape=shape, lens=lens, ms=dev_ms["dq"], bound_ms=dq_b[0],
        bound_by=dq_b[1], plain_ms=dev_ms["bwd_plain"], library_ms=None))
    del q, k, v, do, out, qg, kg, vg
    torch.cuda.empty_cache()


def _bert_batch(mx, b, s, ctx, lens=None):
    """One fixed pretraining batch from numpy seed 0: token ids, segment
    ids (0, then 1 from a split point inside the valid length), valid
    lengths in [s/2, s] (or `lens`), BERT_P masked positions inside each
    length, their labels, and NSP labels."""
    rng = np.random.RandomState(0)
    tok = rng.randint(0, BERT_VOCAB, (b, s)).astype(np.int32)
    vl = np.asarray(lens if lens is not None
                    else rng.randint(s // 2, s + 1, b), np.int32)
    split = (vl * rng.uniform(0.2, 0.8, b)).astype(np.int32)
    seg = (np.arange(s)[None, :] >= split[:, None]).astype(np.int32)
    pos = (rng.uniform(0, 1, (b, BERT_P)) * vl[:, None]).astype(np.int32)
    mlm_y = rng.randint(0, BERT_VOCAB, (b, BERT_P)).astype(np.int32)
    nsp_y = rng.randint(0, 2, b).astype(np.int32)
    return [mx.nd.array(a, ctx=ctx)
            for a in (tok, seg, vl, pos, mlm_y, nsp_y)]


def _bert_step(mx, model, trainer, ce, batch):
    """examples/bert_pretrain.py's step: the MLM and NSP cross-entropies,
    backward, and (with a trainer) an update."""
    tok, seg, vl, pos, mlm_y, nsp_y = batch
    with mx.autograd.record():
        mlm, nsp = model(tok, seg, vl, pos)
        loss = ce(mlm.reshape((-1, BERT_VOCAB)),
                  mlm_y.reshape((-1,))).mean() + ce(nsp, nsp_y).mean()
    loss.backward()
    if trainer is not None:
        trainer.step(tok.shape[0])
    return loss


def _bert_pretraining(mx, num_layers=None):
    """BERTForPretraining over bert_base (max_length 512, dropout 0), or
    a full-width BERT of `num_layers` layers."""
    if num_layers is None:
        bert = mx.models.bert_base(max_length=BERT_S, dropout=0.0)
    else:
        bert = mx.models.BERTModel(BERT_VOCAB, units=768, hidden_size=3072,
                                   num_layers=num_layers, num_heads=BERT_H,
                                   max_length=BERT_S, dropout=0.0)
    return mx.models.BERTForPretraining(bert)


def phase_bert_train(mx, torch, init_file):
    """examples/bert_pretrain.py's Gluon loop on full-width bert_base in
    fp32 at bench_bert.py's shape (B=16, S=512, 76 masked positions),
    Adam at 1e-4, BERT_STEPS steps on one fixed batch. The counters are
    zeroed just before and read just after: every step must launch 12
    flash forwards, 12 fused and 12 dQ backward kernels (S = 512 takes
    the split path) and 2 x 12 + 2 LayerNorms. Tokens/s (B * S a step
    over the summed wall time of steps 3 on), the per-step spread, peak
    memory, then one step under torch.profiler. The initial weights go
    to `init_file` for the card-vs-CPU phase."""
    K = mx.ops.kernels
    mx.random.seed(0)
    model = _bert_pretraining(mx)
    model.initialize(ctx=mx.gpu(0))
    model.save_parameters(init_file)
    n_params = sum(p.numel() for p in model.parameters())
    batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
    trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": 1e-4})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    losses, per_step, step_s = [], [], []
    for _ in range(BERT_STEPS):
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        losses.append(_bert_step(mx, model, trainer, ce,
                                 batch)._data.detach())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({k: K.LAUNCHES[k] - before[k] for k in before})
    launches = dict(K.LAUNCHES)

    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite BERT loss: {losses}")
    check(losses[-1] < losses[0], f"BERT loss did not fall: {losses}")
    n = len(model.bert.encoder.layers)
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd=n, flash_bwd=n,
                flash_bwd_dq=n, layer_norm=2 * n + 2)
    for i, counts in enumerate(per_step):
        check(counts == want, f"BERT step {i + 1} launches {counts} != "
                              f"{want}")
    for name, p in model._collect_params_with_prefix().items():
        check(p.data()._data.is_cuda and p.grad()._data.is_cuda,
              f"{name} or its gradient is not on the card")
    # all the tokens of steps 3 on over all their wall time, as the
    # other training phases count; the per-step rates give the spread
    timed = step_s[2:]
    tok_s = [BERT_B * BERT_S / t for t in timed]
    summary = dict(params=n_params, batch=BERT_B, seq=BERT_S,
                   masked=BERT_P, lengths=batch[2].asnumpy().tolist(),
                   losses=losses,
                   tokens_per_s=BERT_B * BERT_S * len(timed) / sum(timed),
                   tokens_per_s_min=min(tok_s), tokens_per_s_max=max(tok_s),
                   step_ms=[t * 1e3 for t in step_s], launches=launches,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("bert training " + json.dumps(summary))

    got = device_profile(torch, lambda: _bert_step(mx, model, trainer, ce,
                                                   batch))
    if got is not None:
        log_profile("bert profile", *got, "1 training step")
        busy = sum(r[0] for r in got[1])
        for tag, words in (("flash forward", ("flash_fwd",)),
                           ("split backward", ("flash_bwd",)),
                           ("LayerNorm", ("layer_norm",)),
                           ("GEMM", ("gemm", "sgemm", "cutlass"))):
            us = sum(r[0] for r in got[1]
                     if any(w in r[2].lower() for w in words))
            log(f"bert profile: {tag} {us / 1e3:.3f} ms, "
                f"{100 * us / busy:.1f} % of device time")
        for dev_us, count, key in got[1]:
            if "flash" in key or "layer_norm" in key:
                log(f"bert profile: port kernel {dev_us / 1e3:.3f} ms "
                    f"{count}x {key[:70]}")
    del model, trainer, batch
    torch.cuda.empty_cache()
    return launches


def phase_bert_card_vs_cpu(mx, torch, init_file):
    """One step of a full-width BERT (768 units, 3072 hidden, 12 heads,
    vocab 30522) cut to 2 layers, at B=2, S=512 (the split backward
    path), lengths (300, 512), 76 masked positions, from the initial
    weights of `phase_bert_train` (its first two layers) on the card and
    on the CPU: the loss and every gradient agree within the limits of
    `phase_train_card_vs_cpu`."""
    K = mx.ops.kernels
    results = {}
    for tag, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        model = _bert_pretraining(mx, num_layers=2)
        model.load_parameters(init_file, ctx=ctx, ignore_extra=True)
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        K.reset_launch_counts()
        loss = _bert_step(mx, model, None, ce,
                          _bert_batch(mx, 2, BERT_S, ctx, lens=(300, 512)))
        results[tag] = (model, float(loss.asnumpy()), dict(K.LAUNCHES))
    (card, card_loss, launches), (cpu, cpu_loss, _) = (results["card"],
                                                       results["cpu"])
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd=2, flash_bwd=2,
                flash_bwd_dq=2, layer_norm=6)
    check(launches == want, f"BERT card step launches {launches} != {want}")
    check(abs(card_loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss),
          f"BERT card vs CPU loss {card_loss} vs {cpu_loss}")
    worst, cpu_params = (0.0, "", 0.0), cpu._collect_params_with_prefix()
    for name, p in card._collect_params_with_prefix().items():
        got = p.grad().asnumpy()
        want_g = cpu_params[name].grad().asnumpy()
        err = np.abs(got - want_g)
        lim = TRAIN_GRAD_TOL["atol"] + TRAIN_GRAD_TOL["rtol"] * np.abs(want_g)
        check(bool((err <= lim).all()),
              f"BERT card vs CPU gradient of {name}: max abs err "
              f"{float(err.max())}, worst share of its limit "
              f"{float((err / lim).max())}")
        worst = max(worst, (float((err / lim).max()), name,
                            float(err.max())))
    log(f"bert card vs cpu (2 layers, B=2, S=512, lengths (300, 512)): loss "
        f"{card_loss:.7f} vs {cpu_loss:.7f} (rtol {TRAIN_LOSS_RTOL}); all "
        f"{len(cpu_params)} gradients within |card - cpu| <= "
        f"{TRAIN_GRAD_TOL['atol']} + {TRAIN_GRAD_TOL['rtol']} |cpu|; worst "
        f"{worst[1]} at {worst[0]:.3f} of its limit (max abs err "
        f"{worst[2]:.3e}); card launches {launches}")


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _lc_leaves(torch, arrays, layout_bshd):
    """Fresh leaves on this process's card from numpy arrays (B, S, H,
    D); with `layout_bshd` False, transposed to (B, H, S, D)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    ts = [torch.tensor(a, device=dev) for a in arrays]
    if not layout_bshd:
        ts = [t.transpose(1, 2).contiguous() for t in ts]
    return [t.requires_grad_(True) for t in ts]


def _block_f64(torch, q, k, v, g, g_lse, causal, scale):
    """(out, lse, dQ, dK, dV) of block attention by float64 autograd on
    the CPU, for the cotangents g of out and g_lse of lse."""
    q, k, v = (t.detach().cpu().double().requires_grad_(True)
               for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.tensor(-torch.inf, dtype=s.dtype))
    lse = torch.logsumexp(s, -1)
    out = torch.softmax(s, -1) @ v
    grads = torch.autograd.grad((out, lse), (q, k, v),
                                (g.cpu().double(), g_lse.cpu().double()))
    return [out.detach(), lse.detach(), *grads]


def _lc_reference(mx, torch, arrays):
    """The whole-sequence reference of the long-context checks, (B, H, S,
    D) on the card: `flash_attention`'s output and gradients of sum(out
    * w), the plain versions' gradients and float64 autograd's (CPU)."""
    K = mx.ops.kernels
    q, k, v, w = _lc_leaves(torch, arrays, False)
    w = w.detach()
    ref = K.flash_attention(q, k, v, causal=True)
    ref_grads = torch.autograd.grad((ref * w).sum(), (q, k, v))
    scale = LC_D ** -0.5
    q0, k0, v0 = (t.detach() for t in (q, k, v))
    out, lse = K._flash_plain(q0, k0, v0, True, scale, None)
    delta = (out * w).sum(-1).reshape(-1, LC_S)
    plain = K._flash_bwd_plain(q0, k0, v0, w, lse, delta, True, scale, None)
    f64 = _attention_grads_f64(torch, q0, k0, v0, w, True, scale, None)
    return ref.detach(), ref_grads, plain, f64, w


def _lc_grads_check(torch, what, got, ref, worst):
    """Gradients `got` against flash_attention's (BWD_TOL) and float64,
    no further from it than BWD_F64_RATIO times the plain version."""
    ref_grads, plain, f64 = ref
    for name, a, r, p, r64 in zip(("dq", "dk", "dv"), got, ref_grads, plain,
                                  f64):
        err = (a - r).abs().max().item()
        worst[0] = max(worst[0], err)
        check(torch.isfinite(a).all().item()
              and torch.allclose(a, r, **BWD_TOL),
              f"{what} {name} vs flash_attention: max abs err {err}")
        e64 = (a.cpu().double() - r64).abs().max().item()
        p64 = (p.cpu().double() - r64).abs().max().item()
        check(e64 <= BWD_F64_RATIO * p64,
              f"{what} {name} {e64} from float64, more than "
              f"{BWD_F64_RATIO}x the plain version's {p64}")


def _lc_example(mx, torch, mesh, arrays, ref, want):
    """(a) examples/long_context.py's flow on the card: both strategies
    forward and backward through their `_sharded` entries, the counters
    zeroed just before and read just after (they must equal `want`, the
    nonzero ones); then held against `flash_attention` over the whole
    sequence. Returns the launches and the worst error."""
    K = mx.ops.kernels
    par = mx.parallel
    ref_out, ref_grads, plain, f64, w = ref
    qu, ku, vu, wu = _lc_leaves(torch, arrays, True)
    qr, kr, vr = _lc_leaves(torch, arrays[:3], False)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    uly = par.ulysses_attention_sharded(qu, ku, vu, mesh, causal=True)
    (uly * wu.detach()).sum().backward()
    ring = par.ring_attention_sharded(qr, kr, vr, mesh, causal=True)
    (ring * w).sum().backward()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches == dict(dict.fromkeys(K.LAUNCHES, 0), **want),
          f"long context launches {launches}, want {want}")
    uly = uly.detach().transpose(1, 2)
    ring = ring.detach()
    worst = [0.0]
    for what, out in (("ulysses", uly), ("ring", ring)):
        err = (out - ref_out).abs().max().item()
        worst[0] = max(worst[0], err)
        check(torch.isfinite(out).all().item()
              and torch.allclose(out, ref_out, **FLASH_TOL),
              f"{what} vs flash_attention: max abs err {err}")
    check(torch.allclose(uly, ring, **FLASH_TOL),
          f"ulysses vs ring: max abs err {(uly - ring).abs().max().item()}")
    _lc_grads_check(torch, "ulysses", [t.grad.transpose(1, 2)
                                       for t in (qu, ku, vu)],
                    (ref_grads, plain, f64), worst)
    _lc_grads_check(torch, "ring", [t.grad for t in (qr, kr, vr)],
                    (ref_grads, plain, f64), worst)
    log(f"long context {(LC_B, LC_S, LC_H, LC_D)} causal, sp="
        f"{mesh.shape['sp']} over NCCL, on {torch.cuda.current_device()}: "
        f"ulysses and ring within FLASH_TOL of flash_attention and of each "
        f"other, gradients within BWD_TOL and {BWD_F64_RATIO}x the plain "
        f"version's distance from float64; worst abs err {worst[0]:.3e}; "
        f"launches {launches}")
    return launches, worst[0]


def _lc_block_check(mx, torch, g):
    """(b) `flash_block_attention` against its plain version at the
    example's shape, causal and not, with random cotangents of out and a
    nonzero one of lse: out, lse and dQ, dK, dV within FLASH_TOL /
    BWD_TOL, and no further from float64 than FLASH_F64_RATIO /
    BWD_F64_RATIO times the plain version. Returns the worst error."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    shape = (LC_B, LC_H, LC_S, LC_D)
    scale = LC_D ** -0.5
    worst = 0.0
    for causal in (False, True):
        q, k, v, do = (torch.randn(shape, generator=g).to(dev)
                       for _ in range(4))
        g_lse = torch.randn(shape[:3], generator=g).to(dev)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        out, lse = K.flash_block_attention(qg, kg, vg, causal)
        got = [out.detach(), lse.detach(),
               *torch.autograd.grad((out, lse), (qg, kg, vg), (do, g_lse))]
        p_out, p_lse = K._flash_plain(q, k, v, causal, scale, None)
        delta = ((p_out * do).sum(-1) - g_lse).reshape(-1, LC_S)
        plain = [p_out, p_lse.reshape(shape[:3]),
                 *K._flash_bwd_plain(q, k, v, do, p_lse, delta, causal,
                                     scale, None)]
        f64 = _block_f64(torch, q, k, v, do, g_lse, causal, scale)
        errs, errs64, plain64 = {}, {}, {}
        for name, a, p, r64 in zip(("out", "lse", "dq", "dk", "dv"), got,
                                   plain, f64):
            fwd = name in ("out", "lse")
            errs[name] = (a - p).abs().max().item()
            check(torch.isfinite(a).all().item() and torch.allclose(
                a, p, **(FLASH_TOL if fwd else BWD_TOL)),
                f"flash_block {name} causal={causal} vs plain: max abs "
                f"err {errs[name]}")
            errs64[name] = (a.cpu().double() - r64).abs().max().item()
            plain64[name] = (p.cpu().double() - r64).abs().max().item()
            ratio = FLASH_F64_RATIO if fwd else BWD_F64_RATIO
            check(errs64[name] <= ratio * plain64[name],
                  f"flash_block {name} causal={causal}: {errs64[name]} "
                  f"from float64, more than {ratio}x the plain version's "
                  f"{plain64[name]}")
        worst = max(worst, *errs.values())
        log(f"flash_block {shape} causal={causal}, nonzero g_lse: max abs "
            f"err vs plain {errs} (FLASH_TOL / BWD_TOL); vs float64 "
            f"{errs64} (plain {plain64})")
    return worst


def _lc_ring_on_one_card(mx, torch, arrays, ref):
    """(c) A ring of LC_RING ranks on one card: for each query shard r,
    the key blocks rank r of the ring would meet, in its order (src = r,
    r - 1, ..., skipping the later shards), through the ring's own
    `_ring_step`. Real lse cotangents reach the backward kernels here
    (a ring of one gives them zero). The counters are zeroed just before
    and read just after; the output and gradients are held against
    `flash_attention` over the whole sequence."""
    from mxnet_tpu_torch.parallel.ring_attention import _ring_step
    K = mx.ops.kernels
    ref_out, ref_grads, plain, f64, w = ref
    q, k, v = _lc_leaves(torch, arrays[:3], False)
    n, sh = LC_RING, LC_S // LC_RING
    torch.cuda.synchronize()
    K.reset_launch_counts()
    blocks = [(k[:, :, j * sh:(j + 1) * sh].contiguous(),
               v[:, :, j * sh:(j + 1) * sh].contiguous()) for j in range(n)]
    outs = []
    for r in range(n):
        qr = q[:, :, r * sh:(r + 1) * sh].contiguous()
        o = torch.zeros(qr.shape, dtype=torch.float32, device=qr.device)
        lse = torch.full(qr.shape[:3], -1e30, dtype=torch.float32,
                         device=qr.device)
        for i in range(n):
            src = (r - i) % n
            o, lse = _ring_step(qr, *blocks[src], o, lse, src, r, True,
                                LC_D ** -0.5)
        outs.append(o)
    out = torch.cat(outs, 2)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    pairs = n * (n + 1) // 2          # blocks at or before the diagonal
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update(flash_block=pairs, flash_fwd=pairs, flash_bwd=pairs,
                flash_bwd_dq=pairs)
    check(launches == want, f"one-card ring launches {launches} != {want}")
    err = (out.detach() - ref_out).abs().max().item()
    check(torch.allclose(out.detach(), ref_out, **FLASH_TOL),
          f"one-card ring vs flash_attention: max abs err {err}")
    worst = [err]
    _lc_grads_check(torch, "one-card ring", [t.grad for t in (q, k, v)],
                    (ref_grads, plain, f64), worst)
    log(f"one-card ring of {n} (shards of {sh}): output and gradients "
        f"within FLASH_TOL / BWD_TOL of flash_attention, gradients within "
        f"{BWD_F64_RATIO}x the plain version's distance from float64; "
        f"worst abs err {worst[0]:.3e}; launches {launches}")
    return worst[0]


def _lc_times(mx, torch, g):
    """(d) `flash_block_attention` forward and forward + backward at the
    example's shape (causal), by CUDA-graph replay, beside the plain
    versions and SDPA's forward and forward + backward."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    shape = (LC_B, LC_H, LC_S, LC_D)
    scale = LC_D ** -0.5
    q, k, v, do = (torch.randn(shape, generator=g).to(dev)
                   for _ in range(4))
    g_lse = torch.randn(shape[:3], generator=g).to(dev)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def block_fwd_bwd():
        torch.autograd.grad(K.flash_block_attention(qg, kg, vg, True),
                            (qg, kg, vg), (do, g_lse))

    def plain_fwd_bwd():
        out, lse = K._flash_plain(q, k, v, True, scale, None)
        delta = ((out * do).sum(-1) - g_lse).reshape(-1, LC_S)
        K._flash_bwd_plain(q, k, v, do, lse, delta, True, scale, None)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg),
                            do)

    fns = {"fwd": lambda: K.flash_block_attention(q, k, v, True),
           "fwd_bwd": block_fwd_bwd,
           "plain_fwd": lambda: K._flash_plain(q, k, v, True, scale, None),
           "plain_fwd_bwd": plain_fwd_bwd,
           "sdpa_fwd": lambda: sdpa(q, k, v, is_causal=True),
           "sdpa_fwd_bwd": sdpa_fwd_bwd}
    dev_ms = {name: graph_ms(fn, calls=5, iters=10)
              for name, fn in fns.items()}
    pairs = LC_B * LC_H * LC_S * (LC_S + 1) // 2   # causal (q, k) pairs
    rows_q = 4 * LC_B * LC_H * LC_S * LC_D         # bytes of (B, H, S, D)
    stats = 4 * LC_B * LC_H * LC_S                 # bytes of lse
    # forward: q, k, v read, out and lse written; QK^T and PV
    fwd_b = bound(4 * rows_q + stats, 4 * pairs * LC_D, PEAK_TF32X3_FLOPS)
    # forward + backward: q, k, v, dO and g_lse read, out, lse, dQ, dK
    # and dV written; the backward adds S, dP, dV, dQ and dK
    all_b = bound(8 * rows_q + 2 * stats, 14 * pairs * LC_D,
                  PEAK_TF32X3_FLOPS)
    tflops = {name: f * pairs * LC_D / (dev_ms[name] * 1e-3) / 1e12
              for name, f in (("fwd", 4), ("fwd_bwd", 14))}
    log(f"flash_block timed {shape} causal: device (CUDA graph) {dev_ms}; "
        f"bounds fwd {fwd_b}, fwd+bwd {all_b}; fwd / SDPA fwd "
        f"{dev_ms['fwd'] / dev_ms['sdpa_fwd']:.3f}; fwd+bwd / SDPA fwd+bwd "
        f"{dev_ms['fwd_bwd'] / dev_ms['sdpa_fwd_bwd']:.3f}; achieved "
        f"TFLOP/s {tflops}")
    return dict(ms=dev_ms["fwd_bwd"], plain_ms=dev_ms["plain_fwd_bwd"],
                bound_ms=all_b[0], bound_by=all_b[1],
                library_ms=dev_ms["sdpa_fwd_bwd"],
                per_shape=[dict(shape=list(shape), causal=True,
                                what="forward", ms=dev_ms["fwd"],
                                plain_ms=dev_ms["plain_fwd"],
                                bound_ms=fwd_b[0], bound_by=fwd_b[1],
                                library_ms=dev_ms["sdpa_fwd"])])


def flash_f64_sweep(mx, torch):
    """{"S<n>_causal" / "S<n>_full": {name: the kernels' largest distance
    from float64 over the plain version's}} for the forward's out and lse
    and the backward's dQ, dK and dV (`flash_attention_fwd` /
    `flash_attention_bwd`, each from its own forward's lse), at B=1,
    H=8, D=64 and S in F64_SWEEP_S, inputs from a seeded generator. It takes
    `mx` as given, so another checkout's package can be measured the
    same way."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)
    b, h, d = 1, 8, 64
    scale = d ** -0.5
    ratios = {}
    for s in F64_SWEEP_S:
        for causal in (True, False):
            q, k, v, do = (torch.randn((b, h, s, d), generator=g).to(dev)
                           for _ in range(4))
            out, lse = K.flash_attention_fwd(q, k, v, causal, scale)
            p_out, p_lse = K._flash_plain(q, k, v, causal, scale, None)
            got = K.flash_attention_bwd(
                q, k, v, do, lse, (out * do).sum(-1).reshape(b * h, s),
                causal, scale)
            plain = K._flash_bwd_plain(
                q, k, v, do, p_lse, (p_out * do).sum(-1).reshape(b * h, s),
                causal, scale, None)
            o64, l64, _ = _attention_f64(torch, q, k, v, causal, scale,
                                         None)
            g64 = _attention_grads_f64(torch, q, k, v, do, causal, scale,
                                       None)
            r = {}
            for name, a, p, ref in (("out", out, p_out, o64),
                                    ("lse", lse, p_lse, l64),
                                    *zip(("dq", "dk", "dv"), got, plain,
                                         g64)):
                r[name] = ((a.cpu().double() - ref).abs().max().item()
                           / (p.cpu().double() - ref).abs().max().item())
            ratios[f"S{s}_{'causal' if causal else 'full'}"] = r
    return ratios


def phase_long_context(mx, torch):
    """Long-context sequence parallelism at examples/long_context.py's
    full size (B=1, S=2048, H=8, D=64, causal, fp32, inputs from numpy
    seed 0) on a one-rank NCCL group: (a) the example's flow through the
    `_sharded` entries, (b) `flash_block_attention` against its plain
    version, (c) a four-rank ring on one card, (d) times; then (e) the
    flash kernels against float64 at S = 512-4096 (`flash_f64_sweep`).
    Returns the kernels row of `flash_block_attention` and the launches
    of (a)."""
    rs = np.random.RandomState(0)
    arrays = [rs.standard_normal((LC_B, LC_S, LC_H, LC_D)).astype(np.float32)
              for _ in range(4)]
    g = torch.Generator(device="cpu").manual_seed(8)
    mx.kvstore.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}")
        mesh = mx.parallel.make_mesh({"sp": 1})
        check(mesh.device_type == "cuda" and mesh.shape == {"sp": 1},
              f"mesh {mesh}")
        ref = _lc_reference(mx, torch, arrays)
        launches, _ = _lc_example(mx, torch, mesh, arrays, ref, dict(
            flash_block=2, flash_fwd=2, flash_bwd=2, flash_bwd_dq=2))
        worst = _lc_block_check(mx, torch, g)
        worst = max(worst, _lc_ring_on_one_card(mx, torch, arrays, ref))
        row = _lc_times(mx, torch, g)
    finally:
        mx.kvstore.reset_distributed()
    # (e) the kernels' distance from float64 along long walks
    ratios = flash_f64_sweep(mx, torch)
    for case, r in ratios.items():
        for name, x in r.items():
            limit = FLASH_F64_RATIO if name in ("out", "lse") \
                else BWD_F64_RATIO
            check(x <= limit, f"flash {name} at {case}: {x:.2f}x the plain "
                  f"version's distance from float64, more than {limit}")
    log(f"flash kernels vs float64 along long walks, (B, H, D) = (1, 8, "
        f"64): distance over the plain version's "
        f"{ {c: {n: round(x, 2) for n, x in r.items()} for c, r in ratios.items()} }")
    torch.cuda.empty_cache()
    return dict(name="flash_block_attention", counter="flash_block",
                route="cuda", source="mxnet_tpu_torch/ops/kernels.py",
                replaces="mxnet_tpu/ops/pallas_kernels.py:741",
                max_abs_err=worst, **row), launches


def _sp_rank(rank, world, port, out_dir):
    """One NCCL rank of `--ranks N`: phase 13 (a) over an 'sp' axis of
    `world` cards, against the whole-sequence references on this rank's
    card; writes its launches and worst error to out_dir."""
    sys.path.insert(0, HERE)
    import torch
    import mxnet_tpu_torch as mx
    K = mx.ops.kernels
    rs = np.random.RandomState(0)
    arrays = [rs.standard_normal((LC_B, LC_S, LC_H, LC_D)).astype(np.float32)
              for _ in range(4)]
    mx.kvstore.init_distributed(f"127.0.0.1:{port}", world, rank)
    try:
        dev = torch.cuda.current_device()
        check(dev == rank and torch.distributed.get_backend() == "nccl",
              f"rank {rank} on cuda:{dev}, "
              f"{torch.distributed.get_backend()}")
        mesh = mx.parallel.make_mesh({"sp": world})
        ref = _lc_reference(mx, torch, arrays)
        # Ulysses: one block over every key; the ring: the blocks at or
        # before this rank's shard, each of S / world keys
        blocks = 1 + (rank + 1)
        split = K.flash_bwd_plan(LC_S // world, LC_D)["path"] == "split"
        want = dict(flash_block=blocks, flash_fwd=blocks, flash_bwd=blocks,
                    flash_bwd_dq=1 + (rank + 1) * split)
        launches, worst = _lc_example(mx, torch, mesh, arrays, ref, want)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "device": f"cuda:{dev}",
                       "launches": {n: c for n, c in launches.items() if c},
                       "max_abs_err": worst}, f)
    finally:
        mx.kvstore.reset_distributed()


def sp_ranks_main(mx, torch, world):
    """`--ranks N`: the long-context example over N NCCL ranks, one card
    each (one process a rank, spawned and joined here)."""
    import torch.multiprocessing as mp
    check(torch.cuda.device_count() >= world,
          f"--ranks {world} needs {world} cards, have "
          f"{torch.cuda.device_count()}")
    t_start = time.perf_counter()
    phase_build(mx, torch)          # the ranks load this build
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_sp_rank, args=(world, _free_port(), out_dir),
                           nprocs=world, start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r in ranks:
        log(f"sp rank {r['rank']} on {r['device']}: ulysses and ring within "
            f"FLASH_TOL / BWD_TOL of flash_attention and {BWD_F64_RATIO}x "
            f"the plain version's distance from float64, worst abs err "
            f"{r['max_abs_err']:.3e}; launches {r['launches']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"sp_ranks": ranks}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=()):
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
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    if argv:
        check(len(argv) == 2 and argv[0] == "--ranks" and argv[1].isdigit()
              and int(argv[1]) > 1, f"usage: chip_smoke.py [--ranks N>1], "
              f"got {list(argv)}")
        return sp_ranks_main(mx, torch, int(argv[1]))
    t_start = time.perf_counter()
    phase_build(mx, torch)
    bwd_rows, long_launches = phase_flash_bwd(mx, torch)
    kernels = [phase_flash(mx, torch), phase_rpa(mx, torch),
               *phase_rpa_fastpath(mx, torch), *bwd_rows,
               phase_ln(mx, torch), *phase_conv1x1(mx, torch)]
    rtc_row, rtc_launches = phase_rtc(mx, torch)
    kernels.append(rtc_row)
    model, srv, reqs, handles, serve_launches = phase_serve(mx, torch)
    phase_profile(mx, torch, srv, reqs)
    phase_card_vs_cpu(mx, torch, model, srv, reqs, handles)
    srv.close()
    fast_launches = phase_fastpath(mx, torch, model)
    del model, srv
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "transformer_base_init.params")
        train_launches = phase_train(mx, torch, init_file)
        phase_train_card_vs_cpu(mx, torch, init_file)
        torch.cuda.empty_cache()
        resnet_init = os.path.join(tmp, "resnet50_v1_init.params")
        net, images, resnet_launches = phase_resnet_train(mx, torch,
                                                          resnet_init)
        conv_launches = phase_resnet_conv1x1(mx, torch, net, images)
        del net, images
        torch.cuda.empty_cache()
        phase_resnet_card_vs_cpu(mx, torch, resnet_init)
        phase_bert_attention(mx, torch, {k["name"]: k for k in kernels})
        bert_init = os.path.join(tmp, "bert_base_init.params")
        bert_launches = phase_bert_train(mx, torch, bert_init)
        phase_bert_card_vs_cpu(mx, torch, bert_init)
    block_row, lc_launches = phase_long_context(mx, torch)
    kernels.append(block_row)
    for k in kernels:
        # a row's launches are its wrapper's counter (`flash_block_attention`
        # counts under `flash_block`)
        c = k.get("counter", k["name"])
        by_path = {"serve": serve_launches[c], "fastpath": fast_launches[c],
                   "train": train_launches[c], "rtc": rtc_launches[c],
                   "long_attention": long_launches[c],
                   "resnet_train": resnet_launches[c],
                   "resnet_conv1x1": conv_launches[c],
                   "bert_train": bert_launches[c],
                   "long_context": lc_launches[c]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        check(k["launches"] > 0, f"{k['name']} never launched on a path")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "call_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys + ("per_shape",)
                                   if key in k} for k in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
