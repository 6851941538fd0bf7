#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`mxnet_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --ranks N   # sequence, data and composite
                                      # parallelism on N cards

Phases (any failure raises and the script exits non-zero):

  1. build     — `nvcc` builds the port's kernels from `mxnet_tpu_torch/
                 ops/csrc/` for sm_90a (one nvcc per source, in parallel);
                 TF32 is switched off for matmuls and cuDNN.
  1b. engine   — the dependency engine: g++ builds the port's own
                 `mxnet_tpu_torch/csrc/engine.cc` and the facade runs on
                 it (it fails if the engine fell back to `_PyEngine`);
                 writes in push order with readers between them, a
                 failed writer poisoning its var's later tasks only, a
                 TaskGroup's queued members CANCELLED, a deadline
                 EXPIRED.
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
                 paged attention, fp32 and int8 1-wide, fp32 and int8
                 widened (RPA_CASES: the serving shape, 8 slots, H = 8,
                 dh = 64, psize 16, W = 4 for the widened forms, and
                 W = 9 too; its edges, length-0 slots and rows past the
                 page budget; a long table; two calls bit-identical; all
                 four also timed at the long case, the widened at W = 9,
                 each beside the graph-replay time of an empty kernel of
                 its serving grid, the launch floor; each held against
                 its plain version in float64; the widened int8 form
                 within RPA_TOL of float64 and of the fp32 plain version
                 on a fixed witness draw),
                 the flash backward (training shapes on
                 its fused path, edge shapes, and Sk above one block on
                 its split
                 path, causal with Sq != Sk on each; also against
                 float64 autograd and a repeated launch, bit for bit)
                 and LayerNorm (every width its
                 paths give it: 512, BERT's 768, 1024, 200, and 1032,
                 4096, 8192 on its one-block-a-row form; timed at each
                 under `per_shape`, every LayerNorm time with x read
                 from HBM: `graph_ms` rotating over copies of x). The
                 long-sequence path drives
                 `flash_attention` forward and backward at B=4, H=8,
                 S=1024, D=64, causal and not (counters zeroed just
                 before, read just after: 2 launches of the forward, the
                 fused and the dQ kernel each), and times the split path
                 against SDPA's backward.
                 The bfloat16 forms of the three flash kernels and
                 LayerNorm (their own counters, `*_bf16`): every case of
                 `_bf16_cases` (serving, the training step's three
                 attentions, BERT's shape, padded widths 32-128 and D no
                 multiple of 8, causal with Sq != Sk both ways,
                 zero-length rows, Sk above one backward block) and a
                 misaligned q, the forward at every plan it takes,
                 against the bf16 plain versions (BF16_RTOL,
                 BF16_OUT_ATOL, BF16_GRAD_ATOL) and float64 (at most
                 BF16_F64_RATIO x the plain version's distance), two
                 launches bit-identical; LayerNorm with fp32 and bf16
                 gamma / beta at every width above (LN_BF16_TOL);
                 timed at the serving and training shapes and LN_TIMED
                 beside SDPA and `F.layer_norm` in bf16. The fp32
                 LayerNorm with bf16 gamma / beta (a cast TransformerNMT's
                 fp32 activations) at LN_BF16_GAMMA (each launch form)
                 against its plain version (LN_TOL) and bit for bit
                 against the same gammas in fp32; timed at the cast
                 NMT's shape beside `F.layer_norm`.
  2w. flash wide — heads wider than 128, any width (`flash_wide.cu`):
                 the wgmma forms' SASS holds HGMMA (cuobjdump -sass of
                 the built library) and flash_wide.cu's build log no
                 ptxas C7515 / C7520 serialisation warning; the
                 forward, dK/dV and dQ kernels in fp32, bf16 and fp16 at
                 D = 192, 198, 200, 256, 512, 1024 and 2048, B = 2, H =
                 8, S = 1024, causal and with key lengths, and with a
                 misaligned q at D = 256 (198 and the misaligned q: the
                 element copies where no row is a whole number of 16-byte
                 pieces or a base is not 16-byte aligned), and at the
                 bert_wide_bf16 path's attention (B = 16, H = 3, S =
                 512, D = 256, BERT's key lengths), against their
                 plain versions (the per-dtype limits) and float64
                 (WIDE_F64_RATIO), two launches bit-identical; each
                 timed at each D but 2048 beside SDPA in its dtype (and
                 the backend SDPA picks) and its bound, the dK/dV + dQ
                 pair beside SDPA's backward, and the misaligned q at D =
                 256 in bf16 (`per_shape` "D256_misaligned_q"); then
                 `flash_attention` forward and backward at D = 256 in
                 each dtype with the counters zeroed just before and
                 read just after (path `wide_attention`).
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
  4s. serve engine — phase 3's model and 16 requests through a default
                 `serve.Server(model, slots=8, page_size=16,
                 max_src_len=128, max_new_tokens=32)`: engine-driven,
                 its decode loop a PRIORITY_HIGH engine task on the
                 native engine's threads. The counters zeroed just
                 before and read just after: one flash launch a prefill
                 layer and one paged launch a decode turn layer, the
                 prefills on engine threads; phase 3's inline tokens
                 exactly, alone and under a background flood of host
                 tasks (the JAX bench's: FLOOD_PER_WORKER sleeping
                 PRIORITY_BACKGROUND tasks a worker, topped up); TTFT p50
                 / p99 and tokens/s of both beside the inline server's.
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
  4m. mnist    — MLP-on-MNIST (BASELINE.json's first configuration) as
                 examples/train_mnist.py runs it at bench_mlp.py's width
                 (784-512-256-10, batch 512, SGD lr 0.1 momentum 0.9):
                 2 epochs of synthetic MNIST(train=True) through
                 DataLoader(shuffle=True) (batchified on the engine),
                 eager and through `trainer.capture`, from the same
                 weights; each's test accuracy within MNIST_ACC_TOL of
                 the JAX package's on the CPU, samples/s an epoch, one
                 profiled step's busy share, and the first 5 losses
                 against the port on the CPU (MNIST_LOSS_RTOL).
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
  5b. nmt train, bf16 — bench_nmt.py's step: phase 5's weights,
                 `model.cast("bfloat16")`, SGD lr 1e-3 momentum 0.9, B=64
                 of 64 + 64 tokens at full length, 10 steps. The
                 activations stay fp32 as in the JAX package, so every
                 step must launch the fp32 forms (18 flash forwards, 18
                 fused backwards, 30 LayerNorms with bf16 gamma) and no
                 bf16 form; the logits fp32, the loss finite and
                 falling. Tokens/s and its spread, peak memory, one
                 profiled step, then 5 steps timed with TF32 matmuls on
                 (restored after).
  6b. nmt card vs CPU, bf16 — phase 6 on the cast model cut to 2
                 layers: the loss within phase 6's limit, each bf16
                 gradient within a bf16 ulp in norm (NMT_BF16_*).
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
 9c. stem s2d — `ops.nn_ops.stem_conv_s2d` against the plain 7x7 /
                 stride-2 / pad-3 convolution at (128, 224, 224, 3), fp32
                 and bf16: y and the weight gradient against float64
                 (STEM_F32_*, BF16_F64_*); both timed.
  7b. resnet train, bf16 — bench.py's model: `resnet50_v1(layout=
                 "NHWC", stem_s2d=True)` on phase 7's weights, cast to
                 bf16, SGD lr 0.1 momentum 0.9 (no weight decay) on the
                 mean loss of fp32 logits, 10 steps at B=128 on phase 7's
                 images in bf16: every parameter bf16 on the card, every
                 running statistic moving, no port kernel. Images/s and
                 its spread, peak memory, one profiled step (busy share,
                 the convolutions' share).
  8b. resnet conv1x1, bf16 — phase 8 on that bf16 net's live stride-1 1x1
                 convolutions, through the bf16 kernel only (30
                 launches).
  7p. resnet from a JPEG pack, bf16 (path `resnet_pack_bf16`) — 7b's
                 model, weights and SGD fed from a JPEG RecordIO pack in
                 the shape of an `im2rec --resize 256 --quality 95`
                 ImageNet pack (PACK_RECORDS records written through
                 `recordio.MXIndexedRecordIO` + `recordio.pack_img`,
                 short side 256, long side 256-384, labels 0-999, numpy
                 seed 0; record 0 decodes within PACK_PSNR_DB of its
                 source) through `image.ImageIter(shuffle=True,
                 aug_list=image.CreateAugmenter(resize=256,
                 rand_crop=True, rand_mirror=True, mean=True, std=True))`
                 and `io.PrefetchingIter(prefetch_to_device=mx.gpu(0))`,
                 each batch's NCHW float32 transposed to NHWC and cast to
                 bf16 on the card. Counters zeroed just before and read
                 just after RESNET_STEPS steps: no port kernel; every
                 parameter bf16 on the card, the loss finite, every
                 running statistic moving. `io.ImageRecordIter` over the
                 same pack on the card gives its ctx=mx.cpu() batches bit
                 for bit (PACK_RECORD_ITER_BATCHES); an image folder of
                 JPEG and PNG files through `ImageFolderDataset` and a
                 card DataLoader gives its sources (PNG bit for bit, JPEG
                 within PACK_PSNR_DB). Then phase 8b on the pack-fed net
                 with its first batch: 30 bf16 conv1x1 launches, each
                 held against its plain version. Logged, with no gate:
                 images/s from the pack beside 7b's in memory, with
                 spread; host decode ms a record and augment ms a batch;
                 `prefetch_starved`; the synchronizing calls of the input
                 path and of the step over PACK_SYNC_STEPS steps; pack
                 write s (the first record, with the codec's g++ build,
                 apart), mean record bytes, peak memory, phase s.
  9b. resnet card vs CPU, bf16 — that model cut to one bottleneck a
                 stage, phase 7's weights, one bf16 SGD step at B=4 on the
                 card and the CPU, each against the fp32 step on the CPU:
                 the card no further from it than BF16_F64_RATIO x the
                 CPU's distance (in norm, each parameter) + BF16_F64_FLOOR.
 10. bert attention — the flash kernels at BERT-base's attention shape
                 (B=16, H=12, S=512, D=64) with key lengths mid-block
                 (300), on a block edge (384), full (512), very short (3)
                 and from numpy seed 0 in [256, 512]: the forward against
                 its plain version, the backward on its split path (the
                 fused kernel for dK / dV, then the dQ kernel) against
                 its plain version and float64 autograd, dK / dV exactly
                 0 past each length; the forward, the kernel pair, each
                 kernel and SDPA timed there (the rows' `per_shape`).
 10b. bert attention, bf16 — the same shape in bf16: the bf16 kernels
                 against their plain versions and float64, then timed
                 beside SDPA in bf16 (the dQ kernel's row, `per_shape`
                 of the others).
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
 11b. bert train, bf16 — phase 11 as bench_bert.py builds it: the same
                 weights, `model.cast("bfloat16")`, SGD lr 1e-3 momentum
                 0.9 through `gluon.Trainer` (bf16 weights and momentum),
                 the losses on logits cast to fp32, the batch-mean
                 loss's gradient as it is; every step must launch 12
                 bf16 flash forwards, 12 bf16 fused and 12 bf16 dQ
                 kernels, 26 bf16 LayerNorms and no fp32 form; the loss
                 finite and falling. Tokens/s and its spread, peak
                 memory and one profiled step (busy, GEMM and port
                 kernels' shares) beside phase 11's, with the state of
                 cuBLAS's reduced-precision bf16 reductions.
 11r. bert pretrain resume, bf16 — 11b's model and SGD fed from a
                 RecordIO pack (RESUME_BATCHES batches of bench_bert.py's
                 shape from numpy seed 1, written with
                 `recordio.MXIndexedRecordIO` + `recordio.pack`, one
                 sample a record as little-endian int32): the pack
                 served by `NativeRecordFile`, three batches read back
                 through `DataLoader(prefetch_to_device=True,
                 pin_memory=True)` equal to the written ones on the card.
                 Counters zeroed just before and read just after:
                 RESUME_STEPS eager steps from the prefetcher, each
                 launching 12 / 12 / 12 / 26 bf16 flash forwards, dK/dV,
                 dQ and LayerNorms and nothing else, with
                 `CheckpointManager(max_to_keep=2).save(_async=True)`
                 of the weights, the Trainer's `states_bytes()` and the
                 data cursor every RESUME_SAVE_EVERY steps to RESUME_AT;
                 then a fresh model and Trainer restored
                 (`restore_latest`, `load_states_bytes`, the loader at
                 the cursor) run RESUME_AT..RESUME_STEPS: weights and
                 momentum bit for bit the uninterrupted run's. The same
                 through `Trainer.capture`, restored into the live
                 captured step (one miss, `state_change`, and a new
                 capture). Torch's deterministic algorithms are on in
                 this phase (the MLM gather's and the embeddings'
                 backward sums otherwise vary in order). A corrupted
                 newest step falls back to the one before
                 (`checkpoint_fallbacks` + 1); an emergency save through
                 `fault.preemption` (the `preempt.sigterm` point)
                 publishes a valid step. Logged, with no gate: tokens/s
                 fed from the pack beside in-memory batches, the
                 synchronizing calls of the input path and of the step
                 over RESUME_SYNC_STEPS steps (torch's sync debug mode),
                 `prefetch_starved`, the time an async save holds the
                 loop and its wall time, bytes and MB/s, the restore's
                 time, peak memory, the card's name and power limit.
 11w. bert wide, bf16 — the `bert_wide_bf16` path: 11b's model, cast and
                 SGD, but BERTModel at bert_base's shape with three
                 heads of 256 (the wide kernels), 10 steps through Gluon
                 on phase 11's batch: every step 12 wide bf16 forwards,
                 dK/dV and dQ kernels and 26 bf16 LayerNorms; tokens/s
                 beside 11b's from the same call, one profiled step.
 12. bert card vs CPU — phase 11's initial weights, cut to 2 layers at
                 full width, one step at B=2, S=512, lengths (300, 512)
                 on the card and on the CPU: the loss and every gradient
                 within phase 6's limits.
 12b. bert card vs CPU, bf16 — phase 12's weights cast to bf16, one Adam
                 step with multi_precision=True on the card and on the
                 CPU, each held against the fp32 step on the CPU: the
                 card's loss and gradients no further from it than
                 BF16_F64_RATIO x the CPU bf16 step's distance (plus one
                 bf16 ulp); every fp32 master Adam's first update of its
                 own gradient and every weight its master rounded.
 12w. wide bert card vs CPU, bf16 — 12b on the same weights as three
                 heads of 256, at B=2, S=128, lengths (77, 128): the wide
                 bf16 kernels on the card, held as 12b holds its step.
 12c. train fused — 11b's bf16 BERT-base: one backward, then the fused
                 Trainer's and the per-parameter Trainer's first step on
                 those gradients from the same weights (momentum bit for
                 bit, each weight within a bf16 ulp of itself and one of
                 its step, one `fused_update` dispatch a bucket), then
                 one whole step of each under torch.profiler (device
                 kernels, host launch calls).
 11c. bert train, bf16, captured — 11b through `trainer.capture`, 10
                 steps beside five eager fused runs of 10 from the same
                 weights (`_captured_vs_eager`): the losses and each
                 parameter no further from the first eager run than
                 CAPTURE_RATIO x the largest distance between eager runs
                 plus an ulp (where the eager runs agree to the bit, at
                 least CAPTURE_STEPS ulps of its largest element, and a
                 copy of the captured weights with those parameters
                 moved by twice that limit fails the same check), no
                 fallback, the warm steps' launches equal to the eager
                 steps', one graph launch and no kernel launch from the
                 host in a profiled warm step; tokens/s, peak memory and
                 the busy share of both forms.
  5c. nmt train, captured — phases 5 (fp32, Adam: t on the device) and 5b
                 (cast, SGD) the same way.
  9d. resnet BN, captured — the cut bf16 S2D ResNet (9b's) at B = 16, 3
                 steps captured and eager: the running statistics moved and
                 carried.
 11d. bert data parallel, bf16 — 11b's model, batch and SGD through the
                 store on a one-rank NCCL group (`kvstore.
                 init_distributed`): (a) `Trainer(kvstore="dist_sync")`,
                 one `allreduce_flat` a bucket a step, against the
                 store-less Trainer from the same weights under torch's
                 deterministic algorithms: the weights bit for bit, every
                 step 12 / 12 / 12 / 26 bf16 flash forwards, dK/dV, dQ
                 and LayerNorms (path `bert_dp_bf16`), the kv counters one
                 collective a bucket a step; tokens/s and its spread
                 beside 11b's and the store-less run's; (b) `trainer.
                 capture` over that store with a `dp` mesh of one, the
                 gradients reduced inside the graph (NCCL's one-rank
                 forms; `kv_collective_bytes{op=in_graph_psum}` their
                 bytes a replay), held as 11c is (path
                 `bert_dp_bf16_captured`); (c) the
                 gradients of two half batches pushed as two towers to
                 `kv.create("device")`: each pull their `torch.add` bit
                 for bit, and no further from the whole batch's gradient
                 in fp32 than DP_TOWER_RATIO x the whole bf16 one's
                 distance plus a bf16 ulp;
                 (d) the store's in-graph all-reduce, reduce-scatter and
                 all-gather captured in a CUDA graph and replayed: right,
                 and their device work in DP_PROFILE_REPLAYS replays
                 under the profiler (on one rank NCCL's copies, also in
                 the graph's node list; its kernels under `--ranks N`);
                 an empty profile fails.
 12d. capture guard — a captured 2-layer bf16 BERT with skip_nonfinite and
                 `grad.nan` at step 2 (every weight and state bit for bit
                 through that replay, the streak 0, 1, 0), and float16
                 AMP on a Dense stack, captured and eager (the same loss
                 scale after every step).
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
                 BWD_F64_RATIO of the plain version's distance. Then in
                 bf16: (a) on bf16 inputs (2 launches each of
                 `flash_block_bf16` and the bf16 forward, fused and dQ
                 kernels), held against `flash_attention` in bf16; (b)
                 in bf16 and fp16 against the plain versions of the
                 kernels it runs (the LOWP limits) and float64
                 (BF16_F64_RATIO); (d) timed beside SDPA in bf16 and
                 fp16.

 14. composite — the 5-axis train step (`parallel.composite`) at
                 COMPOSITE_BASE (BERT-base's widths, 12 layers, S = 512,
                 B = 8 in 2 microbatches, an 8-expert Switch-style MoE
                 in every block at capacity 1.25; 585 M parameters,
                 fp32) on a one-rank NCCL group, every axis of size 1,
                 under deterministic algorithms: (a) 10 SGD steps from
                 seed-0 weights (counters zeroed just before, read just
                 after: COMPOSITE_WANT a step), tokens/s over steps 3-10,
                 step ms, peak memory and each MoE layer's dropped
                 share; (b) the first step against one float64 step
                 through the kernels' plain formulas (COMPOSITE_F64_RATIO
                 x the fp32 plain step's distance), with a control that
                 must fail; (c) 2 layers, B = 2, card against CPU
                 (COMPOSITE_CPU_RTOL); (d) `remat=True` and
                 `sp_strategy="alltoall"` against (a)'s first step; (e)
                 `column_parallel_dense` / `row_parallel_dense`,
                 `pipeline_apply` and `moe_ffn` on one-rank meshes.

`--capture` runs the build and the fused-Trainer and captured-step
phases alone, 11d among them (on fresh weights), with no kernels line and no `ok` line.
`--ranks N` (N > 1 cards) runs phase 13 (a) over N NCCL ranks instead,
one process a card: each rank's Ulysses and ring output and gradients
against `flash_attention` over the whole sequence on its card
(FLASH_TOL, BWD_TOL, float64), its launches checked (Ulysses one block,
the ring the blocks at or before its shard); then phase 11d over N NCCL
ranks (B = BERT_B a rank): the eager store path, the captured step over
a `dp` store and `sharded_update=True`, each form's weights bit for bit
the same on every rank and within DP_RANKS_RATIO of the one-rank run on
the global batch (the embedding tables also within twice that run's
distance from an fp32 copy; every form's losses within
DP_RANKS_LOSS_RTOL of its), the sharded optimizer state 1/N of each momentum whose dim 0
splits over N, and (d) on the N ranks (NCCL's kernels in the replay);
then phase 14 over N = 4 ranks at COMPOSITE_RANKS_LAYERS layers of full
width, each of COMPOSITE_RANKS_CASES (pp x tp, tp x ep, sp x ep with
the ring and with all-to-all, dp x pp with 3 microbatches) against the
one-rank step of its configuration on card 0, within (b)'s limits, every
block that several ranks hold the same bits on each; then a
`{"sp_ranks": [...], "dp_ranks": [...], "composite_ranks": {...}}`
line in place of the kernels line.

Output: progress lines, then `nvidia-smi`'s name and power limit, then
one JSON line `{"kernels": [...]}`, then the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or without the `mxnet_tpu_torch` package beside
this file, it exits non-zero and prints no result.
"""
import contextlib
import json
import os
import shutil
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
# the paged kernels' cases, (pool pages, page tables, lengths) at H = 8,
# dh = 64, psize 16: the serving shape (max_new_tokens 32 / psize 16 = 2
# pages a slot, pool 17 pages; slot 0 is length 1 on the null page 0),
# its edges (length-0 slots, rows past the page budget) and a long table
# (10 pages a slot, lengths up to 160)
_SERVE_TABLES = [[0, 0]] + [[1 + 2 * i, 2 + 2 * i] for i in range(7)]
RPA_CASES = {
    "serving": (17, _SERVE_TABLES, SERVE_LENS),
    "edge": (17, _SERVE_TABLES, [0, 31, 32, 17, 30, 29, 0, 2]),
    "long": (81, [[(7 * s + j) % 80 + 1 for j in range(10)]
                  for s in range(8)], [160, 1, 0, 33, 100, 64, 15, 159]),
}
# cases only timed (`rpa_times`), where the 1-wide kernels' time comes
# from: every slot of length 1 or 32, and four times the slots
RPA_SWEEP = {
    "all1": (17, _SERVE_TABLES, [1] * 8),
    "all32": (17, _SERVE_TABLES, [32] * 8),
    "slots32": (65, [[0, 0]] + [[1 + 2 * i, 2 + 2 * i] for i in range(31)],
                SERVE_LENS * 4),
}
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

# The bfloat16 kernels against their bf16 plain versions: both round at
# the JAX kernels' points, with fp32 sums in other orders. An output's one
# rounding to bf16 may then land one bf16 ulp apart, at most 2^-7 of its
# value (BF16_RTOL). The forward also rounds P to bf16 (2^-9 relative)
# after exp(s - a running max) in the kernel but exp(s - the row's max)
# in the plain version, which moves out by at most 2 * 2^-9 * sum(p
# |v|) / l <= 2^-8 max|V| (BF16_OUT_ATOL, times each (b, h) slice's
# max|V|); the backward's p = exp(s - lse) is the same in both, so its
# roundings differ only where fp32 order moves a value across a bf16
# rounding boundary: one ulp of an element of P or dS, at most 2^-7 of
# the slice's largest gradient (BF16_GRAD_ATOL, times that value)
BF16_RTOL = 2.0 ** -7
BF16_OUT_ATOL = 2.0 ** -8
BF16_GRAD_ATOL = 2.0 ** -7
# and against float64: the same rounding points as the plain version, so
# no further from float64 than BF16_F64_RATIO times the plain version's
# distance, plus a floor of one bf16 ulp (2^-8 relative) of the largest
# float64 value (a single rounding that lands the other way); lse is
# fp32 in both, and its floor one fp32 ulp (2^-23) of the largest |lse|
BF16_F64_RATIO = 2.0
BF16_F64_FLOOR = 2.0 ** -8
FP32_F64_FLOOR = 2.0 ** -23
# the bf16 LayerNorm's y against its plain version: one rounding of an
# fp32 value computed in another order (BF16_RTOL), and for y near 0 the
# fp32 part of LN_TOL's absolute limit; mean and rstd are fp32 (LN_TOL)
LN_BF16_TOL = dict(rtol=BF16_RTOL, atol=LN_TOL["atol"])
# The float16 kernels against their float16 plain versions and float64:
# the bf16 limits' derivation at fp16's unit roundoff, 2^-11 where
# bf16's is 2^-8, so each 2^-3 of bf16's: one output rounding lands at
# most one fp16 ulp (2^-10 of the value) apart (F16_RTOL); the forward's
# P rounding moves out by at most 2^-11 max|V| (F16_OUT_ATOL, x each
# slice's max|V|); one fp16 ulp of an element of P or dS, 2^-10 of the
# slice's largest gradient (F16_GRAD_ATOL); and float64 a floor of one
# fp16 rounding (2^-11) of its largest value (F16_F64_FLOOR)
F16_RTOL = 2.0 ** -10
F16_OUT_ATOL = 2.0 ** -11
F16_GRAD_ATOL = 2.0 ** -10
F16_F64_FLOOR = 2.0 ** -11
LN_F16_TOL = dict(rtol=F16_RTOL, atol=LN_TOL["atol"])
# The backward checks' floor where a gradient cancels (a key length of 1:
# the one key takes p = 1, dP - delta is 0 and so are dQ and dK, up to
# rounding). dP and delta are fp32 sums of D products in either
# implementation, each within D 2^-24 of the sum of its terms'
# magnitudes, so dS = p (dP - delta) scale lies within D 2^-24 scale p
# (|dO| |V|^T + rowsum(|dO| |O|)) of its exact value, and dQ (dK) within
# that times |K| (|Q|) summed; kernel and plain version may each lie
# there, so the limit adds twice it (`_bwd_cancel_floor`). It is far
# below GRAD_ATOL x a slice's largest gradient wherever the gradient does
# not cancel, and lets the shared cases take lengths of 1 again
BWD_CANCEL = 2.0 ** -24
# each 16-bit form's limits, by dtype name
LOWP = {
    "bfloat16": dict(label="bf16", rtol=BF16_RTOL, out_atol=BF16_OUT_ATOL,
                     grad_atol=BF16_GRAD_ATOL, f64_floor=BF16_F64_FLOOR,
                     ln_tol=LN_BF16_TOL),
    "float16": dict(label="f16", rtol=F16_RTOL, out_atol=F16_OUT_ATOL,
                    grad_atol=F16_GRAD_ATOL, f64_floor=F16_F64_FLOOR,
                    ln_tol=LN_F16_TOL)}


def _lowp(dtype):
    return LOWP[str(dtype).split(".")[-1]]


# the bert_wide_bf16 path: bert_base's shape with three heads of 256 (the
# wide kernels' path), and its 2-layer card-vs-CPU copy at S = 128
BERT_WIDE_H = 3
BERT_WIDE_CHECK_S, BERT_WIDE_CHECK_LENS = 128, (77, 128)
# phase 11b: bench_bert.py's optimizer (SGD, lr 1e-3, momentum 0.9,
# bench_bert.py:68) on the bf16 model, its loss on logits cast to fp32
BERT_BF16_LR, BERT_BF16_MOMENTUM = 1e-3, 0.9
# phase 11r: the pack holds RESUME_BATCHES batches; the uninterrupted run
# takes RESUME_STEPS steps and saves every RESUME_SAVE_EVERY steps up to
# RESUME_AT, where the resumed run starts; RESUME_CHECK_BATCHES batches
# are compared on the card, RESUME_SYNC_STEPS run under sync debug mode
RESUME_BATCHES, RESUME_STEPS, RESUME_AT = 24, 12, 6
RESUME_SAVE_EVERY, RESUME_CHECK_BATCHES, RESUME_SYNC_STEPS = 2, 3, 3
BERT_RECORD_FIELDS = ("tokens", "segments", "valid_length", "positions",
                      "mlm_labels", "nsp_label")
# phase 12b: a bf16 step on the card against one on the CPU, each held
# against the fp32 step on the CPU from the same weights: the card's
# distance from it at most BF16_F64_RATIO times the CPU's, plus one bf16
# ulp (BF16_F64_FLOOR) of its scale
BERT_MP_LR = 1e-4

# the fp32 LayerNorm with bf16 gamma / beta, as a TransformerNMT after
# cast("bfloat16") runs it (fp32 activations, bf16 weights): the cast
# NMT's shape (nmt_train_bf16: 64 x 64 rows of 512), BERT's, a width no
# multiple of 32 and the one-block-a-row form; held against `_ln_plain`
# within LN_TOL, the first timed
LN_BF16_GAMMA = [(64 * 64, 512), (16 * 512, 768), (4099, 200), (2048, 4096)]
# phases 5b / 6b: bench_nmt.py's bf16 step (bench_nmt.py:40-61):
# transformer_base cast to bf16, B = 64 (the smaller of its chip
# candidates), 64 source and 64 target tokens at full length, SGD lr 1e-3
# momentum 0.9 on the mean loss's gradient as it is; then a few steps
# timed again with TF32 on for fp32 matmuls
NMT_BF16_B, NMT_BF16_LR, NMT_BF16_MOMENTUM = 64, 1e-3, 0.9
NMT_BF16_STEPS, NMT_TF32_STEPS = 10, 5
# phase 6b: the cast NMT computes in fp32 on bf16 weights on both
# devices, so the loss agrees to TRAIN_LOSS_RTOL; each bf16 gradient is
# an fp32 value rounded once to bf16, which may land one bf16 ulp (2^-7
# of the value at most) apart, so in norm at most 2^-7 of the CPU's; the
# tied embedding's sums three bf16 gradients (two gathers and the
# output projection) in bf16, each of which may land so
NMT_BF16_GRAD_RTOL = 2.0 ** -7
NMT_BF16_EMBED_GRAD_RTOL = 3 * 2.0 ** -7
# phases 7b-9b: bench.py's ResNet-50 (bench.py:226-228): NHWC, the S2D
# stem, cast to bf16, trained by make_sgd_step's SGD (bench_util.py:
# 40-64: lr 0.1, momentum 0.9 in the parameter's dtype, no weight decay,
# the mean loss's gradient as it is), the loss on fp32 logits
RESNET_BF16_LR, RESNET_BF16_MOMENTUM = 0.1, 0.9
# phase 7p: bench.py's bf16 ResNet-50 fed from a JPEG RecordIO pack in
# the shape of an `im2rec --resize 256 --quality 95` ImageNet pack:
# PACK_RECORDS records (12 batches), short side PACK_SHORT, long side
# drawn from PACK_LONG, labels 0-999, from numpy seed 0; ImageRecordIter
# reads PACK_RECORD_ITER_BATCHES batches of it; an image folder of
# PACK_FOLDER_FILES files (JPEG and PNG, PACK_FOLDER_SIDE square) feeds
# one DataLoader batch. A JPEG at q95 of these images comes back at least
# PACK_PSNR_DB from its source (the N(0, 6) noise dominates its error)
PACK_RECORDS, PACK_SHORT, PACK_LONG, PACK_QUALITY = 1536, 256, (256, 384), 95
PACK_RECORD_ITER_BATCHES, PACK_SYNC_STEPS = 2, 3
PACK_FOLDER_FILES, PACK_FOLDER_SIDE = 8, 64
PACK_PSNR_DB = 30.0
PACK_MEAN = (123.68, 116.28, 103.53)      # CreateAugmenter(mean=True)
PACK_STD = (58.395, 57.12, 57.375)        # CreateAugmenter(std=True)
# phase 9c: stem_conv_s2d against the plain 7x7 / stride-2 / pad-3
# convolution at bench.py's input (128, 224, 224, 3), y and the weight
# gradient each against float64 on the card: in fp32, no further from it
# than STEM_F32_RATIO times the plain convolution's distance plus
# STEM_F32_FLOOR of the largest value (two cuDNN algorithms summing 147
# or 192 products, and 1.6 M for the weight gradient, in other orders);
# in bf16 BF16_F64_RATIO and BF16_F64_FLOOR, as for the bf16 kernels
STEM_SHAPE = (128, 224, 224, 3)
STEM_F32_RATIO, STEM_F32_FLOOR = 10.0, 1e-5

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
    `ms` is device time and has no other source. `fn` may be a list of
    calls, each on its own inputs (as many sets as `rotating_sets`
    gives): call i then runs fn[i % len(fn)], max(calls, len(fn)) of
    them, each output held until the capture ends so that no two calls
    write the same buffer, and what a call reads is not in L2 from an
    earlier call."""
    import torch
    fns = fn if isinstance(fn, list) else [fn]
    n = max(calls, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fns[i % len(fns)]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    held = []
    with torch.cuda.graph(graph):
        for i in range(n):
            out = fns[i % len(fns)]()
            if isinstance(fn, list):
                held.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * n)


# the card's L2 (an H100 SXM's 50 MiB): a timing that rotates through
# twice as many bytes finds none of a call's inputs there from the last
# call on them
L2_BYTES = 50 * 2 ** 20


def rotating_sets(nbytes):
    """How many sets of inputs and outputs, `nbytes` bytes a call, span
    twice L2_BYTES."""
    return max(1, -(-2 * L2_BYTES // nbytes))


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
        if ("registers" in line or "spill" in line or "wgmma" in line
                or "entry function" in line or line.startswith("==")):
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


def _f64_scores(torch, q, k, causal, scale, lens):
    """Softmax attention's scores in float64 on q's device (the card's
    fp64 units: at the larger shapes the CPU takes seconds a call) with
    the kernels' mask: (s, live), masked entries -inf and a row with no
    visible key (live False) all 0, the kernels' convention."""
    s = q.double() @ k.double().transpose(-1, -2) * scale
    dev = s.device
    allowed = torch.ones(s.shape, dtype=torch.bool, device=dev)
    if lens is not None:
        keys = torch.arange(s.shape[-1], device=dev)[None, :] \
            < torch.tensor(lens, device=dev)[:, None]
        allowed &= keys[:, None, None, :]
    if causal:
        allowed &= torch.ones(s.shape[-2:], dtype=torch.bool,
                              device=dev).tril()
    live = allowed.any(-1, keepdim=True)
    s = torch.where(allowed, s, torch.tensor(-torch.inf, dtype=s.dtype,
                                             device=dev))
    return torch.where(live, s, torch.zeros_like(s)), live


def _attention_f64(torch, q, k, v, causal, scale, lens):
    """(out, lse (B*H, Sq), live (B*H, Sq)) of softmax attention in
    float64 (`_f64_scores`), on the CPU; a row with no visible key is
    zeros and its lse is not compared."""
    b, h, sq, _ = q.shape
    s, live = _f64_scores(torch, q.detach(), k.detach(), causal, scale,
                          lens)
    out = torch.softmax(s, -1) * live @ v.detach().double()
    return (out.cpu(), torch.logsumexp(s, -1).reshape(b * h, sq).cpu(),
            live.reshape(b * h, sq).cpu())


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


def _fwd_plans(K, q, k):
    """{name: plan} of the forward kernel at other plans than
    `flash_fwd_plan`'s that fit a block, in q's dtype: fp32, rw row warps
    x ks key-split warps of bk-key tiles; bf16 and fp16, both block
    shapes of the wgmma kernel (`_fwd_bf16_plan`: 128 rows, 64 rows)."""
    b, h, sq, d = q.shape
    plan = K.flash_fwd_plan(b * h, sq, k.shape[2], d, q.dtype)
    plans = {}
    if q.dtype != K.torch.float32:
        for rw in (2, 1):
            p = K._fwd_bf16_plan(plan["dp"], rw)
            plans[f"rw{rw}_bk{p['bk']}"] = p
        return plans
    for rw, ks, bk in ((4, 1, 32), (4, 1, 16), (2, 2, 32), (2, 4, 16),
                       (1, 4, 32), (1, 8, 16), (1, 4, 16)):
        smem = K.flash_fwd_smem(rw, ks, bk, plan["dp"])
        if smem > 227 * 1024:
            continue                  # more than a block's memory
        plans[f"rw{rw}_ks{ks}_bk{bk}"] = dict(
            plan, rw=rw, ks=ks, bk=bk, warps=rw * ks, rows=16 * rw,
            smem=smem)
    return plans


def _fwd_plan_fns(K, q, k, v, causal, scale, vl):
    """The forward kernel at each of `_fwd_plans`, to check and time
    beside its choice."""
    return {name: (lambda p=p: K._flash_cuda(q, k, v, causal, scale, vl, p))
            for name, p in _fwd_plans(K, q, k).items()}


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


def _rpa_inputs(torch, g, case, W, quant, L=6, H=8, dh=64, psize=16,
                dev=None):
    """q, the layer-2 slices of a 5-D (L, P, psize, H, dh) pool (and (L,
    P, H) scales for int8 pages) as the runtime holds them, the page
    tables and lengths of `case` = (P, tables, lengths), on `dev` (the
    card by default); q is (S, H, dh) for W = None, else (S, W, H,
    dh)."""
    dev = dev or torch.device("cuda", 0)
    P, tables, lens = case
    shape = (L, P, psize, H, dh)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, generator=g,
                                dtype=torch.int8).to(dev)
                  for _ in range(2))
        ks, vs = ((torch.rand((L, P, H), generator=g) * 0.05 + 1e-3)
                  .to(dev)[2] for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=g).to(dev) for _ in range(2))
        ks = vs = None
    qshape = (len(lens), H, dh) if W is None else (len(lens), W, H, dh)
    q = torch.randn(qshape, generator=g).to(dev)
    pt = torch.tensor(tables, dtype=torch.int32, device=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp[2], vp[2], pt, ln, ks, vs


def _rpa_plain(K, q, kp, vp, pt, ln, ks, vs):
    run = K._paged_attention_plain_multi if q.dim() == 4 \
        else K._paged_attention_plain
    return run(q, kp, vp, pt, ln, ks, vs)


def _rpa_share(a, ref):
    """(max abs error of `a` from `ref`, the largest share of RPA_TOL's
    limit atol + rtol * |ref| that it takes at an element)."""
    err = (a.double() - ref.double()).abs()
    limit = RPA_TOL["atol"] + RPA_TOL["rtol"] * ref.double().abs()
    return err.max().item(), (err / limit).max().item()


def _rpa_f64(torch, K, q, kp, vp, pt, ln, ks, vs):
    """The paged kernels' function in float64 throughout (int8 pages
    dequantized in float64): row i of slot s a softmax over the first
    min(lengths[s] + i, npages * psize) positions, zeros where it sees
    none. The same shape as q. `_rpa_check` holds the paged kernels
    against it: the plain version sums each score over dh terms of
    dequantized keys (up to about 6.5) in one fp32 GEMM, and on the
    fast-path phase's int8 draws it lay up to 1.745 of RPA_TOL's limit
    from this function on an NVIDIA H100, so the exact answer would fail
    against it."""
    d = torch.float64
    qq = q.to(d) if q.dim() == 4 else q.to(d)[:, None]     # (S, W, H, dh)
    pages = (kp, vp) if ks is not None else (kp.to(d), vp.to(d))
    scales = (None, None) if ks is None else (ks.to(d), vs.to(d))
    kc, vc, L = K._gathered_context(qq, *pages, pt, *scales)
    vis = ln.long()[:, None] + torch.arange(qq.shape[1], device=q.device)
    seen = torch.arange(L, device=q.device) < vis[..., None]   # (S, W, L)
    sc = torch.einsum("swhd,shld->swhl", qq, kc) / q.shape[-1] ** 0.5
    sc = sc.masked_fill(~seen[:, :, None], float("-inf"))
    out = torch.einsum("swhl,shld->swhd",
                       torch.softmax(sc, -1).nan_to_num(0.0), vc)
    return out if q.dim() == 4 else out[:, 0]


def rpa_witness_inputs(torch, dev=None):
    """The widened int8 inputs at the long case on the one draw where the
    first widened int8 kernel read beyond RPA_TOL from its plain version:
    `phase_rpa_fastpath`'s generator as it stood when the int8 1-wide row
    also drew its long-case timing inputs from it."""
    g = torch.Generator(device="cpu").manual_seed(4)
    W = SPEC_K + 1
    for w, quant, cases in (
            (None, True, ("serving", "edge", "long", "serving", "long")),
            (W, False, ("serving", "edge", "long", "serving")),
            (W, True, ("serving", "edge"))):
        for case in cases:
            _rpa_inputs(torch, g, RPA_CASES[case], w, quant, dev=dev)
    return _rpa_inputs(torch, g, RPA_CASES["long"], W, True, dev=dev)


def rpa_f64_witness(mx, torch, dev=None):
    """The widened int8 kernel on `rpa_witness_inputs`. Returns {pair:
    (max abs error, the largest share of RPA_TOL's limit atol + rtol *
    |ref| at an element)} for the kernel against the plain version, and
    each of them against `_rpa_f64`; on the card it fails the run unless
    the kernel is within the limit (a share below 1) of both. On CPU
    tensors the "kernel" is the plain version, and nothing is held."""
    K = mx.ops.kernels
    args = rpa_witness_inputs(torch, dev)
    q, kp, vp, pt, ln, ks, vs = args
    out = K.ragged_paged_attention(q, kp, vp, pt, ln, k_scales=ks,
                                   v_scales=vs)
    plain = _rpa_plain(K, *args)
    exact = _rpa_f64(torch, K, *args)
    res = {"kernel_vs_plain": _rpa_share(out, plain),
           "kernel_vs_f64": _rpa_share(out, exact),
           "plain_vs_f64": _rpa_share(plain, exact)}
    log("ragged_paged_attention_multi_int8 long, the draw once beyond "
        "RPA_TOL: " + "; ".join(f"{k} max abs {a:.3e} ({r:.3f} of the "
                                f"RPA_TOL limit)" for k, (a, r) in
                                res.items()))
    if q.is_cuda:
        for pair in ("kernel_vs_plain", "kernel_vs_f64"):
            check(res[pair][1] < 1.0,
                  f"ragged_paged_attention_multi_int8 on the witness draw: "
                  f"{pair} {res[pair][1]:.3f} of RPA_TOL's limit")
    return res


def _rpa_bound(lens, npages, w, quant, H=8, dh=64, psize=16):
    """The least time of one paged call on this run's data: row i of
    slot s reads min(len + i, npages * psize) keys, so a slot's live K/V
    rows are those of its longest row; int8 pages are 1 byte an element
    plus one f32 scale per (page, head) they touch, dequantized by one
    multiply an element. (ms, "bytes" or "operations")."""
    S = len(lens)
    vis = [[min(n + i, npages * psize) for i in range(w)] for n in lens]
    live = sum(v[-1] for v in vis)
    item = 1 if quant else 4
    pages = sum(-(-v[-1] // psize) for v in vis)
    nbytes = (2 * 4 * S * w * H * dh + 2 * item * live * H * dh
              + (2 * 4 * pages * H if quant else 0) + 4 * S * npages
              + 4 * S)
    flops = 4 * sum(map(sum, vis)) * H * dh \
        + (2 * live * H * dh if quant else 0)
    return bound(nbytes, flops, PEAK_TF32X3_FLOPS)


def launch_floor_ms(mx, blocks, threads):
    """Graph-replay ms of an empty kernel of `blocks` x `threads`, built
    and launched as the port's kernels are (`_build`, ctypes): what no
    one-launch kernel of that grid goes below."""
    import torch
    lib = mx.ops._build.library()

    def launch():
        rc = lib.mxtt_launch_floor(blocks, threads,
                                   torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"empty kernel launch failed: CUDA error {rc}")
    return graph_ms(launch)


def _rpa_check(mx, torch, g, name, W, quant, cases):
    """The paged kernel `name` against its plain version in float64
    (`_rpa_f64`) on `cases` (RPA_TOL), a row with no visible key exactly
    zero, and two calls bit-identical; its distance from the fp32 plain
    version is logged beside. Returns the largest error."""
    K = mx.ops.kernels
    worst = 0.0
    for case in cases:
        q, kp, vp, pt, ln, ks, vs = _rpa_inputs(torch, g, RPA_CASES[case], W,
                                                quant)
        lens = ln.tolist()
        out = K.ragged_paged_attention(q, kp, vp, pt, ln, k_scales=ks,
                                       v_scales=vs)
        again = K.ragged_paged_attention(q, kp, vp, pt, ln, k_scales=ks,
                                         v_scales=vs)
        ref = _rpa_f64(torch, K, q, kp, vp, pt, ln, ks, vs)
        plain = _rpa_plain(K, q, kp, vp, pt, ln, ks, vs)
        torch.cuda.synchronize()
        err, share = _rpa_share(out, ref)
        err32, share32 = _rpa_share(out, plain)
        check(torch.isfinite(out).all().item(), f"{name} not finite")
        check(torch.allclose(out.double(), ref, **RPA_TOL),
              f"{name} kernel vs plain (float64): max abs err {err} at "
              f"lens {lens}")
        check(torch.equal(out, again),
              f"{name}: two calls gave other bits at lens {lens}")
        if 0 in lens:
            # row 0 of a length-0 slot sees no key
            zero = out[lens.index(0)]
            check((zero[0] if W else zero).abs().max().item() == 0.0,
                  f"{name}: a row with no visible key must be zeros")
        worst = max(worst, err)
        log(f"{name} {case} P={kp.shape[0]} W={W or 1} lens={lens}: max "
            f"abs err {err:.3e} ({share:.3f} of the limit) from the plain "
            f"version in float64 (tol rtol={RPA_TOL['rtol']} "
            f"atol={RPA_TOL['atol']}), {err32:.3e} ({share32:.3f}) from it "
            f"in fp32, which is {_rpa_share(plain, ref)[1]:.3f} from "
            f"float64; two calls bit-identical")
    return worst


def _rpa_row(mx, torch, g, name, W, quant, line, extra):
    """The kernels row of paged kernel `name`: checked on the serving,
    edge and long cases, timed (kernel and plain version) at the serving
    shape and at each (case, window) of `extra` (`per_shape`, their
    inputs from a generator of their own, so the other rows' inputs stay
    the draws of `g` they had before they were timed)."""
    K = mx.ops.kernels
    worst = _rpa_check(mx, torch, g, name, W, quant, RPA_CASES)
    timed = []
    for case, w in (("serving", W), *extra):
        args = _rpa_inputs(torch, g if not timed else
                           torch.Generator(device="cpu").manual_seed(10),
                           RPA_CASES[case], w, quant)
        q, kp, vp, pt, ln, ks, vs = args
        fns = {"kernel": lambda: K.ragged_paged_attention(
                   q, kp, vp, pt, ln, k_scales=ks, v_scales=vs),
               "plain": lambda: _rpa_plain(K, *args)}
        call = {k: cuda_ms(fn) for k, fn in fns.items()}
        dev_ms = {k: graph_ms(fn) for k, fn in fns.items()}
        bms, by = _rpa_bound(RPA_CASES[case][2], pt.shape[1], w or 1, quant)
        log(f"{name} {case} shape S={q.shape[0]} W={w or 1} H=8 dh=64 "
            f"psize=16 lens={RPA_CASES[case][2]}: per call (host launch "
            f"included) {call}; device (CUDA graph) {dev_ms}; bound "
            f"{bms:.6f} ms ({by}); library: none (no single PyTorch call "
            f"gathers pages)")
        timed.append(dict(case=case, W=w or 1, lens=RPA_CASES[case][2],
                          ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                          bound_ms=bms, bound_by=by, library_ms=None,
                          call_ms=call["kernel"]))
    serve = timed.pop(0)
    row = dict(name=name, route="cuda",
               source="mxnet_tpu_torch/ops/csrc/ragged_paged_attention.cu",
               replaces=f"mxnet_tpu/ops/pallas_kernels.py:{line}",
               max_abs_err=worst, **{k: serve[k] for k in (
                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "call_ms")})
    if timed:
        row["per_shape"] = timed
    return row


def _rpa_floor(mx, W):
    """The launch floor of a paged kernel's serving grid (8 slots, H = 8,
    dh = 64, tables of 2 pages of 16): an empty kernel of as many blocks
    and threads as `rpa_plan` (W = None) or `rpa_multi_plan` give."""
    K = mx.ops.kernels
    if W is None:
        plan = K.rpa_plan(8, 8, 64, 16, 2)
        blocks = plan["blocks"]
    else:
        plan = K.rpa_multi_plan(8, W, 8, 64, 16, 2)
        blocks = plan["blocks"][0] * plan["blocks"][1]
    floor = launch_floor_ms(mx, blocks, 32 * plan["warps"])
    log(f"launch floor: an empty kernel of the W={W or 1} serving grid "
        f"({blocks} x {32 * plan['warps']}) {floor:.6f} ms by CUDA-graph "
        f"replay")
    return floor


def phase_rpa(mx, torch):
    """The 1-wide fp32 paged kernel against its plain version on
    RPA_CASES (two calls bit-identical), timed at the serving shape and
    the long case, beside an empty kernel of its serving grid (the
    launch floor)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    row = _rpa_row(mx, torch, g, "ragged_paged_attention", None, False,
                   "872", [("long", None)])
    row["launch_floor_ms"] = _rpa_floor(mx, None)
    return row


def phase_rpa_fastpath(mx, torch):
    """The int8 1-wide, fp32 widened and int8 widened paged kernels
    against their plain versions at the serving shape of the fast path
    (8 slots, W = 4, H = 8, dh = 64, psize 16, a 5-D pool) and RPA_CASES'
    edges (slots of length 0, rows past the page budget: row i sees
    lengths + i keys, clamped to the table) and long table; two calls
    bit-identical. The widened kernels are also held at W = 9
    (speculative_k = 8: three groups of rows) on the same cases, and
    timed at the long case and at W = 9, each beside the launch floor of
    its serving grid; the int8 1-wide kernel is timed at the long case;
    the widened int8 kernel is held against float64 on the draw where
    its first design read beyond RPA_TOL (`rpa_f64_witness`)."""
    g = torch.Generator(device="cpu").manual_seed(4)
    W = SPEC_K + 1
    rows = [_rpa_row(mx, torch, g, name, w, quant, line, extra)
            for name, w, quant, line, extra in (
                ("ragged_paged_attention_int8", None, True, "872 (quant)",
                 [("long", None)]),
                ("ragged_paged_attention_multi", W, False, "1014",
                 [("long", W), ("serving", 9)]),
                ("ragged_paged_attention_multi_int8", W, True,
                 "1014 (quant)", [("long", W), ("serving", 9)]))]
    g9 = torch.Generator(device="cpu").manual_seed(11)
    for row, quant in zip(rows[1:], (False, True)):
        worst9 = _rpa_check(mx, torch, g9, row["name"], 9, quant, RPA_CASES)
        row["max_abs_err"] = max(row["max_abs_err"], worst9)
        row["launch_floor_ms"] = _rpa_floor(mx, W)
    rpa_f64_witness(mx, torch)
    return rows


def rpa_times(mx, torch):
    """{"<form> <case>": device ms by CUDA-graph replay} of the four
    paged kernels at RPA_CASES' serving and long cases, and of the 1-wide
    ones at RPA_SWEEP's cases too, with "floor" the launch floor of the
    1-wide serving grid where the package builds the empty kernel. Where
    the package's widened kernels take any window (`rpa_multi_plan`),
    also the widened ones at W = 9 ("w9", three groups of rows) and the
    floor of that grid ("floor w9"). It takes `mx` as given, so
    another checkout's package is measured the same way
    (`chip_train_ab.py --phase rpa`)."""
    K = mx.ops.kernels
    g = torch.Generator(device="cpu").manual_seed(9)
    times = {}
    forms = [("f32", None, False), ("i8", None, True),
             ("multi_f32", SPEC_K + 1, False), ("multi_i8", SPEC_K + 1, True)]
    if hasattr(K, "rpa_multi_plan"):
        forms += [("multi_f32 w9", 9, False), ("multi_i8 w9", 9, True)]
    for form, W, quant in forms:
        cases = {k: RPA_CASES[k] for k in ("serving", "long")}
        if W is None:
            cases.update(RPA_SWEEP)
        for case, spec in cases.items():
            q, kp, vp, pt, ln, ks, vs = _rpa_inputs(torch, g, spec, W, quant)

            def run():
                return K.ragged_paged_attention(q, kp, vp, pt, ln,
                                                k_scales=ks, v_scales=vs)
            times[f"{form} {case}"] = graph_ms(run)
    if hasattr(mx.ops._build.library(), "mxtt_launch_floor"):
        times["floor"] = launch_floor_ms(mx, 64, 256)
        if hasattr(K, "rpa_multi_plan"):
            times["floor w9"] = _rpa_floor(mx, 9)
    return times


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
    """(dQ, dK, dV) of softmax attention by autograd in float64
    (`_f64_scores`), on the CPU; a row with no visible key is zeros, the
    kernels' convention."""
    q, k, v = (t.detach().double().requires_grad_(True) for t in (q, k, v))
    s, live = _f64_scores(torch, q, k, causal, scale, lens)
    p = torch.softmax(s, -1) * live
    grads = torch.autograd.grad(p @ v, (q, k, v),
                                do.detach().double().to(q.device))
    return tuple(g.cpu() for g in grads)


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
    worst = max(worst, _ln_bf16_gamma_checks(K, torch, g, dev))
    per_shape = []
    for rows, d in LN_TIMED:
        x, ga, be = [torch.randn(shape, generator=g).to(dev)
                     for shape in ((rows, d), (d,), (d,))]
        fns = {"kernel": lambda x: K.layer_norm_fwd(x, ga, be, 1e-5),
               "plain": lambda x: K._ln_plain(x, ga, be, 1e-5),
               "torch": lambda x: torch.nn.functional.layer_norm(
                   x, (d,), ga, be, 1e-5)}
        call = {name: cuda_ms(lambda: fn(x)) for name, fn in fns.items()}
        dev_ms = _ln_cold_ms(x, fns)
        # x and y once each, gamma and beta, mean and rstd; ~8 FLOP an
        # element
        bms, by = bound(4 * (2 * rows * d + 2 * d + 2 * rows), 8 * rows * d)
        per_shape.append(dict(shape=[rows, d], form=form(d),
                              ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                              library_ms=dev_ms["torch"], bound_ms=bms,
                              bound_by=by, call_ms=call["kernel"]))
        log(f"layer norm ({rows}, {d}) {form(d)} form: per call "
            f"(host launch included, warm) {call}; device (CUDA graph, x "
            f"from HBM) {dev_ms}; bound {bms:.6f} ms ({by}); kernel / bound "
            f"{dev_ms['kernel'] / bms:.2f}, kernel / F.layer_norm "
            f"{dev_ms['kernel'] / dev_ms['torch']:.3f}")
    per_shape.append(_ln_bf16_gamma_times(K, torch, g, dev))
    top = per_shape[0]
    return dict(name="layer_norm", route="cuda",
                source="mxnet_tpu_torch/ops/csrc/layer_norm.cu",
                replaces="mxnet_tpu/ops/pallas_kernels.py:1209",
                max_abs_err=worst, per_shape=per_shape,
                **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "call_ms")})


def _ln_cold_ms(x, fns):
    """{name: device ms} of each LayerNorm form `fns[name](x)`, by
    `graph_ms` rotating over copies of x (x read from HBM, each y
    written to its own buffer)."""
    xs = [x.clone() for _ in range(rotating_sets(2 * x.nbytes))]
    return {name: graph_ms([lambda c=c, fn=fn: fn(c) for c in xs])
            for name, fn in fns.items()}


def _ln_bf16_gamma_checks(K, torch, g, dev):
    """The fp32 LayerNorm kernel with bf16 gamma / beta (a cast model's
    fp32 activations) at LN_BF16_GAMMA against `_ln_plain` (LN_TOL), y
    fp32; and with those gammas widened to fp32 it must give the same
    bits (the bf16 read is exact, the rest one code). Returns the worst
    max abs error."""
    worst = 0.0
    for rows, d in LN_BF16_GAMMA:
        x = (3 * torch.randn((rows, d), generator=g) + 1).to(dev)
        ga, be = (torch.randn(d, generator=g).to(dev).to(torch.bfloat16)
                  for _ in range(2))
        got = K.layer_norm_fwd(x, ga, be, 1e-5)
        wide = K.layer_norm_fwd(x, ga.float(), be.float(), 1e-5)
        ref = K._ln_plain(x, ga, be, 1e-5)
        torch.cuda.synchronize()
        errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        check(got[0].dtype == torch.float32
              and all(torch.allclose(a, r, **LN_TOL)
                      for a, r in zip(got, ref)),
              f"layer norm, fp32 x and bf16 gamma, kernel vs plain at "
              f"({rows}, {d}): y {got[0].dtype}, max abs errs (y, mean, "
              f"rstd) {errs}")
        check(all(torch.equal(a, b) for a, b in zip(got, wide)),
              f"layer norm ({rows}, {d}): bf16 gamma and the same gamma "
              f"in fp32 gave other bits")
        worst = max(worst, *errs)
        log(f"layer norm ({rows}, {d}) fp32 x, bf16 gamma / beta: max abs "
            f"err (y, mean, rstd) {errs} (LN_TOL); the same bits as with "
            f"the gammas in fp32")
    return worst


def _ln_bf16_gamma_times(K, torch, g, dev):
    """The fp32 LayerNorm with bf16 gamma / beta at the cast NMT's shape
    (LN_BF16_GAMMA[0]) timed beside its plain version and
    `F.layer_norm` (which takes gamma in x's dtype: fp32 copies)."""
    rows, d = LN_BF16_GAMMA[0]
    x = torch.randn((rows, d), generator=g).to(dev)
    ga, be = (torch.randn(d, generator=g).to(dev).to(torch.bfloat16)
              for _ in range(2))
    ga32, be32 = ga.float(), be.float()
    fns = {"kernel": lambda x: K.layer_norm_fwd(x, ga, be, 1e-5),
           "plain": lambda x: K._ln_plain(x, ga, be, 1e-5),
           "torch": lambda x: torch.nn.functional.layer_norm(
               x, (d,), ga32, be32, 1e-5)}
    call = cuda_ms(lambda: fns["kernel"](x))
    dev_ms = _ln_cold_ms(x, fns)
    # fp32 x and y once each, bf16 gamma and beta, fp32 mean and rstd
    bms, by = bound(4 * (2 * rows * d + 2 * rows) + 2 * 2 * d,
                    8 * rows * d)
    log(f"layer norm ({rows}, {d}) fp32 x, bf16 gamma / beta: device (CUDA "
        f"graph, x from HBM) {dev_ms}; per call (warm) {call:.5f}; bound "
        f"{bms:.6f} ms ({by}); kernel / bound "
        f"{dev_ms['kernel'] / bms:.2f}, kernel / F.layer_norm "
        f"{dev_ms['kernel'] / dev_ms['torch']:.3f}")
    return dict(shape=[rows, d], form="warp", gamma="bfloat16",
                ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                library_ms=dev_ms["torch"], bound_ms=bms, bound_by=by,
                call_ms=call)


# ---------------------------------------------------------------------------
# the bfloat16 forms of the flash and LayerNorm kernels (phase 2, bf16)
# ---------------------------------------------------------------------------
def _bf16_share(torch, got, ref, atol, rtol=BF16_RTOL):
    """The largest share of the limit rtol * |ref| + atol (a number or a
    tensor broadcast against ref) that |got - ref| takes."""
    err = (got.float() - ref.float()).abs()
    return (err / (rtol * ref.float().abs() + atol)).max().item()


def _slice_max(t):
    """Each (b, h) slice's largest |value|, at least the smallest normal
    fp32 (so a limit scaled by it is never 0)."""
    return t.float().abs().amax(dim=(-2, -1), keepdim=True).clamp_min(
        1.17549435e-38)


def _lowp_qkv(torch, g, b, h, sq, sk, d, n=3, dtype=None):
    """q, k, v (and dO with n = 4) on the card in `dtype` (bfloat16 when
    None), from the CPU generator `g`."""
    dev = torch.device("cuda", 0)
    dtype = dtype or torch.bfloat16
    shapes = [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)]
    return [torch.randn(shape, generator=g).to(dev).to(dtype)
            for shape in shapes[:n]]


def _lowp_f64_check(lim, name, e64, p64, scale, what, floor=None):
    floor = lim["f64_floor"] if floor is None else floor
    check(e64 <= BF16_F64_RATIO * p64 + floor * scale,
          f"{lim['label']} {name} {e64} from float64, more than "
          f"{BF16_F64_RATIO}x the plain version's {p64} + {floor} x "
          f"{scale} at {what}")


def _lowp_fwd_check(torch, K, q, k, v, causal, lens, what, plan=None):
    """The bf16 or fp16 forward kernel (q's dtype; as `flash_fwd_plan`
    says, or at `plan`) against `_flash_plain` in that dtype (the
    dtype's LOWP limits: rtol, out_atol x each slice's max|V|; lse
    FLASH_TOL) and, at its own plan, float64 (BF16_F64_RATIO), two
    launches bit-identical, a zero-length row exactly 0. Returns (max
    abs error, share of the limit, float64 distances, the plain
    version's; None at another plan)."""
    own = plan is None
    lim = _lowp(q.dtype)
    d = q.shape[-1]
    scale = d ** -0.5
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=q.device)
    plan = plan or K.flash_fwd_plan(q.shape[0] * q.shape[1], q.shape[2],
                                    k.shape[2], d, q.dtype)
    out, lse = K._flash_cuda(q, k, v, causal, scale, vl, plan)
    out2, lse2 = K._flash_cuda(q, k, v, causal, scale, vl, plan)
    ref, ref_lse = K._flash_plain(q, k, v, causal, scale, vl)
    torch.cuda.synchronize()
    tag = f"{lim['label']} flash"
    check(out.dtype == q.dtype and lse.dtype == torch.float32,
          f"{tag} output dtypes {out.dtype}, {lse.dtype}")
    check(torch.isfinite(out).all().item(), f"{tag} {what} not finite")
    check(torch.equal(out, out2) and torch.equal(lse, lse2),
          f"{tag} {what}: two launches gave other bits")
    err = (out.float() - ref.float()).abs().max().item()
    share = _bf16_share(torch, out, ref, lim["out_atol"] * _slice_max(v),
                        lim["rtol"])
    check(share <= 1.0, f"{tag} kernel vs plain at {what}: max abs err "
                        f"{err}, {share:.3f} of the limit")
    check(torch.allclose(lse, ref_lse, **FLASH_TOL),
          f"{tag} lse vs plain at {what}: max abs err "
          f"{(lse - ref_lse).abs().max().item()}")
    for bi, n in enumerate(lens or []):
        if n == 0:
            check(out[bi].abs().max().item() == 0.0,
                  f"a zero-length row must be zeros at {what}")
    if not own:
        return err, share, None, None
    o64, l64, live = _attention_f64(torch, q, k, v, causal, scale, lens)
    e64 = {"out": (out.cpu().double() - o64).abs().max().item(),
           "lse": (lse.cpu().double() - l64)[live].abs().max().item()}
    p64 = {"out": (ref.cpu().double() - o64).abs().max().item(),
           "lse": (ref_lse.cpu().double() - l64)[live].abs().max().item()}
    _lowp_f64_check(lim, "out", e64["out"], p64["out"],
                    o64.abs().max().item(), what)
    _lowp_f64_check(lim, "lse", e64["lse"], p64["lse"],
                    l64[live].abs().max().item(), what, FP32_F64_FLOOR)
    return err, share, e64, p64


def _bwd_cancel_floor(torch, q, k, v, do, out, causal, scale, lens):
    """{dq, dk, dv: the part of the backward kernels' limit that fp32
    leaves where a gradient cancels}, in float64 on q's device:
    BWD_CANCEL x D x scale x (A |K|) for dQ and (A^T |Q|) for dK, A = p
    (|dO| |V|^T + rowsum(|dO| |O|)) over each (b, h, q, k) of the mask's
    p (`_f64_scores`); 0 for dV (no cancellation)."""
    q, k, v, do, out = (t.detach() for t in (q, k, v, do, out))
    s, live = _f64_scores(torch, q, k, causal, scale, lens)
    q, k, v, do, out = (t.double().abs() for t in (q, k, v, do, out))
    a = torch.softmax(s, -1) * live * (
        do @ v.transpose(-1, -2) + (do * out).sum(-1, keepdim=True))
    c = BWD_CANCEL * q.shape[-1] * scale
    return {"dq": c * (a @ k), "dk": c * (a.transpose(-1, -2) @ q),
            "dv": torch.zeros((), dtype=a.dtype, device=a.device)}


def _lowp_bwd_check(torch, K, q, k, v, do, causal, lens, what):
    """The bf16 or fp16 backward kernels (q's dtype; `flash_attention_bwd`
    as `flash_bwd_plan` says) from that form's forward kernel's lse
    against `_flash_bwd_plain` in that dtype (the dtype's LOWP rtol, and
    grad_atol x each slice's largest gradient plus the cancellation
    floor, `_bwd_cancel_floor`) and float64 autograd (BF16_F64_RATIO), a
    repeated launch bit-identical, dK / dV exactly 0 past each length,
    and only that form's counters moving. Returns ({name: max abs err},
    {name: share of the limit}, float64 distances, the plain
    version's)."""
    lim = _lowp(q.dtype)
    sfx = K._suffix(q.dtype)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=q.device)
    path = K.flash_bwd_plan(sk, d, q.dtype)["path"]
    out, lse = K.flash_attention_fwd(q, k, v, causal, scale, vl)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, sq)
    before = dict(K.LAUNCHES)
    got = K.flash_attention_bwd(q, k, v, do, lse, delta, causal, scale, vl)
    again = K.flash_attention_bwd(q, k, v, do, lse, delta, causal, scale,
                                  vl)
    refs = K._flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, vl)
    torch.cuda.synchronize()
    counts = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
    want = dict(dict.fromkeys(K.LAUNCHES, 0), **{
        "flash_bwd" + sfx: 2, "flash_bwd_dq" + sfx: 2 * (path == "split")})
    tag = f"{lim['label']} bwd"
    check(counts == want, f"{tag} {what}: launches {counts} != {want}")
    check(all(torch.equal(a, r) for a, r in zip(got, again)),
          f"{tag} {what}: a repeated launch gave other bits")
    errs, shares, e64, p64 = {}, {}, {}, {}
    refs64 = _attention_grads_f64(torch, q, k, v, do, causal, scale, lens)
    floors = _bwd_cancel_floor(torch, q, k, v, do, out, causal, scale, lens)
    for name, g, ref, r64 in zip(("dq", "dk", "dv"), got, refs, refs64):
        check(g.dtype == q.dtype and torch.isfinite(g).all().item(),
              f"{tag} {name} at {what}: dtype {g.dtype} or not finite")
        errs[name] = (g.float() - ref.float()).abs().max().item()
        atol = lim["grad_atol"] * _slice_max(ref) \
            + 2 * floors[name].float().to(g.device)
        shares[name] = _bf16_share(torch, g, ref, atol, lim["rtol"])
        check(shares[name] <= 1.0,
              f"{tag} {name} kernel vs plain at {what}: max abs err "
              f"{errs[name]}, {shares[name]:.3f} of the limit")
        e64[name] = (g.cpu().double() - r64).abs().max().item()
        p64[name] = (ref.cpu().double() - r64).abs().max().item()
        _lowp_f64_check(lim, name, e64[name], p64[name],
                        r64.abs().max().item(), what)
    dk, dv = got[1], got[2]
    for bi, n in enumerate(lens or []):
        if n < sk:
            check(dk[bi, :, n:].abs().max().item() == 0.0
                  and dv[bi, :, n:].abs().max().item() == 0.0,
                  f"{tag} dK/dV of keys past kv_len {n} must be exactly 0")
    return errs, shares, e64, p64


def _bf16_cases():
    """(B, H, Sq, Sk, D, causal, kv_lengths) of the bf16 checks: the
    serving prefill, the training step's three attentions, BERT's shape,
    padded widths 32-128 and D no multiple of 8, causal with Sq != Sk
    both ways, zero-length rows, Sk above one backward block, and every
    plan variant of the wgmma backward (fused over one or two
    warpgroups, split, DP 64 and 128) and of the wgmma forward (its key
    tiles' and row blocks' edges); `phase_flash_bf16` runs the forward
    at each of its block shapes on every case."""
    g = np.random.RandomState(0)
    bert = (4, BERT_H, BERT_S, BERT_S, 64, False,
            [300, 384, 3, int(g.randint(256, 513))])
    cases = [(1, 8, 128, 128, 64, False, [77]), *_train_attention_cases(),
             bert, (2, 2, 48, 48, 128, False, [0, 48]),
             (1, 2, 33, 33, 32, True, None),
             (1, 4, 64, 200, 64, True, None),
             (1, 4, 64, 200, 64, True, [150]),
             (1, 4, 200, 64, 64, True, [40]),
             (3, 2, 200, 200, 64, False, [0, 131, 200]),
             (2, 2, 70, 90, 96, True, [0, 61]),
             (2, 3, 100, 70, 32, False, [0, 70]),
             (2, 2, 45, 45, 30, True, [45, 17]),
             (1, 2, 50, 300, 18, False, [260]),
             (2, 2, 130, 300, 64, True, [280, 300]),
             # the wgmma backward's plan variants (`flash_bwd_plan` in
             # bf16): fused with a second warpgroup idle past kv_len,
             # fused over two warpgroups causal with Sq != Sk, fused at
             # DP = 128 (D = 128, and 96 in two swizzle atoms), split at
             # DP = 128 causal with Sq > Sk
             (1, 2, 128, 128, 64, False, [40]),
             (2, 2, 100, 120, 64, True, [0, 77]),
             (1, 2, 40, 64, 128, True, [50]),
             (1, 2, 64, 64, 96, True, [33]),
             (2, 2, 300, 200, 128, True, [150, 200]),
             # the wgmma forward's own tile edges (`flash_fwd_plan` in
             # bf16: 128-key tiles at DP = 64, 64 at 128; 128-row
             # blocks): Sk no multiple of a tile with kv_len inside the
             # last one, causal with Sq > Sk and Sq < Sk across a 128-row
             # block, D = 96 (two swizzle atoms, part padded) over 64-key
             # tiles
             (2, 3, 256, 300, 64, False, [290, 261]),
             (1, 2, 300, 170, 64, True, None),
             (2, 2, 150, 400, 64, True, [390, 400]),
             (2, 2, 200, 150, 96, False, [150, 100]),
             # many items a persistent block (both Q buffers, the ring's
             # phases across items of other lengths), causal, and with the
             # element-by-element copies; one-key rows, whose dQ and dK
             # cancel to 0 (BWD_CANCEL's floor)
             (8, 16, 512, 512, 64, True, [512, 1, 0, 257, 1, 64, 511, 130]),
             (8, 16, 300, 300, 30, False, [1, 300, 2, 1, 150, 0, 44, 299])]
    for d in (32, 96, 128, 18, 30):
        cases += [(2, 2, 512, 512, d, False, [300, 512]),
                  (1, 2, 1024, 1024, d, True, None)]
    return cases


def _lowp_attention_times(torch, K, b, h, s, d, lens, backward=True,
                          dtype=None):
    """Device ms (CUDA-graph replay) of the bf16 (or `dtype`: fp16)
    kernels at (B, H, S, S, D) with key lengths `lens`: the forward (as
    planned and at each of its block shapes, `_fwd_plans`), the backward
    as planned, its kernels alone, the plain versions and SDPA in that
    dtype (forward, and backward as fwd+bwd - fwd), with the bounds of
    this run's data: the live (q, k) pairs only, every 2-byte array read
    or written once, fp32 lse / delta, at the bf16 (= fp16) tensor-core
    peak."""
    g = torch.Generator(device="cpu").manual_seed(11)
    dtype = dtype or torch.bfloat16
    q, k, v, do = _lowp_qkv(torch, g, b, h, s, s, d, 4, dtype)
    vl = torch.tensor(lens, dtype=torch.int32, device=q.device)
    scale = d ** -0.5
    mask = (torch.arange(s, device=q.device)[None, :]
            < vl[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out, lse = K.flash_attention_fwd(q, k, v, kv_lengths=vl)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, s)
    args = (q, k, v, do, lse, delta, False, scale, vl)
    plan = K.flash_bwd_plan(s, d, dtype)
    fns = {"fwd": lambda: K.flash_attention_fwd(q, k, v, kv_lengths=vl),
           "fwd_plain": lambda: K._flash_plain(q, k, v, False, scale, vl),
           "sdpa_fwd": lambda: sdpa(q, k, v, attn_mask=mask)}
    fns.update({f"fwd {name}": fn for name, fn in _fwd_plan_fns(
        K, q, k, v, False, scale, vl).items()})
    if backward:
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(qg, kg, vg, attn_mask=mask),
                                (qg, kg, vg), do)
        fns.update(
            bwd=lambda: K.flash_attention_bwd(*args),
            fused=lambda: K._flash_bwd_fused_cuda(*args, plan),
            bwd_plain=lambda: K._flash_bwd_plain(*args),
            sdpa_fwd_bwd=sdpa_fwd_bwd)
        if plan["path"] == "split":
            fns["dq"] = lambda: K._flash_bwd_dq_cuda(*args, plan)
    dev_ms = {name: graph_ms(fn, calls=5, iters=10)
              for name, fn in fns.items()}
    call_ms = {name: cuda_ms(fns[name]) for name in ("fwd", "fused")
               if name in fns}
    live = sum(min(n, s) for n in lens)
    pairs = h * s * live
    rows_q = 2 * b * h * s * d            # bytes of one bf16 (B, H, S, D)
    rows_kv = 2 * h * live * d            # bytes of the live K (or V) rows
    stats = 4 * b * h * s                 # bytes of lse (or delta)
    reads = 2 * rows_q + 2 * rows_kv + 2 * stats + 4 * b
    bounds = {"fwd": bound(2 * rows_q + 2 * rows_kv + stats + 4 * b,
                           4 * pairs * d, PEAK_BF16_FLOPS)}
    if backward:
        if plan["path"] == "fused":
            bounds["fused"] = bound(reads + 3 * rows_q, 10 * pairs * d,
                                    PEAK_BF16_FLOPS)
        else:
            bounds["fused"] = bound(reads + 2 * rows_q, 8 * pairs * d,
                                    PEAK_BF16_FLOPS)
            bounds["dq"] = bound(reads + rows_q, 6 * pairs * d,
                                 PEAK_BF16_FLOPS)
        bounds["bwd"] = bound(reads + 3 * rows_q, 10 * pairs * d,
                              PEAK_BF16_FLOPS)
        dev_ms["sdpa_bwd"] = dev_ms["sdpa_fwd_bwd"] - dev_ms["sdpa_fwd"]
    # the operations each computes over the live pairs: the fused kernel
    # 8 (S, dP, dV, dK) or, writing dQ too, 10; the dQ kernel 6 (S, dP,
    # dQ); the backward as planned 10 on the fused path, 14 on the split
    flops = {"fwd": 4, "bwd": 10 if plan["path"] == "fused" else 14,
             "fused": 10 if plan["path"] == "fused" else 8, "dq": 6}
    tflops = {name: f * pairs * d / (dev_ms[name] * 1e-3) / 1e12
              for name, f in flops.items() if name in dev_ms}
    of_bound = {name: dev_ms[name] / bounds[name][0] for name in bounds}
    log(f"{_lowp(dtype)['label']} flash timed {(b, h, s, d)} lens "
        f"{lens[:4]}...: plans fwd "
        f"{K.flash_fwd_plan(b * h, s, s, d, dtype)} bwd {plan}; "
        f"device (CUDA graph) {dev_ms}; per call {call_ms}; bounds "
        f"{bounds}; achieved TFLOP/s {tflops}; kernel / bound {of_bound}; "
        f"forward / SDPA forward {dev_ms['fwd'] / dev_ms['sdpa_fwd']:.3f}"
        + (f"; backward / SDPA backward "
           f"{dev_ms['bwd'] / dev_ms['sdpa_bwd']:.3f}" if backward else ""))
    return dev_ms, call_ms, bounds, tflops


def _lowp_checks(torch, K, g, dtype, cases):
    """The 16-bit flash kernels in `dtype` against their plain versions
    and float64 on `cases` (`_lowp_fwd_check` at the plan
    `flash_fwd_plan` gives and at every other it takes,
    `_lowp_bwd_check` on the path `flash_bwd_plan` gives), then a
    misaligned q on both backward paths (fused at S = 100, split at 200:
    element-by-element copies into the swizzled tiles). Returns the
    worst error of each kernel, by counter name."""
    label, sfx = _lowp(dtype)["label"], K._suffix(dtype)
    fwd, bwd, dqn = ("flash_fwd" + sfx, "flash_bwd" + sfx,
                     "flash_bwd_dq" + sfx)
    worst = dict.fromkeys((fwd, bwd, dqn), 0.0)
    for b, h, sq, sk, d, causal, lens in cases:
        q, k, v, do = _lowp_qkv(torch, g, b, h, sq, sk, d, 4, dtype)
        what = f"{(b, h, sq, sk, d)} causal={causal} lens=" \
               f"{None if lens is None else lens[:4]}"
        err, share, e64, p64 = _lowp_fwd_check(torch, K, q, k, v, causal,
                                               lens, what)
        shares = [share]
        for name, p in _fwd_plans(K, q, k).items():
            err_p, share_p, _, _ = _lowp_fwd_check(torch, K, q, k, v, causal,
                                                   lens, f"{what} {name}", p)
            err, shares = max(err, err_p), shares + [share_p]
        worst[fwd] = max(worst[fwd], err)
        berrs, bshares, be64, bp64 = _lowp_bwd_check(torch, K, q, k, v, do,
                                                     causal, lens, what)
        split = K.flash_bwd_plan(sk, d, dtype)["path"] == "split"
        worst[bwd] = max(worst[bwd], berrs["dk"], berrs["dv"],
                         0.0 if split else berrs["dq"])
        if split:
            worst[dqn] = max(worst[dqn], berrs["dq"])
        log(f"{label} flash {what}: forward max abs err {err:.3e}, at most "
            f"{max(shares):.3f} of the limit over {len(shares)} plans; vs "
            f"float64 {e64} (plain {p64}); backward "
            f"({'split' if split else 'fused'}) max abs err {berrs}, "
            f"shares {bshares}; vs float64 {be64} (plain {bp64}); repeats "
            f"bit-identical")
        del q, k, v, do
    for b, h, s, d, causal in ((2, 2, 100, 64, False), (2, 2, 200, 64, True)):
        base = torch.randn(b * h * s * d + 1, generator=g).to(
            torch.device("cuda", 0)).to(dtype)
        q = base[1:].view(b, h, s, d)
        _, k, v, do = _lowp_qkv(torch, g, b, h, s, s, d, 4, dtype)
        check(q.is_contiguous() and q.data_ptr() % 16 != 0
              and K._vec_copies(d, q, k, v) == 0, "q not misaligned")
        lens = [70, s]
        err, share, e64, p64 = _lowp_fwd_check(torch, K, q, k, v, causal,
                                               lens, "misaligned q")
        berrs, bshares, _, _ = _lowp_bwd_check(torch, K, q, k, v, do,
                                               causal, lens, "misaligned q")
        worst[fwd] = max(worst[fwd], err)
        log(f"{label} flash misaligned q {(b, h, s, s, d)} causal={causal}: "
            f"forward {err:.3e} ({share:.3f} of the limit), vs float64 "
            f"{e64} (plain {p64}); backward {berrs} (shares {bshares})")
    torch.cuda.empty_cache()
    return worst


def phase_flash_bf16(mx, torch):
    """The bfloat16 flash kernels against their bf16 plain versions and
    float64 on `_bf16_cases` and a misaligned q (`_lowp_checks`). Then
    timed: the forward at the serving prefill (its row) and the training
    shape, the fused backward at the training shape (its row); the dQ
    kernel's row is filled at BERT's shape by
    `phase_bert_attention_bf16`. Returns the three rows."""
    K = mx.ops.kernels
    g = torch.Generator(device="cpu").manual_seed(10)
    worst = _lowp_checks(torch, K, g, torch.bfloat16, _bf16_cases())
    src_f = "mxnet_tpu_torch/ops/csrc/flash_fwd.cu"
    src_b = "mxnet_tpu_torch/ops/csrc/flash_bwd.cu"
    serve, serve_call, serve_b, _ = _lowp_attention_times(
        torch, K, 1, 8, 128, 64, [77], backward=False)
    tb, th, ts, _, td, _, tl = _train_attention_cases()[1]
    train, train_call, train_b, _ = _lowp_attention_times(
        torch, K, tb, th, ts, td, tl)
    fwd_row = dict(
        name="flash_fwd_bf16", route="cuda", source=src_f,
        replaces="mxnet_tpu/ops/pallas_kernels.py:219",
        max_abs_err=worst["flash_fwd_bf16"], ms=serve["fwd"],
        plain_ms=serve["fwd_plain"], bound_ms=serve_b["fwd"][0],
        bound_by=serve_b["fwd"][1], library_ms=serve["sdpa_fwd"],
        call_ms=serve_call["fwd"],
        per_shape=[dict(shape=[tb, th, ts, ts, td], lens=tl,
                        ms=train["fwd"], plain_ms=train["fwd_plain"],
                        bound_ms=train_b["fwd"][0],
                        bound_by=train_b["fwd"][1],
                        library_ms=train["sdpa_fwd"])])
    bwd_row = dict(
        name="flash_bwd_bf16", route="cuda", source=src_b,
        replaces="mxnet_tpu/ops/pallas_kernels.py:417",
        max_abs_err=worst["flash_bwd_bf16"], ms=train["fused"],
        plain_ms=train["bwd_plain"], bound_ms=train_b["fused"][0],
        bound_by=train_b["fused"][1], library_ms=train["sdpa_bwd"],
        call_ms=train_call["fused"])
    dq_row = dict(
        name="flash_bwd_dq_bf16", route="cuda", source=src_b,
        replaces="mxnet_tpu/ops/pallas_kernels.py:484",
        max_abs_err=worst["flash_bwd_dq_bf16"], library_ms=None)
    return [fwd_row, bwd_row, dq_row]


def _f16_cases():
    """(B, H, Sq, Sk, D, causal, kv_lengths) of the float16 checks: the
    serving prefill, the training step's three attentions (B=32, H=8,
    S=64, D=64, lengths 5-64), BERT's shape (B=16, H=12, S=512, D=64,
    `_bert_lengths`), and causal and key-length cases over both block
    shapes of the forward, both paths of the backward at DP = 64 and 128,
    one-key and zero-length rows, and D no multiple of 8 (the element
    copies)."""
    return [(1, 8, 128, 128, 64, False, [77]), *_train_attention_cases(),
            (BERT_B, BERT_H, BERT_S, BERT_S, 64, False,
             _bert_lengths(BERT_B)),
            (2, 3, 256, 300, 64, False, [290, 1]),
            (1, 2, 300, 170, 64, True, None),
            (2, 2, 300, 200, 128, True, [150, 200]),
            (1, 2, 40, 64, 128, True, [50]),
            (8, 16, 512, 512, 64, True, [512, 1, 0, 257, 1, 64, 511, 130]),
            (2, 2, 45, 45, 30, True, [45, 17])]


def phase_flash_f16(mx, torch):
    """The float16 flash kernels (`mxtt_flash_fwd_f16`,
    `mxtt_flash_bwd_f16`, `mxtt_flash_bwd_dq_f16`) against their float16
    plain versions and float64 on `_f16_cases` and a misaligned q
    (`_lowp_checks`, F16_* limits). Then timed by CUDA-graph
    replay beside SDPA in float16 and the plain versions: the forward at
    the serving prefill (its row), the training shape and BERT's; the
    fused backward at the training shape (its row) and, as dK / dV, at
    BERT's; the dQ kernel at BERT's (its row). Returns the three rows."""
    K = mx.ops.kernels
    F16 = torch.float16
    g = torch.Generator(device="cpu").manual_seed(15)
    worst = _lowp_checks(torch, K, g, F16, _f16_cases())
    serve, serve_call, serve_b, _ = _lowp_attention_times(
        torch, K, 1, 8, 128, 64, [77], backward=False, dtype=F16)
    tb, th, ts, _, td, _, tl = _train_attention_cases()[1]
    train, train_call, train_b, _ = _lowp_attention_times(
        torch, K, tb, th, ts, td, tl, dtype=F16)
    blens = _bert_lengths(BERT_B)
    bert, _, bert_b, bert_tf = _lowp_attention_times(
        torch, K, BERT_B, BERT_H, BERT_S, 64, blens, dtype=F16)
    bshape = [BERT_B, BERT_H, BERT_S, BERT_S, 64]
    src_f = "mxnet_tpu_torch/ops/csrc/flash_fwd.cu"
    src_b = "mxnet_tpu_torch/ops/csrc/flash_bwd.cu"
    fwd_row = dict(
        name="flash_fwd_f16", route="cuda", source=src_f,
        replaces="mxnet_tpu/ops/pallas_kernels.py:219",
        max_abs_err=worst["flash_fwd_f16"], ms=serve["fwd"],
        plain_ms=serve["fwd_plain"], bound_ms=serve_b["fwd"][0],
        bound_by=serve_b["fwd"][1], library_ms=serve["sdpa_fwd"],
        call_ms=serve_call["fwd"],
        per_shape=[dict(shape=[tb, th, ts, ts, td], lens=tl,
                        ms=train["fwd"], plain_ms=train["fwd_plain"],
                        bound_ms=train_b["fwd"][0],
                        bound_by=train_b["fwd"][1],
                        library_ms=train["sdpa_fwd"]),
                   dict(shape=bshape, lens=blens, ms=bert["fwd"],
                        plain_ms=bert["fwd_plain"],
                        bound_ms=bert_b["fwd"][0],
                        bound_by=bert_b["fwd"][1],
                        library_ms=bert["sdpa_fwd"], tflops=bert_tf["fwd"],
                        of_bound=bert["fwd"] / bert_b["fwd"][0],
                        of_library=bert["fwd"] / bert["sdpa_fwd"])])
    bwd_row = dict(
        name="flash_bwd_f16", route="cuda", source=src_b,
        replaces="mxnet_tpu/ops/pallas_kernels.py:417",
        max_abs_err=worst["flash_bwd_f16"], ms=train["fused"],
        plain_ms=train["bwd_plain"], bound_ms=train_b["fused"][0],
        bound_by=train_b["fused"][1], library_ms=train["sdpa_bwd"],
        call_ms=train_call["fused"],
        per_shape=[dict(shape=bshape, lens=blens, path="split",
                        ms=bert["fused"], bound_ms=bert_b["fused"][0],
                        bound_by=bert_b["fused"][1], pair_ms=bert["bwd"],
                        pair_bound_ms=bert_b["bwd"][0],
                        plain_ms=bert["bwd_plain"], library_ms=None,
                        pair_library_ms=bert["sdpa_bwd"],
                        tflops=bert_tf["fused"],
                        pair_tflops=bert_tf["bwd"],
                        of_bound=bert["fused"] / bert_b["fused"][0],
                        pair_of_library=bert["bwd"] / bert["sdpa_bwd"])])
    dq_row = dict(
        name="flash_bwd_dq_f16", route="cuda", source=src_b,
        replaces="mxnet_tpu/ops/pallas_kernels.py:484",
        max_abs_err=worst["flash_bwd_dq_f16"], ms=bert["dq"],
        plain_ms=bert["bwd_plain"], bound_ms=bert_b["dq"][0],
        bound_by=bert_b["dq"][1], library_ms=None, shape=bshape,
        pair_ms=bert["bwd"], pair_library_ms=bert["sdpa_bwd"],
        per_shape=[dict(shape=bshape, lens=blens, tflops=bert_tf["dq"],
                        of_bound=bert["dq"] / bert_b["dq"][0])])
    torch.cuda.empty_cache()
    return [fwd_row, bwd_row, dq_row]


def _phase_ln_16(mx, torch, dtype, timed_gamma):
    """A 16-bit LayerNorm kernel (x in `dtype`, bf16 or fp16) against
    `_ln_plain` (y the dtype's LOWP ln_tol, mean and rstd LN_TOL) with
    gamma / beta in fp32 and in x's dtype, at every width of `phase_ln`
    and its edge shapes, and at D = 2050, 9001 and 12000 (each launch
    form of `layer_norm.cu` at a checked width: 128 threads x 2 or 4
    chunks, 256 x 4, strided above 8192), two launches bit-identical;
    with gamma / beta that x's dtype represents, fp32 gamma / beta
    (aligned, and one element off 16-byte alignment) bit for bit against
    the same values in x's dtype; timed with gamma / beta in
    `timed_gamma` at LN_TIMED beside `F.layer_norm` on the same x and
    gamma / beta in x's dtype (it takes no other: 2 x 2 D bytes fewer
    than fp32 ones), beside the kernel with the other gamma dtype and,
    for the one-warp form, the launch floor of its grid, and at the MLM
    head's (1216, 768); BERT's shape (8192, 768) the row's own."""
    K = mx.ops.kernels
    lim = _lowp(dtype)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(13)
    worst = 0.0
    tag = f"{lim['label']} layer norm"
    for rows, d in [*LN_TIMED, (7, 512), (1, 512), (4099, 512), (7, 768),
                    (1, 1024), (13, 200), (1000, 1032), (3, 8192),
                    (1, 33), (5, 2050), (3, 9001), (5, 12000)]:
        for gdt in (torch.float32, dtype):
            x = (3 * torch.randn((rows, d), generator=g) + 1).to(dev).to(
                dtype)
            ga, be = (torch.randn(d, generator=g).to(dev).to(gdt)
                      for _ in range(2))
            got = K.layer_norm_fwd(x, ga, be, 1e-5)
            again = K.layer_norm_fwd(x, ga, be, 1e-5)
            ref = K._ln_plain(x, ga, be, 1e-5)
            torch.cuda.synchronize()
            check(got[0].dtype == dtype
                  and all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{tag} ({rows}, {d}): dtype {got[0].dtype} or two "
                  f"launches gave other bits")
            errs = [(a.float() - r.float()).abs().max().item()
                    for a, r in zip(got, ref)]
            check(torch.allclose(got[0].float(), ref[0].float(),
                                 **lim["ln_tol"])
                  and all(torch.allclose(a, r, **LN_TOL)
                          for a, r in zip(got[1:], ref[1:])),
                  f"{tag} kernel vs plain at ({rows}, {d}) gamma {gdt}: max "
                  f"abs errs (y, mean, rstd) {errs}")
            worst = max(worst, *errs)
            log(f"{tag} ({rows}, {d}) gamma {gdt}: max abs err (y, mean, "
                f"rstd) {errs} (y rtol={lim['ln_tol']['rtol']} "
                f"atol={lim['ln_tol']['atol']}; mean, rstd LN_TOL); repeat "
                f"bit-identical")
        # gamma / beta that x's dtype represents: fp32 gamma (16-byte
        # loads where vec holds) gives the bits of the same values in x's
        # dtype, and so does an fp32 gamma one element off 16-byte
        # alignment (vec 0: one masked load an element)
        x = (3 * torch.randn((rows, d), generator=g) + 1).to(dev).to(dtype)
        ga, be = (torch.randn(d, generator=g).to(dev).to(dtype)
                  for _ in range(2))
        shifted = torch.empty(d + 1, device=dev)[1:]
        shifted.copy_(ga.float())
        outs = [K.layer_norm_fwd(x, a, b, 1e-5) for a, b in (
            (ga, be), (ga.float(), be.float()), (shifted, be.float()))]
        torch.cuda.synchronize()
        check(K._vec_copies(d, x, shifted) == 0 and all(
            torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o)),
              f"{tag} ({rows}, {d}): fp32 gamma / beta (aligned, then "
              f"misaligned) gave other bits than the same values in "
              f"{dtype}")
    per_shape = []
    # LN_TIMED, and the MLM head's LayerNorm, the one a 16-bit BERT step
    # gives 16-bit x (BERT_B x BERT_P masked rows of 768)
    for rows, d in [*LN_TIMED, (BERT_B * BERT_P, 768)]:
        x = torch.randn((rows, d), generator=g).to(dev).to(dtype)
        ga, be = (torch.randn(d, generator=g).to(dev).to(timed_gamma)
                  for _ in range(2))
        # F.layer_norm takes gamma / beta of x's dtype only; the kernel
        # is timed with the other gamma dtype too
        lga, lbe = ga.to(dtype), be.to(dtype)
        other = dtype if timed_gamma == torch.float32 else torch.float32
        oga, obe = ga.to(other), be.to(other)
        fns = {"kernel": lambda x: K.layer_norm_fwd(x, ga, be, 1e-5),
               "other_gamma": lambda x: K.layer_norm_fwd(x, oga, obe, 1e-5),
               "plain": lambda x: K._ln_plain(x, ga, be, 1e-5),
               "torch": lambda x: torch.nn.functional.layer_norm(
                   x, (d,), lga, lbe, 1e-5)}
        call = cuda_ms(lambda: fns["kernel"](x))
        dev_ms = _ln_cold_ms(x, fns)
        # x and y once each (2 bytes an element), gamma and beta, fp32
        # mean and rstd
        gb = 4 if timed_gamma == torch.float32 else 2
        bms, by = bound(2 * 2 * rows * d + gb * 2 * d + 4 * 2 * rows,
                        8 * rows * d)
        row = dict(shape=[rows, d], ms=dev_ms["kernel"],
                   plain_ms=dev_ms["plain"], library_ms=dev_ms["torch"],
                   bound_ms=bms, bound_by=by, call_ms=call,
                   other_gamma=str(other).split(".")[-1],
                   other_gamma_ms=dev_ms["other_gamma"])
        if d <= 1024:
            # the one-warp form's grid (8 rows a 256-thread block) as an
            # empty kernel: where the bound lies under it, it is the floor
            row["launch_floor_ms"] = launch_floor_ms(mx, -(-rows // 8), 256)
        per_shape.append(row)
        log(f"{tag} ({rows}, {d}) gamma {timed_gamma}: device (CUDA graph, "
            f"x from HBM) {dev_ms}; per call (warm) {call:.5f}; bound "
            f"{bms:.6f} ms ({by}); launch floor "
            f"{row.get('launch_floor_ms')}; kernel / bound "
            f"{dev_ms['kernel'] / bms:.2f}, kernel / F.layer_norm "
            f"{dev_ms['kernel'] / dev_ms['torch']:.3f}, kernel / the same "
            f"with {other} gamma "
            f"{dev_ms['kernel'] / dev_ms['other_gamma']:.3f}")
    top = next(r for r in per_shape if r["shape"] == [BERT_B * BERT_S, 768])
    return dict(name="layer_norm" + mx.ops.kernels._suffix(dtype),
                route="cuda", source="mxnet_tpu_torch/ops/csrc/layer_norm.cu",
                replaces="mxnet_tpu/ops/pallas_kernels.py:1209",
                max_abs_err=worst,
                per_shape=[r for r in per_shape if r is not top],
                **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "call_ms",
                                       "launch_floor_ms")})


def phase_ln_bf16(mx, torch):
    """The bf16 LayerNorm kernel (`_phase_ln_16`), timed with bf16 gamma
    / beta, as `Block.cast` leaves them."""
    return _phase_ln_16(mx, torch, torch.bfloat16, torch.bfloat16)


def phase_ln_f16(mx, torch):
    """The float16 LayerNorm kernel (`_phase_ln_16`), timed with fp32
    gamma / beta, as float16 AMP leaves them (`_KEEP_FP32`), beside
    `F.layer_norm` in float16."""
    return _phase_ln_16(mx, torch, torch.float16, torch.float32)


def fp32_kernel_times(mx, torch):
    """{"<kernel> <shape>": device ms by CUDA-graph replay} of the fp32
    flash and LayerNorm kernels at their paths' shapes: the forward at
    the serving prefill, the training shape and BERT's; the fused
    backward at the training shape and, with the dQ kernel, at BERT's;
    LayerNorm at the training and BERT shapes. It calls only entries
    that earlier packages have too, so another checkout's package is
    measured the same way (`chip_train_ab.py --phase fp32`)."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(12)
    times = {}
    train = _train_attention_cases()[1]
    for tag, (b, h, s, d, lens) in (
            ("serving", (1, 8, 128, 64, [77])),
            ("training", (train[0], train[1], train[2], train[4],
                          train[6])),
            ("bert", (BERT_B, BERT_H, BERT_S, 64, _bert_lengths(BERT_B)))):
        q, k, v, do = [torch.randn((b, h, s, d), generator=g).to(dev)
                       for _ in range(4)]
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        times[f"flash_fwd {tag}"] = graph_ms(
            lambda: K.flash_attention_fwd(q, k, v, kv_lengths=vl), calls=5,
            iters=10)
        if tag == "serving":
            continue
        out, lse = K.flash_attention_fwd(q, k, v, kv_lengths=vl)
        delta = (out * do).sum(-1).reshape(b * h, s)
        args = (q, k, v, do, lse, delta, False, d ** -0.5, vl)
        plan = K.flash_bwd_plan(s, d)
        times[f"flash_bwd {tag}"] = graph_ms(
            lambda: K._flash_bwd_fused_cuda(*args, plan), calls=5, iters=10)
        if plan["path"] == "split":
            times[f"flash_bwd_dq {tag}"] = graph_ms(
                lambda: K._flash_bwd_dq_cuda(*args, plan), calls=5,
                iters=10)
    for rows, d in LN_TIMED[:2]:
        x, ga, be = [torch.randn(shape, generator=g).to(dev)
                     for shape in ((rows, d), (d,), (d,))]
        times[f"layer_norm ({rows}, {d})"] = graph_ms(
            lambda: K.layer_norm_fwd(x, ga, be, 1e-5))
    return times


def bf16_kernel_times(mx, torch):
    """{"<kernel> <shape>": device ms by CUDA-graph replay} of the bf16
    flash and LayerNorm kernels at their paths' shapes: the forward at
    the serving prefill, the training shape and BERT's; the backward at
    the training shape (the fused kernel, the whole backward); at BERT's
    the dK/dV kernel, the dQ kernel and the pair as `flash_attention_bwd`
    runs it; LayerNorm (bf16 gamma / beta) at the training and BERT
    shapes, D = 4096 and 8192. The counterpart of `fp32_kernel_times`:
    it calls
    only entries that earlier packages have too, so another checkout's
    package is measured the same way (`chip_train_ab.py --phase
    bf16`)."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(15)
    times = {}
    train = _train_attention_cases()[1]
    for tag, (b, h, s, d, lens) in (
            ("serving", (1, 8, 128, 64, [77])),
            ("training", (train[0], train[1], train[2], train[4],
                          train[6])),
            ("bert", (BERT_B, BERT_H, BERT_S, 64, _bert_lengths(BERT_B)))):
        q, k, v, do = _lowp_qkv(torch, g, b, h, s, s, d, 4)
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        times[f"flash_fwd_bf16 {tag}"] = graph_ms(
            lambda: K.flash_attention_fwd(q, k, v, kv_lengths=vl), calls=5,
            iters=10)
        if tag == "serving":
            continue
        out, lse = K.flash_attention_fwd(q, k, v, kv_lengths=vl)
        delta = (out.float() * do.float()).sum(-1).reshape(b * h, s)
        args = (q, k, v, do, lse, delta, False, d ** -0.5, vl)
        plan = K.flash_bwd_plan(s, d, torch.bfloat16)
        times[f"flash_bwd_bf16 {tag}"] = graph_ms(
            lambda: K._flash_bwd_fused_cuda(*args, plan), calls=5, iters=10)
        if plan["path"] == "split":
            times[f"flash_bwd_dq_bf16 {tag}"] = graph_ms(
                lambda: K._flash_bwd_dq_cuda(*args, plan), calls=5,
                iters=10)
            times[f"flash_bwd_pair_bf16 {tag}"] = graph_ms(
                lambda: K.flash_attention_bwd(*args), calls=5, iters=10)
    for rows, d in (LN_TIMED[0], LN_TIMED[1], LN_TIMED[4], LN_TIMED[5]):
        x = torch.randn((rows, d), generator=g).to(dev).to(torch.bfloat16)
        ga, be = (torch.randn(d, generator=g).to(dev).to(torch.bfloat16)
                  for _ in range(2))
        times[f"layer_norm_bf16 ({rows}, {d})"] = graph_ms(
            lambda: K.layer_norm_fwd(x, ga, be, 1e-5))
    return times


def bf16_backward_digest(mx, torch):
    """The SHA-256 (hex) of the bf16 backward pair's dQ, dK, dV bits at
    BERT's shape, from seeded inputs and an lse and delta that the plain
    version computes, so two packages' backward kernels see the same
    inputs whatever their forward: equal for two packages only if every
    bit is (`chip_train_ab.py --phase bf16` compares the sides')."""
    import hashlib
    K = mx.ops.kernels
    g = torch.Generator(device="cpu").manual_seed(16)
    b, h, s, d = BERT_B, BERT_H, BERT_S, 64
    q, k, v, do = _lowp_qkv(torch, g, b, h, s, s, d, 4)
    vl = torch.tensor(_bert_lengths(b), dtype=torch.int32, device=q.device)
    out, lse = K._flash_plain(q, k, v, False, d ** -0.5, vl)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, s)
    grads = K.flash_attention_bwd(q, k, v, do, lse.contiguous(), delta,
                                  False, d ** -0.5, vl)
    h256 = hashlib.sha256()
    for t in grads:
        h256.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h256.hexdigest()


def ln_fp32_digest(mx, torch):
    """The SHA-256 (hex) of the fp32 LayerNorm kernel's y, mean and rstd
    bits with fp32 gamma / beta at every width of LN_TIMED, from seeded
    inputs: equal for two packages only if every bit is
    (`chip_train_ab.py --phase fp32` compares the sides')."""
    import hashlib
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(17)
    h256 = hashlib.sha256()
    for rows, d in LN_TIMED:
        x, ga, be = [torch.randn(shape, generator=g).to(dev)
                     for shape in ((rows, d), (d,), (d,))]
        for t in K.layer_norm_fwd(3 * x + 1, ga, be, 1e-5):
            h256.update(t.contiguous().cpu().numpy().tobytes())
    return h256.hexdigest()


def conv1x1_kernel_times(mx, torch):
    """{"<kernel> (M, K, N)": device ms by CUDA-graph replay} of the
    conv1x1 + BN-stats kernel in fp32 and bf16 at the probe's four
    ResNet-50 shapes (`CONV1X1_SHAPES`), as `phase_conv1x1` times them;
    it calls only `conv1x1_bn_stats`, so another checkout's package is
    measured the same way (`chip_train_ab.py --phase conv`)."""
    K = mx.ops.kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    times = {}
    for dt, name in ((torch.float32, "conv1x1_bn_stats"),
                     (torch.bfloat16, "conv1x1_bn_stats_bf16")):
        for m, k, n in CONV1X1_SHAPES:
            x = torch.randn((m, k), generator=g, device=dev).to(dt)
            w = (torch.randn((k, n), generator=g, device=dev) * 0.05).to(dt)
            times[f"{name} ({m}, {k}, {n})"] = graph_ms(
                lambda x=x, w=w: K.conv1x1_bn_stats(x, w), calls=5, iters=10)
        times[f"{name} total"] = sum(
            v for key, v in times.items() if key.startswith(name + " ("))
    return times


def _train_batch(mx, b, s, ctx):
    """One fixed batch from numpy seed 0: source and target tokens,
    labels, and source lengths 16..s (all of them s when s < 16)."""
    rng = np.random.RandomState(0)
    toks = [rng.randint(4, VOCAB, (b, s)).astype(np.int32) for _ in range(3)]
    lens = rng.randint(min(16, s), s + 1, b).astype(np.int32)
    return [mx.nd.array(a, ctx=ctx) for a in (*toks, lens)]


def _train_step(mx, model, trainer, ce, batch, bench=False):
    """examples/nmt_translate.py's step (rescale_grad 1/B), or with
    `bench` bench_nmt.py's: the loss on the logits as fp32 (a cast
    model's are fp32 already) and the update on the mean loss's gradient
    as it is."""
    src, tgt, lab, vl = batch
    with mx.autograd.record():
        logits = model(src, tgt, vl)
        if bench:
            logits = logits.astype("float32")
        loss = ce(logits.reshape((-1, VOCAB)), lab.reshape((-1,))).mean()
    loss.backward()
    if trainer is not None:
        trainer.step(1 if bench else src.shape[0])
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
# bf16 training as bench_nmt.py runs it: TransformerNMT after cast
# ---------------------------------------------------------------------------
# kernel-name words of a profiled step's groups
GEMM_WORDS = ("gemm", "sgemm", "cutlass", "nvjet")
CONV_WORDS = ("conv", "xmma", "implicit", "fprop", "dgrad", "wgrad",
              "cudnn")


def _timed_steps(torch, K, step, n):
    """n calls of `step()` (a training step returning its loss), each
    ending in a synchronize, with the peak memory and the counters reset
    just before: (losses, each step's launches, each step's wall seconds,
    all launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, per_step, step_s = [], [], []
    for _ in range(n):
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        losses.append(step()._data.detach())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({k: K.LAUNCHES[k] - before[k] for k in before})
    return [float(x) for x in losses], per_step, step_s, dict(K.LAUNCHES)


def _profile_shares(tag, rows, groups):
    """Log each group's device ms and share of a profiled window's
    device time ({name: kernel-name words}, in order: a kernel counts in
    the first group one of whose words its name holds); returns {name:
    share}."""
    busy = sum(r[0] for r in rows)
    us = dict.fromkeys(groups, 0.0)
    for dev_us, _, key in rows:
        name = next((n for n, words in groups.items()
                     if any(w in key.lower() for w in words)), None)
        if name is not None:
            us[name] += dev_us
    for name, t in us.items():
        log(f"{tag}: {name} {t / 1e3:.3f} ms, {100 * t / busy:.1f} % of "
            f"device time")
    return {name: t / busy for name, t in us.items()}


def _nmt_bf16_batch(mx, b, s, ctx):
    """bench_nmt.py's batch: `_train_batch`'s tokens, every source at its
    full length s."""
    *toks, _ = _train_batch(mx, b, s, ctx)
    return [*toks, mx.nd.array(np.full(b, s, np.int32), ctx=ctx)]


def phase_nmt_train_bf16(mx, torch, init_file):
    """bench_nmt.py's bf16 training at full width: phase 5's initial
    weights (`init_file`), `model.cast("bfloat16")`, SGD at lr 1e-3 with
    momentum 0.9 through `gluon.Trainer` (bf16 weights and momentum), B
    = 64 of 64 + 64 tokens at full length, NMT_BF16_STEPS steps on one
    batch. The activations stay fp32, as in the JAX package (the
    positional add promotes the bf16 embeddings, every product promotes
    to fp32), so every step must launch the fp32 forms: 18 flash
    forwards, 18 fused backwards and 30 LayerNorms (bf16 gamma), and no
    bf16 form. Tokens/s (src + tgt) over steps 3 on and its spread,
    peak memory, one profiled step (busy share; fp32 GEMMs, the port's
    kernels), then NMT_TF32_STEPS steps timed again with TF32 matmuls
    on (restored after)."""
    K = mx.ops.kernels
    model = mx.models.transformer_base(VOCAB, max_length=TRAIN_S,
                                       dropout=0.0)
    model.load_parameters(init_file, ctx=mx.gpu(0))
    model.cast("bfloat16")
    params = model._collect_params_with_prefix()
    for name, p in params.items():
        check(p.data()._data.dtype == torch.bfloat16
              and p.data()._data.is_cuda, f"{name} not bf16 on the card")
    batch = _nmt_bf16_batch(mx, NMT_BF16_B, TRAIN_S, mx.gpu(0))
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": NMT_BF16_LR,
                                "momentum": NMT_BF16_MOMENTUM})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        return _train_step(mx, model, trainer, ce, batch, True)
    losses, per_step, step_s, launches = _timed_steps(torch, K, step,
                                                      NMT_BF16_STEPS)
    check(all(np.isfinite(losses)), f"non-finite bf16 NMT loss: {losses}")
    check(losses[-1] < losses[0], f"bf16 NMT loss did not fall: {losses}")
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd=18, flash_bwd=18,
                layer_norm=30)
    for i, counts in enumerate(per_step):
        check(counts == want, f"bf16 NMT step {i + 1} launches {counts} != "
                              f"{want}")
    for name, p in params.items():
        check(p.grad()._data.dtype == torch.bfloat16
              and p.grad()._data.is_cuda, f"{name}'s gradient not bf16 on "
                                          f"the card")
    tokens = NMT_BF16_B * TRAIN_S * 2
    timed = step_s[2:]
    tok_s = [tokens / t for t in timed]
    summary = dict(params=sum(p.numel() for p in model.parameters()),
                   dtype="bfloat16", batch=NMT_BF16_B, seq=TRAIN_S,
                   losses=losses, tokens_per_s=tokens * len(timed) /
                   sum(timed), tokens_per_s_min=min(tok_s),
                   tokens_per_s_max=max(tok_s),
                   step_ms=[t * 1e3 for t in step_s],
                   mean_step_ms=sum(timed) / len(timed) * 1e3,
                   launches=launches, attention_dtype="float32",
                   optimizer=f"sgd lr {NMT_BF16_LR} momentum "
                             f"{NMT_BF16_MOMENTUM}",
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("nmt bf16 training " + json.dumps(summary))
    got = device_profile(torch, step)
    if got is not None:
        log_profile("nmt bf16 profile", *got, "1 training step")
        _profile_shares("nmt bf16 profile", got[1],
                        {"fp32 GEMM": GEMM_WORDS,
                         "flash forward": ("flash_fwd",),
                         "flash backward": ("flash_bwd",),
                         "LayerNorm": ("layer_norm",)})
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, _, tf32_s, _ = _timed_steps(torch, K, step, 1 + NMT_TF32_STEPS)
        tf32_s = tf32_s[1:]                  # after one warm-up step
        got = device_profile(torch, step)
        if got is not None:
            log_profile("nmt bf16 tf32 profile", *got, "1 training step")
            _profile_shares("nmt bf16 tf32 profile", got[1],
                            {"fp32 GEMM (TF32)": GEMM_WORDS})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32 = [tokens / t for t in tf32_s]
    log(f"nmt bf16 training, TF32 matmuls on for {NMT_TF32_STEPS} steps "
        f"after one warm-up step (restored to "
        f"{torch.backends.cuda.matmul.allow_tf32}): "
        f"{tokens * len(tf32_s) / sum(tf32_s):.1f} tokens/s "
        f"({min(tf32):.1f}-{max(tf32):.1f}), against "
        f"{summary['tokens_per_s']:.1f} with TF32 off")
    del model, trainer, batch
    torch.cuda.empty_cache()
    return launches


def phase_nmt_card_vs_cpu_bf16(mx, torch, init_file):
    """Phase 6 for the cast model: phase 5's initial weights cut to 2
    layers at full width, cast to bf16 after loading, one step at B=2,
    S=16 (full lengths) on the card and on the CPU. Both compute in fp32
    on the same bf16 weights, so the loss agrees within TRAIN_LOSS_RTOL
    and each bf16 gradient, in norm, within NMT_BF16_GRAD_RTOL of the
    CPU's (NMT_BF16_EMBED_GRAD_RTOL for the tied embedding). The card
    must launch the fp32 forms only: 6 flash forwards, 6 fused
    backwards, 10 LayerNorms."""
    K = mx.ops.kernels
    results = {}
    for tag, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        model = mx.models.TransformerNMT(VOCAB, units=512, hidden=2048,
                                         num_layers=2, num_heads=8,
                                         max_length=TRAIN_S, dropout=0.0)
        model.load_parameters(init_file, ctx=ctx, ignore_extra=True)
        model.cast("bfloat16")
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        batch = _nmt_bf16_batch(mx, 2, 16, ctx)
        check(model(*batch[:2], batch[3])._data.dtype == torch.float32,
              "the cast NMT's logits are not fp32")
        K.reset_launch_counts()
        loss = _train_step(mx, model, None, ce, batch, True)
        results[tag] = (model, float(loss.asnumpy()), dict(K.LAUNCHES))
    (card, card_loss, launches), (cpu, cpu_loss, _) = (results["card"],
                                                       results["cpu"])
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd=6, flash_bwd=6,
                layer_norm=10)
    check(launches == want, f"bf16 NMT card step launches {launches} != "
                            f"{want}")
    check(abs(card_loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss),
          f"bf16 NMT card vs CPU loss {card_loss} vs {cpu_loss}")
    worst, cpu_params = (0.0, "", 0.0), cpu._collect_params_with_prefix()
    for name, p in card._collect_params_with_prefix().items():
        got, want_g = p.grad()._data, cpu_params[name].grad()._data
        check(got.dtype == want_g.dtype == torch.bfloat16,
              f"{name}: gradients {got.dtype}, {want_g.dtype}")
        got, want_g = got.double().cpu(), want_g.double()
        err = ((got - want_g).norm() / want_g.norm()).item()
        lim = NMT_BF16_EMBED_GRAD_RTOL if name == "embed.weight" \
            else NMT_BF16_GRAD_RTOL
        check(err <= lim, f"bf16 NMT card vs CPU gradient of {name}: "
                          f"norm-relative error {err} > {lim}")
        worst = max(worst, (err / lim, name, err))
    log(f"nmt bf16 card vs cpu (2 layers, B=2, S=16): loss {card_loss:.7f} "
        f"vs {cpu_loss:.7f} (rtol {TRAIN_LOSS_RTOL}); all {len(cpu_params)} "
        f"bf16 gradients within {NMT_BF16_GRAD_RTOL} in norm (embedding "
        f"{NMT_BF16_EMBED_GRAD_RTOL}); worst {worst[1]} at {worst[0]:.3f} "
        f"of its limit ({worst[2]:.3e}); card launches {launches}")


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


def phase_resnet_conv1x1(mx, torch, net, x, bf16_only=False):
    """The conv1x1 kernel fed the live activations of the ResNet-50 of
    `phase_resnet_train` (or, `bf16_only`, of the bf16 one of
    `phase_resnet_train_bf16`): one training-mode forward at B=128 with
    a hook on every stride-1 1x1 Conv2D (each feeds a BatchNorm in v1:
    16 expand, 13 reduce and the stage-1 downsample convolutions). With
    the counters zeroed, each hooked convolution's input goes through
    the kernel as (B*H*W, Cin) @ (Cin, Cout), in fp32 (not `bf16_only`)
    and in bf16; then y is held against the Conv2D's own output (fp32)
    or the float64 product of the bf16 operands, and the statistics
    against float64 ones."""
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
    outs = [(None if bf16_only else K.conv1x1_bn_stats(x2d, w2d),
             K.conv1x1_bn_stats(x2d.bfloat16(), w2d.bfloat16()))
            for x2d, w2d, _ in operands]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update(conv1x1_bn_stats_bf16=30)
    if not bf16_only:
        want.update(conv1x1_bn_stats=30)
    check(launches == want, f"live conv1x1 launches {launches} != {want}")
    worst = {"f32": {}, "bf16": {}}
    for (x2d, w2d, yconv), (f32, bf16) in zip(operands, outs):
        shape = tuple(x2d.shape) + (w2d.shape[1],)
        ok, errs16, lims = _conv1x1_errors(torch, x2d.bfloat16(),
                                           w2d.bfloat16(), bf16)
        check(ok, f"live conv1x1 {shape} bf16 vs float64: {errs16}, limits "
                  f"{lims}")
        for key, v in errs16.items():
            worst["bf16"][key] = max(worst["bf16"].get(key, 0.0), v)
        if f32 is None:
            continue
        y64 = yconv.double()
        err_y = (f32[0].double() - y64).abs().max().item()
        y_lim = CONV1X1_Y_RTOL * y64.abs().max().item()
        msq64 = (y64 * y64).mean(0)
        s_lim = CONV1X1_STATS_RTOL * msq64.abs().max().item() \
            + CONV1X1_STATS_ATOL
        errs = dict(y=err_y,
                    mean=(f32[1].double() - y64.mean(0)).abs().max().item(),
                    meansq=(f32[2].double() - msq64).abs().max().item())
        check(err_y <= y_lim and errs["mean"] <= s_lim
              and errs["meansq"] <= s_lim,
              f"live conv1x1 {shape} fp32 vs the Conv2D output: {errs}, "
              f"limits y {y_lim}, stats {s_lim}")
        for key, v in errs.items():
            worst["f32"][key] = max(worst["f32"].get(key, 0.0), v)
    shapes = sorted({tuple(o[0].shape) + (o[1].shape[1],) for o in operands})
    log(f"resnet conv1x1{' (bf16 net)' if bf16_only else ''}: 30 live "
        f"stride-1 1x1 convolutions, {len(shapes)} shapes {shapes}; worst "
        f"max abs errs {worst}; launches {launches}")
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
# bf16 training as bench.py runs it: ResNet-50 with the S2D stem, cast
# ---------------------------------------------------------------------------
def _resnet_s2d(mx, cut=False):
    """bench.py's ResNet-50 v1 (NHWC, the S2D stem), or at full width
    one bottleneck a stage (`cut`)."""
    vision = mx.gluon.model_zoo.vision
    if cut:
        return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                               [64, 256, 512, 1024, 2048], layout="NHWC",
                               stem_s2d=True)
    return vision.resnet50_v1(layout="NHWC", stem_s2d=True)


def _resnet_bf16_step(mx, net, trainer, ce, x, y):
    """bench.py's step: the cross-entropy on the logits cast to fp32,
    backward and, with a trainer, an update on the mean loss's gradient
    as it is."""
    with mx.autograd.record():
        loss = ce(net(x).astype("float32"), y).mean()
    loss.backward()
    if trainer is not None:
        trainer.step(1)
    return loss


def phase_resnet_train_bf16(mx, torch, init_file):
    """bench.py's bf16 ResNet-50 at full width and depth on the card:
    `resnet50_v1(layout="NHWC", stem_s2d=True)` on phase 7's initial
    weights (`init_file`: the S2D stem has the 7x7 stem's weight and
    name), `cast("bfloat16")`, SGD at lr 0.1 with momentum 0.9 in bf16,
    no weight decay, RESNET_STEPS steps at B=128 on phase 7's images in
    bf16. Every parameter bf16 on the card, the loss finite, every
    running statistic moving, no port kernel launched (the convolutions
    are cuDNN's, as XLA's in the JAX package). Images/s over steps 3 on
    and its spread, step ms, peak memory, one profiled step (busy share,
    the convolutions' share)."""
    K = mx.ops.kernels
    ctx = mx.gpu(0)
    net = _resnet_s2d(mx)
    net.load_parameters(init_file, ctx=ctx)
    net.cast("bfloat16")
    params = net._collect_params_with_prefix()
    for name, p in params.items():
        check(p.data()._data.dtype == torch.bfloat16
              and p.data()._data.is_cuda, f"{name} not bf16 on the card")
    x, y = _resnet_batch(mx, RESNET_B, ctx)
    x = x.astype("bfloat16")
    stats0 = {n: p.data()._data.clone() for n, p in params.items()
              if n.endswith(("running_mean", "running_var"))}
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": RESNET_BF16_LR,
                                "momentum": RESNET_BF16_MOMENTUM})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        return _resnet_bf16_step(mx, net, trainer, ce, x, y)
    losses, _, step_s, launches = _timed_steps(torch, K, step, RESNET_STEPS)
    check(all(np.isfinite(losses)), f"non-finite bf16 ResNet loss: {losses}")
    check(sum(launches.values()) == 0,
          f"the bf16 ResNet step launched a port kernel: {launches}")
    moved = sum(not torch.equal(p.data()._data, stats0[n])
                for n, p in params.items() if n in stats0)
    check(moved == len(stats0), f"{len(stats0) - moved} running statistics "
                                f"did not move")
    for name, p in params.items():
        check(p.data()._data.dtype == torch.bfloat16,
              f"{name} left bf16 in training")
    timed = step_s[2:]
    img_s = [RESNET_B / t for t in timed]
    summary = dict(model="resnet50_v1", layout="NHWC", stem_s2d=True,
                   dtype="bfloat16", batch=RESNET_B,
                   params=sum(p.data().size for p in params.values()
                              if p.grad_req != "null"),
                   losses=losses,
                   images_per_s=RESNET_B * len(timed) / sum(timed),
                   images_per_s_min=min(img_s), images_per_s_max=max(img_s),
                   step_ms=[t * 1e3 for t in step_s],
                   mean_step_ms=sum(timed) / len(timed) * 1e3,
                   launches=launches, running_stats_moved=moved,
                   optimizer=f"sgd lr {RESNET_BF16_LR} momentum "
                             f"{RESNET_BF16_MOMENTUM}",
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("resnet bf16 training " + json.dumps(summary))
    got = device_profile(torch, step)
    if got is not None:
        log_profile("resnet bf16 profile", *got, "1 training step")
        _profile_shares("resnet bf16 profile", got[1],
                        {"convolutions (cuDNN's kernels, GEMMs included)":
                         CONV_WORDS + GEMM_WORDS,
                         "copies (layout and dtype)": ("copy",),
                         "reductions (BatchNorm statistics)":
                         ("reduce_kernel",),
                         "other elementwise (BatchNorm, ReLU, adds, SGD)":
                         ("elementwise",)})
    return net, x, launches, summary


def pack_image(rng, h=None, w=None):
    """One HWC uint8 image of phase 7p's pack from the numpy Generator
    `rng`: short side PACK_SHORT and long side drawn from PACK_LONG,
    portrait or landscape (or h x w); six sinusoids a channel plus N(0, 6)
    noise, a smooth field whose JPEG has a photo's size rather than
    noise's. A channel's six sin(fx x + fy y + phase) are one sum of
    outer products of their separable halves (`einsum`: no BLAS thread
    pool beside the host pipeline this phase measures)."""
    if h is None:
        long_side = int(rng.integers(PACK_LONG[0], PACK_LONG[1] + 1))
        h, w = (PACK_SHORT, long_side) if rng.random() < 0.5 \
            else (long_side, PACK_SHORT)
    y = np.arange(h, dtype=np.float32)
    x = np.arange(w, dtype=np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fx, fy = rng.uniform(0.005, 0.08, (2, 6)).astype(np.float32)
        amp = rng.uniform(10, 40, (6, 1)).astype(np.float32)
        phase = rng.uniform(0, 6.3, (6, 1)).astype(np.float32)
        a = np.outer(fx, x) + phase                 # (6, w)
        b = np.outer(fy, y)                         # (6, h)
        img[..., c] = np.einsum(
            "kh,kw->hw", np.concatenate([np.cos(b), np.sin(b)]),
            np.concatenate([amp * np.sin(a), amp * np.cos(a)]))
    img += 128.0
    img += 6.0 * rng.standard_normal(img.shape, dtype=np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _pack_augmenters(mx):
    return mx.image.CreateAugmenter((3, 224, 224), resize=256,
                                    rand_crop=True, rand_mirror=True,
                                    mean=True, std=True)


def _image_folder_check(mx, torch, root, ctx):
    """PACK_FOLDER_FILES images (JPEG and PNG by turns, two classes)
    written as files under `root`, read by `ImageFolderDataset` through a
    `DataLoader` on the card as one batch: the batch on the card, its
    labels the files' classes, each image its source (PNG bit for bit,
    JPEG within PACK_PSNR_DB). Returns {format: worst PSNR}."""
    rng = np.random.default_rng(1)
    sources = []
    for k in range(PACK_FOLDER_FILES):
        cls = k % 2
        fmt = ".jpg" if (k // 2) % 2 == 0 else ".png"
        img = pack_image(rng, PACK_FOLDER_SIDE, PACK_FOLDER_SIDE)
        head = mx.recordio.IRHeader(0, float(cls), k, 0)
        _, payload = mx.recordio.unpack(mx.recordio.pack_img(
            head, img, quality=PACK_QUALITY, img_fmt=fmt))
        os.makedirs(os.path.join(root, f"class{cls}"), exist_ok=True)
        path = os.path.join(root, f"class{cls}", f"{k:02d}{fmt}")
        with open(path, "wb") as f:
            f.write(payload)
        sources.append((path, cls, fmt, img))
    ds = mx.gluon.data.vision.ImageFolderDataset(root)
    check(ds.synsets == ["class0", "class1"] and len(ds) ==
          PACK_FOLDER_FILES, f"ImageFolderDataset: {ds.synsets}, {len(ds)}")
    loader = mx.gluon.data.DataLoader(ds, batch_size=PACK_FOLDER_FILES,
                                      ctx=ctx)
    data, label = next(iter(loader))
    check(data._data.is_cuda and data.shape == (
        PACK_FOLDER_FILES, PACK_FOLDER_SIDE, PACK_FOLDER_SIDE, 3)
        and data.dtype == np.uint8, f"folder batch {data.shape} "
        f"{data.dtype} on {data.context}")
    by_path = {p: (c, f, img) for p, c, f, img in sources}
    got = data.asnumpy()
    psnr = {".jpg": float("inf"), ".png": float("inf")}
    for i, (path, cls) in enumerate(ds.items):
        c, fmt, img = by_path[path]
        check(int(label.asnumpy()[i]) == c == cls, f"folder label of "
                                                    f"{path}")
        if fmt == ".png":
            check(np.array_equal(got[i], img), f"PNG {path} not bit for bit")
        else:
            psnr[fmt] = min(psnr[fmt], _psnr(got[i], img))
    check(psnr[".jpg"] >= PACK_PSNR_DB, f"folder JPEG PSNR {psnr}")
    return psnr


def phase_resnet_pack_bf16(mx, torch, init_file, memory_images_s):
    """Phase 7p (module docstring): phase 7b's model and SGD fed from a
    JPEG RecordIO pack through `image.ImageIter` and
    `io.PrefetchingIter(prefetch_to_device=mx.gpu(0))`; then phase 8b's
    conv1x1 check on the pack-fed net, whose launches it returns (the
    path `resnet_pack_bf16`, counted from 0)."""
    K = mx.ops.kernels
    reg = mx.observability.registry()
    ctx = mx.gpu(0)
    t_phase = time.perf_counter()
    out = dict(records=PACK_RECORDS, batch=RESNET_B, steps=RESNET_STEPS,
               quality=PACK_QUALITY)
    tmp = tempfile.mkdtemp(prefix="mxtt_imgpack_")
    try:
        # -------------------------------------------------------- the pack
        rec, idx = os.path.join(tmp, "train.rec"), os.path.join(tmp,
                                                                 "train.idx")
        rng = np.random.default_rng(0)
        writer = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
        gen_s = write_s = 0.0
        nbytes, first, labels = 0, None, []
        for i in range(PACK_RECORDS):
            t0 = time.perf_counter()
            img = pack_image(rng)
            label = int(rng.integers(0, 1000))
            t1 = time.perf_counter()
            s = mx.recordio.pack_img(mx.recordio.IRHeader(0, float(label), i,
                                                          0), img,
                                     quality=PACK_QUALITY, img_fmt=".jpg")
            writer.write_idx(i, s)
            gen_s += t1 - t0
            if first is None:       # g++ builds the codec at first use
                first = (s, img)
                out["first_record_s"] = time.perf_counter() - t1
            else:
                write_s += time.perf_counter() - t1
            nbytes += len(s)
            labels.append(label)
        t0 = time.perf_counter()
        writer.close()
        out.update(pack_write_s=write_s + time.perf_counter() - t0,
                   image_gen_s=gen_s, mean_record_bytes=nbytes / PACK_RECORDS,
                   pack_bytes=os.path.getsize(rec))
        head, back = mx.recordio.unpack_img(first[0], iscolor=1)
        out["first_record_psnr_db"] = _psnr(back, first[1])
        check(back.shape == first[1].shape and head.label == labels[0]
              and out["first_record_psnr_db"] >= PACK_PSNR_DB,
              f"record 0 decodes to {back.shape}, label {head.label}, "
              f"{out['first_record_psnr_db']:.2f} dB")

        # ------------------------ host decode and augment, on this thread
        reader = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
        raws = [reader.read_idx(k) for k in range(RESNET_B)]
        reader.close()
        t0 = time.perf_counter()
        decoded = [mx.recordio.unpack_img(r)[1] for r in raws]
        out["host_decode_ms_per_record"] = (time.perf_counter() - t0) \
            / RESNET_B * 1e3
        augs = _pack_augmenters(mx)
        np.random.seed(0)
        t0 = time.perf_counter()
        for img in decoded:
            x = mx.nd.array(img, ctx=mx.cpu())
            for aug in augs:
                x = aug(x)
        out["host_augment_ms_per_batch"] = (time.perf_counter() - t0) * 1e3
        check(x.shape == (224, 224, 3) and x.dtype == np.float32,
              f"augmented image {x.shape} {x.dtype}")
        del raws, decoded

        # ------------------------------------------------------- the model
        net = _resnet_s2d(mx)
        net.load_parameters(init_file, ctx=ctx)
        net.cast("bfloat16")
        params = net._collect_params_with_prefix()
        for name, p in params.items():
            check(p.data()._data.dtype == torch.bfloat16
                  and p.data()._data.is_cuda, f"{name} not bf16 on the card")
        stats0 = {n: p.data()._data.clone() for n, p in params.items()
                  if n.endswith(("running_mean", "running_var"))}
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": RESNET_BF16_LR,
                                    "momentum": RESNET_BF16_MOMENTUM})
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

        def pack_iter():
            it = mx.image.ImageIter(RESNET_B, (3, 224, 224), path_imgrec=rec,
                                    path_imgidx=idx, shuffle=True,
                                    aug_list=_pack_augmenters(mx))
            return mx.io.PrefetchingIter(it, prefetch_to_device=ctx)

        def step_inputs(batch):
            # the user's NCHW float32 -> NHWC bf16, on the card
            return (batch.data[0].transpose(0, 2, 3, 1).astype("bfloat16"),
                    batch.label[0])

        # ------------------------------- the main path, counters from 0
        np.random.seed(0)
        pf = pack_iter()
        starved0 = reg.counter("prefetch_starved").value
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        losses, step_s, x0 = [], [], None
        for _ in range(RESNET_STEPS):
            t0 = time.perf_counter()
            x, y = step_inputs(pf.next())
            if x0 is None:
                x0, y0 = x, y
            losses.append(_resnet_bf16_step(mx, net, trainer, ce, x, y)
                          ._data.detach())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        step_launches = dict(K.LAUNCHES)
        out["prefetch_starved"] = (reg.counter("prefetch_starved").value
                                   - starved0)
        losses = [float(v) for v in losses]
        check(x0.shape == (RESNET_B, 224, 224, 3) and x0._data.dtype ==
              torch.bfloat16 and x0._data.is_cuda and bool(
                  torch.isfinite(x0._data).all()), f"pack batch {x0.shape} "
              f"{x0._data.dtype} on {x0.context}")
        ys = y0.asnumpy()
        check(ys.shape == (RESNET_B,) and ys.min() >= 0 and ys.max() < 1000
              and set(ys.astype(int)) <= set(labels), f"pack labels {ys}")
        check(all(np.isfinite(losses)), f"non-finite pack-fed loss: {losses}")
        check(sum(step_launches.values()) == 0, f"the pack-fed bf16 ResNet "
                                                f"step launched a port "
                                                f"kernel: {step_launches}")
        moved = sum(not torch.equal(p.data()._data, stats0[n])
                    for n, p in params.items() if n in stats0)
        check(moved == len(stats0), f"{len(stats0) - moved} running "
                                    f"statistics did not move")
        for name, p in params.items():
            check(p.data()._data.dtype == torch.bfloat16,
                  f"{name} left bf16 in training")
        timed = step_s[2:]
        img_s = [RESNET_B / t for t in timed]
        out.update(losses=losses, images_per_s=RESNET_B * len(timed)
                   / sum(timed), images_per_s_min=min(img_s),
                   images_per_s_max=max(img_s),
                   step_ms=[t * 1e3 for t in step_s],
                   memory_images_per_s=memory_images_s,
                   running_stats_moved=moved,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out["pack_over_memory"] = out["images_per_s"] / memory_images_s

        pf.close()

        # ------------ the input path's sync calls, on a fresh iterator
        syncs = {}
        pf = pack_iter()
        for _ in range(PACK_SYNC_STEPS):
            with _sync_calls(torch, syncs, "input"):
                x, y = step_inputs(pf.next())
            with _sync_calls(torch, syncs, "step"):
                _resnet_bf16_step(mx, net, trainer, ce, x, y)
        pf.close()
        torch.cuda.synchronize()
        out["sync_calls"] = syncs

        # --------------------------- ImageRecordIter over the same pack
        kw = dict(path_imgrec=rec, data_shape=(3, 224, 224),
                  batch_size=RESNET_B, mean_r=PACK_MEAN[0],
                  mean_g=PACK_MEAN[1], mean_b=PACK_MEAN[2],
                  std_r=PACK_STD[0], std_g=PACK_STD[1], std_b=PACK_STD[2])
        on_card = mx.io.ImageRecordIter(**kw)
        on_host = mx.io.ImageRecordIter(ctx=mx.cpu(), **kw)
        t0 = time.perf_counter()
        for b in range(PACK_RECORD_ITER_BATCHES):
            got = on_card.next()
            torch.cuda.synchronize()
            want = on_host.next()
            g, w = got.data[0]._data, want.data[0]._data
            check(g.is_cuda and tuple(g.shape) == (RESNET_B, 3, 224, 224)
                  and torch.equal(g.cpu(), w) and torch.equal(
                      got.label[0]._data.cpu(), want.label[0]._data)
                  and bool(torch.isfinite(w).all()), f"ImageRecordIter "
                  f"batch {b} on the card differs from the host's")
            check(np.array_equal(want.label[0].asnumpy(), np.asarray(
                labels[b * RESNET_B:(b + 1) * RESNET_B], np.float32)),
                f"ImageRecordIter batch {b} labels")
        out["record_iter_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 \
            / (2 * PACK_RECORD_ITER_BATCHES)
        out["record_iter_skipped"] = on_card.records_skipped

        # ---------------------------------------- an image folder, once
        out["folder_psnr_db"] = _image_folder_check(
            mx, torch, os.path.join(tmp, "folder"), ctx)

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        out["card"] = smi.stdout.strip()
        out["phase_s"] = time.perf_counter() - t_phase
        log("resnet pack bf16 " + json.dumps(out))
        launches = phase_resnet_conv1x1(mx, torch, net, x0, bf16_only=True)
        del net, trainer, x0, x, y
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _resnet_cut_step(mx, ctx, init_file, bf16):
    """(loss, {name: fp32 gradient on the CPU}, {name: running statistic
    after the step}, launches) of one SGD step of the cut S2D ResNet
    (`_resnet_s2d(cut=True)`) at B=4 from `init_file` on `ctx`, cast to
    bf16 or not, the loss on fp32 logits."""
    K = mx.ops.kernels
    net = _resnet_s2d(mx, cut=True)
    net.load_parameters(init_file, ctx=ctx, ignore_extra=True)
    x, y = _resnet_batch(mx, 4, ctx)
    if bf16:
        net.cast("bfloat16")
        x = x.astype("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": RESNET_BF16_LR,
                                "momentum": RESNET_BF16_MOMENTUM})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    K.reset_launch_counts()
    with mx.autograd.record():
        loss = ce(net(x).astype("float32"), y).mean()
    loss.backward()
    params = net._collect_params_with_prefix()
    grads = {n: p.grad()._data.double().cpu() for n, p in params.items()
             if p.grad_req != "null"}
    trainer.step(1)
    stats = {n: p.data()._data.double().cpu() for n, p in params.items()
             if p.grad_req == "null"}
    return float(loss.asnumpy()), grads, stats, dict(K.LAUNCHES)


def phase_resnet_card_vs_cpu_bf16(mx, torch, init_file):
    """Phase 9 for bench.py's bf16 ResNet, cut to one bottleneck a stage
    at full width, on phase 7's initial weights: one SGD step at B=4 in
    bf16 on the card and on the CPU, each held against the same step in
    fp32 on the CPU. The card's loss, and each gradient and running
    statistic in norm, no further from the fp32 step than BF16_F64_RATIO
    times the CPU bf16 step's distance (that parameter's or the median
    of its kind, the larger: a few ReLU kinks decide one parameter's),
    plus BF16_F64_FLOOR of its scale. No port kernel launches."""
    card = _resnet_cut_step(mx, mx.gpu(0), init_file, True)
    cpu = _resnet_cut_step(mx, mx.cpu(), init_file, True)
    ref = _resnet_cut_step(mx, mx.cpu(), init_file, False)
    check(sum(card[3].values()) == 0, f"the bf16 ResNet step launched a "
                                      f"port kernel: {card[3]}")
    d_card, d_cpu = abs(card[0] - ref[0]), abs(cpu[0] - ref[0])
    check(np.isfinite(card[0]) and d_card <= BF16_F64_RATIO * d_cpu
          + BF16_F64_FLOOR * abs(ref[0]),
          f"bf16 ResNet loss: card {card[0]}, cpu {cpu[0]}, fp32 {ref[0]}")
    report = {}
    for i, kind in ((1, "gradient"), (2, "running statistic")):
        check(set(card[i]) == set(cpu[i]) == set(ref[i]) and ref[i],
              f"bf16 ResNet {kind} names differ")
        rel = {}
        for n, r in ref[i].items():
            scale = max(r.norm().item(), 1e-30)
            rel[n] = ((card[i][n] - r).norm().item() / scale,
                      (cpu[i][n] - r).norm().item() / scale)
        typical = float(np.median([dp for _, dp in rel.values()]))
        worst = (0.0, "", 0.0, 0.0)
        for n, (dc, dp) in rel.items():
            lim = BF16_F64_RATIO * max(dp, typical) + BF16_F64_FLOOR
            check(dc <= lim, f"bf16 ResNet {kind} {n}: card {dc:.4e}, cpu "
                             f"{dp:.4e} from the fp32 step (relative "
                             f"norms; median cpu {typical:.4e})")
            worst = max(worst, (dc / lim, n, dc, dp))
        report[kind] = dict(count=len(rel), median_cpu=typical,
                            worst_share=worst[0], worst=worst[1],
                            card=worst[2], cpu=worst[3])
    log(f"resnet bf16 card vs cpu (cut to [1, 1, 1, 1], B=4): loss card "
        f"{card[0]:.6f}, cpu {cpu[0]:.6f}, fp32 {ref[0]:.6f}; within "
        f"{BF16_F64_RATIO}x max(the cpu bf16 step's distance from fp32, "
        f"its kind's median) + {BF16_F64_FLOOR} (relative norms): "
        + json.dumps(report))


def phase_stem_s2d(mx, torch):
    """`ops.nn_ops.stem_conv_s2d` against the plain 7x7 / stride-2 /
    pad-3 NHWC `convolution` on the card at STEM_SHAPE, fp32 and bf16:
    y and the weight gradient of sum(y * dy), each against float64
    (STEM_F32_* / BF16_F64_* rules); both timed forward and forward +
    backward."""
    nn_ops = mx.ops.nn_ops
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(15)
    n, h, w, c = STEM_SHAPE
    x0 = torch.rand(STEM_SHAPE, generator=g).to(dev)
    w0 = (torch.randn((64, 7, 7, c), generator=g) * 0.1).to(dev)
    dy0 = torch.randn((n, h // 2, w // 2, 64), generator=g).to(dev)
    fns = {"s2d": nn_ops.stem_conv_s2d,
           "plain": lambda a, b: nn_ops.convolution(a, b, None, 2, 3,
                                                    layout="NHWC")}

    def run(fn, dt, in_f64=False):
        """(y, dw) of `fn` on x0, w0 and the cotangent dy0 in `dt`, or
        (in_f64) on their `dt` values in float64."""
        cast = (lambda t: t.to(dt).double()) if in_f64 \
            else (lambda t: t.to(dt))
        wt = cast(w0).detach().requires_grad_()
        y = fn(cast(x0), wt)
        y.backward(cast(dy0))
        return y.detach(), wt.grad
    report = {}
    for dt, ratio, floor in ((torch.float32, STEM_F32_RATIO, STEM_F32_FLOOR),
                             (torch.bfloat16, BF16_F64_RATIO,
                              BF16_F64_FLOOR)):
        ref = run(fns["plain"], dt, in_f64=True)
        got = {k: run(fn, dt) for k, fn in fns.items()}
        torch.cuda.synchronize()
        tag = str(dt).split(".")[-1]
        for i, what in ((0, "y"), (1, "dw")):
            e = {k: (v[i].double() - ref[i]).abs().max().item()
                 for k, v in got.items()}
            lim = ratio * e["plain"] + floor * ref[i].abs().max().item()
            check(got["s2d"][i].dtype == dt and e["s2d"] <= lim,
                  f"stem_conv_s2d {tag} {what}: {e['s2d']} from float64, "
                  f"plain convolution {e['plain']}, limit {lim}")
            report[f"{tag} {what}"] = dict(s2d=e["s2d"], plain=e["plain"],
                                           limit=lim)
        xs, ws = x0.to(dt), w0.to(dt).detach().requires_grad_()
        for k, fn in fns.items():
            report[f"{tag} {k} fwd ms"] = cuda_ms(lambda: fn(xs, ws.detach()),
                                                  iters=20)
            report[f"{tag} {k} fwd+bwd ms"] = cuda_ms(
                lambda: fn(xs, ws).sum().backward(), iters=20)
    log(f"stem_conv_s2d vs the plain 7x7 convolution at {STEM_SHAPE} "
        f"(max abs errors from float64): " + json.dumps(report))


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


def _bert_step(mx, model, trainer, ce, batch, bench=False):
    """examples/bert_pretrain.py's step: the MLM and NSP cross-entropies,
    backward, and (with a trainer) an update with rescale_grad 1/B. With
    `bench`, bench_bert.py's: the losses on the logits cast to fp32
    (bench_bert.py:60-61), and the update on the batch-mean loss's
    gradient as it is (rescale_grad 1)."""
    tok, seg, vl, pos, mlm_y, nsp_y = batch
    with mx.autograd.record():
        mlm, nsp = model(tok, seg, vl, pos)
        if bench:
            mlm, nsp = mlm.astype("float32"), nsp.astype("float32")
        loss = ce(mlm.reshape((-1, BERT_VOCAB)),
                  mlm_y.reshape((-1,))).mean() + ce(nsp, nsp_y).mean()
    loss.backward()
    if trainer is not None:
        trainer.step(1 if bench else tok.shape[0])
    return loss


def _bert_pretraining(mx, num_layers=None, num_heads=BERT_H):
    """BERTForPretraining over bert_base (max_length 512, dropout 0), or
    a full-width BERT of `num_layers` layers (12 when None) and
    `num_heads` heads (BERT_WIDE_H: three of 256)."""
    if num_layers is None and num_heads == BERT_H:
        bert = mx.models.bert_base(max_length=BERT_S, dropout=0.0)
    else:
        bert = mx.models.BERTModel(BERT_VOCAB, units=768, hidden_size=3072,
                                   num_layers=num_layers or 12,
                                   num_heads=num_heads, max_length=BERT_S,
                                   dropout=0.0)
    return mx.models.BERTForPretraining(bert)


def _bert_train_loop(mx, torch, model, trainer, batch, bench):
    """BERT_STEPS steps of `_bert_step` on one batch (`_timed_steps`)."""
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return _timed_steps(torch, mx.ops.kernels, lambda: _bert_step(
        mx, model, trainer, ce, batch, bench), BERT_STEPS)


def _bert_train_report(mx, torch, tag, model, trainer, batch, bench, losses,
                       per_step, step_s, launches, want, **extra):
    """Check a BERT training run (finite and falling loss, `want`
    launches every step, parameters and gradients on the card), log its
    summary (tokens/s as B * S a step over the wall time of steps 3 on,
    the per-step spread, peak memory) and profile one more step: busy
    share, the GEMM and port kernels' shares and rows. Returns the
    summary, with the profiled step's shares of device time by group
    (`device_shares`) where the profiler traced the card."""
    check(all(np.isfinite(losses)), f"non-finite {tag} loss: {losses}")
    check(losses[-1] < losses[0], f"{tag} loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        check(counts == want, f"{tag} step {i + 1} launches {counts} != "
                              f"{want}")
    for name, p in model._collect_params_with_prefix().items():
        check(p.data()._data.is_cuda and p.grad()._data.is_cuda,
              f"{name} or its gradient is not on the card")
    timed = step_s[2:]
    tok_s = [BERT_B * BERT_S / t for t in timed]
    summary = dict(params=sum(p.numel() for p in model.parameters()),
                   batch=BERT_B, seq=BERT_S, masked=BERT_P,
                   lengths=batch[2].asnumpy().tolist(), losses=losses,
                   tokens_per_s=BERT_B * BERT_S * len(timed) / sum(timed),
                   tokens_per_s_min=min(tok_s), tokens_per_s_max=max(tok_s),
                   step_ms=[t * 1e3 for t in step_s], launches=launches,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   **extra)
    log(f"{tag} " + json.dumps(summary))
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    prof = tag.replace("training", "profile")
    groups = {"flash forward": ("flash_fwd",),
              "split backward": ("flash_bwd",),
              "wide forward": ("wide_fwd",),
              "wide dK/dV": ("wide_dkv",), "wide dQ": ("wide_dq",),
              "LayerNorm": ("layer_norm",), "GEMM": GEMM_WORDS}
    got = device_profile(torch, lambda: _bert_step(mx, model, trainer, ce,
                                                   batch, bench))
    if got is not None:
        log_profile(prof, *got, "1 training step")
        summary["device_shares"] = _profile_shares(prof, got[1], groups)
        for dev_us, count, key in got[1]:
            if "flash" in key or "wide" in key or "layer_norm" in key:
                log(f"{prof}: port kernel {dev_us / 1e3:.3f} ms "
                    f"{count}x {key[:70]}")
    return summary


def phase_bert_train(mx, torch, init_file):
    """examples/bert_pretrain.py's Gluon loop on full-width bert_base in
    fp32 at bench_bert.py's shape (B=16, S=512, 76 masked positions),
    Adam at 1e-4, BERT_STEPS steps on one fixed batch. The counters are
    zeroed just before and read just after: every step must launch 12
    flash forwards, 12 fused and 12 dQ backward kernels (S = 512 takes
    the split path) and 2 x 12 + 2 LayerNorms. Tokens/s (B * S a step
    over the summed wall time of steps 3 on), the per-step spread, peak
    memory, then one step under torch.profiler. The initial weights go
    to `init_file` for the card-vs-CPU phases."""
    K = mx.ops.kernels
    mx.random.seed(0)
    model = _bert_pretraining(mx)
    model.initialize(ctx=mx.gpu(0))
    model.save_parameters(init_file)
    batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
    trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": 1e-4})
    losses, per_step, step_s, launches = _bert_train_loop(
        mx, torch, model, trainer, batch, False)
    n = len(model.bert.encoder.layers)
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd=n, flash_bwd=n,
                flash_bwd_dq=n, layer_norm=2 * n + 2)
    _bert_train_report(mx, torch, "bert training", model, trainer, batch,
                       False, losses, per_step, step_s, launches, want)
    del model, trainer, batch
    torch.cuda.empty_cache()
    return launches


def phase_bert_train_bf16(mx, torch):
    """Phase 11 in bf16, as bench_bert.py builds it: the same
    `bert_base` from `mx.random.seed(0)`, `model.cast("bfloat16")`, SGD
    at lr 1e-3 with momentum 0.9 through `gluon.Trainer` (the weights
    and the momentum in bf16, as bench_bert.py's make_sgd_step keeps
    them), the MLM + NSP losses on logits cast to fp32, the update on
    the batch-mean loss's gradient; BERT_STEPS steps on phase 11's
    batch. Every step must launch the bf16 forms only: 12 flash
    forwards, 12 fused and 12 dQ backward kernels, 2 x 12 + 2
    LayerNorms. Logged beside phase 11: tokens/s and its spread, peak
    memory, one profiled step. Returns the launches and the summary."""
    K = mx.ops.kernels
    log(f"bf16: torch.backends.cuda.matmul."
        f"allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    mx.random.seed(0)
    model = _bert_pretraining(mx)
    model.initialize(ctx=mx.gpu(0))
    model.cast("bfloat16")
    for name, p in model._collect_params_with_prefix().items():
        check(p.data()._data.dtype == torch.bfloat16
              and p.grad()._data.dtype == torch.bfloat16,
              f"{name} not bf16 after cast")
    batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": BERT_BF16_LR,
                                "momentum": BERT_BF16_MOMENTUM})
    losses, per_step, step_s, launches = _bert_train_loop(
        mx, torch, model, trainer, batch, True)
    n = len(model.bert.encoder.layers)
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd_bf16=n,
                flash_bwd_bf16=n, flash_bwd_dq_bf16=n,
                layer_norm_bf16=2 * n + 2)
    summary = _bert_train_report(
        mx, torch, "bert bf16 training", model, trainer, batch, True, losses,
        per_step, step_s, launches, want, dtype="bfloat16",
        optimizer=f"sgd lr {BERT_BF16_LR} momentum {BERT_BF16_MOMENTUM}")
    del model, trainer, batch
    torch.cuda.empty_cache()
    return launches, summary


def pack_bert_sample(tok, seg, vl, pos, mlm_y, nsp_y):
    """One pretraining sample as a record payload, little-endian int32:
    S, P, the valid length and the NSP label, then the token and segment
    ids (S each), the masked positions and their MLM labels (P each)."""
    head = np.array([len(tok), len(pos), vl, nsp_y], "<i4")
    return b"".join(np.ascontiguousarray(a, "<i4").tobytes()
                    for a in (head, tok, seg, pos, mlm_y))


def unpack_bert_sample(payload):
    """`pack_bert_sample`'s arrays back: (tokens, segments, valid length,
    positions, MLM labels, NSP label), int32, the two scalars 0-d."""
    a = np.frombuffer(payload, "<i4")
    s, p = int(a[0]), int(a[1])
    body = a[4:].astype(np.int32)
    return (body[:s], body[s:2 * s], np.array(a[2], np.int32),
            body[2 * s:2 * s + p], body[2 * s + p:2 * s + 2 * p],
            np.array(a[3], np.int32))


def bert_pack_batches(n, b, s, p, vocab, seed=1):
    """`n` pretraining batches as numpy arrays (BERT_RECORD_FIELDS; as
    `_bert_batch` draws them, from numpy seed `seed`)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tok = rng.randint(0, vocab, (b, s)).astype(np.int32)
        vl = rng.randint(max(1, s // 2), s + 1, b).astype(np.int32)
        split = (vl * rng.uniform(0.2, 0.8, b)).astype(np.int32)
        seg = (np.arange(s)[None, :] >= split[:, None]).astype(np.int32)
        pos = (rng.uniform(0, 1, (b, p)) * vl[:, None]).astype(np.int32)
        mlm_y = rng.randint(0, vocab, (b, p)).astype(np.int32)
        nsp_y = rng.randint(0, 2, b).astype(np.int32)
        out.append((tok, seg, vl, pos, mlm_y, nsp_y))
    return out


def write_bert_pack(mx, rec_path, batches):
    """Every sample of `batches`, in order, as one record (the NSP label
    in its IRHeader, `pack_bert_sample`'s payload) through
    `recordio.MXIndexedRecordIO` into `rec_path` and its .idx."""
    rio = mx.recordio
    w = rio.MXIndexedRecordIO(os.path.splitext(rec_path)[0] + ".idx",
                              rec_path, "w")
    i = 0
    for batch in batches:
        for j in range(len(batch[0])):
            fields = [f[j] for f in batch]
            w.write_idx(i, rio.pack(rio.IRHeader(0, float(fields[5]), i, 0),
                                    pack_bert_sample(*fields)))
            i += 1
    w.close()


def bert_record_dataset(mx, rec_path):
    """(the `gluon.data.RecordFileDataset` over the pack, the dataset of
    its decoded samples)."""
    rio = mx.recordio
    ds = mx.gluon.data.RecordFileDataset(rec_path)
    return ds, ds.transform(lambda rec: unpack_bert_sample(rio.unpack(rec)[1]))


def bert_pack_loader(mx, samples, b, start=0, **kw):
    """A DataLoader over the decoded samples from batch `start` on, in
    order, full batches of `b` (the resumed run's cursor)."""
    sampler = mx.gluon.data.BatchSampler(range(start * b, len(samples)), b,
                                         "discard")
    return mx.gluon.data.DataLoader(samples, batch_sampler=sampler, **kw)


@contextlib.contextmanager
def _deterministic(torch):
    """Torch's deterministic algorithms (warn only: cuBLAS is held
    deterministic on one stream, as the NMT paths' repeat shows), without
    filling new memory; yields the distinct warnings raised inside."""
    import warnings
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            yield caught
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = fill


@contextlib.contextmanager
def _sync_calls(torch, counts, key):
    """Count into counts[key] the synchronizing CUDA calls made inside
    (torch's sync debug mode, as `phase_profile` counts them), and each
    under "<key> at <file>:<line>" of the Python line that made it."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            counts[key] = counts.get(key, 0) + 1
            where = f"{key} at {os.path.basename(w.filename)}:{w.lineno}"
            counts[where] = counts.get(where, 0) + 1


def _bits_equal(torch, a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _cache_misses(reg):
    """{reason: count} of the captured step's cache misses."""
    return {dict(m.labels).get("reason"): m.value
            for m in reg.series("cachedop_cache_misses")}


def _train_state(model, trainer):
    """({name: weight}, {index: momentum}) clones."""
    weights = {n: t.clone() for n, t in _param_tensors(model).items()}
    moms = {i: s[0]._data.clone() for i, s in
            trainer._updater.states.items()}
    return weights, moms


def _same_state(torch, tag, got, want):
    """Check two `_train_state`s bit for bit; logs how many agree."""
    (gw, gm), (ww, wm) = got, want
    w_eq = sum(_bits_equal(torch, gw[n], ww[n]) for n in ww)
    m_eq = sum(_bits_equal(torch, gm[i], wm[i]) for i in wm if i in gm)
    log(f"{tag}: {w_eq} of {len(ww)} weights and {m_eq} of {len(wm)} "
        f"momenta bit for bit")
    check(w_eq == len(ww) and m_eq == len(wm) and len(gm) == len(wm),
          f"{tag}: {w_eq}/{len(ww)} weights and {m_eq}/{len(wm)} momenta "
          f"bit for bit")


def phase_bert_pretrain_resume(mx, torch):
    """Phase 11r (module docstring): bf16 BERT-base pretraining fed from
    a RecordIO pack through the device prefetcher, checkpointed
    asynchronously, killed at RESUME_AT and resumed, eager and captured.
    Returns the launches of the uninterrupted eager run (the path
    `bert_pretrain_resume`), counted from 0."""
    import warnings
    K = mx.ops.kernels
    ck = mx.checkpoint
    reg = mx.observability.registry()
    dev = mx.gpu(0)
    B, S = BERT_B, BERT_S
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(batch=B, seq=BERT_S, masked=BERT_P, steps=RESUME_STEPS,
               resume_at=RESUME_AT)
    tmp = tempfile.mkdtemp(prefix="mxtt_resume_")
    try:
        # -------------------------------------------------------- the pack
        batches = bert_pack_batches(RESUME_BATCHES, B, S, BERT_P,
                                    BERT_VOCAB)
        rec = os.path.join(tmp, "pretrain.rec")
        t0 = time.perf_counter()
        write_bert_pack(mx, rec, batches)
        out["pack_write_s"] = time.perf_counter() - t0
        out["pack_bytes"] = os.path.getsize(rec)
        ds, samples = bert_record_dataset(mx, rec)
        check(len(ds) == RESUME_BATCHES * B, f"pack holds {len(ds)} records")
        check(ds._rec is None and isinstance(ds._records,
                                             mx.recordio.NativeRecordFile),
              "the pack was not served by recordio.NativeRecordFile")

        def loader(start=0):
            return bert_pack_loader(mx, samples, B, start,
                                    prefetch_to_device=True,
                                    pin_memory=True)
        it = iter(loader())
        for i in range(RESUME_CHECK_BATCHES):
            got = next(it)
            for name, g, w in zip(BERT_RECORD_FIELDS, got, batches[i]):
                check(g._data.is_cuda, f"pack batch {i} {name} not on "
                                       f"the card")
                check(torch.equal(g._data.cpu(), torch.from_numpy(w)),
                      f"pack batch {i} {name} differs from the written one")
        it.close()
        log(f"bert resume: pack of {len(ds)} records, {out['pack_bytes']} "
            f"bytes, served by NativeRecordFile; {RESUME_CHECK_BATCHES} "
            f"batches on the card equal the written ones bit for bit")

        # ------------------------------------------------------- the model
        mx.random.seed(0)
        model = _bert_pretraining(mx)
        model.initialize(ctx=dev)
        model.cast("bfloat16")
        start = {n: t.clone() for n, t in _param_tensors(model).items()}
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        n = len(model.bert.encoder.layers)
        want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd_bf16=n,
                    flash_bwd_bf16=n, flash_bwd_dq_bf16=n,
                    layer_norm_bf16=2 * n + 2)

        def make_trainer(m):
            return mx.gluon.Trainer(m.collect_params(), "sgd",
                                    {"learning_rate": BERT_BF16_LR,
                                     "momentum": BERT_BF16_MOMENTUM})

        def eager(m, tr):
            fn = _bert_bench_loss(mx, m, ce)

            def step(batch):
                with mx.autograd.record():
                    loss = fn(*batch)
                loss.backward()
                tr.step(1)
                return loss
            return step

        def params_of(m):
            return {"params": {k: p.data() for k, p in
                               m._collect_params_with_prefix().items()}}

        saves = []

        def run(step, it, first, last, mgr=None, tr=None, m=None,
                keep=None):
            """Steps first+1..last of `step` on batches from `it`; with
            `mgr`, an async save after every RESUME_SAVE_EVERY-th step
            up to RESUME_AT (weights, the Trainer's states, the cursor);
            `keep` collects {step: (weights, momenta)} clones after the
            steps it names. Returns (each step's launches, losses,
            seconds from the end of step first+2 to the last)."""
            per_step, losses = [], []
            t_mark = None
            for s in range(first + 1, last + 1):
                batch = next(it)
                before = dict(K.LAUNCHES)
                losses.append(step(batch))
                per_step.append({k: K.LAUNCHES[k] - before[k]
                                 for k in before})
                if mgr is not None and s % RESUME_SAVE_EVERY == 0 \
                        and s <= RESUME_AT:
                    t0 = time.perf_counter()
                    states = tr.states_bytes()
                    t1 = time.perf_counter()
                    fut = mgr.save(s, params_of(m), _async=True, extras={
                        "trainer": states,
                        "cursor": json.dumps({"batches": s}).encode()})
                    rec_ = dict(step=s, t0=t0, states_s=t1 - t0,
                                hold_s=time.perf_counter() - t0)
                    fut.add_done_callback(
                        lambda f, r=rec_: r.setdefault(
                            "done", time.perf_counter()))
                    saves.append((rec_, fut, mgr))
                if keep is not None and s in keep:
                    keep[s] = _train_state(m, tr)
                if s == first + 2:
                    torch.cuda.synchronize()
                    t_mark = time.perf_counter()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t_mark if t_mark else None
            return per_step, [x._data.detach().item() for x in losses], secs

        with _deterministic(torch) as det_warnings:
            # ---------------------------- uninterrupted, eager: main path
            trainer = make_trainer(model)
            mgr = ck.CheckpointManager(os.path.join(tmp, "eager"),
                                       max_to_keep=2)
            keep = {RESUME_SAVE_EVERY * 2: None, RESUME_AT: None}
            starved0 = reg.counter("prefetch_starved").value
            it = iter(loader())
            K.reset_launch_counts()
            per_step, losses, _ = run(eager(model, trainer), it, 0,
                                      RESUME_STEPS, mgr, trainer, model,
                                      keep)
            launches = dict(K.LAUNCHES)
            it.close()
            out["prefetch_starved"] = (reg.counter("prefetch_starved").value
                                       - starved0)
            for i, counts in enumerate(per_step):
                check(counts == want, f"bert resume step {i + 1} launches "
                      f"{ {k: v for k, v in counts.items() if v} } != "
                      f"{ {k: v for k, v in want.items() if v} }")
            check(all(np.isfinite(losses)), f"bert resume losses {losses}")
            final = _train_state(model, trainer)
            mgr.wait()
            out["losses"] = losses
            check(mgr.steps() == [RESUME_AT - RESUME_SAVE_EVERY, RESUME_AT],
                  f"retention kept {mgr.steps()}")

            # ----------------------------------- resumed, fresh, eager
            mx.random.seed(1)
            model2 = _bert_pretraining(mx)
            model2.initialize(ctx=dev)
            model2.cast("bfloat16")
            trainer2 = make_trainer(model2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_k, restored = mgr.restore_latest(params_of(model2))
            check(step_k == RESUME_AT, f"restore_latest gave {step_k}")
            for k, p in model2._collect_params_with_prefix().items():
                p.set_data(restored["params"][k])
            trainer2.load_states_bytes(mgr.read_extra(step_k, "trainer"))
            cursor = json.loads(mgr.read_extra(step_k, "cursor"))
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
            _same_state(torch, "bert resume: restored step "
                        f"{RESUME_AT}", _train_state(model2, trainer2),
                        keep[RESUME_AT])
            it = iter(loader(cursor["batches"]))
            per2, losses2, _ = run(eager(model2, trainer2), it,
                                   cursor["batches"], RESUME_STEPS)
            it.close()
            check(losses2 == losses[RESUME_AT:], f"resumed losses "
                  f"{losses2} != {losses[RESUME_AT:]}")
            _same_state(torch, "bert resume: eager, resumed at step "
                        f"{RESUME_AT}, at step {RESUME_STEPS}",
                        _train_state(model2, trainer2), final)

            # -------------------- corrupted newest step -> the one before
            newest = os.path.join(mgr.directory, str(RESUME_AT), "state")
            path = min(os.path.join(d, f) for d, _, fs in os.walk(newest)
                       for f in fs)
            victim = os.path.relpath(path, newest)
            with open(path, "rb") as f:
                blob = bytearray(f.read())
            blob[-1] ^= 0xFF
            with open(path, "wb") as f:
                f.write(bytes(blob))
            fb0 = reg.counter("checkpoint_fallbacks").value
            step_f, restored = mgr.restore_latest(params_of(model2))
            prev = RESUME_AT - RESUME_SAVE_EVERY
            check(step_f == prev and reg.counter("checkpoint_fallbacks")
                  .value == fb0 + 1, f"corrupt newest step: restored "
                  f"{step_f}, fallbacks +"
                  f"{reg.counter('checkpoint_fallbacks').value - fb0}")
            eq = sum(_bits_equal(torch, restored["params"][k]._data,
                                 keep[prev][0][k]) for k in keep[prev][0])
            check(eq == len(keep[prev][0]), f"fallback step {prev}: {eq} "
                  f"of {len(keep[prev][0])} weights bit for bit")
            log(f"bert resume: {victim} of step {RESUME_AT} corrupted; "
                f"restore_latest fell back to step {prev} "
                f"(checkpoint_fallbacks +1), its weights bit for bit")

            # ------------------------------- emergency save on SIGTERM
            fault = mx.fault
            mgr.enable_emergency_save(
                params_fn=lambda: params_of(model2),
                step_fn=lambda: RESUME_STEPS,
                extras_fn=lambda: {"trainer": trainer2.states_bytes()})
            fault.inject("preempt.sigterm", at=[1], action="sigterm")
            t0 = time.perf_counter()
            try:
                check(fault.check("preempt.sigterm") is True,
                      "preempt.sigterm did not fire")
                check(fault.preempted(), "no preemption recorded")
                try:
                    fault.check_preempted()
                    check(False, "check_preempted did not raise")
                except fault.Preempted:
                    pass
            finally:
                out["emergency_save_s"] = time.perf_counter() - t0
                fault.clear()
                mgr.disable_emergency_save()
                fault.reset_preemption(clear_callbacks=True)
                fault.uninstall_preemption_handler()
            check(RESUME_STEPS in mgr.valid_steps(), f"emergency save: "
                  f"valid steps {mgr.valid_steps()}")
            log(f"bert resume: SIGTERM through preempt.sigterm published "
                f"step {RESUME_STEPS} (valid) in "
                f"{out['emergency_save_s']:.3f} s")

            # ------------------------------ the input path's sync calls
            syncs = {}
            it = iter(loader())
            step2 = eager(model2, trainer2)
            for _ in range(RESUME_SYNC_STEPS):
                with _sync_calls(torch, syncs, "input"):
                    batch = next(it)
                with _sync_calls(torch, syncs, "step"):
                    step2(batch)
            it.close()
            torch.cuda.synchronize()
            out["sync_calls"] = syncs
            del model2, trainer2, step2, restored
            torch.cuda.empty_cache()

            # ------------------------- pack-fed against in-memory batches
            for form in ("pack", "memory"):
                _restore(torch, model, start)
                tr = make_trainer(model)
                if form == "pack":
                    it = iter(loader())
                else:
                    it = iter([[mx.nd.array(a, ctx=dev) for a in bt]
                               for bt in batches[:RESUME_STEPS]])
                _, _, secs = run(eager(model, tr), it, 0, RESUME_STEPS)
                if form == "pack":
                    it.close()
                out[f"tokens_per_s_{form}"] = B * S * (RESUME_STEPS - 2) \
                    / secs

            # ------------------- uninterrupted, captured; live restore
            _restore(torch, model, start)
            trainer3 = make_trainer(model)
            step_fn = trainer3.capture(_bert_bench_loss(mx, model, ce))

            def captured(batch):
                loss = step_fn(*batch, batch_size=1)
                check(step_fn.last_fallback_reason is None, "bert resume "
                      f"captured: fell back ({step_fn.last_fallback_reason})")
                return loss
            mgr_c = ck.CheckpointManager(os.path.join(tmp, "captured"),
                                         max_to_keep=2)
            sync0 = mx.prefetch.sync_h2d_count()
            it = iter(bert_pack_loader(mx, samples, B,
                                       prefetch_to_device=trainer3))
            per_c, losses_c, _ = run(captured, it, 0, RESUME_STEPS, mgr_c,
                                     trainer3, model)
            it.close()
            check(mx.prefetch.sync_h2d_count() == sync0, "the captured "
                  "step made synchronous copies of prefetched batches")
            check(per_c[0] == {k: 2 * v for k, v in want.items()}
                  and all(c == want for c in per_c[1:]),
                  f"bert resume captured launches {per_c[:2]}")
            final_c = _train_state(model, trainer3)
            mgr_c.wait()
            misses = _cache_misses(reg)
            step_k, restored = mgr_c.restore_latest(params_of(model))
            check(step_k == RESUME_AT, f"captured restore gave {step_k}")
            for k, p in model._collect_params_with_prefix().items():
                p.set_data(restored["params"][k])
            trainer3.load_states_bytes(mgr_c.read_extra(step_k, "trainer"))
            cursor = json.loads(mgr_c.read_extra(step_k, "cursor"))
            it = iter(bert_pack_loader(mx, samples, B, cursor["batches"],
                                       prefetch_to_device=trainer3))
            _, losses_c2, _ = run(captured, it, cursor["batches"],
                                  RESUME_STEPS)
            it.close()
            after = _cache_misses(reg)
            moved = {r: v - misses.get(r, 0) for r, v in after.items()
                     if v != misses.get(r, 0)}
            log(f"bert resume captured: restored into the live captured "
                f"step; its cache misses since {moved}, cache size "
                f"{step_fn.cache_size}")
            check(moved == {"state_change": 1}, f"the live restore's "
                  f"misses {moved} != one state_change")
            check(losses_c2 == losses_c[RESUME_AT:], f"captured resumed "
                  f"losses {losses_c2} != {losses_c[RESUME_AT:]}")
            _same_state(torch, "bert resume: captured, resumed at step "
                        f"{RESUME_AT}, at step {RESUME_STEPS}",
                        _train_state(model, trainer3), final_c)
            kinds = sorted({str(w.message).split("\n")[0][:100]
                            for w in det_warnings
                            if "determinis" in str(w.message)})
        for rec_, fut, _ in saves:
            check(fut.exception() is None, f"save of step {rec_['step']} "
                                           f"failed: {fut.exception()}")
        walls = [r["done"] - r["t0"] for r, _, _ in saves]
        sizes = []
        for r, _, m in saves:
            path = os.path.join(m.directory, str(r["step"]))
            if os.path.isdir(path):
                sizes.append(sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(path) for f in fs))
        out.update(
            save_hold_ms=[r["hold_s"] * 1e3 for r, _, _ in saves],
            save_hold_states_bytes_ms=[r["states_s"] * 1e3
                                       for r, _, _ in saves],
            save_wall_s=walls,
            save_bytes=max(sizes) if sizes else None,
            save_mb_per_s=[max(sizes) / 1e6 / w for w in walls]
            if sizes else None,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            phase_s=time.perf_counter() - t_phase,
            nondeterminism_warnings=kinds)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        out["card"] = smi.stdout.strip()
        log("bert resume " + json.dumps(out))
        del model, trainer, trainer3, step_fn, restored
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_bert_wide_bf16(mx, torch, base_tokens_s):
    """The `bert_wide_bf16` path: phase 11b's model, cast and trainer,
    but BERTModel at bert_base's shape with BERT_WIDE_H heads of 256
    (heads wider than 128 run the wide kernels, `csrc/flash_wide.cu`),
    BERT_STEPS steps on phase 11's batch through Gluon. Every step must
    launch the wide bf16 kernels only: 12 wide forwards, 12 dK/dV and 12
    dQ kernels, and 2 x 12 + 2 LayerNorms (counters zeroed just before a
    step and read just after). Tokens/s over steps 3 on beside phase
    11b's from the same call (`base_tokens_s`): the cost of wide heads."""
    K = mx.ops.kernels
    mx.random.seed(0)
    model = _bert_pretraining(mx, num_heads=BERT_WIDE_H)
    model.initialize(ctx=mx.gpu(0))
    model.cast("bfloat16")
    check(model.bert.encoder.layers[0].attention._num_heads == BERT_WIDE_H,
          "the wide BERT's heads")
    batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": BERT_BF16_LR,
                                "momentum": BERT_BF16_MOMENTUM})
    losses, per_step, step_s, launches = _bert_train_loop(
        mx, torch, model, trainer, batch, True)
    n = len(model.bert.encoder.layers)
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_wide_fwd_bf16=n,
                flash_wide_bwd_dkv_bf16=n, flash_wide_bwd_dq_bf16=n,
                layer_norm_bf16=2 * n + 2)
    summary = _bert_train_report(
        mx, torch, "bert wide bf16 training", model, trainer, batch, True,
        losses, per_step, step_s, launches, want, dtype="bfloat16",
        heads=BERT_WIDE_H, head_width=768 // BERT_WIDE_H,
        optimizer=f"sgd lr {BERT_BF16_LR} momentum {BERT_BF16_MOMENTUM}")
    wide = summary["tokens_per_s"]
    shares = summary.get("device_shares")
    dq_share = "not measured" if shares is None \
        else f"{100 * shares['wide dQ']:.1f} %"
    log(f"bert wide bf16 ({BERT_WIDE_H} heads of {768 // BERT_WIDE_H}) "
        f"{wide:.1f} tokens/s beside bert_base bf16 (12 heads of 64) "
        f"{base_tokens_s:.1f} tokens/s in this call: ratio "
        f"{wide / base_tokens_s:.3f}; the wide dQ kernel {dq_share} of a "
        f"profiled step's device time")
    del model, trainer, batch
    torch.cuda.empty_cache()
    return launches


def phase_bert_wide_card_vs_cpu_bf16(mx, torch, init_file):
    """Phase 12b on the wide BERT: phase 11's initial weights cut to 2
    layers, as BERT_WIDE_H heads of 256 (the same weights: the heads
    split the same projections), cast to bf16, one Adam step with
    `multi_precision` at B = 2, S = BERT_WIDE_CHECK_S on the card and on
    the CPU, each held against the same step in fp32 on the CPU as phase
    12b holds them; the card must launch the wide bf16 kernels only."""
    K = mx.ops.kernels
    shape = dict(num_heads=BERT_WIDE_H, s=BERT_WIDE_CHECK_S,
                 lens=BERT_WIDE_CHECK_LENS)
    card = _mp_step(mx, torch, mx.gpu(0), init_file, True, **shape)
    cpu = _mp_step(mx, torch, mx.cpu(), init_file, True, **shape)
    ref = _mp_step(mx, torch, mx.cpu(), init_file, False, **shape)
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_wide_fwd_bf16=2,
                flash_wide_bwd_dkv_bf16=2, flash_wide_bwd_dq_bf16=2,
                layer_norm_bf16=6)
    check(card[2] == want, f"wide BERT bf16 card step launches {card[2]} "
                           f"!= {want}")
    _mp_compare("wide BERT bf16", card, cpu, ref,
                f"2 layers, {BERT_WIDE_H} heads of {768 // BERT_WIDE_H}, "
                f"B=2, S={BERT_WIDE_CHECK_S}, lengths "
                f"{BERT_WIDE_CHECK_LENS}, ")


def phase_bert_attention_bf16(mx, torch, rows):
    """Phase 10 in bf16: the bf16 kernels at BERT-base's attention shape
    (B=16, H=12, S=512, D=64, `_bert_lengths`) against their bf16 plain
    versions and float64 (`_lowp_fwd_check`, `_lowp_bwd_check`: the
    split path), then timed there beside SDPA in bf16: the dQ kernel's
    row, and `per_shape` entries of the forward's and the fused
    kernel's rows."""
    K = mx.ops.kernels
    B, H, S, D = BERT_B, BERT_H, BERT_S, 64
    lens = _bert_lengths(B)
    g = torch.Generator(device="cpu").manual_seed(14)
    q, k, v, do = _lowp_qkv(torch, g, B, H, S, S, D, 4)
    what = f"bert {(B, H, S, D)}"
    err, share, e64, p64 = _lowp_fwd_check(torch, K, q, k, v, False, lens,
                                           what)
    berrs, bshares, be64, bp64 = _lowp_bwd_check(torch, K, q, k, v, do,
                                                 False, lens, what)
    log(f"bf16 bert attention {(B, H, S, D)} lens {lens}: forward {err:.3e} "
        f"({share:.3f} of the limit), vs float64 {e64} (plain {p64}); "
        f"backward (split) {berrs} (shares {bshares}), vs float64 {be64} "
        f"(plain {bp64})")
    del q, k, v, do
    dev_ms, call_ms, b_, tf = _lowp_attention_times(torch, K, B, H, S, D,
                                                    lens)
    shape = [B, H, S, S, D]
    rows["flash_fwd_bf16"]["max_abs_err"] = max(
        rows["flash_fwd_bf16"]["max_abs_err"], err)
    rows["flash_fwd_bf16"]["per_shape"].append(dict(
        shape=shape, lens=lens, ms=dev_ms["fwd"],
        plain_ms=dev_ms["fwd_plain"], bound_ms=b_["fwd"][0],
        bound_by=b_["fwd"][1], library_ms=dev_ms["sdpa_fwd"],
        tflops=tf["fwd"], of_bound=dev_ms["fwd"] / b_["fwd"][0],
        of_library=dev_ms["fwd"] / dev_ms["sdpa_fwd"]))
    rows["flash_bwd_bf16"]["max_abs_err"] = max(
        rows["flash_bwd_bf16"]["max_abs_err"], berrs["dk"], berrs["dv"])
    rows["flash_bwd_bf16"].setdefault("per_shape", []).append(dict(
        shape=shape, lens=lens, path="split", ms=dev_ms["fused"],
        bound_ms=b_["fused"][0], bound_by=b_["fused"][1],
        pair_ms=dev_ms["bwd"], pair_bound_ms=b_["bwd"][0],
        pair_bound_by=b_["bwd"][1], plain_ms=dev_ms["bwd_plain"],
        library_ms=None, pair_library_ms=dev_ms["sdpa_bwd"],
        tflops=tf["fused"], pair_tflops=tf["bwd"],
        of_bound=dev_ms["fused"] / b_["fused"][0],
        pair_of_bound=dev_ms["bwd"] / b_["bwd"][0],
        pair_of_library=dev_ms["bwd"] / dev_ms["sdpa_bwd"]))
    dq = rows["flash_bwd_dq_bf16"]
    dq.update(max_abs_err=max(dq["max_abs_err"], berrs["dq"]),
              ms=dev_ms["dq"], plain_ms=dev_ms["bwd_plain"],
              bound_ms=b_["dq"][0], bound_by=b_["dq"][1],
              shape=shape, pair_ms=dev_ms["bwd"],
              pair_library_ms=dev_ms["sdpa_bwd"],
              per_shape=[dict(shape=shape, lens=lens, tflops=tf["dq"],
                              of_bound=dev_ms["dq"] / b_["dq"][0])])
    torch.cuda.empty_cache()


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


def _mp_step(mx, torch, ctx, init_file, bf16, num_heads=BERT_H, s=BERT_S,
             lens=(300, 512)):
    """One Adam step (BERT_MP_LR, multi_precision=True) of the 2-layer
    full-width BERT from `init_file` on `ctx`, cast to bf16 or not, on
    the B=2, S=512 batch with lengths (300, 512), the losses on logits
    cast to fp32: (loss, {name: fp32 gradient on the CPU}, launches).
    In bf16 each fp32 master must be its start (the weight as cast) plus
    Adam's first update of the run's own gradient, -lr g / (|g| + eps),
    evaluated in float64: fp32 rounds about 8 operations of the update
    (1e-6 of lr) and the sum once (2^-23 of the master); and the weight
    written back must be the master rounded to bf16, bit for bit."""
    K = mx.ops.kernels
    model = _bert_pretraining(mx, num_layers=2, num_heads=num_heads)
    model.load_parameters(init_file, ctx=ctx, ignore_extra=True)
    params = model._collect_params_with_prefix()
    if bf16:
        model.cast("bfloat16")
    start = {n: p.data()._data.detach().double().cpu()
             for n, p in params.items()}
    trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": BERT_MP_LR,
                                "multi_precision": True})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    K.reset_launch_counts()
    loss = _bert_step(mx, model, trainer, ce,
                      _bert_batch(mx, 2, s, ctx, lens=lens), True)
    launches = dict(K.LAUNCHES)
    index = {id(p): i for i, p in enumerate(trainer._params)}
    grads = {n: p.grad()._data.float().cpu() for n, p in params.items()}
    worst = (0.0, "")
    for n, p in params.items():
        if not bf16:
            break
        master = trainer._updater.states[index[id(p)]][0]._data.cpu()
        check(master.dtype == torch.float32, f"{n}: master {master.dtype}")
        g = grads[n].double()
        want = start[n] - BERT_MP_LR * g / (g.abs() + 1e-8)
        lim = 1e-6 * BERT_MP_LR + 2.0 ** -23 * want.abs()
        share = ((master.double() - want).abs() / lim).max().item()
        check(share <= 1.0, f"{n}: the master is not Adam's first update "
                            f"of its gradient ({share:.3f} of the limit)")
        check(torch.equal(p.data()._data.cpu(),
                          master.to(torch.bfloat16)),
              f"{n}: the bf16 weight is not its master rounded")
        worst = max(worst, (share, n))
    if bf16:
        log(f"bert bf16 step on {ctx}: every master is Adam's first update "
            f"of its own gradient (worst {worst[0]:.3f} of the limit, "
            f"{worst[1]}), every weight its master rounded to bf16")
    return float(loss.asnumpy()), grads, launches


def phase_bert_card_vs_cpu_bf16(mx, torch, init_file):
    """Phase 12 in bf16 with multi_precision: phase 11's initial weights
    cut to 2 layers at full width, cast to bf16 after loading, one Adam
    step (BERT_MP_LR, `multi_precision=True`: fp32 masters and states)
    at B=2, S=512, lengths (300, 512), on the card and on the CPU, each
    held against the same step in fp32 on the CPU: the card's loss and
    every gradient no further from the fp32 step than BF16_F64_RATIO
    times the CPU bf16 step's distance, plus BF16_F64_FLOOR of its scale
    (in norm, each parameter; the loss as a number), so the card's bf16
    step is as close to fp32 as the CPU's; every master and weight as
    `_mp_step` holds them. The card must launch the bf16 forms only."""
    K = mx.ops.kernels
    card = _mp_step(mx, torch, mx.gpu(0), init_file, True)
    cpu = _mp_step(mx, torch, mx.cpu(), init_file, True)
    ref = _mp_step(mx, torch, mx.cpu(), init_file, False)
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd_bf16=2,
                flash_bwd_bf16=2, flash_bwd_dq_bf16=2, layer_norm_bf16=6)
    check(card[2] == want, f"BERT bf16 card step launches {card[2]} != "
                           f"{want}")
    _mp_compare("BERT bf16", card, cpu, ref, "2 layers, B=2, S=512, "
                "lengths (300, 512), ")


def _mp_compare(tag, card, cpu, ref, shape=""):
    """Phase 12b's comparison of a bf16 step on the card and on the CPU
    with the fp32 step on the CPU: the loss and every gradient."""
    check(np.isfinite(card[0]), f"{tag} card loss {card[0]}")
    d_card, d_cpu = abs(card[0] - ref[0]), abs(cpu[0] - ref[0])
    check(d_card <= BF16_F64_RATIO * d_cpu + BF16_F64_FLOOR * abs(ref[0]),
          f"{tag} loss: card {card[0]}, cpu {cpu[0]}, fp32 {ref[0]}")
    worst = (0.0, "", 0.0, 0.0)
    for n, r in ref[1].items():
        c, p = card[1][n], cpu[1][n]
        scale = r.norm().item()
        check(scale > 0, f"{n}: the fp32 gradient is 0")
        dc = (c - r).norm().item() / scale
        dp = (p - r).norm().item() / scale
        lim = BF16_F64_RATIO * dp + BF16_F64_FLOOR
        check(dc <= lim, f"{tag} gradient of {n}: card {dc:.4e}, cpu "
                         f"{dp:.4e} from the fp32 step (relative norms)")
        worst = max(worst, (dc / lim, n, dc, dp))
    log(f"{tag} card vs cpu ({shape}"
        f"Adam multi_precision): loss card {card[0]:.6f}, cpu {cpu[0]:.6f}, "
        f"fp32 {ref[0]:.6f}; all {len(ref[1])} gradients within "
        f"{BF16_F64_RATIO}x the cpu bf16 step's distance from fp32 + "
        f"{BF16_F64_FLOOR} (relative norms); worst (share of the limit, "
        f"name, card, cpu) {worst}; card launches {card[2]}")



# ---------------------------------------------------------------------------
# the fused Trainer and the captured step (Trainer.capture: one CUDA graph)
# ---------------------------------------------------------------------------
# host runtime calls that launch work from the host (torch.profiler's CPU
# events): a warm captured step makes one graph launch and none of these
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx",
                       "cudaLaunchCooperativeKernel")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
# captured against eager from the same weights and batch, 10 steps, with
# four more eager runs as the yardstick: the same kernels on the same
# values, but a step is not bit for bit repeatable where an atomic sum's
# order varies (BERT's MLM gather and segment embedding backwards), and
# the differences grow along the steps. The captured run's largest
# distance from the first eager run, over the steps' losses and per
# parameter in norm after the last step, at most CAPTURE_RATIO times the
# largest distance between two eager runs, plus one ulp (2^-8 relative
# for bf16, 2^-23 for fp32; the loss is fp32). A parameter whose eager
# runs agree to the bit (spread 0) is held instead to `_rounding_floor`,
# one ulp of its largest element for each of the CAPTURE_STEPS steps,
# where that is the larger: without it, one rounding step the replay
# takes differently fails it (`nsp.bias` at 4.65x in one run). Five eager
# runs (ten pairs) measure a small parameter's spread: with three, a
# 2-element bias's spread came out below what the replay showed
# (`nsp.bias` at 1.096x in 11d (b) in one run)
CAPTURE_RATIO = 3.0
CAPTURE_EAGER_RUNS = 5
CAPTURE_STEPS = 10


def profile_launches(torch, work):
    """`work()` under torch.profiler: (window wall us, device rows as
    `device_profile`, {host runtime call: count} for the launch calls),
    or None where the profiler cannot trace the card."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows, calls = [], {}
        for ev in prof.key_averages():
            if "CUDA" in str(getattr(ev, "device_type", "")):
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(ev, "self_cuda_time_total", 0)
                rows.append((dev_us, ev.count, ev.key))
            elif ev.key in KERNEL_LAUNCH_CALLS + GRAPH_LAUNCH_CALLS:
                calls[ev.key] = calls.get(ev.key, 0) + ev.count
    except RuntimeError as e:
        log(f"profile: not measured ({e})")
        return None
    rows.sort(reverse=True)
    return wall_us, rows, calls


def _param_tensors(model):
    return {n: p.data()._data.detach() for n, p in
            model._collect_params_with_prefix().items()}


def _restore(torch, model, saved):
    """Put the weights (and running statistics) of `saved` back, in
    place."""
    with torch.no_grad():
        for n, p in model._collect_params_with_prefix().items():
            p.data()._data.copy_(saved[n])


def _rel(torch, a, b):
    return float((a.double() - b.double()).norm() / max(
        float(b.double().norm()), 1e-30))


def _kernel_count(rows):
    return sum(r[1] for r in rows)


def _ulp(torch, dtype):
    return 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23


def _rounding_floor(torch, w):
    """The limit's floor for a parameter: a rounding step the captured
    run takes differently from the eager one changes an element by at
    most one ulp of the largest element, |w|max (2^(e - 7) in bf16,
    2^(e - 10) in fp16, 2^(e - 23) in fp32, e = floor(log2 |w|max)), and
    the optimizer carries it through the later steps; at most one such
    step a step over CAPTURE_STEPS steps is CAPTURE_STEPS of those
    ulps."""
    import math
    top = float(w.double().abs().max())
    if top == 0.0:
        return 0.0
    mant = {torch.bfloat16: 7, torch.float16: 10}.get(w.dtype, 23)
    return CAPTURE_STEPS * 2.0 ** (math.floor(math.log2(top)) - mant)


def phase_train_fused(mx, torch):
    """The fused Trainer against the per-parameter one on phase 11b's
    bf16 BERT-base (`bert_base` from `mx.random.seed(0)`, cast, SGD lr
    1e-3 momentum 0.9, bench_bert.py's step). (a) The update alone: one
    backward, then each path's first step on those same gradients from
    the same weights: the momentum bit for bit (the same two roundings
    in both), each weight within one bf16 ulp of itself plus one of its
    step lr * m of the per-parameter one (the fused rule reads lr as a
    bf16 scalar, as the JAX package's weak-typed lr on a bf16 weight,
    where the per-parameter path multiplies by the float: the step's
    rounding may land one of its ulps apart, then the subtraction rounds
    once); one `fused_update` dispatch a bucket, one
    `opt_update` a parameter. (b) A whole step of each, profiled: its
    device kernels and the host's launch calls."""
    mx.random.seed(0)
    model = _bert_pretraining(mx)
    model.initialize(ctx=mx.gpu(0))
    model.cast("bfloat16")
    batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = model._collect_params_with_prefix()
    start = {n: t.clone() for n, t in _param_tensors(model).items()}
    _bert_step(mx, model, None, ce, batch, True)
    grads = {n: p.grad()._data.clone() for n, p in params.items()}
    res = {}
    for fused in (True, False):
        _restore(torch, model, start)
        with torch.no_grad():
            for n, p in params.items():
                p.grad()._data.copy_(grads[n])
        trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                                   {"learning_rate": BERT_BF16_LR,
                                    "momentum": BERT_BF16_MOMENTUM},
                                   fused=fused)
        check(trainer._fused == fused, f"fused={fused} not taken")
        mx.profiler.reset_dispatches()
        trainer.step(1)
        torch.cuda.synchronize()
        index = {id(p): i for i, p in enumerate(trainer._params)}
        res[fused] = dict(
            weights={n: t.clone() for n, t in
                     _param_tensors(model).items()},
            moms={n: trainer._updater.states[index[id(p)]][0]._data.clone()
                  for n, p in params.items()},
            dispatches={k: mx.profiler.dispatch_count(k)
                        for k in ("fused_update", "opt_update")},
            buckets=len(trainer._buckets) if fused else None,
            bucket_bytes=mx.profiler.bucket_sizes() if fused else None)
        del trainer
    f, u = res[True], res[False]
    check(f["dispatches"]["fused_update"] == f["buckets"] > 0,
          f"fused_update dispatches {f['dispatches']} != {f['buckets']} "
          f"buckets")
    n_params = len(f["weights"])
    check(u["dispatches"]["opt_update"] == n_params,
          f"per-parameter dispatches {u['dispatches']} != {n_params}")
    def bf16_ulp(v):
        # 2^-7 of the power of two at or below |v|
        return torch.exp2(torch.floor(torch.log2(
            torch.clamp(v.abs(), min=2.0 ** -126)))) * 2.0 ** -7

    worst_ulps, mom_equal, w_equal = 0.0, 0, 0
    for n in f["weights"]:
        a, b = f["weights"][n].float(), u["weights"][n].float()
        step = BERT_BF16_LR * u["moms"][n].float()
        lim = bf16_ulp(b) + bf16_ulp(step)
        ulps = float(((a - b).abs() / lim).max())
        worst_ulps = max(worst_ulps, ulps)
        check(ulps <= 1.0, f"{n}: fused weight {ulps:.2f} of its limit from "
                           f"the per-parameter one")
        mom_equal += int(torch.equal(f["moms"][n], u["moms"][n]))
        w_equal += int(torch.equal(f["weights"][n], u["weights"][n]))
    check(mom_equal == n_params, f"momentum bit for bit in {mom_equal} of "
                                 f"{n_params} parameters")
    summary = dict(params=n_params, buckets=f["buckets"],
                   bucket_bytes=f["bucket_bytes"],
                   dispatches_fused=f["dispatches"],
                   dispatches_per_parameter=u["dispatches"],
                   worst_weight_share_of_limit=worst_ulps,
                   weights_bit_equal=w_equal, momentum_bit_equal=mom_equal)
    for fused in (True, False):
        tag = "fused" if fused else "per_parameter"
        _restore(torch, model, start)
        trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                                   {"learning_rate": BERT_BF16_LR,
                                    "momentum": BERT_BF16_MOMENTUM},
                                   fused=fused)
        _bert_step(mx, model, trainer, ce, batch, True)
        got = profile_launches(torch, lambda: _bert_step(
            mx, model, trainer, ce, batch, True))
        if got is not None:
            wall_us, rows, calls = got
            summary[f"kernels_per_step_{tag}"] = _kernel_count(rows)
            summary[f"host_launch_calls_{tag}"] = calls
            summary[f"busy_share_{tag}"] = sum(x[0] for x in rows) / wall_us
            log_profile(f"train fused profile ({tag})", wall_us, rows,
                        "1 bf16 BERT step")
        del trainer
    log("train fused " + json.dumps(summary))
    del model, batch, start, res, grads
    torch.cuda.empty_cache()


def _captured_vs_eager(mx, torch, tag, model, make_trainer, loss_fn,
                       eager_step, batch, batch_size, tokens, want):
    """Train `model` CAPTURE_STEPS steps eagerly (`eager_step(trainer)`
    returns the loss) CAPTURE_EAGER_RUNS times, then through
    `trainer.capture(loss_fn)`, each from the same weights with a fresh
    trainer: the steps' losses and each parameter after the last step no
    further from the first eager run than CAPTURE_RATIO times the
    largest distance between eager runs plus an ulp, under float16 AMP
    the same loss scale after every step (so the same steps skipped), no
    fallback, the warm steps' launches equal to the eager steps' (`want`
    counters above 0), one graph launch and no kernel launch from the
    host in a profiled warm step. Logs tokens/s over steps 3 on with the
    spread, peak memory and each form's busy share; returns the captured
    and the first eager run's launches."""
    K = mx.ops.kernels
    start = {n: t.clone() for n, t in _param_tensors(model).items()}
    forms = [f"eager{k}" for k in range(CAPTURE_EAGER_RUNS)] + ["captured"]
    runs = {}
    for form in forms:
        _restore(torch, model, start)
        trainer = make_trainer()
        if form == "captured":
            step_fn = trainer.capture(loss_fn)

            def step():
                loss = step_fn(*batch, batch_size=batch_size)
                check(step_fn.last_fallback_reason is None,
                      f"{tag}: fell back ({step_fn.last_fallback_reason})")
                return loss
        else:
            def step():
                return eager_step(trainer)
        scales = []

        def scaled_step(step=step):
            loss = step()
            if mx.amp.scaler() is not None:
                scales.append(mx.amp.scaler().loss_scale)
            return loss
        losses, per_step, step_s, launches = _timed_steps(
            torch, K, scaled_step, CAPTURE_STEPS)
        run = dict(losses=np.asarray(losses), per_step=per_step,
                   step_s=step_s, launches=launches, scales=scales,
                   peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                   weights={n: t.clone() for n, t in
                            _param_tensors(model).items()})
        if form in ("eager0", "captured"):
            run["profile"] = profile_launches(torch, step)
        if form == "captured":
            run["build_s"] = step_fn.last_compile_seconds
            run["cache_size"] = step_fn.cache_size
        runs[form] = run
        del trainer
    e, c = runs["eager0"], runs["captured"]
    eagers = [runs[f] for f in forms[:-1]]
    pairs = [(a, b) for i, a in enumerate(eagers) for b in eagers[i + 1:]]
    loss_spread = max(float(np.abs(a["losses"] - b["losses"]).max())
                      for a, b in pairs)
    loss_dist = float(np.abs(c["losses"] - e["losses"]).max())
    loss_lim = CAPTURE_RATIO * loss_spread + 2.0 ** -23 * float(
        np.abs(e["losses"]).max())

    def dist(a, b, n):
        return float((a["weights"][n].double()
                      - b["weights"][n].double()).norm())
    # each parameter's limit, the floor only where the eager runs agree
    # to the bit
    spreads, lims, floored = {}, {}, []
    for n, we in e["weights"].items():
        spreads[n] = max(dist(a, b, n) for a, b in pairs)
        lims[n] = CAPTURE_RATIO * spreads[n] + _ulp(torch, we.dtype) * float(
            we.double().norm())
        floor = _rounding_floor(torch, we)
        if spreads[n] == 0.0 and floor > lims[n]:
            lims[n] = floor
            floored.append(n)

    def beyond(weights):
        """[(name, distance, eager spread)] of the parameters of
        `weights` further from the first eager run than their limit."""
        out = []
        for n, we in e["weights"].items():
            d = float((weights[n].double() - we.double()).norm())
            if d > lims[n]:
                out.append((n, d, spreads[n]))
        return out
    bad = beyond(c["weights"])
    worst = max((dist(c, e, n) / lims[n] if lims[n] else 0.0, n)
                for n in lims)
    bits = sum(int(torch.equal(c["weights"][n], e["weights"][n]))
               for n in lims)
    # the control: a copy of the captured weights with each floored
    # parameter moved by twice its limit (in float64, away from the eager
    # weight; along its first element where they are equal) goes through
    # the same comparison, and each of those parameters must fail it
    moved = dict(c["weights"])
    for n in floored:
        we = e["weights"][n].double()
        diff = c["weights"][n].double() - we
        u = torch.zeros_like(diff).flatten()
        if float(diff.norm()):
            u = (diff / diff.norm()).flatten()
        else:
            u[0] = 1.0
        moved[n] = c["weights"][n].double() + 2.0 * lims[n] * u.view_as(diff)
    caught = {b[0] for b in beyond(moved)}
    check(caught >= set(floored), f"{tag}: moved by twice their limit, "
          f"{sorted(set(floored) - caught)} pass")
    controls = len(floored)
    summary = dict(steps=CAPTURE_STEPS, tokens_per_step=tokens,
                   losses_eager=e["losses"].tolist(),
                   losses_captured=c["losses"].tolist(),
                   loss_scales_eager=e["scales"],
                   loss_scales_captured=c["scales"],
                   loss_captured_vs_eager=loss_dist,
                   loss_spread_of_eager_runs=loss_spread,
                   worst_param_share_of_limit=worst[0],
                   worst_param=worst[1], params=len(e["weights"]),
                   params_at_the_floor_with_control=controls,
                   params_bit_equal=bits,
                   launches_per_step={k: v for k, v in
                                      c["per_step"][-1].items() if v},
                   first_captured_step_launches={
                       k: v for k, v in c["per_step"][0].items() if v},
                   build_s=c["build_s"])
    for key, r in (("eager", e), ("captured", c)):
        timed = r["step_s"][2:]
        tok = [tokens / t for t in timed]
        summary[f"tokens_per_s_{key}"] = tokens * len(timed) / sum(timed)
        summary[f"tokens_per_s_{key}_min"] = min(tok)
        summary[f"tokens_per_s_{key}_max"] = max(tok)
        summary[f"step_ms_{key}"] = [t * 1e3 for t in r["step_s"]]
        summary[f"peak_mem_gib_{key}"] = r["peak"]
        if r["profile"] is not None:
            wall_us, rows, calls = r["profile"]
            summary[f"busy_share_{key}"] = sum(x[0] for x in rows) / wall_us
            summary[f"device_kernels_{key}"] = _kernel_count(rows)
            summary[f"host_launch_calls_{key}"] = calls
            log_profile(f"{tag} profile ({key})", wall_us, rows,
                        "1 warm step")
    log(f"{tag} " + json.dumps(summary))
    check(all(np.isfinite(c["losses"])), f"{tag}: non-finite captured "
                                         f"loss {c['losses']}")
    check(loss_dist <= loss_lim, f"{tag}: captured losses {loss_dist:.3e} "
          f"from eager, eager runs {loss_spread:.3e} apart")
    check(c["scales"] == e["scales"], f"{tag}: captured loss scales "
          f"{c['scales']} != eager {e['scales']}")
    check(not bad, f"{tag}: parameters beyond their limit (name, distance, "
                   f"eager spread): {bad[:5]}")
    for i in range(1, CAPTURE_STEPS):
        check(c["per_step"][i] == e["per_step"][i],
              f"{tag}: captured step {i + 1} launches {c['per_step'][i]} "
              f"!= eager {e['per_step'][i]}")
    for name in want:
        check(c["per_step"][-1][name] > 0, f"{tag}: no {name} in a replay")
    check(c["cache_size"] == 1, f"{tag}: {c['cache_size']} cache entries")
    if c["profile"] is not None:
        calls = c["profile"][2]
        graphs = sum(calls.get(k, 0) for k in GRAPH_LAUNCH_CALLS)
        kernels = sum(calls.get(k, 0) for k in KERNEL_LAUNCH_CALLS)
        check(graphs == 1 and kernels == 0,
              f"{tag}: a warm captured step made {graphs} graph launches "
              f"and {kernels} kernel launches from the host ({calls})")
    return c["launches"], e["launches"]


def _bert_bench_loss(mx, model, ce):
    def loss_fn(tok, seg, vl, pos, mlm_y, nsp_y):
        mlm, nsp = model(tok, seg, vl, pos)
        mlm, nsp = mlm.astype("float32"), nsp.astype("float32")
        return ce(mlm.reshape((-1, BERT_VOCAB)),
                  mlm_y.reshape((-1,))).mean() + ce(nsp, nsp_y).mean()
    return loss_fn


def phase_bert_train_bf16_captured(mx, torch):
    """Phase 11b through `trainer.capture`: bf16 `bert_base` from
    `mx.random.seed(0)`, SGD lr 1e-3 momentum 0.9 on the batch-mean
    loss's gradient (batch_size 1), phase 11's batch;
    `_captured_vs_eager` against the eager fused step from the same
    weights. Every replay launches the bf16 forms: 12 flash forwards, 12
    fused and 12 dQ backward kernels, 26 LayerNorms."""
    mx.random.seed(0)
    model = _bert_pretraining(mx)
    model.initialize(ctx=mx.gpu(0))
    model.cast("bfloat16")
    batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def make_trainer():
        return mx.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": BERT_BF16_LR,
                                 "momentum": BERT_BF16_MOMENTUM})
    launches = _captured_vs_eager(
        mx, torch, "bert bf16 captured", model, make_trainer,
        _bert_bench_loss(mx, model, ce),
        lambda tr: _bert_step(mx, model, tr, ce, batch, True), batch, 1,
        BERT_B * BERT_S, ("flash_fwd_bf16", "flash_bwd_bf16",
                          "flash_bwd_dq_bf16", "layer_norm_bf16"))[0]
    del model, batch
    torch.cuda.empty_cache()
    return launches


# the bf16 kernels of BERT-base (rows 1b, 2b, 3b, 8b): each must launch
# on both of 11d's paths
DP_KERNELS = ("flash_fwd_bf16", "flash_bwd_bf16", "flash_bwd_dq_bf16",
              "layer_norm_bf16")
# phase 11d (c): the sum of the two half-batch gradients pulled from a
# "device" store, held with the whole batch's bf16 gradient against the
# whole batch's gradient in fp32 from the same weights, per parameter in
# norm: no further from it than DP_TOWER_RATIO x the whole bf16
# gradient's distance plus one bf16 ulp of its norm (the bf16 parity
# rule). Not against the whole bf16 gradient itself: the embeddings'
# backward adds thousands of rows into a few bf16 elements, where small
# addends are lost, so the token-type table's whole-batch and two-half
# gradients part by 25-35 % of its norm (measured on the H100)
DP_TOWER_RATIO = 2.0
# phase 11d (d): the collectives captured in a CUDA graph, on bf16
# buffers of DP_NCCL_ROWS x 768 (BERT-base's width)
DP_NCCL_ROWS = 4096
# 11d (d) profiles DP_PROFILE_REPLAYS replays of that graph in one window:
# torch.profiler (Kineto / CUPTI) loses device records of a window once
# the process is some seconds old, a lone record's window most often
# (`chip_profiler_age.py`, torch alone, on an H100 with torch 2.11: a
# one-kernel window shows no row from 20-60 s on, while 192-200 of 200
# kernels show), so one replay's two copies vanished late in the whole
# script (ROADMAP Queue 3 #18)
DP_PROFILE_REPLAYS = 50


def _dp_trainer(mx, model, kvstore):
    return mx.gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": BERT_BF16_LR,
                             "momentum": BERT_BF16_MOMENTUM},
                            kvstore=kvstore)


def _kv_counts(mx):
    """(the store's `kv_allreduce` dispatches, `kv_collective_bytes` of
    its process sums) so far."""
    reg = mx.observability.registry()
    return (mx.profiler.dispatch_count("kv_allreduce"),
            reg.counter("kv_collective_bytes", op="process_sum").value)


def _dp_store_runs(mx, torch, model, batch, start, want):
    """11d (a): BERT_STEPS eager steps of 11b store-less and through
    `Trainer(kvstore="dist_sync")` on the one-rank NCCL group, from the
    same weights, under torch's deterministic algorithms; returns
    {form: run}."""
    K = mx.ops.kernels
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    with _deterministic(torch) as caught:
        for form, kv in (("storeless", None), ("dist_sync", "dist_sync")):
            _restore(torch, model, start)
            tr = _dp_trainer(mx, model, kv)
            kv0 = _kv_counts(mx)
            losses, per_step, step_s, launches = _timed_steps(
                torch, K, lambda: _bert_step(mx, model, tr, ce, batch, True),
                BERT_STEPS)
            kv1 = _kv_counts(mx)
            runs[form] = dict(
                losses=losses, step_s=step_s, launches=launches,
                weights={n: t.clone() for n, t in
                         _param_tensors(model).items()},
                allreduce=kv1[0] - kv0[0], coll_bytes=kv1[1] - kv0[1],
                buckets=len(tr._buckets or ()), store=tr._kvstore,
                grad_bytes=sum(p.grad()._data.numel() * 2
                               for p in model.collect_params().values()))
            for i, counts in enumerate(per_step):
                check(counts == want, f"bert dp bf16 {form} step {i + 1} "
                                      f"launches {counts} != {want}")
    log(f"bert dp bf16: deterministic-algorithm warnings "
        f"{sorted({str(w.message)[:80] for w in caught})}")
    return runs


def _dp_towers(mx, torch, model, batch):
    """11d (c): the gradients of the two half batches (each loss weighted
    1/2, so that their sum is the whole batch's mean-loss gradient)
    pushed as two towers to `kv.create("device")`: each pull is their
    `torch.add`, bit for bit, and within DP_TOWER_RATIO of the whole
    batch's bf16 gradient's distance from its fp32 gradient (an fp32 copy
    of the model). Returns the worst share of that limit."""
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def grads(model, rows, weight):
        params = list(model._collect_params_with_prefix().values())
        for p in params:
            p.zero_grad()
        tok, seg, vl, pos, mlm_y, nsp_y = [mx.nd.NDArray(a._data[rows])
                                           for a in batch]
        with mx.autograd.record():
            mlm, nsp = model(tok, seg, vl, pos)
            mlm, nsp = mlm.astype("float32"), nsp.astype("float32")
            loss = (ce(mlm.reshape((-1, BERT_VOCAB)),
                       mlm_y.reshape((-1,))).mean()
                    + ce(nsp, nsp_y).mean()) * weight
        loss.backward()
        return [p.grad()._data.clone() for p in params]

    half = BERT_B // 2
    g0 = grads(model, slice(0, half), 0.5)
    g1 = grads(model, slice(half, BERT_B), 0.5)
    gw = grads(model, slice(0, BERT_B), 1.0)
    ref = _bert_pretraining(mx)
    ref.initialize(ctx=mx.gpu(0))
    for (name, p), q in zip(ref._collect_params_with_prefix().items(),
                            model._collect_params_with_prefix().values()):
        p.set_data(q.data())
    g32 = grads(ref, slice(0, BERT_B), 1.0)
    del ref
    names = list(model._collect_params_with_prefix())
    kv = mx.kv.create("device")
    check(kv.type == "device" and kv.device.type == "cuda",
          f"device store on {kv.device}")
    worst, bits = (0.0, "", 0.0), 0
    for i, (a, b, w, r) in enumerate(zip(g0, g1, gw, g32)):
        kv.init(i, torch.zeros_like(a))
        kv.push(i, [a, b])
        got = kv.pull(i)._data
        bits += int(_bits_equal(torch, got, torch.add(a, b)))
        r = r.double()
        whole = float((w.double() - r).norm())
        lim = DP_TOWER_RATIO * whole + 2.0 ** -8 * float(r.norm())
        d = float((got.double() - r).norm())
        worst = max(worst, (d / lim if lim else float(d > 0), names[i],
                            whole / max(float(r.norm()), 1e-30)))
    check(bits == len(names), f"bert dp towers: {bits} of {len(names)} "
                              f"pulls bit for bit torch.add of the towers")
    check(worst[0] <= 1.0, f"bert dp towers: {worst[1]} at {worst[0]:.3f} "
                           f"of its limit from the fp32 gradient")
    log(f"bert dp towers: {len(names)} pulls equal torch.add(half0, "
        f"half1) bit for bit; worst {worst[0]:.3f} of the limit "
        f"(DP_TOWER_RATIO={DP_TOWER_RATIO} x the whole bf16 batch's "
        f"distance from fp32 + a bf16 ulp) at {worst[1]}, whose whole bf16 "
        f"gradient is {worst[2]:.3e} of its norm from fp32")
    return worst[0]


def _dp_nccl_graph(mx, torch, mesh):
    """11d (d): the store's in-graph all-reduce (mean), reduce-scatter and
    all-gather on the mesh's `dp` group (P ranks), run once outside,
    then captured in a CUDA graph and replayed on new values: the right
    results, bit for bit (small integers, exact in bf16, the same on
    every rank); then DP_PROFILE_REPLAYS profiled replays show the
    collectives' device work, one graph launch each and no kernel launch
    from the host, and the check fails on an empty profile. With P > 1
    that is NCCL's kernels. On one rank NCCL runs each collective as a
    device copy (the in-place all-reduce as nothing, and the mean over
    one rank multiplies by nothing), so the graph holds two copies and no
    NCCL kernel: the graph's own node list (`CUDAGraph.debug_dump`) must
    name them, and the profile must show them. Returns the replays' NCCL
    kernel count."""
    kv = mx.kv.create("dist_sync").set_mesh(mesh)
    n = int(mesh.shape["dp"])
    check(kv.capture_spec() is not None and kv.capture_spec()[2] == n,
          f"capture spec {kv.capture_spec()} on a dp mesh of {n}")
    g = torch.Generator(device="cpu").manual_seed(23)
    dev = mesh.device

    def draw():
        return torch.randint(-8, 9, (DP_NCCL_ROWS, 768), generator=g).to(
            dev).to(torch.bfloat16)
    red, rs_in, ag_in = draw(), draw(), draw()
    rs_out = torch.empty((DP_NCCL_ROWS // n, 768), dtype=torch.bfloat16,
                         device=dev)
    ag_out = torch.empty((DP_NCCL_ROWS * n, 768), dtype=torch.bfloat16,
                         device=dev)

    def collectives():
        kv.graph_allreduce(red, "dp", n, mean=True)
        kv.graph_reduce_scatter(rs_in, "dp", n, out=rs_out)
        kv.graph_all_gather(ag_in, "dp", out=ag_out)

    collectives()                       # the communicator, outside
    torch.cuda.synchronize()
    # on one rank the node list is read (debug_dump): keep_graph keeps it
    graph = torch.cuda.CUDAGraph(keep_graph=n == 1)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        collectives()
    if n == 1:
        graph.instantiate()
    want = [draw(), draw(), draw()]
    for t, w in zip((red, rs_in, ag_in), want):
        t.copy_(w)
    graph.replay()
    torch.cuda.synchronize()
    me = mesh.axis_index("dp")
    rows = DP_NCCL_ROWS // n
    for name, got, w in (
            ("all-reduce", red, want[0]),
            ("reduce-scatter", rs_out, want[1][me * rows:(me + 1) * rows]
             * n),
            ("all-gather", ag_out, want[2].repeat(n, 1))):
        check(_bits_equal(torch, got, w), f"nccl in a graph: the replayed "
                                          f"{name} is wrong")
    node_copies = None
    if n == 1:
        with tempfile.TemporaryDirectory() as tmp:
            dot = os.path.join(tmp, "graph.dot")
            graph.debug_dump(dot)
            with open(dot) as f:
                node_copies = f.read().lower().count("memcpy")
        check(node_copies >= 2, f"nccl in a graph, 1 rank: the graph's "
                                f"node list names {node_copies} copies")
    prof = profile_launches(torch, lambda: [
        graph.replay() for _ in range(DP_PROFILE_REPLAYS)])
    check(prof is not None and prof[1], f"nccl in a graph: the profiled "
          f"replays show no device work "
          f"({'no profiler' if prof is None else 'no device rows'})")
    _, rows_, calls = prof
    log_profile(f"nccl in a graph, {n} rank(s)", prof[0], rows_,
                f"{DP_PROFILE_REPLAYS} replays")
    nccl = [r for r in rows_ if "nccl" in r[2].lower()]
    copies = sum(r[1] for r in rows_ if "memcpy" in r[2].lower())
    if n > 1:
        check(len(nccl) >= 3, f"nccl in a graph: {len(nccl)} NCCL kernels "
              f"in the replays ({[r[2][:60] for r in rows_]})")
    else:
        check(copies >= 2, f"nccl in a graph: {copies} device copies in "
              f"the one-rank replays ({[r[2][:60] for r in rows_]})")
    check(sum(calls.get(k, 0) for k in GRAPH_LAUNCH_CALLS)
          == DP_PROFILE_REPLAYS and sum(calls.get(k, 0) for k in
                                        KERNEL_LAUNCH_CALLS) == 0,
          f"nccl in a graph: host launch calls {calls}")
    log(f"nccl in a graph: {n} rank(s), results right; {DP_PROFILE_REPLAYS} "
        f"replays ran {sum(r[1] for r in nccl)} NCCL kernels "
        f"({', '.join(r[2][:50] for r in nccl)}) and {copies} device "
        f"copies in the profile, one graph launch each"
        + ("" if node_copies is None else
           f" ({node_copies} copies in the node list, "
           f"{2 * DP_PROFILE_REPLAYS} launched)"))
    return len(nccl)


def phase_bert_dp_bf16(mx, torch, base_tokens_s):
    """11d: 11b's bf16 BERT-base through the store on a one-rank NCCL
    group (`kvstore.init_distributed`). (a) `Trainer(kvstore=
    "dist_sync")` (one `allreduce_flat` a bucket a step) against the
    store-less Trainer from the same weights, under deterministic
    algorithms: the weights bit for bit, each step 12 / 12 / 12 / 26 bf16
    flash forwards, dK/dV, dQ and LayerNorms, the kv counters one
    collective a bucket a step, tokens/s and its spread beside 11b's and
    the store-less run's; (b) `trainer.capture` over that store with a
    `dp` mesh of one (`_captured_vs_eager`, 11c's limits); (c) two towers
    on one card through `kv.create("device")`; (d) the store's
    collectives in a CUDA graph. Returns the launches of (a)'s store run
    and (b)'s captured run."""
    K = mx.ops.kernels
    mx.random.seed(0)
    model = _bert_pretraining(mx)
    model.initialize(ctx=mx.gpu(0))
    model.cast("bfloat16")
    batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
    start = {n: t.clone() for n, t in _param_tensors(model).items()}
    n = len(model.bert.encoder.layers)
    want = dict(dict.fromkeys(K.LAUNCHES, 0), flash_fwd_bf16=n,
                flash_bwd_bf16=n, flash_bwd_dq_bf16=n,
                layer_norm_bf16=2 * n + 2)
    mx.kvstore.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}")
        runs = _dp_store_runs(mx, torch, model, batch, start, want)
        a, b = runs["storeless"], runs["dist_sync"]
        store = b["store"]
        check(store.type == "ici" and store.num_workers == 1
              and store.rank == 0, f"store {store.type} "
              f"{store.rank}/{store.num_workers}")
        same = sum(_bits_equal(torch, b["weights"][k], a["weights"][k])
                   for k in a["weights"])
        check(same == len(a["weights"]), f"bert dp bf16: {same} of "
              f"{len(a['weights'])} weights bit for bit the store-less "
              f"run's")
        check(b["allreduce"] == b["buckets"] * BERT_STEPS and b["buckets"]
              and b["coll_bytes"] == b["grad_bytes"] * BERT_STEPS,
              f"bert dp bf16: {b['allreduce']} kv_allreduce and "
              f"{b['coll_bytes']} bytes for {b['buckets']} buckets x "
              f"{BERT_STEPS} steps of {b['grad_bytes']} bytes")
        check(a["allreduce"] == 0, "the store-less run reduced")
        summary = dict(weights_bit_equal=same, buckets=b["buckets"],
                       kv_allreduce=b["allreduce"],
                       kv_collective_bytes=b["coll_bytes"],
                       tokens_per_s_11b=base_tokens_s,
                       losses=b["losses"])
        for form, r in runs.items():
            timed = r["step_s"][2:]
            tok = [BERT_B * BERT_S / t for t in timed]
            summary[f"tokens_per_s_{form}"] = BERT_B * BERT_S * len(
                timed) / sum(timed)
            summary[f"tokens_per_s_{form}_min"] = min(tok)
            summary[f"tokens_per_s_{form}_max"] = max(tok)
        if base_tokens_s:
            summary["dist_sync_over_11b"] = \
                summary["tokens_per_s_dist_sync"] / base_tokens_s
        log("bert dp bf16 " + json.dumps(summary))
        launches = b["launches"]
        # (b) the captured step over the store, a dp mesh of one
        _restore(torch, model, start)
        mesh = mx.parallel.make_mesh({"dp": 1})
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

        def make_trainer():
            tr = _dp_trainer(mx, model, "dist_sync")
            tr._kvstore.set_mesh(mesh)
            check(tr._kvstore.capture_spec() is not None,
                  "no capture spec on a dp mesh of one")
            return tr
        psum = mx.observability.registry().counter("kv_collective_bytes",
                                                   op="in_graph_psum")
        psum0 = psum.value
        cap_launches = _captured_vs_eager(
            mx, torch, "bert dp bf16 captured", model, make_trainer,
            _bert_bench_loss(mx, model, ce),
            lambda tr: _bert_step(mx, model, tr, ce, batch, True), batch, 1,
            BERT_B * BERT_S, ("flash_fwd_bf16", "flash_bwd_bf16",
                              "flash_bwd_dq_bf16", "layer_norm_bf16"))[0]
        # the gradients reduced inside the graph: every replay (the
        # CAPTURE_STEPS steps and the profiled one) counts their bytes
        psum_bytes = psum.value - psum0
        check(psum_bytes == (CAPTURE_STEPS + 1) * b["grad_bytes"],
              f"bert dp bf16 captured: in_graph_psum {psum_bytes} bytes, "
              f"want {CAPTURE_STEPS + 1} x {b['grad_bytes']}")
        log(f"bert dp bf16 captured: in_graph_psum {psum_bytes} bytes in "
            f"{CAPTURE_STEPS + 1} replays")
        # (c) two towers, (d) NCCL inside a graph
        _restore(torch, model, start)
        _dp_towers(mx, torch, model, batch)
        _dp_nccl_graph(mx, torch, mesh)
    finally:
        mx.kvstore.reset_distributed()
    del model, batch, runs, start
    torch.cuda.empty_cache()
    return launches, cap_launches


def _nmt_loss(mx, model, ce, bench):
    def loss_fn(src, tgt, lab, vl):
        logits = model(src, tgt, vl)
        if bench:
            logits = logits.astype("float32")
        return ce(logits.reshape((-1, VOCAB)), lab.reshape((-1,))).mean()
    return loss_fn


def phase_nmt_train_captured(mx, torch, init_file):
    """Phases 5 and 5b through `trainer.capture`, each beside its eager
    fused step from phase 5's initial weights (`_captured_vs_eager`):
    the fp32 `transformer_base` with Adam 3e-4 (the step count t and the
    bias corrections on the device) at B=32 with rescale 1/B, and the
    cast one with SGD lr 1e-3 momentum 0.9 at B=64 on the mean loss's
    gradient. Every replay launches 18 flash forwards, 18 fused
    backwards and 30 LayerNorms (fp32 forms in both)."""
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for tag, bench in (("nmt captured", False), ("nmt bf16 captured",
                                                  True)):
        model = mx.models.transformer_base(VOCAB, max_length=TRAIN_S,
                                           dropout=0.0)
        model.load_parameters(init_file, ctx=mx.gpu(0))
        if bench:
            model.cast("bfloat16")
            batch = _nmt_bf16_batch(mx, NMT_BF16_B, TRAIN_S, mx.gpu(0))

            def make_trainer(model=model):
                return mx.gluon.Trainer(model.collect_params(), "sgd",
                                        {"learning_rate": NMT_BF16_LR,
                                         "momentum": NMT_BF16_MOMENTUM})
        else:
            batch = _train_batch(mx, TRAIN_B, TRAIN_S, mx.gpu(0))

            def make_trainer(model=model):
                return mx.gluon.Trainer(model.collect_params(), "adam",
                                        {"learning_rate": 3e-4})
        b = batch[0].shape[0]
        out[tag] = _captured_vs_eager(
            mx, torch, tag, model, make_trainer,
            _nmt_loss(mx, model, ce, bench),
            lambda tr, model=model, batch=batch, bench=bench: _train_step(
                mx, model, tr, ce, batch, bench),
            batch, 1 if bench else b, b * TRAIN_S * 2,
            ("flash_fwd", "flash_bwd", "layer_norm"))[0]
        del model, batch
        torch.cuda.empty_cache()
    return out["nmt captured"], out["nmt bf16 captured"]


def _amp_step(mx, trainer, loss_fn, batch, batch_size):
    """One eager float16 AMP step: `loss_fn(*batch)` recorded, scaled by
    the installed DynamicLossScaler for the backward (`amp.scale_loss`),
    then `trainer.step(batch_size)`, which unscales the gradients, judges
    the overflow, skips or updates and moves the scale. Returns the
    unscaled loss."""
    with mx.autograd.record():
        loss = loss_fn(*batch)
        scaled = mx.amp.scale_loss(loss, trainer)
    scaled.backward()
    trainer.step(batch_size)
    return loss


def phase_amp_f16(mx, torch, init_file):
    """float16 AMP (`amp.init("float16")`, MXNet's original AMP mode)
    training at full width through Gluon, eager and captured, each
    through `_captured_vs_eager` (five eager runs of CAPTURE_STEPS steps
    and one captured run, from the same weights, a fresh trainer and
    scaler each): (a) `BERTForPretraining(bert_base(max_length=512))`
    from `mx.random.seed(0)` at bench_bert.py's shape (B=16, S=512, 76
    masked; the losses on logits cast to fp32), Adam 1e-4 on the
    batch-mean loss's gradient; (b) `transformer_base` on phase 5's
    initial weights at B=32 of 64 + 64 tokens, Adam 3e-4 at rescale 1/B.
    Under AMP every Dense runs in float16, so every attention launches
    the float16 flash kernels (BERT's split path: `flash_bwd_dq_f16` too)
    and BERT's MLM LayerNorm `layer_norm_f16` (the residual sums promote
    to fp32, which the fp32 LayerNorm takes, as in the JAX package).
    Returns ({path: launches} of the four runs)."""
    out = {}
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    try:
        mx.random.seed(0)
        model = _bert_pretraining(mx)
        model.initialize(ctx=mx.gpu(0))
        batch = _bert_batch(mx, BERT_B, BERT_S, mx.gpu(0))
        loss_fn = _bert_bench_loss(mx, model, ce)

        def make_trainer():
            mx.amp.init("float16")
            return mx.gluon.Trainer(model.collect_params(), "adam",
                                    {"learning_rate": 1e-4})
        cap, eager = _captured_vs_eager(
            mx, torch, "bert f16 amp", model, make_trainer, loss_fn,
            lambda tr: _amp_step(mx, tr, loss_fn, batch, 1), batch, 1,
            BERT_B * BERT_S, ("flash_fwd_f16", "flash_bwd_f16",
                              "flash_bwd_dq_f16", "layer_norm_f16"))
        out.update(bert_train_f16=eager, bert_train_f16_captured=cap)
        del model, batch, loss_fn
        torch.cuda.empty_cache()
        model = mx.models.transformer_base(VOCAB, max_length=TRAIN_S,
                                           dropout=0.0)
        model.load_parameters(init_file, ctx=mx.gpu(0))
        batch = _train_batch(mx, TRAIN_B, TRAIN_S, mx.gpu(0))
        loss_fn = _nmt_loss(mx, model, ce, True)

        def make_trainer():
            mx.amp.init("float16")
            return mx.gluon.Trainer(model.collect_params(), "adam",
                                    {"learning_rate": 3e-4})
        cap, eager = _captured_vs_eager(
            mx, torch, "nmt f16 amp", model, make_trainer, loss_fn,
            lambda tr: _amp_step(mx, tr, loss_fn, batch, TRAIN_B), batch,
            TRAIN_B, TRAIN_B * TRAIN_S * 2,
            ("flash_fwd_f16", "flash_bwd_f16", "layer_norm"))
        out.update(nmt_train_f16=eager, nmt_train_f16_captured=cap)
        del model, batch, loss_fn
    finally:
        mx.amp.reset()
    torch.cuda.empty_cache()
    return out


def phase_serve_cast(mx, torch):
    """A TransformerNMT after `cast("bfloat16")` served on the card:
    `transformer_base(36548)` from `mx.random.seed(0)`, cast, behind
    `Server(engine_driven=False)` with the fast path's settings, the 16
    requests of `_fastpath_requests` at k = 0 and at speculative_k=3
    (`_fast_run`: every prefill launches the flash forward, every decode
    turn the paged kernel, once a layer). The positional table stays fp32,
    so the activations, the pages and the kernels are fp32 (the JAX
    runtime takes the position table's dtype); speculation must give the
    k = 0 server's greedy tokens (or part at a near tie). Returns the
    launches of both servers, summed."""
    mx.random.seed(0)
    model = mx.models.transformer_base(VOCAB, dropout=0.0)
    model.initialize(ctx=mx.gpu(0))
    model.cast("bfloat16")
    reqs = _fastpath_requests()
    ref_srv, ref_h, ref_sum, total = _fast_run(
        mx, torch, model, reqs, "cast k=0", "ragged_paged_attention")
    check(ref_srv.runtime.k_pages.dtype == torch.float32,
          f"cast server pages {ref_srv.runtime.k_pages.dtype}")
    log("serve cast " + json.dumps(ref_sum))
    ref = [list(h.tokens) for h in ref_h]
    srv, handles, summary, launches = _fast_run(
        mx, torch, model, reqs, f"cast k={SPEC_K}",
        "ragged_paged_attention_multi", speculative_k=SPEC_K)
    got = [list(h.tokens) for h in handles]
    summary["match_vs_k0"] = _match_rate(ref, got)
    log("serve cast " + json.dumps(summary))
    for i, req in enumerate(reqs):
        how = _same_or_near_tie(ref_srv.runtime, req, got[i], ref[i],
                                LOGITS_TOL, f"cast k={SPEC_K} vs k=0 "
                                            f"request {i}")
        if how != "greedy tokens identical":
            log(f"serve cast request {i}: {how}")
    srv.close()
    ref_srv.close()
    del model
    torch.cuda.empty_cache()
    return {n: total[n] + launches[n] for n in total}


def _snapshot(trainer, model):
    return ([p.data()._data.detach().clone() for p in trainer._params],
            [s._data.clone() for st in trainer._updater.states.values()
             for s in st])


def phase_capture_guard(mx, torch):
    """The guard on the card. (a) A captured 2-layer full-width bf16
    BERT (SGD with momentum, skip_nonfinite=True) with `grad.nan` at
    step 2: that replay leaves every weight and state (momentum) bit for
    bit, the streak goes to 1 and back to 0 on step 3, which updates.
    (b) float16 AMP's loss scaler on a Dense stack (768 -> 3072 -> 768 ->
    10; the flash kernels take no float16) with `grad.nan` at step 2,
    captured against eager from the same weights: the same loss scale
    after every step, and each weight within one fp32 ulp (2^-23) of the
    eager one in norm (the same deterministic kernels)."""
    inj = mx.fault.injection
    mx.random.seed(0)
    model = _bert_pretraining(mx, num_layers=2)
    model.initialize(ctx=mx.gpu(0))
    model.cast("bfloat16")
    batch = _bert_batch(mx, 2, BERT_S, mx.gpu(0), lens=(300, 512))
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": BERT_BF16_LR,
                                "momentum": BERT_BF16_MOMENTUM},
                               skip_nonfinite=True)
    step = trainer.capture(_bert_bench_loss(mx, model, ce))
    inj.clear()
    inj.inject("grad.nan", at=[2])
    streaks = []
    try:
        step(*batch, batch_size=1)
        streaks.append(trainer.consecutive_skipped_steps)
        before = _snapshot(trainer, model)
        step(*batch, batch_size=1)
        streaks.append(trainer.consecutive_skipped_steps)
        after = _snapshot(trainer, model)
        step(*batch, batch_size=1)
        streaks.append(trainer.consecutive_skipped_steps)
        moved = _snapshot(trainer, model)
    finally:
        inj.clear()
    check(step.last_fallback_reason is None and step.cache_size == 1,
          f"guard: fell back ({step.last_fallback_reason})")
    same = sum(int(torch.equal(a, b)) for a, b in zip(before[0] + before[1],
                                                      after[0] + after[1]))
    total = len(before[0]) + len(before[1])
    check(same == total, f"guard: the skipped replay changed "
                         f"{total - same} of {total} weights and states")
    check(streaks == [0, 1, 0], f"guard: streaks {streaks} != [0, 1, 0]")
    changed = sum(int(not torch.equal(a, b)) for a, b in zip(after[0],
                                                             moved[0]))
    check(changed > 0, "guard: step 3 moved no weight")
    log(f"capture guard: bf16 BERT (2 layers, B=2) with grad.nan at step "
        f"2: {same} of {total} weights and states bit for bit through the "
        f"skipped replay, streaks {streaks}, step 3 moved {changed} of "
        f"{len(after[0])} weights")
    del model, trainer, step, before, after, moved
    scales = {}
    rng = np.random.RandomState(0)
    x = rng.randn(64, 768).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    weights = None
    for captured in (False, True):
        net = mx.gluon.nn.Sequential()
        net.add(mx.gluon.nn.Dense(3072, activation="relu"),
                mx.gluon.nn.Dense(768, activation="relu"),
                mx.gluon.nn.Dense(10))
        mx.random.seed(0)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        xb, yb = mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(y, ctx=mx.gpu(0))
        net(xb)
        mx.amp.init("float16")
        inj.clear()
        inj.inject("grad.nan", at=[2])
        seq = []
        try:
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.05, "momentum": 0.9})
            lossf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            if captured:
                cstep = tr.capture(lambda a, b: lossf(net(a), b).mean())
            for _ in range(4):
                if captured:
                    cstep(xb, yb)
                    check(cstep.last_fallback_reason is None,
                          f"amp capture fell back "
                          f"({cstep.last_fallback_reason})")
                else:
                    with mx.autograd.record():
                        loss = mx.amp.scale_loss(lossf(net(xb), yb).mean())
                    loss.backward()
                    tr.step(64)
                seq.append((mx.amp.scaler().loss_scale,
                            tr.consecutive_skipped_steps))
        finally:
            mx.amp.reset()
            inj.clear()
        scales[captured] = seq
        w = {n: t.clone() for n, t in _param_tensors(net).items()}
        if weights is None:
            weights = w
        else:
            err = max(_rel(torch, w[n], weights[n]) for n in w)
            check(err <= 2.0 ** -23, f"amp: captured weights {err:.3e} "
                                     f"from eager in norm")
    check(scales[True] == scales[False],
          f"amp: captured scales {scales[True]} != eager {scales[False]}")
    check(scales[True][1][0] < scales[True][0][0],
          f"amp: the poisoned step did not halve the scale: {scales[True]}")
    log(f"capture guard: float16 AMP with grad.nan at step 2, (loss scale, "
        f"streak) after each step, captured {scales[True]}, eager "
        f"{scales[False]}; weights within {err:.3e} in norm")
    torch.cuda.empty_cache()


def phase_resnet_captured_bn(mx, torch, init_file):
    """BatchNorm's running statistics through a captured step: phase
    9b's cut S2D ResNet (one bottleneck a stage at full width) on phase
    7's weights, cast to bf16, B=16, 3 steps of bench.py's SGD, captured
    against eager from the same weights: every running statistic moved,
    and each one and each weight within one bf16 ulp (2^-8) of the eager
    one in norm (the same deterministic kernels);
    no port kernel launches (the JAX ResNet runs none)."""
    K = mx.ops.kernels
    x, y = _resnet_batch(mx, 16, mx.gpu(0))
    x = x.astype("bfloat16")
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for captured in (False, True):
        net = _resnet_s2d(mx, cut=True)
        net.load_parameters(init_file, ctx=mx.gpu(0), ignore_extra=True)
        net.cast("bfloat16")
        start = {n: t.clone() for n, t in _param_tensors(net).items()}
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": RESNET_BF16_LR,
                                    "momentum": RESNET_BF16_MOMENTUM})
        K.reset_launch_counts()
        if captured:
            step = trainer.capture(
                lambda a, b: ce(net(a).astype("float32"), b).mean())
            for _ in range(3):
                step(x, y, batch_size=1)
                check(step.last_fallback_reason is None,
                      f"resnet capture fell back "
                      f"({step.last_fallback_reason})")
        else:
            for _ in range(3):
                _resnet_bf16_step(mx, net, trainer, ce, x, y)
        check(dict(K.LAUNCHES) == dict.fromkeys(K.LAUNCHES, 0),
              f"resnet BN: port kernels launched {dict(K.LAUNCHES)}")
        params = net._collect_params_with_prefix()
        out[captured] = {n: t.clone() for n, t in
                         _param_tensors(net).items()}
        stats = [n for n, p in params.items() if p.grad_req == "null"]
        moved = sum(int(not torch.equal(out[captured][n], start[n]))
                    for n in stats)
        check(moved == len(stats), f"resnet BN: {len(stats) - moved} "
                                   f"running statistics did not move")
        del net, trainer
    stats_err = max(_rel(torch, out[True][n], out[False][n])
                    for n in stats)
    w_err = max(_rel(torch, out[True][n], out[False][n]) for n in out[True])
    check(w_err <= 2.0 ** -8, f"resnet BN: captured vs eager "
                                   f"{w_err:.3e} in norm")
    log(f"capture resnet BN: cut S2D ResNet bf16, B=16, 3 steps: "
        f"{len(stats)} running statistics moved; captured vs eager worst "
        f"{stats_err:.3e} (statistics), {w_err:.3e} (all) in norm")
    torch.cuda.empty_cache()


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


def _lc_block_check(mx, torch, g, dtype=None):
    """(b) `flash_block_attention` in `dtype` (fp32 when None) against the
    plain versions of the kernels it runs (`_flash_plain`,
    `_flash_bwd_plain` on delta - g_lse) at the example's shape, causal
    and not, with random cotangents of out and a nonzero one of lse: out,
    lse and dQ, dK, dV within FLASH_TOL / BWD_TOL in fp32, the dtype's
    LOWP limits in bf16 / fp16 (lse FLASH_TOL), and no further from
    float64 than FLASH_F64_RATIO / BWD_F64_RATIO times the plain version
    in fp32, BF16_F64_RATIO times plus the dtype's floor in 16 bits.
    Returns the worst error."""
    K = mx.ops.kernels
    dtype = dtype or torch.float32
    lim = None if dtype == torch.float32 else _lowp(dtype)
    tag = "" if lim is None else f" {lim['label']}"
    dev = torch.device("cuda", 0)
    shape = (LC_B, LC_H, LC_S, LC_D)
    scale = LC_D ** -0.5
    worst = 0.0
    for causal in (False, True):
        q, k, v, do = (torch.randn(shape, generator=g).to(dev).to(dtype)
                       for _ in range(4))
        g_lse = torch.randn(shape[:3], generator=g).to(dev)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        out, lse = K.flash_block_attention(qg, kg, vg, causal)
        check(out.dtype == dtype and lse.dtype == torch.float32,
              f"flash_block{tag}: out {out.dtype}, lse {lse.dtype}")
        got = [out.detach(), lse.detach(),
               *torch.autograd.grad((out, lse), (qg, kg, vg), (do, g_lse))]
        p_out, p_lse = K._flash_plain(q, k, v, causal, scale, None)
        delta = ((p_out.float() * do.float()).sum(-1) - g_lse).reshape(
            -1, LC_S)
        plain = [p_out, p_lse.reshape(shape[:3]),
                 *K._flash_bwd_plain(q, k, v, do, p_lse, delta, causal,
                                     scale, None)]
        f64 = _block_f64(torch, q, k, v, do, g_lse, causal, scale)
        errs, errs64, plain64 = {}, {}, {}
        for name, a, p, r64 in zip(("out", "lse", "dq", "dk", "dv"), got,
                                   plain, f64):
            fwd = name in ("out", "lse")
            errs[name] = (a.float() - p.float()).abs().max().item()
            if lim is None or name == "lse":
                ok = torch.allclose(a, p, **(FLASH_TOL if fwd else BWD_TOL))
            else:
                atol = lim["out_atol"] * _slice_max(v) if name == "out" \
                    else lim["grad_atol"] * _slice_max(p)
                ok = _bf16_share(torch, a, p, atol, lim["rtol"]) <= 1.0
            check(torch.isfinite(a).all().item() and ok,
                  f"flash_block{tag} {name} causal={causal} vs plain: max "
                  f"abs err {errs[name]}")
            errs64[name] = (a.cpu().double() - r64).abs().max().item()
            plain64[name] = (p.cpu().double() - r64).abs().max().item()
            if lim is None:
                limit = (FLASH_F64_RATIO if fwd else BWD_F64_RATIO) \
                    * plain64[name]
            else:
                floor = FP32_F64_FLOOR if name == "lse" \
                    else lim["f64_floor"]
                limit = BF16_F64_RATIO * plain64[name] \
                    + floor * r64.abs().max().item()
            check(errs64[name] <= limit,
                  f"flash_block{tag} {name} causal={causal}: {errs64[name]}"
                  f" from float64, more than {limit} (plain "
                  f"{plain64[name]})")
        worst = max(worst, *errs.values())
        log(f"flash_block{tag} {shape} causal={causal}, nonzero g_lse: max "
            f"abs err vs plain {errs}; vs float64 {errs64} (plain "
            f"{plain64})")
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


def _lc_times(mx, torch, g, dtype=None):
    """(d) `flash_block_attention` in `dtype` (fp32 when None) forward and
    forward + backward at the example's shape (causal), by CUDA-graph
    replay, beside the plain versions and SDPA's forward and forward +
    backward in the same dtype; the bound at the split-TF32 rate in fp32,
    the tensor cores' bf16 / fp16 rate otherwise."""
    K = mx.ops.kernels
    dtype = dtype or torch.float32
    dev = torch.device("cuda", 0)
    shape = (LC_B, LC_H, LC_S, LC_D)
    scale = LC_D ** -0.5
    q, k, v, do = (torch.randn(shape, generator=g).to(dev).to(dtype)
                   for _ in range(4))
    g_lse = torch.randn(shape[:3], generator=g).to(dev)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def block_fwd_bwd():
        torch.autograd.grad(K.flash_block_attention(qg, kg, vg, True),
                            (qg, kg, vg), (do, g_lse))

    def plain_fwd_bwd():
        out, lse = K._flash_plain(q, k, v, True, scale, None)
        delta = ((out.float() * do.float()).sum(-1) - g_lse).reshape(-1,
                                                                     LC_S)
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
    rows_q = q.element_size() * LC_B * LC_H * LC_S * LC_D   # (B, H, S, D)
    stats = 4 * LC_B * LC_H * LC_S                 # bytes of lse
    rate = PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    # forward: q, k, v read, out and lse written; QK^T and PV
    fwd_b = bound(4 * rows_q + stats, 4 * pairs * LC_D, rate)
    # forward + backward: q, k, v, dO and g_lse read, out, lse, dQ, dK
    # and dV written; the backward adds S, dP, dV, dQ and dK
    all_b = bound(8 * rows_q + 2 * stats, 14 * pairs * LC_D, rate)
    tflops = {name: f * pairs * LC_D / (dev_ms[name] * 1e-3) / 1e12
              for name, f in (("fwd", 4), ("fwd_bwd", 14))}
    log(f"flash_block timed {shape} causal {dtype}: device (CUDA graph) "
        f"{dev_ms}; bounds fwd {fwd_b}, fwd+bwd {all_b}; fwd / SDPA fwd "
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


def _lc_example_lowp(mx, torch, mesh, arrays, dtype):
    """(a) in bfloat16: examples/long_context.py's flow on the one-rank
    mesh, both strategies forward and backward through their `_sharded`
    entries on bf16 inputs, the counters zeroed just before and read
    just after (one flash_block_bf16 forward and one bf16 flash forward
    and split backward each); held against `flash_attention` in bf16
    over the whole sequence (the LOWP limits). Returns the launches."""
    K = mx.ops.kernels
    lim = _lowp(dtype)
    sfx = K._suffix(dtype)
    par = mx.parallel
    qu, ku, vu, wu = (t.detach().to(dtype).requires_grad_(True)
                      for t in _lc_leaves(torch, arrays, True))
    qr, kr, vr = (t.detach().transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in (qu, ku, vu))
    w = wu.detach().transpose(1, 2).contiguous()
    qf, kf, vf = (t.detach().clone().requires_grad_(True)
                  for t in (qr, kr, vr))
    ref = K.flash_attention(qf, kf, vf, causal=True)
    ref_grads = torch.autograd.grad((ref.float() * w.float()).sum(),
                                    (qf, kf, vf))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    uly = par.ulysses_attention_sharded(qu, ku, vu, mesh, causal=True)
    (uly.float() * wu.detach().float()).sum().backward()
    ring = par.ring_attention_sharded(qr, kr, vr, mesh, causal=True)
    (ring.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {f"flash_block{sfx}": 2, f"flash_fwd{sfx}": 2,
            f"flash_bwd{sfx}": 2, f"flash_bwd_dq{sfx}": 2}
    check(launches == dict(dict.fromkeys(K.LAUNCHES, 0), **want),
          f"long context {dtype} launches {launches}, want {want}")
    outs = {"ulysses": uly.detach().transpose(1, 2), "ring": ring.detach()}
    grads = {"ulysses": [t.grad.transpose(1, 2) for t in (qu, ku, vu)],
             "ring": [t.grad for t in (qr, kr, vr)]}
    worst = 0.0
    for what in outs:
        check(outs[what].dtype == dtype, f"{what} {dtype}: {outs[what].dtype}")
        share = _bf16_share(torch, outs[what], ref.detach(),
                            lim["out_atol"] * _slice_max(vf), lim["rtol"])
        check(share <= 1.0, f"{what} {dtype} vs flash_attention: share "
                            f"{share}")
        worst = max(worst, share)
        for name, a, r in zip(("dq", "dk", "dv"), grads[what], ref_grads):
            share = _bf16_share(torch, a, r, lim["grad_atol"]
                                * _slice_max(r), lim["rtol"])
            check(share <= 1.0, f"{what} {dtype} {name} vs flash_attention:"
                                f" share {share}")
            worst = max(worst, share)
    log(f"long context {(LC_B, LC_S, LC_H, LC_D)} causal in {lim['label']}, "
        f"sp={mesh.shape['sp']} over NCCL: ulysses and ring within the "
        f"{lim['label']} limits of flash_attention (worst share "
        f"{worst:.3f}); launches {launches}")
    return launches


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
    (a) in bf16 follows (`_lc_example_lowp`), then (b) and (d) in bf16
    and fp16 (the fp16 times in the bf16 row's `per_shape`). Returns
    the kernels rows of `flash_block_attention` (fp32, bf16) and the
    launches of (a) in each."""
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
        bf = torch.bfloat16
        launches_bf16 = _lc_example_lowp(mx, torch, mesh, arrays, bf)
        worst_bf16 = _lc_block_check(mx, torch, g, bf)
        _lc_block_check(mx, torch, g, torch.float16)
        row_bf16 = _lc_times(mx, torch, g, bf)
        row_f16 = _lc_times(mx, torch, g, torch.float16)
        # the fp16 form (no path casts to it) beside the bf16 row
        row_bf16["per_shape"] += [
            dict(entry, dtype="float16", what=f"{entry['what']}, float16")
            for entry in row_f16["per_shape"]] + [dict(
                shape=list(row_f16["per_shape"][0]["shape"]), causal=True,
                dtype="float16", what="forward + backward, float16",
                ms=row_f16["ms"], plain_ms=row_f16["plain_ms"],
                bound_ms=row_f16["bound_ms"], bound_by=row_f16["bound_by"],
                library_ms=row_f16["library_ms"])]
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
    common = dict(route="cuda", source="mxnet_tpu_torch/ops/kernels.py",
                  replaces="mxnet_tpu/ops/pallas_kernels.py:741")
    rows = [dict(name="flash_block_attention", counter="flash_block",
                 max_abs_err=worst, **common, **row),
            dict(name="flash_block_attention_bf16",
                 counter="flash_block_bf16", max_abs_err=worst_bf16,
                 **common, **row_bf16)]
    return rows, {"long_context": launches,
                  "long_context_bf16": launches_bf16}


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


# `--ranks N`, phase 11d over N ranks: each form's weights after
# BERT_STEPS steps against the one-rank run on the global batch, per
# parameter in norm: at most DP_RANKS_RATIO of how far that run moved the
# parameter, plus 2^-7 of its norm (a bf16 ulp where an element sits at
# the bottom of its binade: the ranks' reduction sums bf16 gradients in
# another order than one backward over all the rows). An embedding table
# (DP_RANKS_TABLES) adds twice the one-rank run's distance from an fp32
# copy of the model trained the same way: its backward adds thousands of
# rows into a few bf16 rows, where small addends are lost (the token-type
# table adds 32768 rows into two in the one-rank run, 8192 a rank here;
# it was 1.105x its limit without that term, every other parameter
# below, on four H100s), so the one-rank run is no exact yardstick
# there, and the bf16 parity rule (twice the reference's distance from
# fp32, plus an ulp) measures how far off it is. Every form's losses
# (the global batch's: the eager ranks' means all-reduced) within
# DP_RANKS_LOSS_RTOL of the one-rank run's: a gradient off by a factor
# would move them by about as much as the 10 steps do (1 %)
DP_RANKS_RATIO = 0.5
DP_RANKS_LOSS_RTOL = 2.0 ** -8
DP_RANKS_TABLES = ("word_embed", "token_type_embed", "position")


def _dp_rank_runs(mx, torch, world, rank):
    """11d over `world` ranks on the default group, this rank's part: the
    eager store path on its BERT_B rows (`step(world)`: each rank's loss
    is its rows' mean; the global loss is their all-reduced mean), the
    captured step over a `dp` store fed the global batch (each rank cuts
    its rows, `global_batch=True`; 'mean'), and `sharded_update=True`
    fed this rank's rows; rank 0 also runs the one-rank reference on the
    global batch, and an fp32 copy of it for the embedding tables, and
    measures every form against it. Checks nothing (`dp_ranks_main`
    does, once every rank has ended): returns a JSON-able dict."""
    import hashlib
    mesh = mx.parallel.make_mesh({"dp": world})
    ctx = mesh.device
    mx.random.seed(0)
    model = _bert_pretraining(mx)
    model.initialize(ctx=ctx)
    model.cast("bfloat16")
    start = {n: t.clone() for n, t in _param_tensors(model).items()}
    glob = _bert_batch(mx, BERT_B * world, BERT_S, ctx)
    mine = [mx.nd.NDArray(a._data[rank * BERT_B:(rank + 1) * BERT_B])
            for a in glob]
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn = _bert_bench_loss(mx, model, ce)
    out, weights = {"rank": rank, "device": str(ctx)}, {}

    def eager_step(tr):
        with mx.autograd.record():
            loss = loss_fn(*mine)
        loss.backward()
        tr.step(world)
        # the global batch's loss: the mean of the ranks' means
        total = loss._data.detach().float().clone()
        torch.distributed.all_reduce(total)
        return mx.nd.NDArray(total / world)

    for form in ("eager", "captured", "sharded"):
        _restore(torch, model, start)
        tr = _dp_trainer(mx, model, "dist_sync")
        if form == "eager":
            step = lambda: eager_step(tr)        # noqa: E731
        else:
            tr._kvstore.set_mesh(mesh)
            cap = tr.capture(loss_fn, sharded_update=form == "sharded")
            if form == "captured":
                step = lambda cap=cap: cap(      # noqa: E731
                    *glob, batch_size=1, global_batch=True)
            else:
                step = lambda cap=cap: cap(*mine, batch_size=1)  # noqa: E731
        t_form = time.perf_counter()
        losses = [float(step()._data.detach()) for _ in range(BERT_STEPS)]
        log(f"dp rank {rank}: {form}, {BERT_STEPS} steps in "
            f"{time.perf_counter() - t_form:.1f} s")
        weights[form] = {n: t.clone() for n, t in
                         _param_tensors(model).items()}
        h = hashlib.sha256()
        for t in weights[form].values():
            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
        out[form] = dict(losses=losses, digest=h.hexdigest(), state_bytes=sum(
            s._data.numel() * s._data.element_size()
            for st in tr._updater.states.values() for s in st),
            fallback=None if form == "eager" else cap.last_fallback_reason)
    # what ZeRO keeps: 1/P of every momentum whose dim 0 splits over P
    out["sharded_state_bytes_want"] = sum(
        (p.data()._data.numel() * 2) // (
            world if p.data().shape[0] % world == 0 else 1)
        for p in model.collect_params().values())
    if rank == 0:
        _restore(torch, model, start)
        tr = _dp_trainer(mx, model, None)
        ref = [float(_bert_step(mx, model, tr, ce, glob, True)
                     ._data.detach()) for _ in range(BERT_STEPS)]
        ref_w = _param_tensors(model)
        # the fp32 copy from the same start, trained the same way
        f32 = _bert_pretraining(mx)
        f32.initialize(ctx=ctx)
        for p, (n, q) in zip(f32._collect_params_with_prefix().values(),
                             start.items()):
            p.set_data(mx.nd.NDArray(q.float()))
        tr32 = _dp_trainer(mx, f32, None)
        for _ in range(BERT_STEPS):
            _bert_step(mx, f32, tr32, ce, glob, True)
        ref32 = {n: t.double() for n, t in zip(
            start, _param_tensors(f32).values())}
        del f32, tr32
        worst, table_err = {}, {}
        for n in ref_w:
            if any(k in n for k in DP_RANKS_TABLES):
                table_err[n] = float((ref_w[n].double() - ref32[n]).norm())
        for form, ws in weights.items():
            worst[form] = (0.0, "")
            for n, w in ws.items():
                moved = float((ref_w[n].double() - start[n].double()).norm())
                lim = DP_RANKS_RATIO * moved + 2.0 * table_err.get(
                    n, 0.0) + 2.0 ** -7 * float(ref_w[n].double().norm())
                d = float((w.double() - ref_w[n].double()).norm())
                worst[form] = max(worst[form], (d / lim if lim else 0.0, n))
        out["reference_losses"] = ref
        out["table_distance_from_fp32"] = table_err
        out["worst_share_of_limit"] = worst
    del model, weights, start
    if ctx.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _dp_rank(rank, world, port, out_dir):
    """One NCCL rank of `--ranks N`'s phase 11d: writes its result, or
    its traceback and exits at once (a rank that left would hold the
    others in their next collective)."""
    import traceback
    sys.path.insert(0, HERE)
    import torch
    import mxnet_tpu_torch as mx
    # phase_build's settings (the parent built the kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mx.kvstore.init_distributed(f"127.0.0.1:{port}", world, rank)
        check(torch.cuda.current_device() == rank
              and torch.distributed.get_backend() == "nccl",
              f"dp rank {rank} on cuda:{torch.cuda.current_device()}")
        res = _dp_rank_runs(mx, torch, world, rank)
        res["nccl_graph_kernels"] = _dp_nccl_graph(
            mx, torch, mx.parallel.make_mesh({"dp": world}))
        with open(os.path.join(out_dir, f"dp_rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"dp_rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)
    mx.kvstore.reset_distributed()


def dp_ranks_main(mx, torch, world):
    """`--ranks N`'s phase 11d: N NCCL ranks, one card each; then the
    checks: no fallback, every form's weights the same bits on every
    rank, the sharded state 1/N of each momentum whose dim 0 splits over
    N, every form within its limit of the one-rank run, NCCL's kernels
    in the graph. Returns the ranks' results."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            mp.start_processes(_dp_rank, args=(world, _free_port(), out_dir),
                               nprocs=world, start_method="spawn")
        except Exception as e:
            errs = {f: open(os.path.join(out_dir, f)).read()
                    for f in sorted(os.listdir(out_dir))
                    if f.endswith(".err")}
            check(False, f"dp {world} ranks: {e}; {errs}")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"dp_rank{r}.json")) as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    log(f"dp {world} ranks: " + json.dumps(r0))
    for form in ("eager", "captured", "sharded"):
        digests = {r[form]["digest"] for r in ranks}
        check(len(digests) == 1, f"dp {world} ranks, {form}: the ranks' "
                                 f"weights differ ({len(digests)} digests)")
        check(all(r[form]["fallback"] is None for r in ranks),
              f"dp {world} ranks, {form}: fell back "
              f"{[r[form]['fallback'] for r in ranks]}")
        share, name = r0["worst_share_of_limit"][form]
        check(share <= 1.0, f"dp {world} ranks, {form}: {name} at "
                            f"{share:.3f} of its limit from the one-rank "
                            f"run on the global batch")
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            r0[form]["losses"], r0["reference_losses"]))
        check(rel <= DP_RANKS_LOSS_RTOL, f"dp {world} ranks, {form}: "
              f"losses {rel:.3e} from the one-rank run's")
    for r in ranks:
        check(r["sharded"]["state_bytes"] == r["sharded_state_bytes_want"],
              f"dp rank {r['rank']}: sharded state "
              f"{r['sharded']['state_bytes']} bytes, want "
              f"{r['sharded_state_bytes_want']}")
    log(f"dp {world} ranks: every form's weights equal on every rank; "
        f"optimizer state a rank {r0['captured']['state_bytes']} bytes "
        f"replicated, {r0['sharded']['state_bytes']} sharded ("
        f"{r0['sharded']['state_bytes'] / r0['captured']['state_bytes']:.3f}"
        f"); worst share of the limit from the one-rank run "
        f"{r0['worst_share_of_limit']}; NCCL kernels in a replay "
        f"{r0['nccl_graph_kernels']}")
    return ranks


def sp_ranks_main(mx, torch, world):
    """`--ranks N`: the long-context example over N NCCL ranks, one card
    each (one process a rank, spawned and joined here), then phase 11d
    over N ranks (`dp_ranks_main`)."""
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
    dp = dp_ranks_main(mx, torch, world)
    composite = composite_ranks_main(mx, torch, world)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"sp_ranks": ranks, "dp_ranks": dp,
                      "composite_ranks": composite}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 14: the composite 5-axis train step (dp x pp x tp x sp x ep)
# ---------------------------------------------------------------------------
# BERT-base's widths (vocab 30522, 768, 12 heads of 64, FFN 3072, 12
# layers, S = 512) with a Switch-style MoE layer in every block, shaped
# as the Switch Transformer's 8-expert base models (Fedus et al.,
# arXiv:2101.03961: top-1 over 8 experts at d_model 768, capacity factor
# 1.25), each expert BERT-base's FFN width; B = 8 in 2 microbatches, SGD
# at 1e-2, fp32 (TF32 off): about 585 M parameters
COMPOSITE_BASE = dict(vocab=30522, d_model=768, n_heads=12, d_head=64,
                      d_ff=3072, n_experts=8, d_expert_ff=3072, n_layers=12,
                      seq_len=512, batch=8, n_micro=2, capacity_factor=1.25,
                      lr=1e-2)
COMPOSITE_STEPS = 10
# 14 (b): the fp32 step's loss and each updated leaf no further (in norm)
# from one float64 step through the plain versions than
# COMPOSITE_F64_RATIO x the fp32 plain step's distance from it, plus one
# fp32 ulp of the largest element (a leaf whose update both fp32 steps
# round alike has equal distances; the kernels' other summation order
# shows in the gradients, which the update carries at lr = 1e-2). 14 (d)
# holds remat and the all-to-all step to (a)'s first step within the
# same limits, and `--ranks 4` every factorisation to the one-rank step
COMPOSITE_F64_RATIO = 4.0
# 14 (c): 2 layers, B = 2, on the card and the CPU (plain versions) from
# the same weights: the loss within TRAIN_LOSS_RTOL, each leaf's update
# within COMPOSITE_CPU_RTOL of the CPU's in norm, plus one fp32 ulp of
# the leaf's largest element for each element (the two round the updated
# weights apart where their gradients differ in the last bits)
COMPOSITE_CPU_RTOL = 1e-3
# 14 (e): each helper's output and gradients within COMPOSITE_HELPER_RTOL
# of the reference's norm: fp32 sums in another grouping (the pipeline's
# weight gradient adds four microbatches' products; the loop takes them
# in one GEMM)
COMPOSITE_HELPER_RTOL = 1e-5
# the launches of one step (12 layers x 2 microbatches: a ring block and
# three LayerNorms each, S = 512 takes the split backward; the final
# LayerNorm once)
COMPOSITE_WANT = dict(flash_block=24, flash_fwd=24, flash_bwd=24,
                      flash_bwd_dq=24, layer_norm=73)
# `--ranks 4`: (tag, (dp, pp, tp, sp, ep), config changes), each against
# the one-rank step of its configuration; over the model axes only the
# drops do not depend on the factorisation, so capacity 1.25 holds; with
# dp or sp above 1 a shard's capacity is smaller, so capacity n_experts
# (nothing drops, as the JAX package's dryrun_multichip runs it). GPipe
# with 3 microbatches over 2 stages needs a batch that dp * 3 divides: 12
COMPOSITE_RANKS_LAYERS = 4
COMPOSITE_RANKS_CASES = [
    ("pp2_tp2", (1, 2, 2, 1, 1), {}),
    ("tp2_ep2", (1, 1, 2, 1, 2), {}),
    ("sp2_ep2_ring", (1, 1, 1, 2, 2), dict(capacity_factor=8.0, batch=12,
                                           n_micro=3)),
    ("sp2_ep2_alltoall", (1, 1, 1, 2, 2), dict(
        capacity_factor=8.0, batch=12, n_micro=3, sp_strategy="alltoall")),
    ("dp2_pp2_micro3", (2, 2, 1, 1, 1), dict(capacity_factor=8.0, batch=12,
                                             n_micro=3))]


def _composite_cfg(mx, **change):
    return mx.parallel.composite.CompositeConfig(
        **{**COMPOSITE_BASE, **change})


def _composite_data(torch, cfg, dev):
    """Tokens and targets (batch, seq_len), int64, from a CPU seed."""
    g = torch.Generator().manual_seed(14)
    shape = (cfg.batch, cfg.seq_len)
    return (torch.randint(0, cfg.vocab, shape, generator=g).to(dev),
            torch.randint(0, cfg.vocab, shape, generator=g).to(dev))


def _composite_leaves(mx, tree):
    return dict(mx.parallel.composite._leaves_with_paths(tree))


def _composite_run(mx, torch, mesh, cfg, params, tokens, targets):
    """One composite step from a copy of the global `params`: (this
    rank's updated blocks {path: tensor}, loss)."""
    step, shard, data_sh = mx.parallel.composite.make_composite_train_step(
        mesh, cfg)
    p, loss = step(shard(params), data_sh.place(tokens),
                   data_sh.place(targets))
    return _composite_leaves(mx, p), float(loss)


@contextlib.contextmanager
def _composite_plain(mx, torch):
    """The composite step through the plain versions of its kernels, in
    the tensors' own dtype (their formulas: LayerNorm's centred biased
    variance, eps 1e-5; causal softmax attention over the sequence, which
    a one-rank ring covers in its one diagonal block), so that it runs in
    float64 too."""
    import math
    comp = mx.parallel.composite

    def ln(x, g, b, eps=1e-5):
        xc = x - x.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
        return xc * torch.rsqrt(var + eps) * g + b

    def attention(q, k, v, axis_name="sp", causal=False, sm_scale=None, *,
                  mesh):
        check(mesh.shape[axis_name] == 1, "the plain composite runs on one "
                                          "rank")
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
        return torch.matmul(torch.softmax(s, -1), v)
    saved = comp._ln, comp.ring_attention
    comp._ln, comp.ring_attention = ln, attention
    try:
        yield
    finally:
        comp._ln, comp.ring_attention = saved


def _composite_limits(mx, torch, mesh, cfg, params, tokens, targets):
    """14 (b)'s limits for `cfg` from `params`: the fp32 plain step's and
    a float64 plain step's leaves, each leaf's limit COMPOSITE_F64_RATIO
    x their distance plus one fp32 ulp of its largest element. Returns
    (float64 leaves, float64 loss, {path: limit}, loss limit)."""
    with _composite_plain(mx, torch):
        plain, plain_loss = _composite_run(mx, torch, mesh, cfg, params,
                                           tokens, targets)
        p64 = mx.parallel.composite._rebuild(
            list(_composite_leaves(mx, params)),
            [v.double() for v in _composite_leaves(mx, params).values()])
        f64, f64_loss = _composite_run(mx, torch, mesh, cfg, p64, tokens,
                                       targets)
        del p64
    limits = {}
    for path, w in f64.items():
        d = float((plain[path].double() - w).norm())
        limits[path] = COMPOSITE_F64_RATIO * d + 2.0 ** -23 * float(
            w.abs().max())
    loss_lim = COMPOSITE_F64_RATIO * abs(plain_loss - f64_loss) \
        + 2.0 ** -23 * abs(f64_loss)
    return f64, f64_loss, limits, loss_lim


def _composite_worst(got, want, limits):
    """(worst share of its limit, its leaf) of `got` against `want`."""
    worst = (0.0, "")
    for path, w in want.items():
        d = float((got[path].double() - w.double()).norm())
        worst = max(worst, (d / limits[path] if limits[path] else
                            float(d > 0), "/".join(path)))
    return worst


def _composite_drops(mx, drops):
    """Wrap the composite's `route` to keep each call's dropped-token
    count (on the card, read after) in `drops`; returns the original."""
    comp = mx.parallel.composite
    route = comp.route

    def counted(logits, n_experts, capacity_factor):
        out = route(logits, n_experts, capacity_factor)
        drops.append(((~out[3]).sum(), logits.shape[0]))
        return out
    comp.route = counted
    return route


def _composite_helpers(mx, torch, dev):
    """14 (e): the standalone helpers on one-rank meshes at BERT-base's
    width: column- then row-parallel against torch.matmul; pipeline_apply
    with four layers stacked in its one stage against the sequential loop,
    forward and gradients; moe_ffn with an ep mesh against it without."""
    par = mx.parallel
    g = torch.Generator(device=dev.type).manual_seed(15)
    d, f = COMPOSITE_BASE["d_model"], COMPOSITE_BASE["d_ff"]

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def close(a, b, what):
        a, b = a.detach().double(), b.detach().double()
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        check(rel <= COMPOSITE_HELPER_RTOL, f"composite (e) {what}: "
              f"{rel:.3e} of its norm from the reference")
        return rel
    worst = 0.0
    x, w1, w2 = rnd(2048, d), rnd(f, d, scale=d ** -0.5), \
        rnd(d, f, scale=f ** -0.5)
    tp = par.make_mesh({"tp": 1})
    y = par.row_parallel_dense(torch.relu(par.column_parallel_dense(
        x, w1, mesh=tp)), w2, mesh=tp)
    worst = max(worst, close(y, torch.matmul(torch.relu(torch.matmul(
        x, w1.T)), w2.T), "tensor-parallel dense"))
    ws = rnd(1, 4, d, d, scale=d ** -0.5).requires_grad_(True)
    xm = rnd(4, 512, d).requires_grad_(True)
    r = rnd(4, 512, d)

    def stage(p, h):
        for i in range(p["w"].shape[0]):
            h = torch.tanh(torch.matmul(h, p["w"][i]))
        return h
    out = par.pipeline_apply(stage, {"w": ws}, xm, par.make_mesh({"pp": 1}))
    gw, gx = torch.autograd.grad((out * r).sum(), (ws, xm))
    ref = stage({"w": ws[0]}, xm)
    rw, rx = torch.autograd.grad((ref * r).sum(), (ws, xm))
    for a, b, what in ((out, ref, "pipeline forward"),
                       (gw, rw, "pipeline weight gradient"),
                       (gx, rx, "pipeline input gradient")):
        worst = max(worst, close(a, b, what))
    moe = par.init_moe_params(g, 8, d, f, device=dev)
    moe = {k: v.requires_grad_(True) for k, v in moe.items()}
    xe = rnd(2, 512, d).requires_grad_(True)
    re_ = rnd(2, 512, d)
    runs = []
    for mesh in (par.make_mesh({"ep": 1}), None):
        o, aux = par.moe_ffn(moe, xe, mesh=mesh)
        runs.append((o, aux, *torch.autograd.grad(
            (o * re_).sum() + aux, (xe, *moe.values()))))
    for a, b, what in zip(runs[0], runs[1], ("out", "aux", "dx", "dgate",
                                             "dwi", "dwo")):
        worst = max(worst, close(a, b, f"moe_ffn on an ep mesh, {what}"))
    log(f"composite (e): column / row-parallel dense against torch.matmul, "
        f"pipeline_apply (4 layers in one stage, 4 microbatches) against "
        f"the loop with its gradients, moe_ffn over ep = 1 against no mesh "
        f"(8 experts, 2 x 512 tokens): worst {worst:.3e} of the "
        f"reference's norm (COMPOSITE_HELPER_RTOL={COMPOSITE_HELPER_RTOL})")


def phase_composite_train(mx, torch):
    """14: the composite 5-axis train step (`parallel.composite`) at
    COMPOSITE_BASE on a one-rank NCCL group (`make_composite_mesh(1)`,
    every axis of size 1), fp32, under torch's deterministic algorithms.
    (a) COMPOSITE_STEPS steps from `init_composite_params` (seed 0) on
    seeded tokens: each step's launches exactly COMPOSITE_WANT (counters
    zeroed just before, read just after), every loss finite, tokens/s
    over steps 3-10 with its spread, step ms, peak memory, and the share
    of tokens each MoE layer drops (counted from the step's own routing);
    (b) (a)'s first step against one float64 step through the plain
    versions (`_composite_plain`), within COMPOSITE_F64_RATIO of the fp32
    plain step's distance, and a control (one expert's wi_e moved by
    twice its limit) that must fail; (c) 2 layers, B = 2, card against
    CPU; (d) `remat=True` and `sp_strategy="alltoall"`, one step each,
    against (a)'s first step within (b)'s limits; (e) the standalone
    helpers (`_composite_helpers`). Returns (a)'s launches."""
    K = mx.ops.kernels
    comp = mx.parallel.composite
    dev = mx.gpu(0)
    cfg = _composite_cfg(mx)
    mx.kvstore.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}")
        mesh = comp.make_composite_mesh(1)
        check(mesh.device_type == "cuda" and set(mesh.shape.values()) == {1},
              f"mesh {mesh}")
        g = torch.Generator(device=dev.type).manual_seed(0)
        start = comp.init_composite_params(g, cfg, device=dev)
        n_params = sum(v.numel() for v in _composite_leaves(mx, start)
                       .values())
        tokens, targets = _composite_data(torch, cfg, dev)
        step, shard, data_sh = comp.make_composite_train_step(mesh, cfg)
        params = shard(start)
        tok, tgt = data_sh.place(tokens), data_sh.place(targets)
        drops = []
        route = _composite_drops(mx, drops)
        losses, per_step, step_s = [], [], []
        with _deterministic(torch) as caught:
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launch_counts()
                for i in range(COMPOSITE_STEPS):
                    before = dict(K.LAUNCHES)
                    t0 = time.perf_counter()
                    losses.append(float(step(params, tok, tgt)[1]))
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    per_step.append({k: K.LAUNCHES[k] - before[k]
                                     for k in before})
                    if i == 0:
                        first = {k: v.clone() for k, v in
                                 _composite_leaves(mx, params).items()}
                launches = dict(K.LAUNCHES)
            finally:
                comp.route = route
        peak = torch.cuda.max_memory_allocated()
        # one more step under the profiler: a window of thousands of
        # kernels, which loses at most a few at its start (Queue 3 #18)
        prof = device_profile(torch, lambda: step(params, tok, tgt))
        busy, shares = None, None
        if prof is None or not prof[1]:
            log("composite train: the profiled step shows no device row "
                "(not measured)")
        else:
            busy = log_profile("composite train", prof[0], prof[1],
                               "1 step after the timed ones")
            shares = _profile_shares("composite train", prof[1], {
                "gemm": GEMM_WORDS, "flash": ("flash",),
                "layer_norm": ("layer_norm",),
                "index / sort": ("index", "scatter", "gather", "sort",
                                 "embedding"),
                "softmax": ("softmax",)})
        want = dict(dict.fromkeys(K.LAUNCHES, 0), **COMPOSITE_WANT)
        for i, counts in enumerate(per_step):
            check(counts == want, f"composite step {i + 1} launches "
                                  f"{counts} != {want}")
        check(all(np.isfinite(losses)), f"composite losses {losses}")
        n_layers = cfg.n_layers
        per_layer = [0.0] * n_layers
        for i, (n, tokens_in) in enumerate(drops):
            per_layer[i % n_layers] += float(n) / tokens_in / (
                len(drops) / n_layers)
        timed = step_s[2:]
        tok_s = [cfg.batch * cfg.seq_len / t for t in timed]
        summary = dict(
            params=n_params, losses=losses,
            tokens_per_s=cfg.batch * cfg.seq_len * len(timed) / sum(timed),
            tokens_per_s_min=min(tok_s), tokens_per_s_max=max(tok_s),
            step_ms=1e3 * sum(timed) / len(timed),
            step_ms_min=1e3 * min(timed), step_ms_max=1e3 * max(timed),
            peak_gb=peak / 1e9, busy_share=busy, device_shares=shares,
            drop_share_by_layer=per_layer,
            drop_share=sum(per_layer) / n_layers,
            deterministic_warnings=sorted({str(w.message)[:60]
                                           for w in caught}))
        log("composite train " + json.dumps(summary))
        del params
        # (b) against float64
        f64, f64_loss, limits, loss_lim = _composite_limits(
            mx, torch, mesh, cfg, start, tokens, targets)
        worst = _composite_worst(first, f64, limits)
        check(abs(losses[0] - f64_loss) <= loss_lim,
              f"composite (b): loss {losses[0]} vs float64 {f64_loss}, "
              f"limit {loss_lim:.3e}")
        check(worst[0] <= 1.0, f"composite (b): {worst[1]} at "
                               f"{worst[0]:.3f} of its limit from float64")
        path = ("blocks", "wi_e")
        bad = dict(first)
        bump = torch.zeros_like(bad[path])
        bump[0, 3] = torch.randn(bump[0, 3].shape, generator=g,
                                 device=dev)
        bad[path] = bad[path] + 2.0 * limits[path] * bump / bump.norm()
        control = _composite_worst(bad, f64, limits)
        check(control[0] > 1.0 and control[1] == "blocks/wi_e",
              f"composite (b) control: wi_e moved by twice its limit "
              f"passed ({control})")
        log(f"composite (b): loss {losses[0]:.7f} vs float64 "
            f"{f64_loss:.7f} (limit {loss_lim:.3e}); worst leaf {worst[1]} "
            f"at {worst[0]:.3f} of its limit (COMPOSITE_F64_RATIO="
            f"{COMPOSITE_F64_RATIO} x the fp32 plain step's distance + an "
            f"ulp); control: layer 0 expert 3's wi_e moved by twice the "
            f"limit reads {control[0]:.3f}")
        del f64
        # (d) remat and the all-to-all sequence strategy
        for change in (dict(remat=True), dict(sp_strategy="alltoall")):
            with _deterministic(torch):
                got, loss = _composite_run(mx, torch, mesh, _composite_cfg(
                    mx, **change), start, tokens, targets)
            w = _composite_worst(got, first, limits)
            check(w[0] <= 1.0 and abs(loss - losses[0]) <= loss_lim,
                  f"composite (d) {change}: {w[1]} at {w[0]:.3f} of (b)'s "
                  f"limit, loss {loss} vs {losses[0]}")
            log(f"composite (d) {change}: loss {loss:.7f}; worst leaf {w[1]} "
                f"at {w[0]:.3f} of (b)'s limit from (a)'s first step")
            del got
        torch.cuda.empty_cache()
        _composite_helpers(mx, torch, dev)
        # (c) card against CPU, the card's half on this group
        cut = _composite_cfg(mx, n_layers=2, batch=2)
        small = {k: (v if k != "blocks" else {n: b[:2].clone() for n, b in
                                              v.items()})
                 for k, v in start.items()}
        tok2, tgt2 = tokens[:2], targets[:2]
        card, card_loss = _composite_run(mx, torch, mesh, cut, small, tok2,
                                         tgt2)
        card = {k: v.cpu() for k, v in card.items()}
    finally:
        mx.kvstore.reset_distributed()
    del start
    torch.cuda.empty_cache()
    cpu_small = {k: (v.cpu() if k != "blocks" else
                     {n: b.cpu() for n, b in v.items()})
                 for k, v in small.items()}
    mx.kvstore.init_distributed(device="cpu")
    try:
        cpu, cpu_loss = _composite_run(
            mx, torch, comp.make_composite_mesh(1), cut, cpu_small,
            tok2.cpu(), tgt2.cpu())
    finally:
        mx.kvstore.reset_distributed()
    check(abs(card_loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss),
          f"composite (c): loss {card_loss} vs CPU {cpu_loss}")
    w0 = _composite_leaves(mx, cpu_small)
    worst = (0.0, "")
    for path, c in cpu.items():
        lim = COMPOSITE_CPU_RTOL * float((c.double() - w0[path].double())
                                         .norm()) \
            + c.numel() ** 0.5 * 2.0 ** -23 * float(w0[path].abs().max())
        d = float((card[path].double() - c.double()).norm())
        worst = max(worst, (d / lim if lim else float(d > 0),
                            "/".join(path)))
    check(worst[0] <= 1.0, f"composite (c): {worst[1]} at {worst[0]:.3f} "
                           f"of its limit from the CPU")
    log(f"composite (c) card vs cpu (2 layers, B = 2, full width): loss "
        f"{card_loss:.7f} vs {cpu_loss:.7f} (rtol {TRAIN_LOSS_RTOL}); worst "
        f"leaf {worst[1]} at {worst[0]:.3f} of its limit "
        f"(COMPOSITE_CPU_RTOL={COMPOSITE_CPU_RTOL} of the CPU's update + an "
        f"ulp an element)")
    return launches


def _composite_ref_key(change):
    """The one-rank reference a `--ranks` case is held to: its
    configuration but the sequence strategy."""
    return "ref_" + "_".join(f"{k}{v}" for k, v in sorted(change.items())
                             if k != "sp_strategy")


def _composite_refs(mx, torch, ref_dir, cases):
    """`--ranks N`'s references, on card 0 with a one-rank NCCL group:
    for each configuration of COMPOSITE_RANKS_CASES (COMPOSITE_RANKS_LAYERS
    layers), the one-rank step from the seed-0 weights (a CPU generator,
    as the ranks draw them), its leaves written to `ref_dir`, and (b)'s
    limits."""
    comp = mx.parallel.composite
    dev = mx.gpu(0)
    refs = {}
    mx.kvstore.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = comp.make_composite_mesh(1)
        for _, _, change in cases:
            key = _composite_ref_key(change)
            if key in refs:
                continue
            cfg = _composite_cfg(mx, n_layers=COMPOSITE_RANKS_LAYERS,
                                 **{k: v for k, v in change.items()
                                    if k != "sp_strategy"})
            params = comp.init_composite_params(
                torch.Generator().manual_seed(0), cfg, device=dev)
            tokens, targets = _composite_data(torch, cfg, dev)
            with _deterministic(torch):
                got, loss = _composite_run(mx, torch, mesh, cfg, params,
                                           tokens, targets)
            _, f64_loss, limits, loss_lim = _composite_limits(
                mx, torch, mesh, cfg, params, tokens, targets)
            os.makedirs(os.path.join(ref_dir, key))
            for path, w in got.items():
                np.save(os.path.join(ref_dir, key, "_".join(path) + ".npy"),
                        w.cpu().numpy())
            refs[key] = dict(loss=loss, loss_limit=loss_lim,
                             limits={"/".join(p): v for p, v in
                                     limits.items()}, f64_loss=f64_loss)
            del params, got
            torch.cuda.empty_cache()
    finally:
        mx.kvstore.reset_distributed()
    torch.cuda.empty_cache()
    return refs


def _composite_rank_runs(mx, torch, world, rank, ref_dir):
    """`--ranks N`'s composite, this rank's part: every case of
    COMPOSITE_RANKS_CASES on a mesh over the N ranks, one step from the
    seed-0 weights, under deterministic algorithms; for each leaf this
    rank's block, its coordinates, its SHA-256 and its squared distance
    from the same block of the one-rank step. Checks nothing."""
    import hashlib
    comp = mx.parallel.composite
    specs = _composite_leaves(mx, comp.composite_param_specs())
    out = {}
    for tag, sizes, change in COMPOSITE_RANKS_CASES:
        if np.prod(sizes) != world:
            continue
        mesh = mx.parallel.make_mesh(dict(zip(comp.AXES, sizes)))
        dev = mesh.device
        cfg = _composite_cfg(mx, n_layers=COMPOSITE_RANKS_LAYERS, **change)
        params = comp.init_composite_params(
            torch.Generator().manual_seed(0), cfg, device=dev)
        tokens, targets = _composite_data(torch, cfg, dev)
        t0 = time.perf_counter()
        with _deterministic(torch):
            got, loss = _composite_run(mx, torch, mesh, cfg, params, tokens,
                                       targets)
        leaves = {}
        ref = os.path.join(ref_dir, _composite_ref_key(change))
        for path, block in got.items():
            at = [mesh.axis_index(a) if a else 0 for a in specs[path]]
            whole = np.load(os.path.join(ref, "_".join(path) + ".npy"),
                            mmap_mode="r")
            idx = tuple(slice(i * n, (i + 1) * n)
                        for i, n in zip(at, block.shape))
            want = torch.from_numpy(np.ascontiguousarray(whole[idx])).to(dev)
            leaves["/".join(path)] = dict(
                at=at, sq=float(((block.double() - want.double()) ** 2)
                                .sum()),
                sha=hashlib.sha256(block.reshape(-1).view(torch.uint8)
                                   .cpu().numpy().tobytes()).hexdigest())
        out[tag] = dict(loss=loss, leaves=leaves,
                        coords=[mesh.axis_index(a) for a in comp.AXES],
                        seconds=time.perf_counter() - t0)
        del params, got
        torch.cuda.empty_cache()
    return out


def _composite_rank(rank, world, port, out_dir, ref_dir):
    """One NCCL rank of `--ranks N`'s composite: writes its result, or
    its traceback and exits at once (a rank that left would hold the
    others in their next collective)."""
    import traceback
    sys.path.insert(0, HERE)
    import torch
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mx.kvstore.init_distributed(f"127.0.0.1:{port}", world, rank)
        check(torch.cuda.current_device() == rank
              and torch.distributed.get_backend() == "nccl",
              f"composite rank {rank} on cuda:{torch.cuda.current_device()}")
        res = _composite_rank_runs(mx, torch, world, rank, ref_dir)
        with open(os.path.join(out_dir, f"composite_rank{rank}.json"),
                  "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"composite_rank{rank}.err"),
                  "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)
    mx.kvstore.reset_distributed()


def composite_ranks_main(mx, torch, world):
    """`--ranks N`'s composite: the one-rank references on card 0, then N
    NCCL ranks, one card each, through every case of
    COMPOSITE_RANKS_CASES; then the checks: every block that several
    ranks hold has the same bits on each, each case's loss and every
    leaf within (b)'s limits of its one-rank step. Returns the
    summary."""
    import torch.multiprocessing as mp
    cases = [c for c in COMPOSITE_RANKS_CASES if np.prod(c[1]) == world]
    if not cases:
        log(f"composite: no case of COMPOSITE_RANKS_CASES spans {world} "
            f"ranks")
        return {}
    with tempfile.TemporaryDirectory() as tmp:
        ref_dir = os.path.join(tmp, "refs")
        t0 = time.perf_counter()
        refs = _composite_refs(mx, torch, ref_dir, cases)
        log(f"composite {world} ranks: one-rank references in "
            f"{time.perf_counter() - t0:.1f} s: " + json.dumps(
                {k: dict(loss=v["loss"], f64_loss=v["f64_loss"],
                         loss_limit=v["loss_limit"]) for k, v in
                 refs.items()}))
        try:
            mp.start_processes(_composite_rank, args=(
                world, _free_port(), tmp, ref_dir), nprocs=world,
                start_method="spawn")
        except Exception as e:
            errs = {f: open(os.path.join(tmp, f)).read()
                    for f in sorted(os.listdir(tmp)) if f.endswith(".err")}
            check(False, f"composite {world} ranks: {e}; {errs}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"composite_rank{r}.json")) as f:
                ranks.append(json.load(f))
    summary = {}
    for tag, sizes, change in cases:
        ref = refs[_composite_ref_key(change)]
        losses = {r[tag]["loss"] for r in ranks}
        check(len(losses) == 1, f"composite {tag}: the ranks' losses "
                                f"differ {losses}")
        loss = losses.pop()
        check(abs(loss - ref["loss"]) <= ref["loss_limit"],
              f"composite {tag}: loss {loss} vs the one-rank {ref['loss']}"
              f" (limit {ref['loss_limit']:.3e})")
        worst, replicated = (0.0, ""), 0
        for name, lim in ref["limits"].items():
            blocks = {}
            for r in ranks:
                leaf = r[tag]["leaves"][name]
                blocks.setdefault(tuple(leaf["at"]), []).append(leaf)
            for at, held in blocks.items():
                check(len({h["sha"] for h in held}) == 1,
                      f"composite {tag}: block {at} of {name} differs "
                      f"between the {len(held)} ranks holding it")
                replicated += len(held) > 1
            d = sum(held[0]["sq"] for held in blocks.values()) ** 0.5
            worst = max(worst, (d / lim if lim else float(d > 0), name))
        check(worst[0] <= 1.0, f"composite {tag}: {worst[1]} at "
                               f"{worst[0]:.3f} of its limit from the "
                               f"one-rank step")
        summary[tag] = dict(sizes=sizes, loss=loss, ref_loss=ref["loss"],
                            worst_share=worst[0], worst_leaf=worst[1],
                            replicated_blocks_bit_equal=replicated,
                            seconds=max(r[tag]["seconds"] for r in ranks))
        log(f"composite {world} ranks, {tag} {sizes}: loss {loss:.7f} vs "
            f"one rank {ref['loss']:.7f}; worst leaf {worst[1]} at "
            f"{worst[0]:.3f} of (b)'s limit; {replicated} replicated "
            f"blocks bit-equal on every rank holding them")
    return summary


# ---------------------------------------------------------------------------
# the dependency engine, engine-driven serving, MNIST through gluon.data,
# and the wide-head flash kernels
# ---------------------------------------------------------------------------
# phase_serve_engine's background flood, the JAX package's
# (bench_util.BackgroundEngineLoad, which bench_serve.py
# --background-train and tools/check_qos.py flood with): a producer
# thread keeps FLOOD_PER_WORKER x workers PRIORITY_BACKGROUND tasks live,
# each sleeping FLOOD_TASK_S (a co-tenant's host IO: it holds an engine
# worker, not the GIL), topping up every 5 ms
FLOOD_TASK_S, FLOOD_PER_WORKER = 0.01, 32
# phase_mnist: bench_mlp.py's 784-512-256-10 MLP at batch 512, SGD lr 0.1
# momentum 0.9 (examples/train_mnist.py's optimizer), 2 epochs of
# synthetic MNIST(train=True) through DataLoader(shuffle=True) after
# numpy seed MNIST_SEED, held on the 10000 test images
MNIST_HIDDEN, MNIST_B, MNIST_EPOCHS = (512, 256), 512, 2
MNIST_LR, MNIST_MOMENTUM, MNIST_SEED = 0.1, 0.9, 0
# the JAX package's test accuracy after MNIST_EPOCHS on the CPU for the
# same flow and seed (tools/port_mnist_reference.py); the port's, eager
# and captured, must lie within MNIST_ACC_TOL of it (its initial weights
# are drawn by another generator)
MNIST_JAX_TEST_ACC = 1.0
MNIST_ACC_TOL = 0.02
# the first 5 losses, card against the port on the CPU from the same
# weights and batches: fp32 sums in other orders through 5 momentum steps
# (tests/test_torch_train.py's forward limit)
MNIST_LOSS_RTOL = 1e-4
# phase_flash_wide: heads wider than the narrow kernels' 128
# (csrc/flash_wide.cu), B = 2, H = 8, S = 1024, causal, and with key
# lengths; the float64 yardstick at most WIDE_F64_RATIO x the plain
# version's distance plus one unit roundoff of the dtype (fp32 2^-23)
# times the largest value. WIDE_D are checked and timed (198: no multiple
# of 8 nor of 4, so no dtype's rows are whole 16-byte pieces and every
# kernel takes its element copies where TMA (fp32: cp.async's 16-byte
# form) cannot go; 200: a multiple of 8, not of 64, padded to 256 columns;
# 512: the split mode; 1024: the streamed mode in chunks of 256 columns),
# WIDE_BIG_D checked only; WIDE_SHIFT_D checked with q one element off
# 16-byte alignment (the element copies at a TMA width)
WIDE_D = (192, 198, 200, 256, 512, 1024)
WIDE_BIG_D = 2048
WIDE_SHIFT_D = 256
WIDE_B, WIDE_H, WIDE_S = 2, 8, 1024
# the wgmma kernels (bf16 and fp16 forward, dK/dV and dQ): their SASS
# must hold HGMMA, and their build no serialisation warning (ptxas C7515
# / C7520: a wgmma under a branch it cannot prove warp-uniform)
WIDE_TC_KERNELS = ("wide_fwd_tc_kernel", "wide_dkv_tc_kernel",
                   "wide_dq_tc_kernel")
# each type's instances: the forward's resident, split and streamed modes
# and its causal key split, the dK/dV and dQ kernels' three modes each
WIDE_TC_INSTANCES = 4 + 3 + 3
WIDE_PLAN_OF = {"fwd": "fwd", "bwd_dkv": "dkv", "bwd_dq": "dq"}
WIDE_SERIAL_WARNINGS = ("C7515", "C7520")
WIDE_LENS = [777, 1024]
WIDE_F64_RATIO = 2.0
WIDE_SOURCE = "mxnet_tpu_torch/ops/csrc/flash_wide.cu"
WIDE_REPLACES = {"flash_wide_fwd": "mxnet_tpu/ops/pallas_kernels.py:219",
                 "flash_wide_bwd_dkv": "mxnet_tpu/ops/pallas_kernels.py:417",
                 "flash_wide_bwd_dq": "mxnet_tpu/ops/pallas_kernels.py:484"}


def phase_engine(mx, torch):
    """The native engine (`csrc/engine.cc`, built by g++) runs the
    facade: writes on a var in push order with concurrent readers, a
    failed writer poisoning its readers and later writers (and nothing
    else), a TaskGroup's queued members CANCELLED, a deadline EXPIRED."""
    import threading
    E = mx.engine
    t0 = time.perf_counter()
    check(E.native_engine_loaded(), "the native engine did not build/load: "
                                    "the facade fell back to _PyEngine")
    log(f"engine: native, {E.num_workers()} workers, up in "
        f"{time.perf_counter() - t0:.2f} s")
    v, log_ = E.Var(), []
    for i in range(50):
        E.push(lambda i=i: log_.append(("w", i)), write_vars=[v])
        E.push(lambda i=i: log_.append(("r", i, sum(
            1 for x in list(log_) if x[0] == "w"))), read_vars=[v])
    E.wait_for_var(v)
    check([x for x in log_ if x[0] == "w"] == [("w", i) for i in range(50)],
          "engine writes out of push order")
    check(all(x[2] == x[1] + 1 for x in log_ if x[0] == "r"),
          "an engine reader saw another number of writes than precede it")

    def boom():
        raise ValueError("engine poisoning check")
    E.clear_failures()
    u, w = E.Var(), E.Var()
    futs = [E.push(boom, write_vars=[u]), E.push(lambda: 1, read_vars=[u]),
            E.push(lambda: 2, write_vars=[u]), E.push(lambda: 3,
                                                     write_vars=[w])]
    errs = [type(f.exception(timeout=60)).__name__ if f.exception(
        timeout=60) else f.result() for f in futs]
    check(errs == ["ValueError"] * 3 + [3], f"engine poisoning {errs}")
    check(len(E.failures()) == 1, f"engine failures {E.failures()}")
    E.clear_failures()
    gate, started = threading.Event(), threading.Event()
    g = E.TaskGroup("chip_smoke.engine")
    x = E.Var()
    g.push(lambda: (started.set(), gate.wait(60)), write_vars=[x])
    check(started.wait(60), "engine task did not start")
    queued = [g.push(lambda: 1, write_vars=[x]) for _ in range(3)]
    late = E.push(lambda: 1, write_vars=[x], deadline_ms=1)
    time.sleep(0.02)
    n = g.cancel()
    gate.set()
    check(g.drain(60) and n == 3, f"engine cancel: {n} of 3")
    check(all(f.result(timeout=60) is E.CANCELLED for f in queued),
          "cancelled tasks did not resolve CANCELLED")
    check(late.result(timeout=60) is E.EXPIRED, "deadline did not expire")
    E.wait_for_all()
    check(E.active_groups() == 0 and E.pending_tasks() == 0,
          "engine left tasks or groups live")
    log(f"engine: ordering, poisoning, cancel and deadline checks passed "
        f"in {time.perf_counter() - t0:.2f} s")


def _serve_run(torch, srv, reqs):
    """The 16 requests through `srv`: (tokens per request, TTFT p50 and
    p99 in s, tokens/s, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [srv.submit(src, max_new_tokens=n) for src, n in reqs]
    for h in handles:
        h.result(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = np.sort([h.ttft for h in handles])
    tokens = [list(h.tokens) for h in handles]
    return (tokens, float(np.percentile(ttft, 50)),
            float(np.percentile(ttft, 99)),
            sum(len(t) for t in tokens) / wall, wall)


def phase_serve_engine(mx, torch, model, srv, reqs, handles):
    """A default `Server(model)` (engine-driven: the decode loop runs as
    PRIORITY_HIGH engine tasks on the native engine's worker threads,
    under the server's device) on phase 3's model and 16 requests: the
    tokens equal phase 3's inline ones, alone and under a background
    flood of host tasks; the counters, zeroed just before and read just
    after the first run, show the flash and paged kernels launched from
    engine threads. TTFT p50 / p99 and tokens/s of all three beside the
    inline server in the same call."""
    import threading
    K = mx.ops.kernels
    E = mx.engine
    want = [list(h.tokens) for h in handles]
    esrv = mx.serve.Server(model, slots=8, page_size=16, max_src_len=128,
                           max_new_tokens=32)
    check(esrv._loop is not None, "Server() is not engine-driven")
    esrv.submit(reqs[0][0], max_new_tokens=2).result(timeout=600)
    threads = {}

    def spy(name):
        fn = getattr(K, name)

        def wrapped(*a, **kw):
            threads[threading.current_thread().name] = \
                threads.get(threading.current_thread().name, 0) + 1
            return fn(*a, **kw)
        return fn, wrapped
    orig_fwd, K.flash_attention_fwd = spy("flash_attention_fwd")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    turns0 = esrv.scheduler.decode_turns
    try:
        tokens, p50, p99, tps, wall = _serve_run(torch, esrv, reqs)
    finally:
        K.flash_attention_fwd = orig_fwd
    launches = dict(K.LAUNCHES)
    turns = esrv.scheduler.decode_turns - turns0
    check(tokens == want, "engine-driven tokens differ from phase 3's "
                          "inline tokens")
    check(launches["flash_fwd"] == 6 * len(reqs),
          f"engine serving flash launches {launches['flash_fwd']} != "
          f"6 x {len(reqs)}")
    check(launches["ragged_paged_attention"] == 6 * turns > 0,
          f"engine serving rpa launches "
          f"{launches['ragged_paged_attention']} != 6 x {turns}")
    check(threads and "MainThread" not in threads,
          f"the prefill ran on {threads}, not on engine threads")
    engine_run = dict(ttft_p50_s=p50, ttft_p99_s=p99, tokens_per_s=tps,
                      wall_s=wall, decode_turns=turns,
                      prefill_threads=sorted(threads))
    inline = _serve_run(torch, srv, reqs)
    check(inline[0] == want, "the inline server's tokens moved")

    # the background flood (FLOOD_TASK_S, FLOOD_PER_WORKER)
    flood = E.TaskGroup("chip_smoke.flood")
    stop = threading.Event()
    target = FLOOD_PER_WORKER * E.num_workers()
    ran = [0]

    def feeder():
        while not stop.is_set():
            for _ in range(max(0, target - flood.live())):
                flood.push(lambda: stop.wait(FLOOD_TASK_S),
                           priority=E.PRIORITY_BACKGROUND)
                ran[0] += 1
            time.sleep(0.005)
    feed = threading.Thread(target=feeder, daemon=True)
    feed.start()
    time.sleep(0.2)                      # let the backlog build
    try:
        flooded = _serve_run(torch, esrv, reqs)
        pending = flood.pending()
    finally:
        stop.set()
        feed.join(60)
        flood.cancel()
        check(flood.drain(60), "the flood did not drain")
    check(flooded[0] == want, "engine-driven tokens under the flood differ")
    check(pending > 0, "the flood was not queued while serving")
    esrv.close()
    check(esrv._loop._group.live() == 0, "the loop's group left tasks")
    E.wait_for_all()
    check(E.active_groups() == 0, "engine groups left live")
    summary = dict(engine=engine_run,
                   inline=dict(ttft_p50_s=inline[1], ttft_p99_s=inline[2],
                               tokens_per_s=inline[3], wall_s=inline[4]),
                   engine_under_flood=dict(
                       ttft_p50_s=flooded[1], ttft_p99_s=flooded[2],
                       tokens_per_s=flooded[3], wall_s=flooded[4],
                       flood_tasks_pushed=ran[0],
                       flood_pending_at_end=pending),
                   native_engine=E.native_engine_loaded(),
                   launches={k: v for k, v in launches.items() if v})
    log("serve_engine " + json.dumps(summary))
    return launches


def _mnist_loader(mx, ctx, train=True, shuffle=True):
    ds = mx.gluon.data.vision.MNIST(train=train).transform_first(
        lambda x: x.astype("float32") / 255.0)
    return mx.gluon.data.DataLoader(ds, batch_size=MNIST_B, shuffle=shuffle,
                                    ctx=ctx)


def _mnist_net(mx, ctx, init_file):
    net = mx.models.get_mlp(MNIST_HIDDEN)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.load_parameters(init_file, ctx=ctx)
    return net


def _mnist_test_acc(mx, net, ctx):
    acc = mx.metric.Accuracy()
    for x, y in _mnist_loader(mx, ctx, train=False, shuffle=False):
        acc.update([y], [net(x)])
    return acc.get()[1]


def _mnist_train(mx, torch, net, ctx, captured, steps=None):
    """examples/train_mnist.py's loop (eager) or the same step through
    `trainer.capture`: (per-epoch dicts, first losses, the captured step
    or None, a function running one step). `steps` stops after that
    many steps."""
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": MNIST_LR,
                                "momentum": MNIST_MOMENTUM})
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = trainer.capture(lambda x, y: lf(net(x), y)) if captured else None
    np.random.seed(MNIST_SEED)
    epochs, first = [], []

    def one(x, y, metric):
        if captured:
            return step(x, y)
        with mx.autograd.record():
            out = net(x)
            loss = lf(out, y)
        loss.backward()
        trainer.step(x.shape[0])
        metric.update([y], [out])
        return loss
    n = 0
    for _ in range(MNIST_EPOCHS if steps is None else 1):
        metric = mx.metric.Accuracy()
        if ctx.type == "cuda":
            torch.cuda.synchronize()
        t0, samples = time.perf_counter(), 0
        for x, y in _mnist_loader(mx, ctx):
            loss = one(x, y, metric)
            samples += x.shape[0]
            if len(first) < 5:
                first.append(float(loss.mean().asscalar()))
            n += 1
            if steps is not None and n >= steps:
                return epochs, first, step, one
        if ctx.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs.append(dict(samples_per_s=samples / wall, wall_s=wall,
                           train_acc=None if captured else metric.get()[1],
                           test_acc=_mnist_test_acc(mx, net, ctx)))
    return epochs, first, step, one


def phase_mnist(mx, torch):
    """MLP-on-MNIST (BASELINE.json configuration 1) as
    examples/train_mnist.py runs it, at bench_mlp.py's width, on the card
    through the port's DataLoader on the engine: eager and through
    `trainer.capture` from the same initial weights, each reaching the
    JAX package's accuracy within MNIST_ACC_TOL; samples/s and the busy
    share of a profiled step of each; the first 5 losses against the
    port on the CPU."""
    check(MNIST_JAX_TEST_ACC is not None, "MNIST_JAX_TEST_ACC is not set")
    dev, cpu = mx.gpu(0), mx.cpu()
    mx.random.seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "mlp_init.params")
        net = mx.models.get_mlp(MNIST_HIDDEN)
        net.initialize(mx.init.Xavier(), ctx=dev)
        net(mx.nd.zeros((1, 784), ctx=dev))
        net.save_parameters(init_file)
        out = {}
        for captured in (False, True):
            tag = "captured" if captured else "eager"
            net = _mnist_net(mx, dev, init_file)
            epochs, first, step, one = _mnist_train(mx, torch, net, dev,
                                                    captured)
            acc = epochs[-1]["test_acc"]
            check(abs(acc - MNIST_JAX_TEST_ACC) <= MNIST_ACC_TOL,
                  f"MNIST {tag} test accuracy {acc} not within "
                  f"{MNIST_ACC_TOL} of the JAX package's "
                  f"{MNIST_JAX_TEST_ACC}")
            check(all(np.isfinite(first)), f"MNIST {tag} losses {first}")
            x, y = next(iter(_mnist_loader(mx, dev)))
            metric = mx.metric.Accuracy()
            one(x, y, metric)
            got = device_profile(torch, lambda: one(x, y, metric))
            busy = None if got is None else log_profile(
                f"mnist {tag} profile", *got, "1 training step")
            out[tag] = dict(epochs=epochs, first_losses=first,
                            profiled_step_busy=busy)
            if captured:
                check(step.last_fallback_reason is None,
                      f"MNIST captured step fell back: "
                      f"{step.last_fallback_reason}")
                out[tag]["cache_size"] = step.cache_size
        cpu_net = _mnist_net(mx, cpu, init_file)
        _, cpu_first, _, _ = _mnist_train(mx, torch, cpu_net, cpu, False,
                                          steps=5)
    for tag in ("eager", "captured"):
        check(np.allclose(out[tag]["first_losses"], cpu_first,
                          rtol=MNIST_LOSS_RTOL, atol=0),
              f"MNIST {tag} first losses {out[tag]['first_losses']} vs the "
              f"CPU's {cpu_first}")
    out.update(cpu_first_losses=cpu_first,
               jax_cpu_test_acc=MNIST_JAX_TEST_ACC,
               native_engine=mx.engine.native_engine_loaded())
    log("mnist " + json.dumps(out))
    mx.engine.wait_for_all()
    check(mx.engine.active_groups() == 0, "the DataLoader left groups live")


def _wide_pairs(b, h, s, causal, lens):
    """The live (query, key) pairs of one case (what the work depends
    on)."""
    if causal:
        return b * h * s * (s + 1) // 2
    return h * s * sum(lens if lens is not None else [s] * b)


def _wide_check(mx, torch, g, dtype, d, causal, lens, shift=False,
                shape=(WIDE_B, WIDE_H, WIDE_S)):
    """One case of the wide kernels at (B, H, S) = `shape` against their
    plain versions (fp32: FLASH_TOL / BWD_TOL, slice-scaled; 16-bit: the
    dtype's LOWP limits) and float64 (WIDE_F64_RATIO x the plain
    version's distance + one unit roundoff of the largest value), two
    launches bit-identical, dK / dV exactly 0 past each length, and each
    kernel's counter moving once a launch. `shift`: q one element off
    16-byte alignment. Where a row is no whole number of 16-byte pieces
    or q is shifted, the wrappers' vec must be 0 (the element copies).
    Returns (max abs errors, shares of the limit)."""
    K = mx.ops.kernels
    b, h, s = shape
    what = f"wide {str(dtype).split('.')[-1]} {shape} D={d} " \
           f"causal={causal} lens={lens}" + (" misaligned q" if shift else "")
    sfx = K._suffix(dtype)
    fp32 = dtype == torch.float32
    lim = None if fp32 else _lowp(dtype)
    floor64 = FP32_F64_FLOOR if fp32 else lim["f64_floor"]
    q, k, v, do = _lowp_qkv(torch, g, b, h, s, s, d, n=4, dtype=dtype)
    if shift:
        base = torch.randn(b * h * s * d + 1, generator=g).to(
            q.device).to(dtype)
        q = base[1:].view(b, h, s, d)
        check(q.is_contiguous() and q.data_ptr() % 16 != 0,
              f"{what}: q not misaligned")
    copies = shift or d * q.element_size() % 16 != 0
    check(K._vec_copies(d, q, k, v, do) == int(not copies),
          f"{what}: vec {K._vec_copies(d, q, k, v, do)}, element copies "
          f"expected {copies}")
    scale = d ** -0.5
    vl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=q.device)
    before = dict(K.LAUNCHES)
    out, lse = K.flash_attention_fwd(q, k, v, causal, scale, vl)
    out2, lse2 = K.flash_attention_fwd(q, k, v, causal, scale, vl)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, s)
    got = K.flash_attention_bwd(q, k, v, do, lse, delta, causal, scale, vl)
    again = K.flash_attention_bwd(q, k, v, do, lse, delta, causal, scale, vl)
    torch.cuda.synchronize()
    counts = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
    want = dict(dict.fromkeys(K.LAUNCHES, 0), **{
        "flash_wide_fwd" + sfx: 2, "flash_wide_bwd_dkv" + sfx: 2,
        "flash_wide_bwd_dq" + sfx: 2})
    check(counts == want, f"{what}: launches {counts} != {want}")
    check(torch.equal(out, out2) and torch.equal(lse, lse2)
          and all(torch.equal(a, r) for a, r in zip(got, again)),
          f"{what}: a repeated launch gave other bits")
    ref, ref_lse = K._flash_plain(q, k, v, causal, scale, vl)
    refs = K._flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, vl)
    errs, shares = {}, {}
    for name, t, r in (("out", out, ref), ("lse", lse, ref_lse)) + tuple(
            zip(("dq", "dk", "dv"), got, refs)):
        check(t.dtype == (torch.float32 if name == "lse" else dtype)
              and torch.isfinite(t).all().item(),
              f"{what} {name}: dtype {t.dtype} or not finite")
        errs[name] = (t.float() - r.float()).abs().max().item()
        if name == "lse" or (fp32 and name == "out"):
            ok = torch.allclose(t, r, **FLASH_TOL)
            shares[name] = None
        elif fp32:
            ok = _within(torch, t, r, BWD_TOL, True)
            shares[name] = None
        else:
            atol = lim["out_atol"] * _slice_max(v) if name == "out" \
                else lim["grad_atol"] * _slice_max(r)
            shares[name] = _bf16_share(torch, t, r, atol, lim["rtol"])
            ok = shares[name] <= 1.0
        check(ok, f"{what} {name} kernel vs plain: max abs err "
                  f"{errs[name]}, share {shares[name]}")
    o64, l64, live = _attention_f64(torch, q, k, v, causal, scale, lens)
    g64 = _attention_grads_f64(torch, q, k, v, do, causal, scale, lens)
    for name, t, r, e in (("out", out, ref, o64),) + tuple(
            zip(("dq", "dk", "dv"), got, refs, g64)):
        e64 = (t.cpu().double() - e).abs().max().item()
        p64 = (r.cpu().double() - e).abs().max().item()
        check(e64 <= WIDE_F64_RATIO * p64 + floor64 * e.abs().max().item(),
              f"{what} {name} {e64} from float64, more than "
              f"{WIDE_F64_RATIO}x the plain version's {p64}")
    e64 = (lse.cpu().double() - l64)[live].abs().max().item()
    p64 = (ref_lse.cpu().double() - l64)[live].abs().max().item()
    check(e64 <= WIDE_F64_RATIO * p64 + FP32_F64_FLOOR
          * l64[live].abs().max().item(),
          f"{what} lse {e64} from float64, plain {p64}")
    for bi, n in enumerate(lens or []):
        if n < s:
            check(got[1][bi, :, n:].abs().max().item() == 0.0
                  and got[2][bi, :, n:].abs().max().item() == 0.0,
                  f"{what}: dK/dV past kv_len {n} must be exactly 0")
    return errs, shares


def _sdpa_backend(torch, fn):
    """The backend SDPA picks for `fn` (one call), by the names of the
    kernels it launches under torch.profiler: cudnn, flash, efficient
    (CUTLASS fmha) or math; "not measured" where the profiler cannot
    trace the card."""
    got = device_profile(torch, fn)
    if got is None:
        return "not measured"
    names = " ".join(r[2] for r in got[1]).lower()
    for words, name in ((("cudnn",), "cudnn"), (("flash",), "flash"),
                        (("fmha", "efficient", "mem_eff"), "efficient")):
        if any(w in names for w in words):
            return name
    return "math"


def _wide_times(mx, torch, g, dtype, d, shift=False):
    """The wide kernels at (WIDE_B, WIDE_H, WIDE_S, d), causal, by CUDA-
    graph replay (`shift`: q one element off 16-byte alignment, as
    `_wide_check` makes it, so that the kernels copy its rows element by
    element): each kernel (as `flash_wide_plan` launches it), the
    backward pair, the plain versions, SDPA's forward and backward
    (fwd+bwd - fwd) in the same dtype and the backend it picks, and each
    kernel's bound (each input read and output written once at 3.35 TB/s
    against its products over the live pairs, 4 / 8 / 6 x pairs x D, at
    the split-TF32 rate in fp32 and the bf16 / fp16 tensor-core rate
    otherwise)."""
    K = mx.ops.kernels
    F = torch.nn.functional
    b, h, s = WIDE_B, WIDE_H, WIDE_S
    q, k, v, do = _lowp_qkv(torch, g, b, h, s, s, d, n=4, dtype=dtype)
    if shift:
        base = torch.randn(b * h * s * d + 1, generator=g).to(
            q.device).to(dtype)
        q = base[1:].view(b, h, s, d)
        check(q.data_ptr() % 16 != 0 and K._vec_copies(d, q, k, v, do) == 0,
              f"wide times D={d}: q not misaligned")
    scale = d ** -0.5
    out, lse = K.flash_attention_fwd(q, k, v, True, scale)
    delta = (out.float() * do.float()).sum(-1).reshape(b * h, s).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    st = torch.cuda.current_stream
    from mxnet_tpu_torch.ops import _build
    fwd, dkv, dqf = (K._wide_fn(_build.library(), f"mxtt_flash_wide_{kind}",
                                dtype) for kind in ("fwd", "bwd_dkv",
                                                    "bwd_dq"))
    plans = K.flash_wide_plan(d, dtype, b * h, s, s, causal=True)
    vec = K._vec_copies(d, q, k, v, do)
    args = {kind: K._wide_plan_args(plans[kind], vec)
            for kind in ("fwd", "dkv", "dq")}
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None)
    o2, l2 = torch.empty_like(q), torch.empty_like(lse)
    fns = {
        "fwd": lambda: fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                           o2.data_ptr(), l2.data_ptr(), b, h, s, s, d, 1,
                           scale, *args["fwd"], st().cuda_stream),
        "bwd_dkv": lambda: dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), b, h, s,
                               s, d, 1, scale, *args["dkv"],
                               st().cuda_stream),
        "bwd_dq": lambda: dqf(*ptrs, dq.data_ptr(), b, h, s, s, d, 1, scale,
                              *args["dq"], st().cuda_stream)}
    for name, fn in fns.items():
        check(fn() == 0, f"wide {name} D={d} {dtype}: launch refused")
    fns["pair"] = lambda: K.flash_attention_bwd(q, k, v, do, lse, delta,
                                                True, scale)
    ms = {name: graph_ms(fn, calls=5, iters=10) for name, fn in fns.items()}
    plain_fwd = graph_ms(lambda: K._flash_plain(q, k, v, True, scale, None),
                         calls=2, iters=5)
    plain_bwd = graph_ms(lambda: K._flash_bwd_plain(
        q, k, v, do, lse, delta, True, scale, None), calls=2, iters=5)
    sdpa_fwd = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), calls=5, iters=10)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_both():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)
    sdpa_all = graph_ms(sdpa_both, calls=2, iters=5)
    backend = _sdpa_backend(torch, sdpa_both)
    pairs = _wide_pairs(b, h, s, True, None)
    e = q.element_size()
    rate = PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    rows = b * h * s * d * e
    bounds = {
        "fwd": bound(4 * rows + 4 * b * h * s, 4 * pairs * d, rate),
        "bwd_dkv": bound(6 * rows + 8 * b * h * s, 8 * pairs * d, rate),
        "bwd_dq": bound(5 * rows + 8 * b * h * s, 6 * pairs * d, rate)}
    return dict(ms=ms, plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
                sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_all - sdpa_fwd,
                sdpa_backend=backend, bounds=bounds, pairs=pairs,
                plans={kind: {key: plans[kind][key] for key in (
                    "kind", "mode", "chunks", "stages", "smem")
                    if key in plans[kind]} for kind in plans})


def _wide_build_checks(mx):
    """The wgmma kernels on the tensor cores: every instance of
    WIDE_TC_KERNELS (each type, mode and the key split) in the built
    library holds HGMMA in its SASS
    (`cuobjdump -sass`), and flash_wide.cu's build log (nvcc's stderr and
    ptxas -v) holds no WIDE_SERIAL_WARNINGS. Logs each instance's
    registers and spills. Returns {instance: holds HGMMA}."""
    from mxnet_tpu_torch.ops import _build
    info = _build.build_info()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", info["path"]], capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-500:]}")
    hgmma = {}
    for sec in out.stdout.split("Function : ")[1:]:
        name = sec.split("\n", 1)[0].strip()
        if any(kern in name for kern in WIDE_TC_KERNELS):
            hgmma[name] = "HGMMA" in sec
        # the first form's dQ kernel (a warp a row in fp32 FMAs) is gone
        check("wide_bwd_dq_kernel" not in name,
              f"the library still holds {name}")
    # WIDE_TC_INSTANCES in each of two types
    check(len(hgmma) == 2 * WIDE_TC_INSTANCES and all(hgmma.values()),
          f"the wide wgmma kernels' SASS: {hgmma}")
    if info["cached"]:
        log("wide kernels: build log not available (a cached build was "
            "loaded); the serialisation check needs a fresh build")
    else:
        text = info["log"].split("== flash_wide.cu", 1)[-1].split("\n== ")[0]
        bad = [w for w in WIDE_SERIAL_WARNINGS if w in text]
        check(not bad, f"flash_wide.cu's build warns {bad}: ptxas "
                       f"serialised wgmma")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "_tc_kernel" in line or "_f32_kernel" in line):
                log("wide ptxas: " + " | ".join(
                    ln.strip() for ln in lines[i:i + 4]))
    log(f"wide kernels' SASS holds HGMMA: {hgmma}")
    return hgmma


def _wide_attention_path(mx, torch, g):
    """The wide heads' path: `flash_attention` forward and backward
    through its autograd Function at (WIDE_B, WIDE_H, WIDE_S, 256) in
    each dtype, causal; the counters zeroed just before and read just
    after (one launch of each wide kernel a dtype)."""
    K = mx.ops.kernels
    inputs = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = (t.requires_grad_(True) for t in _lowp_qkv(
            torch, g, WIDE_B, WIDE_H, WIDE_S, WIDE_S, 256, dtype=dtype))
        inputs.append((q, k, v))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for q, k, v in inputs:
        out = K.flash_attention(q, k, v, causal=True)
        out.float().square().sum().backward()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for sfx in ("", "_bf16", "_f16"):
        for kind in ("fwd", "bwd_dkv", "bwd_dq"):
            check(launches[f"flash_wide_{kind}{sfx}"] == 1,
                  f"wide path launches {launches}")
    for q, k, v in inputs:
        check(all(torch.isfinite(t.grad).all().item() for t in (q, k, v)),
              "wide path gradients not finite")
    return launches


def phase_flash_wide(mx, torch):
    """Heads wider than 128 (`csrc/flash_wide.cu`): the wgmma kernels'
    SASS and build log (`_wide_build_checks`); each wide kernel against
    its plain version and float64 at WIDE_D and WIDE_BIG_D, and with a
    misaligned q at WIDE_SHIFT_D, B = 2, H = 8, S = 1024, causal and with
    key lengths, and at the bert_wide_bf16 path's shape (B = 16, three
    heads of 256, S = 512, BERT's key lengths), in fp32, bf16 and fp16
    (`_wide_check`); timed at WIDE_D
    by CUDA-graph replay beside SDPA in the same dtype and beside its
    bound, the dK/dV + dQ pair beside SDPA's backward (`_wide_times`);
    then the path (`_wide_attention_path`). Returns (the kernels' rows,
    the path's launches)."""
    g = torch.Generator().manual_seed(18)
    t0 = time.perf_counter()
    hgmma = _wide_build_checks(mx)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        sfx = mx.ops.kernels._suffix(dtype)
        worst = {kind: 0.0 for kind in ("fwd", "bwd_dkv", "bwd_dq")}
        per_shape = {kind: {} for kind in worst}

        def case(d, causal, lens, shift=False,
                 shape=(WIDE_B, WIDE_H, WIDE_S)):
            errs, shares = _wide_check(mx, torch, g, dtype, d, causal, lens,
                                       shift, shape)
            worst["fwd"] = max(worst["fwd"], errs["out"])
            worst["bwd_dkv"] = max(worst["bwd_dkv"], errs["dk"], errs["dv"])
            worst["bwd_dq"] = max(worst["bwd_dq"], errs["dq"])
            log(f"flash_wide{sfx} {shape} D={d} causal={causal} lens={lens}"
                f"{' misaligned q' if shift else ''}: errs "
                f"{json.dumps(errs)} shares {json.dumps(shares)}")

        # the bert_wide_bf16 path's own shape (phase 11w): BERT_B x
        # BERT_WIDE_H heads of 256 over BERT_S, not causal, BERT's lengths
        case(768 // BERT_WIDE_H, False, _bert_lengths(BERT_B),
             shape=(BERT_B, BERT_WIDE_H, BERT_S))
        for d, shift in [(d, False) for d in WIDE_D + (WIDE_BIG_D,)] + [
                (WIDE_SHIFT_D, True)]:
            for causal, lens in ((True, None), (False, WIDE_LENS)):
                case(d, causal, lens, shift)
            # the misaligned q is timed in bf16 (the path's dtype), its
            # bound the aligned D = 256 row's
            if d == WIDE_BIG_D or (shift and dtype != torch.bfloat16):
                continue
            t = _wide_times(mx, torch, g, dtype, d, shift)
            at = f"D{d}" + ("_misaligned_q" if shift else "")
            for kind in worst:
                plain = t["plain_fwd_ms"] if kind == "fwd" \
                    else t["plain_bwd_ms"]
                lib = t["sdpa_fwd_ms"] if kind == "fwd" else (
                    t["sdpa_bwd_ms"] if kind == "bwd_dkv" else None)
                per_shape[kind][at] = dict(
                    ms=t["ms"][kind], bound_ms=t["bounds"][kind][0],
                    bound_by=t["bounds"][kind][1], plain_ms=plain,
                    library_ms=lib, sdpa_backend=t["sdpa_backend"],
                    pairs=t["pairs"], plan=t["plans"][WIDE_PLAN_OF[kind]])
            for kind in ("bwd_dkv", "bwd_dq"):
                per_shape[kind][at]["pair_ms"] = t["ms"]["pair"]
                per_shape[kind][at]["pair_over_sdpa_bwd"] = \
                    t["ms"]["pair"] / t["sdpa_bwd_ms"]
            log(f"flash_wide{sfx} {at} times " + json.dumps(
                {kind: per_shape[kind][at] for kind in worst}))
        for kind in worst:
            head = per_shape[kind]["D256"]
            rows[f"flash_wide_{kind}{sfx}"] = dict(
                name=f"flash_wide_{kind}{sfx}", route="cuda",
                source=WIDE_SOURCE, replaces=WIDE_REPLACES[
                    f"flash_wide_{kind}"], max_abs_err=worst[kind],
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], per_shape=per_shape[kind])
            if sfx:
                tc = "wide_" + kind.replace("bwd_", "") + "_tc_kernel"
                rows[f"flash_wide_{kind}{sfx}"]["sass_hgmma"] = all(
                    ok for name, ok in hgmma.items() if tc in name)
    launches = _wide_attention_path(mx, torch, g)
    log(f"flash_wide: {len(rows)} kernels checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    return list(rows.values()), launches


def capture_main(mx, torch):
    """`--capture`: the build and the fused-Trainer and captured-step
    phases alone (11d with them) (fresh seed-0 weights for the NMT and ResNet phases in
    place of phases 5 and 7's), for a quick check of the captured step;
    no kernels line and no `ok` line."""
    t_start = time.perf_counter()
    phase_build(mx, torch)
    with tempfile.TemporaryDirectory() as tmp:
        nmt_init = os.path.join(tmp, "transformer_base_init.params")
        mx.random.seed(0)
        model = mx.models.transformer_base(VOCAB, max_length=TRAIN_S,
                                           dropout=0.0)
        model.initialize(ctx=mx.gpu(0))
        model.save_parameters(nmt_init)
        resnet_init = os.path.join(tmp, "resnet50_v1_init.params")
        net = _resnet50(mx)
        net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2), ctx=mx.gpu(0))
        net(_resnet_batch(mx, 1, mx.gpu(0))[0])
        net.save_parameters(resnet_init)
        del model, net
        phase_nmt_train_captured(mx, torch, nmt_init)
        phase_resnet_captured_bn(mx, torch, resnet_init)
    phase_bert_train_bf16_captured(mx, torch)
    phase_bert_dp_bf16(mx, torch, None)
    phase_capture_guard(mx, torch)
    phase_train_fused(mx, torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"capture phases {time.perf_counter() - t_start:.1f} s; "
        f"{smi.stdout.strip()}")
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
    if list(argv) == ["--capture"]:
        return capture_main(mx, torch)
    if argv:
        check(len(argv) == 2 and argv[0] == "--ranks" and argv[1].isdigit()
              and int(argv[1]) > 1, f"usage: chip_smoke.py [--ranks N>1 | "
              f"--capture], got {list(argv)}")
        return sp_ranks_main(mx, torch, int(argv[1]))
    t_start = time.perf_counter()
    phase_build(mx, torch)
    phase_engine(mx, torch)
    bwd_rows, long_launches = phase_flash_bwd(mx, torch)
    kernels = [phase_flash(mx, torch), phase_rpa(mx, torch),
               *phase_rpa_fastpath(mx, torch), *bwd_rows,
               phase_ln(mx, torch), *phase_conv1x1(mx, torch),
               *phase_flash_bf16(mx, torch), phase_ln_bf16(mx, torch),
               *phase_flash_f16(mx, torch), phase_ln_f16(mx, torch)]
    wide_rows, wide_launches = phase_flash_wide(mx, torch)
    kernels.extend(wide_rows)
    rtc_row, rtc_launches = phase_rtc(mx, torch)
    kernels.append(rtc_row)
    model, srv, reqs, handles, serve_launches = phase_serve(mx, torch)
    phase_profile(mx, torch, srv, reqs)
    phase_card_vs_cpu(mx, torch, model, srv, reqs, handles)
    serve_engine_launches = phase_serve_engine(mx, torch, model, srv, reqs,
                                               handles)
    srv.close()
    fast_launches = phase_fastpath(mx, torch, model)
    del model, srv
    torch.cuda.empty_cache()
    cast_launches = phase_serve_cast(mx, torch)
    phase_mnist(mx, torch)
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "transformer_base_init.params")
        train_launches = phase_train(mx, torch, init_file)
        phase_train_card_vs_cpu(mx, torch, init_file)
        torch.cuda.empty_cache()
        nmt_bf16_launches = phase_nmt_train_bf16(mx, torch, init_file)
        phase_nmt_card_vs_cpu_bf16(mx, torch, init_file)
        nmt_cap_launches, nmt_bf16_cap_launches = phase_nmt_train_captured(
            mx, torch, init_file)
        resnet_init = os.path.join(tmp, "resnet50_v1_init.params")
        net, images, resnet_launches = phase_resnet_train(mx, torch,
                                                          resnet_init)
        conv_launches = phase_resnet_conv1x1(mx, torch, net, images)
        del net, images
        torch.cuda.empty_cache()
        phase_resnet_card_vs_cpu(mx, torch, resnet_init)
        phase_stem_s2d(mx, torch)
        torch.cuda.empty_cache()
        net, images, resnet_bf16_launches, bf16_summary = \
            phase_resnet_train_bf16(mx, torch, resnet_init)
        conv_bf16_launches = phase_resnet_conv1x1(mx, torch, net, images,
                                                  bf16_only=True)
        del net, images
        torch.cuda.empty_cache()
        pack_launches = phase_resnet_pack_bf16(
            mx, torch, resnet_init, bf16_summary["images_per_s"])
        phase_resnet_card_vs_cpu_bf16(mx, torch, resnet_init)
        phase_resnet_captured_bn(mx, torch, resnet_init)
        by_name = {k["name"]: k for k in kernels}
        phase_bert_attention(mx, torch, by_name)
        phase_bert_attention_bf16(mx, torch, by_name)
        bert_init = os.path.join(tmp, "bert_base_init.params")
        bert_launches = phase_bert_train(mx, torch, bert_init)
        bert_bf16_launches, bert_bf16 = phase_bert_train_bf16(mx, torch)
        resume_launches = phase_bert_pretrain_resume(mx, torch)
        bert_wide_launches = phase_bert_wide_bf16(
            mx, torch, bert_bf16["tokens_per_s"])
        phase_bert_card_vs_cpu(mx, torch, bert_init)
        phase_bert_card_vs_cpu_bf16(mx, torch, bert_init)
        phase_bert_wide_card_vs_cpu_bf16(mx, torch, bert_init)
        phase_train_fused(mx, torch)
        bert_cap_launches = phase_bert_train_bf16_captured(mx, torch)
        dp_launches, dp_cap_launches = phase_bert_dp_bf16(
            mx, torch, bert_bf16["tokens_per_s"])
        phase_capture_guard(mx, torch)
        amp_launches = phase_amp_f16(mx, torch, init_file)
    block_rows, lc_launches = phase_long_context(mx, torch)
    kernels.extend(block_rows)
    composite_launches = phase_composite_train(mx, torch)
    for k in kernels:
        # a row's launches are its wrapper's counter (`flash_block_attention`
        # counts under `flash_block`)
        c = k.get("counter", k["name"])
        by_path = {"serve": serve_launches[c], "fastpath": fast_launches[c],
                   "serve_engine": serve_engine_launches[c],
                   "wide_attention": wide_launches[c],
                   "train": train_launches[c], "rtc": rtc_launches[c],
                   "nmt_train_bf16": nmt_bf16_launches[c],
                   "long_attention": long_launches[c],
                   "resnet_train": resnet_launches[c],
                   "resnet_conv1x1": conv_launches[c],
                   "resnet_train_bf16": resnet_bf16_launches[c],
                   "resnet_conv1x1_bf16": conv_bf16_launches[c],
                   "resnet_pack_bf16": pack_launches[c],
                   "bert_train": bert_launches[c],
                   "bert_train_bf16": bert_bf16_launches[c],
                   "bert_pretrain_resume": resume_launches[c],
                   "bert_train_bf16_captured": bert_cap_launches[c],
                   "bert_dp_bf16": dp_launches[c],
                   "bert_dp_bf16_captured": dp_cap_launches[c],
                   "nmt_train_captured": nmt_cap_launches[c],
                   "nmt_train_bf16_captured": nmt_bf16_cap_launches[c],
                   "serve_cast": cast_launches[c],
                   "bert_wide_bf16": bert_wide_launches[c],
                   "composite_train": composite_launches[c],
                   **{path: n[c] for path, n in amp_launches.items()},
                   **{path: n[c] for path, n in lc_launches.items()}}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        check(k["launches"] > 0, f"{k['name']} never launched on a path")
        if c in COMPOSITE_WANT:
            check(by_path["composite_train"] > 0,
                  f"{k['name']} not launched on the composite step")
        if c in DP_KERNELS:
            check(by_path["bert_dp_bf16"] > 0
                  and by_path["bert_dp_bf16_captured"] > 0,
                  f"{k['name']} not launched on the store's paths")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "call_ms")
    print(json.dumps({"kernels": [
        {key: k[key] for key in keys + ("per_shape", "launch_floor_ms",
                                         "sass_hgmma")
         if key in k} for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
