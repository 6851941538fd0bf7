#!/usr/bin/env python3
"""Time a training phase, the paged kernels, the fp32 or bf16 flash and
LayerNorm kernels or the conv1x1 kernel, of two checkouts on one card.

    python3 chip_train_ab.py OTHER_CHECKOUT
                             [--phase train|bert|bert_bf16|rpa|fp32|bf16|conv]
                             [--rounds N] [--log-dir DIR]

Runs phase 1 (build) and one phase for OTHER_CHECKOUT and for the
checkout this file lies in, each run in a process of its own, in the
order other, this, this, other, repeated `--rounds` times (2 by
default), so that both sides see the same card and the same host. The
training phases are each checkout's own `chip_smoke.py`'s:
  train  phase 5 (`phase_train`): full-width `transformer_base(36548)`,
         B=32, S=64 + 64, 10 Adam steps on one fixed batch, tokens/s
         (src + tgt) over steps 3-10;
  bert   phase 11 (`phase_bert_train`): full-width `bert_base`, fp32,
         B=16, S=512, 10 Adam steps on one fixed batch, tokens/s (B*S)
         over steps 3-10;
  bert_bf16  phase 11b (`phase_bert_train_bf16`): the same model cast
         to bf16, bench_bert.py's SGD, the same batch and steps;
each then one step under torch.profiler. Prints one line for each run
(tokens/s, mean step ms, the profiled step's window and device busy
time, and the share of that device time of the flash forward (bert) or
of the flash forward and the split backward (bert_bf16)).
  rpa    this checkout's `chip_smoke.rpa_times` on each side's package:
         the four paged kernels' device ms (CUDA-graph replay) at the
         serving shape and the long case, the 1-wide ones also at every
         slot of length 1 or 32 and at 32 slots, and the launch floor
         where the package builds the empty kernel; one line a run.
  fp32   this checkout's `chip_smoke.fp32_kernel_times` on each side's
         package: the fp32 flash forward, fused backward, dQ kernel and
         LayerNorm at their paths' shapes (serving, training, BERT); one
         line a run, with the SHA-256 of the fp32 LayerNorm's output bits
         (`chip_smoke.ln_fp32_digest`); the JSON line says whether every
         run's bits were equal.
  bf16   this checkout's `chip_smoke.bf16_kernel_times` on each side's
         package: the bf16 flash forward, the fused backward, the dK/dV
         and dQ kernels and their pair at BERT's shape, and LayerNorm;
         one line a run, with the SHA-256 of the pair's output bits
         (`chip_smoke.bf16_backward_digest`); the JSON line says whether
         every run's bits were equal.
  conv   this checkout's `chip_smoke.conv1x1_kernel_times` on each side's
         package: the conv1x1 kernel in fp32 and bf16 at the probe's four
         ResNet-50 shapes; one line a run.
Then the card's name and power limit, then one JSON line with every run
and each side's medians. `--log-dir` keeps each run's whole output
there. Exits non-zero without a CUDA device or when a run fails.
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# one run: the phases of the chip_smoke.py at argv[3] (the checkout's own
# for the training phases, this one's for the kernel timings), the
# checkout's package
_RUN = """
import importlib.util, json, os, sys, tempfile
root, phase, smoke = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import mxnet_tpu_torch as mx
pkg = os.path.dirname(os.path.dirname(os.path.abspath(mx.__file__)))
assert pkg == root, f"mxnet_tpu_torch imported from {pkg}, not {root}"
cs.phase_build(mx, torch)
if phase == "rpa":
    print("rpa times " + json.dumps(cs.rpa_times(mx, torch)), flush=True)
    sys.exit(0)
if phase == "fp32":
    print("fp32 times " + json.dumps(cs.fp32_kernel_times(mx, torch)),
          flush=True)
    print("fp32 layer norm bits " + cs.ln_fp32_digest(mx, torch),
          flush=True)
    sys.exit(0)
if phase == "bf16":
    print("bf16 times " + json.dumps(cs.bf16_kernel_times(mx, torch)),
          flush=True)
    print("bf16 backward bits " + cs.bf16_backward_digest(mx, torch),
          flush=True)
    sys.exit(0)
if phase == "conv":
    print("conv times " + json.dumps(cs.conv1x1_kernel_times(mx, torch)),
          flush=True)
    sys.exit(0)
if phase == "bert_bf16":
    cs.phase_bert_train_bf16(mx, torch)
    sys.exit(0)
run = cs.phase_bert_train if phase == "bert" else cs.phase_train
with tempfile.TemporaryDirectory() as tmp:
    run(mx, torch, os.path.join(tmp, "init.params"))
"""
# each phase's summary line and profile tag
_TAGS = {"train": ("training ", "train profile"),
         "bert": ("bert training ", "bert profile"),
         "bert_bf16": ("bert bf16 training ", "bert bf16 profile"),
         "rpa": ("rpa times ", None), "fp32": ("fp32 times ", None),
         "bf16": ("bf16 times ", None), "conv": ("conv times ", None)}
# the phases that time kernels: a dict of ms a run, medians by key
_KERNEL_PHASES = ("rpa", "fp32", "bf16", "conv")
# the kernels whose share of the profiled step's device time a phase
# reports
_SHARES = {"bert": ("flash forward",),
           "bert_bf16": ("flash forward", "split backward")}


def run_once(root, phase, log_path):
    """(summary, profiled window ms, busy ms, {kernel: (ms, share %)} of
    the phase's reported kernels, the bit digest the phase prints or
    None) of one run; for the kernel phases the summary is the timing
    function's dict, the times None and the shares empty."""
    smoke = os.path.join(HERE if phase in _KERNEL_PHASES else root,
                         "chip_smoke.py")
    proc = subprocess.run([sys.executable, "-c", _RUN, root, phase, smoke],
                          cwd=root,
                          capture_output=True, text=True, timeout=900)
    if log_path:
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"chip_train_ab: the run of {root} failed "
                         f"(exit {proc.returncode})")
    head, tag = _TAGS[phase]
    profile = re.compile(rf"^{tag}: window ([0-9.]+) ms, .*device busy "
                         rf"([0-9.]+) ms")
    summary, window, busy, shares, bits = None, None, None, {}, None
    share_res = {what: re.compile(rf"^{tag}: {what} ([0-9.]+) ms, "
                                  rf"([0-9.]+) % of device time")
                 for what in _SHARES.get(phase, ())}
    for line in proc.stdout.splitlines():
        if line.startswith(head + "{"):
            summary = json.loads(line[len(head):])
        if line.startswith(("bf16 backward bits ", "fp32 layer norm bits ")):
            bits = line.split()[-1]
        m = profile.match(line)
        if m:
            window, busy = float(m.group(1)), float(m.group(2))
        for what, share_re in share_res.items():
            m = share_re.match(line)
            if m:
                shares[what] = (float(m.group(1)), float(m.group(2)))
    if summary is None:
        raise SystemExit(f"chip_train_ab: no {head.strip()} line from "
                         f"{root}")
    if phase not in _KERNEL_PHASES and "mean_step_ms" not in summary:
        timed = summary["step_ms"][2:]
        summary["mean_step_ms"] = sum(timed) / len(timed)
    return summary, window, busy, shares, bits


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--phase", choices=sorted(_TAGS), default="train")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--log-dir", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_train_ab: no CUDA device", file=sys.stderr)
        return 1
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    runs = []
    for r in range(args.rounds):
        for i, side in enumerate(("other", "this", "this", "other")):
            log_path = (os.path.join(
                args.log_dir, f"{args.phase}_run{r}_{i}_{side}.log")
                if args.log_dir else None)
            summary, window, busy, shares, bits = run_once(
                sides[side], args.phase, log_path)
            if args.phase in _KERNEL_PHASES:
                runs.append(dict(side=side, ms=summary))
                if bits is not None:
                    runs[-1]["bits"] = bits
                print(f"{side}: " + ", ".join(
                    f"{k} {v:.6f}" for k, v in summary.items())
                    + ("" if bits is None else f"; bits {bits}"),
                    flush=True)
                continue
            runs.append(dict(side=side, tokens_per_s=summary["tokens_per_s"],
                             mean_step_ms=summary["mean_step_ms"],
                             profiled_window_ms=window, busy_ms=busy,
                             shares={what: dict(ms=ms, pct=pct)
                                     for what, (ms, pct) in shares.items()},
                             launches=summary["launches"]))
            print(f"{side}: {summary['tokens_per_s']:.1f} tokens/s, "
                  f"{summary['mean_step_ms']:.3f} ms a step; profiled "
                  f"step window {window} ms, device busy {busy} ms"
                  + "".join(f", {what} {ms} ms, {pct} % of it"
                            for what, (ms, pct) in shares.items()),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    if args.phase in _KERNEL_PHASES:
        median = {side: {k: statistics.median(r["ms"][k] for r in runs
                                               if r["side"] == side)
                         for k in next(r["ms"] for r in runs
                                       if r["side"] == side)}
                  for side in sides}
        key = "median_ms"
    else:
        median = {side: statistics.median(r["tokens_per_s"] for r in runs
                                          if r["side"] == side)
                  for side in sides}
        key = "median_tokens_per_s"
    result = {"phase": args.phase, "checkouts": sides, "runs": runs,
              key: median}
    if any("bits" in r for r in runs):
        result["bits_equal"] = len({r.get("bits") for r in runs}) == 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
