#!/usr/bin/env python3
"""torch.profiler loses device records as a process ages (torch alone).

    python3 chip_profiler_age.py [AGE_S ...]   # default 0 20 60 120

No code of the port runs here. At each age (seconds since the first
profile; the card and the host busy in between) it profiles:

  * a window holding one kernel (`x.add_(1)`), bare and padded inside the
    window by 1 s of host sleep before and after: its device rows;
  * 20 replays of a CUDA graph holding two device copies: the copies the
    profile shows, of 40 launched;
  * 200 kernel launches: the kernels the profile shows;
  * the one kernel and the 200 again, with a host event (a
    `record_function` of 50 ms) after the synchronize inside the window.

One JSON line an age. Some seconds into the process the one-kernel
window shows no device row, padded or not, and longer windows lose a
few records; a host event after the work (the `record_function`) does
not keep them. chip_smoke.py's 11d (d) profiles many replays for that.
"""
import json
import sys
import time


def main(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_profiler_age: no CUDA device", file=sys.stderr)
        return 1
    ages = [float(a) for a in argv] or [0.0, 20.0, 60.0, 120.0]
    x = torch.ones(1 << 20, device="cuda")
    y = torch.empty_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y.copy_(x)
        x.copy_(y)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y.copy_(x)
        x.copy_(y)
    torch.cuda.synchronize()

    def window(work, pad=0.0, tail=False):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            work()
            torch.cuda.synchronize()
            time.sleep(pad)
            if tail:
                with torch.profiler.record_function("tail"):
                    time.sleep(0.05)
        return prof

    def device_count(prof, word=""):
        return sum(e.count for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", ""))
                   and word in e.key.lower())

    t0 = time.perf_counter()
    for age in ages:
        while time.perf_counter() - t0 < age:
            x.mul_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
        print(json.dumps(dict(
            age_s=round(time.perf_counter() - t0, 1),
            one_kernel_rows=device_count(window(lambda: x.add_(1.0))),
            one_kernel_rows_padded_1s=device_count(
                window(lambda: x.add_(1.0), 1.0)),
            graph_copies_seen_of_40=device_count(window(
                lambda: [graph.replay() for _ in range(20)]), "memcpy"),
            kernels_seen_of_200=device_count(window(
                lambda: [x.add_(1.0) for _ in range(200)])),
            one_kernel_rows_host_tail=device_count(
                window(lambda: x.add_(1.0), tail=True)),
            kernels_seen_of_200_host_tail=device_count(window(
                lambda: [x.add_(1.0) for _ in range(200)], tail=True)))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
