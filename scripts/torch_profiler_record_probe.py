#!/usr/bin/env python3
"""How many of K6's device records torch.profiler keeps in a session, by
the way the session is opened.

    python3 scripts/torch_profiler_record_probe.py

Five float32 inputs of 256 × 2048 go through ``rmsnorm_cuda``, 5 or 20
passes a session, 12 sessions of each method:

- A: a plain ``profile`` context (as ``chip_smoke.kernel_busy_ms``);
- B: the same with 50 ms of sleep after the session opens and before
  it closes;
- C: a ``schedule`` with one warm-up step (one pass) before the counted
  one;
- D: C with B's sleeps.

Prints, per method and launches a session, the ``rmsnorm_kernel``
records each session kept. Needs one CUDA card.
"""
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import rmsnorm as k6  # noqa: E402

ACT = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def count(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "rmsnorm_kernel" in e.key)


def main() -> int:
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(256, 2048, device="cuda", generator=g)
          for _ in range(5)]
    w = torch.randn(2048, device="cuda", generator=g)
    fns = [lambda x=x: k6.rmsnorm_cuda(x, w, 1e-5, round_before_gain=True)
           for x in xs]
    for f in fns:
        f()
    torch.cuda.synchronize()

    def run(reps):
        for _ in range(reps):
            for f in fns:
                f()
        torch.cuda.synchronize()

    def plain(reps, pause=0.0):
        torch.cuda.synchronize()
        with profile(activities=ACT) as prof:
            time.sleep(pause)
            run(reps)
            time.sleep(pause)
        return count(prof)

    def warmed(reps, pause=0.0):
        torch.cuda.synchronize()
        with profile(activities=ACT, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            run(1)
            prof.step()
            time.sleep(pause)
            run(reps)
            time.sleep(pause)
            prof.step()
        return count(prof)

    methods = {"A": plain, "B": lambda r: plain(r, 0.05), "C": warmed,
               "D": lambda r: warmed(r, 0.05)}
    res = {m: {5: [], 20: []} for m in methods}
    for _ in range(12):
        for reps in (5, 20):
            for m, f in methods.items():
                res[m][reps].append(f(reps))
    for m in methods:
        for reps in (5, 20):
            print(m, reps * len(fns), res[m][reps], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
