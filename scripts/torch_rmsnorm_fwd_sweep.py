#!/usr/bin/env python3
"""K6's forward on the card over rows x widths x dtypes, beside F.rms_norm.

    python3 scripts/torch_rmsnorm_fwd_sweep.py [--rows 1 8 512 1024 2048 8192]
        [--d 576 1536 2048 4096 8192] [--dtypes bf16 f32]
        [--shapes 2048x576 1024x2048 ...] [--src DIR] [--host-parts]
        [--json PATH]

For each (rows, D, dtype), ``round_before_gain=True`` as the model runs
it: whether y and r (the r-storing launch) have the plain version's bits
(both chains), the lanes a row (``_fwd_layout``), the profiler busy time
of the kernel per call and of ``F.rms_norm`` per call on the same input,
the bytes bound (x and g read once, y and r written once, over 3.35
TB/s), CUDA events over 50 back-to-back calls, and the wrapper's host µs
a call with and without r; one JSON row each on stdout (and, with
``--json``, all of them to PATH). ``--shapes`` replaces the grid by the
shapes given (bfloat16 unless ``--dtypes`` says otherwise). ``--src``
measures the package under DIR instead of this checkout's (a parent
unpacked beside it: run both in one call). ``--host-parts`` also times
the pieces of the wrapper's host path at 1024 x 2048 bfloat16. Needs one
CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, n: int = 2000) -> float:
    """Host µs a call over ``n`` back-to-back calls (after a warm-up), the
    clock stopped before the one synchronize at the end."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / n * 1e6


def launched_lanes(K6, rows: int, d: int, es: int):
    """The lanes a row the rows kernel launches with (``csrc/rmsnorm.cu``'s
    ``launch_rmsnorm``: ``_fwd_layout``'s, doubled while a lane would hold
    more than 3 chunks or rows · lanes < 2**16); None for the wide kernel
    or a package without the rows kernel."""
    if not hasattr(K6, "_fwd_layout"):
        return None
    nvec = -(-d // (16 // es))
    lanes = K6._fwd_layout(d, es)
    if -(-nvec // lanes) > K6.HELD:
        return None
    while lanes < 256 and (-(-nvec // lanes) > 3 or rows * lanes < 2 ** 16):
        lanes *= 2
    return lanes


def host_parts(K6, ops) -> dict:
    """The wrapper's host path at 1024 x 2048 bfloat16, piece by piece."""
    from repro_torch.kernels import build

    x = torch.randn((1024, 2048), device="cuda").to(torch.bfloat16)
    g = torch.randn(2048, device="cuda").to(torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    lib = build.library()
    out = torch.empty_like(x)
    r = torch.empty(1024, dtype=torch.float32, device="cuda")
    lanes = K6._fwd_layout(2048, 2) if hasattr(K6, "_fwd_layout") else None
    args = [x.data_ptr(), g.data_ptr(), out.data_ptr(), r.data_ptr(), 1024,
            2048] + ([lanes] if lanes else []) + [1e-5, 1, 1,
                                                   build.stream_of(x)]
    nbytes = x.numel() * 2 + 1024 * 4
    parts = {
        "wrapper": lambda: K6.rmsnorm_cuda(x, g, 1e-5,
                                           round_before_gain=True),
        "wrapper_return_r": lambda: K6.rmsnorm_cuda(
            x, g, 1e-5, round_before_gain=True, return_r=True),
        "c_call": lambda: lib.repro_rmsnorm(*args),
        "empty_like": lambda: torch.empty_like(x),
        "empty_r": lambda: torch.empty(x.shape[:-1], dtype=torch.float32,
                                       device=x.device),
        "new_empty_r": lambda: x.new_empty(x.shape[:-1],
                                           dtype=torch.float32),
        "batched_r": lambda: K6._new_r(x, build.stream_of(x))
        if hasattr(K6, "_new_r") else None,
        "one_buffer_views": lambda: (
            lambda b: (b[:x.numel() * 2].view(x.dtype).view(x.shape),
                       b[x.numel() * 2:].view(torch.float32)))(
            torch.empty(nbytes, dtype=torch.uint8, device=x.device)),
        "checks": lambda: (x.is_cuda and g.device == x.device,
                           K6._check(x, g), build.dtype_code(x.dtype, "k"),
                           x.is_contiguous(), g.is_contiguous()),
        "stream_of": lambda: build.stream_of(x),
        "rmsnorm_op": lambda: ops.rmsnorm_op(x, g, 1e-5,
                                             round_before_gain=True),
    }

    def under_grad():
        with torch.enable_grad():
            return ops.rmsnorm_op(xg, g, 1e-5, round_before_gain=True)

    parts["rmsnorm_op_under_grad"] = under_grad
    return {k: host_us(fn) for k, fn in parts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[1, 8, 512, 1024, 2048, 8192])
    ap.add_argument("--d", type=int, nargs="+",
                    default=[576, 1536, 2048, 4096, 8192])
    ap.add_argument("--dtypes", nargs="+", default=["bf16", "f32"],
                    choices=["bf16", "f32"])
    ap.add_argument("--shapes", nargs="+", metavar="ROWSxD")
    ap.add_argument("--src", metavar="DIR", default=os.path.join(ROOT, "src"),
                    help="the package to measure (default: this checkout's)")
    ap.add_argument("--host-parts", action="store_true")
    ap.add_argument("--json", metavar="PATH", help="also write the rows here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as K6

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; package: {os.path.dirname(K6.__file__)}",
          flush=True)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    if args.shapes:
        grid = [tuple(map(int, s.split("x"))) for s in args.shapes]
    else:
        grid = [(r, d) for d in args.d for r in args.rows]
    gen = torch.Generator("cuda").manual_seed(0)
    rows_out = []
    for name in args.dtypes:
        dtype = dtypes[name]
        for rows, d in grid:
            x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            g = torch.randn(d, generator=gen, device="cuda").to(dtype)
            equal = True
            for rbg in (False, True):
                y = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=rbg)
                y2, r = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=rbg,
                                        return_r=True)
                py, pr = K6.rmsnorm_plain(x, g, 1e-5, round_before_gain=rbg,
                                          return_r=True)
                equal &= bool(torch.equal(y, py) and torch.equal(y2, py)
                              and torch.equal(r, pr))

            def run():
                return K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=True)

            def run_r():
                return K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=True,
                                       return_r=True)

            def lib():
                return F.rms_norm(x, (d,), weight=g, eps=1e-5)

            es = x.element_size()
            nbytes = 2 * x.numel() * es + d * es + rows * 4
            by, _ = cs.kernel_busy_ms([run_r] * 8, cs.BUSY_KERNELS["rmsnorm"])
            row = dict(
                rows=rows, d=d, dtype=name,
                lanes=K6._fwd_layout(d, es) if hasattr(K6, "_fwd_layout")
                else None,
                lanes_launched=launched_lanes(K6, rows, d, es),
                equal=equal, busy_ms=sum(by.values()) / 8,
                busy_by_kernel={k: v / 8 for k, v in by.items()},
                library_busy_ms=cs.library_busy_ms([lib] * 8) / 8,
                bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                events_ms=cs.time_ms(run_r, iters=50, warmup=5),
                library_events_ms=cs.time_ms(lib, iters=50, warmup=5),
                host_us=host_us(run), host_us_return_r=host_us(run_r))
            rows_out.append(row)
            print(json.dumps(row), flush=True)
            del x, g
    parts = host_parts(K6, ops) if args.host_parts else None
    if parts:
        print(json.dumps({"host_parts_us": parts}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "src": args.src, "rows": rows_out,
                       "host_parts_us": parts}, f, indent=1)
    bad = [r for r in rows_out if not r["equal"]]
    if bad:
        print(f"kernel != plain at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
