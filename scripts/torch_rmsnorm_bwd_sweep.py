#!/usr/bin/env python3
"""K6's backward on the card at the LM training shapes, for several grid
targets (``kernels.rmsnorm.BWD_SMS``: the blocks a call aims at, which
fix the chunk of rows a block takes and so the dg partial rows).

    python3 scripts/torch_rmsnorm_bwd_sweep.py [--sms 66 132 264] [--json PATH]

For each (shape, target): the kernel's bits against the plain version at
that layout, the profiler busy time of each kernel of the pair per call,
CUDA events over 50 back-to-back calls, and the bytes bound, one JSON
row each on stdout (and, with ``--json``, all of them to PATH). Needs
one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import rmsnorm as K6  # noqa: E402

SHAPES = ((1024, 2048), (2048, 576))  # olmoe-train, smollm-train rows x D


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sms", type=int, nargs="+", default=[66, 132, 264])
    ap.add_argument("--json", metavar="PATH", help="also write the rows here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    gen = torch.Generator("cuda").manual_seed(0)
    rows_out = []
    for rows, d in SHAPES:
        x, dy = (torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        g = torch.randn(d, generator=gen, device="cuda").to(torch.bfloat16)
        _, r = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=True,
                               return_r=True)
        nbytes = 3 * x.numel() * 2 + 2 * d * 2 + rows * 4
        bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        saved = K6.BWD_SMS
        for sms in args.sms:
            K6.BWD_SMS = sms
            K6._bwd_layout.cache_clear()
            lanes, groups, chunk = K6._bwd_layout(rows, d, 2)

            def run():
                return K6.rmsnorm_bwd_cuda(x, g, dy, 1e-5,
                                           round_before_gain=True, r=r)

            got = run()
            want = K6.rmsnorm_bwd_plain(x, g, dy, 1e-5,
                                        round_before_gain=True, r=r)
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            by = cs.kernel_busy_ms([run] * 8, cs.BUSY_KERNELS["rmsnorm_bwd"])
            busy = {k: v / 8 for k, v in by.items()}
            row = dict(rows=rows, d=d, sms=sms, lanes=lanes, groups=groups,
                       chunk=chunk, blocks=-(-rows // chunk), equal=equal,
                       busy_ms=sum(busy.values()), busy_by_kernel=busy,
                       events_ms=cs.time_ms(run, iters=50, warmup=5),
                       bound_ms=bound_ms,
                       host_us=cs.host_us_per_launch([run]))
            rows_out.append(row)
            print(json.dumps(row))
            if not equal:
                raise AssertionError(f"kernel != plain at {row}")
        K6.BWD_SMS = saved
        K6._bwd_layout.cache_clear()
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows_out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
