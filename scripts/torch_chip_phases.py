#!/usr/bin/env python3
"""Some phases of ``chip_smoke.py`` alone on the card, for the tree in
the current directory (its ``chip_smoke.py`` and ``src/``), so that two
trees (a parent unpacked beside the checkout, and the checkout) can be
measured in one call.

    cd TREE && python3 /path/to/scripts/torch_chip_phases.py TAG \\
        [--phases 3 7 13] [--json PATH]

Phase 3: the kernel sweeps against the plain versions (``sweep_checks``);
7: LM serving, whose K6 rows (prefill, decode step, float32 copy) it
prints (``lm_serving``); 13: LM training, whose K1 / K2 / K6 /
K6-backward rows it prints (``train_lm_phase``). Each row as
``chip_smoke.py`` prints it, tagged TAG; with ``--json`` all rows to
PATH. Needs one CUDA card.
"""
import argparse
import json
import os
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--phases", type=int, nargs="+", default=[3, 7, 13],
                    choices=[3, 7, 13])
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    root = os.getcwd()
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    build.library()
    cs.log(f"[{args.tag}] card: {card}; build {time.perf_counter() - t0:.1f}"
           f" s")
    run = argparse.Namespace(quick=False, profile=False)
    rows = {}
    for phase in args.phases:
        t0 = time.perf_counter()
        if phase == 3:
            cs.sweep_checks()
            got = {}
        elif phase == 7:
            got, _, _ = cs.lm_serving(run, card)
        else:
            got = cs.train_lm_phase(run, card)
        cs.log(f"[{args.tag}] phase {phase} {time.perf_counter() - t0:.1f} s")
        for kernel, per_path in got.items():
            cs.kernel_summary(kernel, per_path, card)
            rows.setdefault(kernel, {}).update(per_path)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "tag": args.tag, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
