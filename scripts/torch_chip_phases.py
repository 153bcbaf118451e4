#!/usr/bin/env python3
"""Some phases of ``chip_smoke.py`` alone on the card, for the tree in
the current directory (its ``chip_smoke.py`` and ``src/``), so that two
trees (a parent unpacked beside the checkout, and the checkout) can be
measured in one call.

    cd TREE && python3 /path/to/scripts/torch_chip_phases.py TAG \\
        [--phases 3 7 13] [--quick] [--json PATH]

Phase 3: the kernel sweeps against the plain versions (``sweep_checks``);
7: LM serving, whose K6 rows (prefill, decode step, float32 copy) it
prints (``lm_serving``); 9: serving waves and the fleet
(``serving_phase``: on a quarter of arxiv where the tree's
``chip_smoke.py`` pins that size, ``EXPECT_SERVE_LADDER``, else at full
size); 11: SHIRO across two processes (``mp_phase``); 12: training and
the LM across two processes
(``mp_train_phase``); 13: LM training, whose K1 / K2 / K6 / K6-backward
rows it prints (``train_lm_phase``); 14: falcon-mamba serving
(``family_serve`` on ``SSM_CELL``); 15: the hybrid, encdec and prefix
families (zamba2, seamless, llava) and zamba2's train check
(``family_phase``); 16: the dry run against the steps phases 13 and 15
measured (``dryrun_phase``; list 13 and 15 before it). Each row as
``chip_smoke.py`` prints it, tagged
TAG; with ``--json`` all rows to PATH; ``--quick`` for ``chip_smoke.py
--quick``'s sizes. Needs one CUDA card.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def serve_matrices(cs, run):
    """Phase 9's (uniform, power-law, host B) at the size the tree's
    ``chip_smoke.py`` pins for it."""
    if hasattr(cs, "EXPECT_SERVE_LADDER"):
        return cs.life_matrices(run)
    from repro_torch.core.sparse import power_law_sparse, random_sparse

    m = 16_384 if run.quick else cs.M_FULL
    nnz = 7 * m if run.quick else cs.NNZ_FULL
    b_host = np.random.default_rng(0).standard_normal(
        (m, cs.N_COLS), dtype=np.float32)
    return (random_sparse(m, m, nnz / m ** 2, seed=0),
            power_law_sparse(m, m, nnz, 0.8, seed=0), b_host)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--phases", type=int, nargs="+", default=[3, 7, 13],
                    choices=[3, 7, 9, 11, 12, 13, 14, 15, 16])
    ap.add_argument("--quick", action="store_true")
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
    run = argparse.Namespace(quick=args.quick, profile=False)
    rows = {}
    for phase in args.phases:
        t0 = time.perf_counter()
        if phase == 3:
            cs.sweep_checks()
            got = {}
        elif phase == 7:
            got, _, _ = cs.lm_serving(run, card)
        elif phase == 9:
            got = cs.serving_phase(run, card, *serve_matrices(cs, run))
        elif phase == 11:
            got = cs.mp_phase(run, card)
        elif phase == 12:
            got = cs.mp_train_phase(run, card)
        elif phase == 14:
            got = {"rmsnorm": cs.family_serve(run, card, *cs.SSM_CELL)[0]}
        elif phase == 15:
            got = cs.family_phase(run, card)
        elif phase == 16:
            cs.dryrun_phase(run, card)
            got = {}
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
