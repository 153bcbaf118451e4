"""End-to-end GCN training on the port's distributed SpMM (paper §7.6 / Tab. 3).

    PYTHONPATH=src python examples/torch_gnn_training.py [--epochs 200]
    PYTHONPATH=src python examples/torch_gnn_training.py --device cpu \\
        --epochs 5 --nodes 256 --edges 2048
    PYTHONPATH=src python examples/torch_gnn_training.py --nproc 2 \\
        --device cpu --epochs 5 --nodes 256 --edges 2048

The PyTorch counterpart of ``examples/gnn_training.py``: a full-batch
2-layer GCN whose adjacency SpMM runs through the SHIRO joint plan over P
ranks emulated on one device (the card by default; ``--device cpu`` runs
the kernels' plain versions), forward and backward, with AdamW. It
reports per-epoch time, the MWVC preprocessing time and its ratio — the
Table-3 protocol. Weights and inputs come from numpy seeds 0, 1 and 2.

With ``--nproc N`` the same training runs on a fleet of N processes
(``repro_torch.launch.multiprocess.launch_local``), P / N ranks each, as
the reference's example runs on whatever mesh it is given: every process
plans the same handle on ``Topology.multiprocess()``, holds its rows of
the features and of every layer's output, and sums the weight gradients
over the processes before each AdamW step; process 0 prints.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch import SpmmConfig, compile_spmm
from repro_torch.core import build_plan, make_spmm_fn, power_law_sparse
from repro_torch.launch.multiprocess import (
    RANK_ENV, initialize, launch_local, shutdown,
)
from repro_torch.models.gnn import (
    gcn_forward, gcn_from_numpy, gcn_loss, gcn_params, normalize_adjacency,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step

FEAT, HIDDEN, CLASSES = 64, 128, 16


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--edges", type=int, default=65536)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--nproc", type=int, default=1,
                    help="processes of a fleet, each running procs / nproc "
                         "of the ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fleet = os.environ.get(RANK_ENV) is not None
    if args.nproc > 1 and not fleet:  # the launcher: spawn the fleet
        if args.procs % args.nproc:
            raise SystemExit(f"--procs {args.procs} does not split over "
                             f"--nproc {args.nproc}")
        rc = launch_local(args.nproc, args.procs // args.nproc,
                          device=args.device,
                          argv=[sys.executable, os.path.abspath(__file__)]
                          + list(sys.argv[1:] if argv is None else argv))
        if rc:
            raise SystemExit(rc)
        return

    where = initialize(device=args.device) if fleet else args.procs
    say = print if not fleet or where.process_index == 0 else \
        (lambda *a, **k: None)
    say(f"graph: {args.nodes} nodes, ~{args.edges} edges, P={args.procs}, "
        f"device {args.device}"
        + (f", {where.n_hosts} processes" if fleet else ""))
    adj = normalize_adjacency(
        power_law_sparse(args.nodes, args.nodes, args.edges, 1.4, 0))

    t0 = time.perf_counter()
    handle = compile_spmm(adj, where, SpmmConfig(schedule="auto"),
                          device=args.device)
    prep_s = time.perf_counter() - t0
    st = handle.stats()
    vols_col = build_plan(adj, args.procs, "col").volume_rows()
    say(f"MWVC preprocessing + autotune: {prep_s:.2f}s; volume rows "
        f"{vols_col} (col) -> {st['volume_rows']} (joint, "
        f"-{100 * (1 - st['volume_rows'] / max(vols_col, 1)):.1f}%); "
        f"schedule={st['schedule_kind']}/K={st['schedule_K']}")

    spmm = make_spmm_fn(handle)
    model = gcn_from_numpy(gcn_params((FEAT, HIDDEN, CLASSES), seed=0),
                           args.nodes, device=args.device)
    feats = np.random.default_rng(1).standard_normal(
        (args.nodes, FEAT), dtype=np.float32)
    # on a fleet each process holds its rows of the features
    feats = where.put_global(feats) if fleet else \
        torch.from_numpy(feats).to(args.device)
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, CLASSES, args.nodes)).to(args.device)
    opt_cfg = AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=10,
                          total_steps=args.epochs)
    params = list(model.parameters())
    opt = adamw_init(params)

    def step(o):
        loss = gcn_loss(model, feats, labels, spmm)
        loss.backward()
        if fleet:  # this process's share of the loss and of the grads
            handle.comm.reduce_grads(params)
            loss = handle.comm.fold(loss.detach())
        o, _ = adamw_step(opt_cfg, params, o)
        return o, loss.detach()

    opt, loss = step(opt)  # first use: builds the backward maps
    _sync(args.device)
    t0 = time.perf_counter()
    for ep in range(args.epochs):
        opt, loss = step(opt)
        if ep % max(args.epochs // 10, 1) == 0:
            say(f"  epoch {ep:4d}  loss {float(loss):.4f}")
    _sync(args.device)
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        hits = (gcn_forward(model, feats, spmm).argmax(-1) == (
            torch.cat([labels[s:e] for s, e in handle.row_blocks()])
            if fleet else labels)).float().sum()
        if fleet:
            hits = handle.comm.fold(hits)
        acc = float(hits) / args.nodes
    ratio = prep_s / (prep_s + train_s) * 100
    say(f"training: {train_s:.2f}s ({train_s / max(args.epochs, 1) * 1e3:.1f}"
        f"ms/epoch, host wall); final loss {float(loss):.4f}; train acc "
        f"{acc:.3f}")
    say(f"prep ratio (Tab. 3 protocol): {ratio:.1f}%")
    if fleet:
        shutdown()


if __name__ == "__main__":
    main()
