"""End-to-end GCN training on the port's distributed SpMM (paper §7.6 / Tab. 3).

    PYTHONPATH=src python examples/torch_gnn_training.py [--epochs 200]
    PYTHONPATH=src python examples/torch_gnn_training.py --device cpu \\
        --epochs 5 --nodes 256 --edges 2048

The PyTorch counterpart of ``examples/gnn_training.py``: a full-batch
2-layer GCN whose adjacency SpMM runs through the SHIRO joint plan over P
ranks emulated on one device (the card by default; ``--device cpu`` runs
the kernels' plain versions), forward and backward, with AdamW. It
reports per-epoch time, the MWVC preprocessing time and its ratio — the
Table-3 protocol. Weights and inputs come from numpy seeds 0, 1 and 2.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import SpmmConfig, compile_spmm
from repro_torch.core import build_plan, make_spmm_fn, power_law_sparse
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"graph: {args.nodes} nodes, ~{args.edges} edges, P={args.procs}, "
          f"device {args.device}")
    adj = normalize_adjacency(
        power_law_sparse(args.nodes, args.nodes, args.edges, 1.4, 0))

    t0 = time.perf_counter()
    handle = compile_spmm(adj, args.procs, SpmmConfig(schedule="auto"),
                          device=args.device)
    prep_s = time.perf_counter() - t0
    st = handle.stats()
    vols_col = build_plan(adj, args.procs, "col").volume_rows()
    print(f"MWVC preprocessing + autotune: {prep_s:.2f}s; volume rows "
          f"{vols_col} (col) -> {st['volume_rows']} (joint, "
          f"-{100 * (1 - st['volume_rows'] / max(vols_col, 1)):.1f}%); "
          f"schedule={st['schedule_kind']}/K={st['schedule_K']}")

    spmm = make_spmm_fn(handle)
    model = gcn_from_numpy(gcn_params((FEAT, HIDDEN, CLASSES), seed=0),
                           args.nodes, device=args.device)
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (args.nodes, FEAT), dtype=np.float32)).to(args.device)
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, CLASSES, args.nodes)).to(args.device)
    opt_cfg = AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=10,
                          total_steps=args.epochs)
    params = list(model.parameters())
    opt = adamw_init(params)

    def step(o):
        loss = gcn_loss(model, feats, labels, spmm)
        loss.backward()
        o, _ = adamw_step(opt_cfg, params, o)
        return o, loss.detach()

    opt, loss = step(opt)  # first use: builds the backward maps
    _sync(args.device)
    t0 = time.perf_counter()
    for ep in range(args.epochs):
        opt, loss = step(opt)
        if ep % max(args.epochs // 10, 1) == 0:
            print(f"  epoch {ep:4d}  loss {float(loss):.4f}")
    _sync(args.device)
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        acc = float((gcn_forward(model, feats, spmm).argmax(-1) == labels)
                    .float().mean())
    ratio = prep_s / (prep_s + train_s) * 100
    print(f"training: {train_s:.2f}s ({train_s / max(args.epochs, 1) * 1e3:.1f}"
          f"ms/epoch, host wall); final loss {float(loss):.4f}; train acc "
          f"{acc:.3f}")
    print(f"prep ratio (Tab. 3 protocol): {ratio:.1f}%")


if __name__ == "__main__":
    main()
