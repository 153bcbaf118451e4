"""End-to-end GAT training on the port's fused SDDMM+SpMM handle.

    PYTHONPATH=src python examples/torch_gat_training.py [--epochs 50]
    PYTHONPATH=src python examples/torch_gat_training.py --device cpu \\
        --epochs 5 --nodes 256 --edges 2048

The PyTorch counterpart of ``examples/gat_training.py``: a full-batch
2-layer GAT whose per-edge attention (``leaky_relu(q_i · k_j)`` on the
adjacency pattern) and aggregation run through ONE ``kernel="fused"``
DistSpmm handle per layer — the SDDMM and SpMM phases share a single
communication phase on the joint plan — forward and backward (coo, as in
the reference, whose bsr SpMM phase has no gradient), with AdamW. The
attention is the reference's unnormalized form (no per-row softmax).
P ranks are emulated on one device: the card by default, ``--device cpu``
for the kernels' plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import SpmmConfig, compile_fused
from repro_torch.core import power_law_sparse
from repro_torch.models.gnn import (
    gat_forward, gat_from_numpy, gat_loss, gat_params, normalize_adjacency,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step

FEAT, HIDDEN, CLASSES, ATT = 64, 128, 16, 16


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--edges", type=int, default=16384)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"graph: {args.nodes} nodes, ~{args.edges} edges, P={args.procs}, "
          f"device {args.device}")
    adj = normalize_adjacency(
        power_law_sparse(args.nodes, args.nodes, args.edges, 1.4, 0))

    t0 = time.perf_counter()
    handle = compile_fused(adj, args.procs,
                           SpmmConfig(kernel="fused", edge="leaky_relu",
                                      schedule="auto"), device=args.device)
    prep_s = time.perf_counter() - t0
    st = handle.stats()
    print(f"fused handle: kernel={st['kernel']} edge={st['edge']} "
          f"schedule={st['schedule_kind']}/K={st['schedule_K']} "
          f"({prep_s:.2f}s prep); one comm phase serves both the SDDMM "
          f"attention and the SpMM aggregation")

    model = gat_from_numpy(gat_params((FEAT, HIDDEN, CLASSES), ATT, seed=0),
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
        loss = gat_loss(model, feats, labels, handle)
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
        acc = float((gat_forward(model, feats, handle).argmax(-1) == labels)
                    .float().mean())
    print(f"training: {train_s:.2f}s ({train_s / max(args.epochs, 1) * 1e3:.1f}"
          f"ms/epoch, host wall); final loss {float(loss):.4f}; train acc "
          f"{acc:.3f}")


if __name__ == "__main__":
    main()
