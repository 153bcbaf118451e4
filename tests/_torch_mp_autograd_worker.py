"""One worker of the 2-process CPU fleet that ``test_torch_process_autograd``
launches (``launch_local(2, 4, device="cpu", argv=[python, this, out])``).

Every process differentiates through its span of the P = 8 ranks and
writes what it saw to ``<out>/rank<i>.json`` (its gradient rows, losses
and parameters to ``<out>/rank<i>.npz``): each ``ProcessComm`` collective's
input gradient on a random linear functional against ``LocalComm``'s on
the stacked tensor, ``dB`` of ½‖h(b)‖² through every coo executor tier
against the emulated run of the same plan (``Topology.local(8)``), the
backward's rows per axis and across processes, a bsr SpMM under grad, and
three AdamW steps of a GCN and a GAT with the gradients summed over the
processes (``comm.reduce_grads``). It imports no JAX; the test compares
the rows with the JAX package.
"""
import json
import os
import sys

import numpy as np
import torch

from repro_torch.core.api import (
    SpmmConfig, compile_fused, compile_spmm, make_spmm_fn,
    materialize_payload,
)
from repro_torch.core.sparse import power_law_sparse
from repro_torch.distributed.comm import LocalComm
from repro_torch.distributed.topology import Topology
from repro_torch.launch.multiprocess import initialize, shutdown
from repro_torch.models import gnn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step

P, N_COLS = 8, 16
# the executor tiers of tests/test_torch_autograd.py (coo: bsr SpMM takes
# no gradient); hier (2, 4) is the fleet's own grid
CONFIGS = {
    "flat_single": dict(schedule="single"),
    "flat_staged": dict(schedule=2, overlap=False),
    "flat_overlapped": dict(schedule=2, overlap=True),
    "hier_single": dict(hier=(2, 4), schedule="single"),
    "hier_overlapped": dict(hier=(2, 4), schedule=1, overlap=True),
    "replicated": dict(replicate=2),
}
AXES = {"flat": ("x",), "hier": ("g", "l"), "replicated": ("s", "r")}
GCN_DIMS, GAT_DIMS, ATT = (12, 16, 16, 5), (12, 16, 5), 8
MODELS = {"gcn-flat": dict(), "gcn-hier": dict(hier=(2, 4)),
          "gat-flat": dict(), "gat-hier": dict(hier=(2, 4))}
ADAMW = dict(lr=5e-3, weight_decay=0.0, warmup_steps=10, total_steps=200)
STEPS = 3


def matrix():
    return power_law_sparse(64, 64, 400, 1.2, 2)


def _gen(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def collective_cases():
    """(name, groups, replicas, op, x, out_rows): each collective kind on
    the layouts ``test_torch_process_comm`` uses; ``out_rows(w, lo, hi)``
    picks this process's rows of LocalComm's result."""
    t = lambda seed, *shape: torch.from_numpy(_gen(seed, shape))  # noqa
    rows = lambda w, lo, hi: w[lo:hi]  # noqa
    perm = [(0, 5), (5, 2), (2, 7), (3, 0), (6, 6)]
    out = [("all_to_all", 1, 1, lambda c, x: c.all_to_all(x),
            t(1, P, P, 3, 5), rows),
           ("ppermute_partial", 1, 1, lambda c, x: c.ppermute(x, perm),
            t(2, P, 3, 5), rows),
           ("shift3", 1, 1, lambda c, x: c.shift(x, 3), t(3, P, 4, 5), rows)]
    for G in (2, 4):
        L = P // G
        out += [
            (f"group_all_to_all_G{G}", G, 1,
             lambda c, x: c.group_all_to_all(x), t(4, P, G, 3, 5), rows),
            (f"group_shift_G{G}", G, 1, lambda c, x: c.group_shift(x, 1),
             t(5, P, 3, 5), rows),
            (f"local_psum_scatter_G{G}", G, 1,
             lambda c, x: c.local_psum_scatter(x, dim=1),
             t(6, P, 2, L * 3, 5), rows),
            (f"local_all_gather_G{G}", G, 1,
             lambda c, x: c.local_all_gather(x), t(8, P, 3, 5), rows)]
    for C in (2, 4):
        S = P // C
        shifts = tuple((r + 1) % S for r in range(C))
        out += [
            (f"replicate_c{C}", 1, C,
             lambda c, x, S=S, C=C: c.replicate(
                 x.reshape(S, C * 3, 5) if isinstance(c, LocalComm) else x),
             t(9, P, 3, 5), rows),
            (f"lane_shift_c{C}", 1, C,
             lambda c, x, sh=shifts, C=C: c.lane_shift(x, sh, range(C)),
             t(10, P, 3, 5), rows),
            # LocalComm's result is [s, c, rows / c, ...] in (g, r) order;
            # ProcessComm's is its ranks (r, g) in rank order
            (f"replica_psum_scatter_c{C}", 1, C,
             lambda c, x: c.replica_psum_scatter(x), t(12, P, 2 * C, 5),
             lambda w, lo, hi, S=S: torch.stack(
                 [w[p % S, p // S] for p in range(lo, hi)]))]
    return out


def collective_grads(topo):
    """Each collective's input gradient on ⟨r, out⟩ (r random, the same
    global tensor on every process) on the fleet against LocalComm's."""
    lo, hi = topo.span
    res = {}
    for i, (name, G, C, op, x, out_rows) in enumerate(collective_cases()):
        loc = LocalComm(P, G, C)
        proc = topo.comm(G, C)
        xg = x.clone().requires_grad_()
        want_out = op(loc, xg)
        r = torch.from_numpy(_gen(100 + i, tuple(want_out.shape)))
        (want_out * r).sum().backward()
        xl = x[lo:hi].clone().requires_grad_()
        out = op(proc, xl)
        (out * out_rows(r, lo, hi)).sum().backward()
        res[name] = {
            "equal": bool(torch.equal(xl.grad, xg.grad[lo:hi])),
            "rows": [proc.fleet_rows(direction=d) for d in ("fwd", "bwd")],
            "local_rows": [loc.rows(direction=d) for d in ("fwd", "bwd")],
            "crossing": [proc.fleet_rows(crossing=True, direction=d)
                         for d in ("fwd", "bwd")],
            "bwd_exchanges": proc.transport()["bwd_exchanges"]}
    return res


def handle_grads(topo, arrays):
    """dB of ½‖h(b)‖² on every coo tier: this process's rows against the
    emulated run's, and the backward's rows against the forward's."""
    lo, hi = topo.span
    a = matrix()
    b = _gen(0, (64, N_COLS))
    per = 64 // P
    res = {}
    for name, cfg in CONFIGS.items():
        h = compile_spmm(a, topo, SpmmConfig(**cfg))
        emu = materialize_payload(h.save_payload(), Topology.local(P, "cpu"))
        x = torch.from_numpy(b[lo * per:hi * per].copy()).requires_grad_()
        c = h(x)
        c.backward(c.detach())  # d ½‖c‖² / dc = c
        xe = torch.from_numpy(b.copy()).requires_grad_()
        ce = emu(xe)
        ce.backward(ce.detach())
        axes = AXES[h.strategy]
        res[name] = {
            "strategy": h.strategy,
            "equal": bool(torch.equal(x.grad, xe.grad[lo * per:hi * per])),
            "c_equal": bool(torch.equal(c.detach(), torch.cat(
                [ce.detach()[s:e] for s, e in h.row_blocks()]))),
            "rows": {ax: [h.comm.fleet_rows(ax, direction=d)
                          for d in ("fwd", "bwd")]
                     + [emu.comm.rows(ax, d) for d in ("fwd", "bwd")]
                     for ax in axes},
            "crossing": [h.comm.fleet_rows(crossing=True, direction=d)
                         for d in ("fwd", "bwd")],
            "plan_crossing": (None if h.replicated
                              else h.plan_crossing_rows()),
            "transport": h.comm.transport()}
        arrays[f"db/{name}"] = x.grad.numpy()
    hb = compile_spmm(a, topo, backends=("coo", "bsr"))
    x = torch.from_numpy(b[lo * per:hi * per].copy()).requires_grad_()
    try:
        hb(x, backend="bsr")
        res["bsr_raises"] = False
    except NotImplementedError as e:
        res["bsr_raises"] = "no JVP" in str(e)
    return res


def train(topo, arrays):
    """STEPS AdamW steps of each model on the fleet: the first step's
    loss (the fold of the processes' shares) and summed gradients, and
    the parameters after every step."""
    adj = gnn.normalize_adjacency(matrix())
    n = adj.shape[0]
    res = {}
    for name, cfg in MODELS.items():
        kind = name.split("-")[0]
        rng = np.random.default_rng(1 if kind == "gcn" else 3)
        dims = GCN_DIMS if kind == "gcn" else GAT_DIMS
        feats = rng.standard_normal((n, dims[0])).astype(np.float32)
        labels = torch.from_numpy(rng.integers(0, dims[-1], n))
        if kind == "gcn":
            h = compile_spmm(adj, topo, SpmmConfig(**cfg))
            model = gnn.gcn_from_numpy(gnn.gcn_params(dims, seed=0),
                                       device="cpu")
            fn, loss_fn = make_spmm_fn(h), gnn.gcn_loss
        else:
            h = compile_fused(adj, topo, edge="leaky_relu", **cfg)
            model = gnn.gat_from_numpy(gnn.gat_params(dims, ATT, seed=0),
                                       device="cpu")
            fn, loss_fn = h, gnn.gat_loss
        params = list(model.parameters())
        opt_cfg, opt = AdamWConfig(**ADAMW), adamw_init(params)
        x = topo.put_global(feats)  # this process's feature rows
        losses = []
        for step in range(STEPS):
            loss = loss_fn(model, x, labels, fn)
            loss.backward()
            if step == 0:
                rows = [h.comm.fleet_rows(direction=d) for d in ("fwd", "bwd")]
                crossing = [h.comm.fleet_rows(crossing=True, direction=d)
                            for d in ("fwd", "bwd")]
            h.comm.reduce_grads(params)
            losses.append(float(h.comm.fold(loss.detach())))
            if step == 0:
                for i, p in enumerate(params):
                    arrays[f"{name}/grad{i}"] = p.grad.numpy().copy()
            opt, _ = adamw_step(opt_cfg, params, opt)
            for i, p in enumerate(params):
                arrays[f"{name}/step{step}/p{i}"] = p.detach().numpy().copy()
        res[name] = {"losses": losses, "strategy": h.strategy,
                     "rows": rows, "crossing": crossing,
                     "names": [k for k, _ in model.named_parameters()]}
    return res


def main(out_dir):
    topo = initialize(timeout=90.0)
    arrays = {}
    res = {"span": list(topo.span),
           "comm": collective_grads(topo),
           "exec": handle_grads(topo, arrays),
           "train": train(topo, arrays)}
    with open(os.path.join(out_dir, f"rank{topo.process_index}.json"),
              "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out_dir, f"rank{topo.process_index}.npz"),
             **arrays)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(2)
    main(sys.argv[1])
