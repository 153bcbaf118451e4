"""One worker of the CPU fleets that ``test_torch_lm_fleet_train`` launches
(``launch_local(n, w, device="cpu", argv=[python, this, dir, "DxM"])``):
a (data D, model M) grid over n processes of w ranks each.

``<dir>/cases.npz`` holds, for each case, the reference's initial
parameters (flattened key paths) and the batch. Every process runs the
case's ``make_train_step`` for ``STEPS`` steps on the fleet (its rows,
the experts of its model ranks) and the same steps on the emulated
``make_mesh`` grid of the same shape in the same process, and writes to
``<dir>/rank<i>.json`` each step's loss and grad norm from both, whether
they and every parameter it holds are ``torch.equal``, and the largest
differences. It imports no JAX; the test compares with the JAX package.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.context import make_context
from repro_torch.distributed.topology import Topology
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.multiprocess import initialize, shutdown
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
from repro_torch.train.steps import make_train_step

AXES = ("data", "model")
STEPS = 3
# name -> (arch, config changes, microbatches)
CASES = {
    "dense": ("qwen2-1.5b", dict(d_model=64, n_heads=4, n_kv_heads=2), 1),
    "ep": ("olmoe-1b-7b", dict(capacity_factor=8.0), 1),
    "dense_mb2": ("qwen2-1.5b", dict(d_model=64, n_heads=4, n_kv_heads=2),
                  2),
}
OPT = AdamWConfig(lr=1e-3)


def case_config(name):
    arch, changes, mb = CASES[name]
    return dataclasses.replace(get_smoke_config(arch), **changes), mb


def unflatten(flat, prefix):
    """The nested dict of the arrays named ``prefix/a/b``."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, last = key[len(prefix) + 1:].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def run_case(name, arrays, fdist, edist):
    cfg, mb = case_config(name)
    ref = unflatten(arrays, f"{name}/params")
    batch = {"tokens": arrays[f"{name}/tokens"]}
    eparams = TT.transformer_from_numpy(ref, cfg, device="cpu")
    fparams = TT.transformer_from_numpy(ref, cfg, device="cpu", dist=fdist)
    estep = make_train_step(cfg, edist, OPT, mb)
    fstep = make_train_step(cfg, fdist, OPT, mb)
    eo, fo = adamw_init(eparams), adamw_init(fparams)
    steps = []
    for _ in range(STEPS):
        fdist.comm.reset()
        eparams, eo, em = estep(eparams, eo, batch)
        fparams, fo, fm = fstep(fparams, fo, batch)
        mine = TT.shard_experts(eparams, cfg, fdist)
        pe, pf = _leaves(mine), _leaves(fparams)
        steps.append({
            "loss": [float(em["loss"]), float(fm["loss"])],
            "grad_norm": [float(em["grad_norm"]), float(fm["grad_norm"])],
            "loss_equal": bool(torch.equal(em["loss"], fm["loss"])),
            "norm_equal": bool(torch.equal(em["grad_norm"],
                                           fm["grad_norm"])),
            "params_equal": all(torch.equal(a, b) for a, b in zip(pe, pf)),
            "param_max_err": max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(pe, pf)),
            "fold_bytes": fdist.comm.transport()["fold_bytes"],
            "bwd_exchanges": fdist.comm.transport()["bwd_exchanges"]})
    return {"steps": steps, "counts_rows": fdist.counts_rows,
            "experts_held": int(TM.local_experts(
                fparams["layers"]["moe"]["w1"], cfg, fdist, dim=1).shape[1])
            if cfg.family == "moe" else None}


def main(out_dir, grid):
    shape = tuple(int(n) for n in grid.split("x"))
    initialize(timeout=90.0)
    topo = Topology.multiprocess(device="cpu", mesh=make_mesh(shape, AXES))
    fdist = make_context(topo)
    edist = make_context(make_mesh(shape, AXES))
    arrays = dict(np.load(os.path.join(out_dir, "cases.npz")))
    res = {"span": list(fdist.span),
           "groups": fdist.group_processes(),
           "cases": {name: run_case(name, arrays, fdist, edist)
                     for name in CASES}}
    with open(os.path.join(out_dir, f"rank{topo.process_index}.json"),
              "w") as f:
        json.dump(res, f)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1], sys.argv[2])
