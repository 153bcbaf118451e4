"""One worker of the CPU fleets that ``test_torch_trainer_fleet`` launches
(``launch_local(n, w, device="cpu", argv=[python, this, dir, layout,
"DxM", source])``): ``Trainer`` on a (data D, model M) grid over n
processes of w ranks each.

``<dir>/cases.npz`` holds each case's reference initial parameters
(flattened key paths). For each case every process runs, under
``<dir>/<layout>/<case>/``:

* ``fleet``: ``Trainer.fit`` for ``STEPS`` steps with a checkpoint every
  ``EVERY`` (the lead writes), each step's loss, grad norm and parameters
  kept; ``twin<i>``: the same on the emulated grid of the same shape in
  this process, held step by step and checkpoint by checkpoint;
* ``one`` (the lead): a one-device ``Trainer`` to step ``EVERY``, whose
  checkpoint's keys the test holds to the fleet's and the reference's;
* resume: the lead deletes the last checkpoint and a second ``fit``
  resumes from the one before;
* restore across grids, each continued to ``STEPS`` by a fleet
  ``Trainer`` and held to a plain run of the grid from the same
  checkpoint (``CheckpointManager.restore`` onto the whole tree, then
  ``make_train_step`` functional steps on the emulated grid): on (1, 8)
  the one-device checkpoint, and the fleet's own step-``EVERY`` one onto
  one device (the lead); on another grid the (1, 8) fleet's checkpoint
  (``source``, from the launch before);
* a restore whose ``like`` has a wrong shape, on every process;
* ``preempt`` (the dense case), process 1 sends itself SIGTERM: with
  step 2's batch (``batch``: every process stops after that step), or in
  step 1's fold of the stop flag, before its value is gathered
  (``in_fold``) or once it is (``after_fold``): the request is folded
  with step 2, and every process stops after it.

Writes ``<dir>/<layout>.rank<i>.json``. It imports no JAX; the test
compares with the JAX package.
"""
import dataclasses
import json
import os
import shutil
import signal
import sys

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.context import make_context
from repro_torch.distributed.topology import Topology
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.multiprocess import initialize, shutdown
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig, _leaves, _map, adamw_init
from repro_torch.train.steps import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

AXES = ("data", "model")
STEPS, EVERY = 4, 2
BATCH, SEQ = 8, 16
# name -> (arch, config changes)
CASES = {
    "dense": ("qwen2-1.5b", dict(d_model=64, n_heads=4, n_kv_heads=2)),
    "ep": ("olmoe-1b-7b", dict(capacity_factor=8.0)),
}
OPT = AdamWConfig(lr=1e-3)
PREEMPT_CASE, PREEMPT_PROCESS = "dense", 1
# variant -> (where the signal is sent, the step it is sent at, the
# step every process stops after)
PREEMPTS = {"batch": ("batch", 2, 2),
            "in_fold": ("in_fold", 1, 2),
            "after_fold": ("after_fold", 1, 2)}


def case_config(name):
    arch, changes = CASES[name]
    return dataclasses.replace(get_smoke_config(arch), **changes)


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


def source(cfg):
    return SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)


class Preempt:
    """``source``'s batches; on process ``who`` a SIGTERM at step ``at``:
    ``where`` "batch" sends it when that step's batch is taken, "in_fold"
    inside that step's ``fold_host`` before the flag is gathered,
    "after_fold" right after it is (``comm.fold_host`` wrapped until
    ``restore``)."""

    def __init__(self, src, comm, who, where, at):
        self.src, self.comm, self.where, self.at = src, comm, where, at
        self.mine = comm.proc == who
        self.armed = False
        if self.mine and where != "batch":
            inner = comm.fold_host

            def fold_host(value):
                fire, self.armed = self.armed, False
                if fire and where == "in_fold":
                    os.kill(os.getpid(), signal.SIGTERM)
                out = inner(value)
                if fire and where == "after_fold":
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            comm.fold_host = fold_host

    def restore(self):
        self.comm.__dict__.pop("fold_host", None)

    def batch(self, step, shard=0, n_shards=1):
        if step == self.at and self.mine:
            if self.where == "batch":
                os.kill(os.getpid(), signal.SIGTERM)
            self.armed = True
        return self.src.batch(step, shard, n_shards)


def trainer(cfg, ckpt_dir, dist, steps=STEPS, every=EVERY, log=None):
    """A Trainer whose steps (loss, grad norm, a copy of the parameters
    after each) go to ``log``."""
    tr = Trainer(cfg, OPT, TrainerConfig(
        total_steps=steps, ckpt_every=every, ckpt_dir=ckpt_dir,
        log_every=1, straggler_warmup=100), dist)
    if log is not None:
        inner = tr.step_fn

        def step(params, state, batch):
            params, state, m = inner(params, state, batch)
            log.append((m["loss"].clone(), m["grad_norm"].clone(),
                        _map(torch.clone, params)))
            return params, state, m

        tr.step_fn = step
    return tr


def compare(fleet, emulated, cfg, fdist):
    """(every leaf torch.equal, largest abs difference): a fleet tree
    against the emulated tree's leaves this process holds."""
    mine = _leaves(TT.shard_experts(emulated, cfg, fdist))
    pairs = list(zip(_leaves(fleet), mine))
    return (all(a.shape == b.shape and torch.equal(a, b) for a, b in pairs),
            max(float((a.float() - b.float()).abs().max()) for a, b in pairs))


def npz_arrays(step_dir):
    """A checkpoint's arrays as float64 numpy, bfloat16 decoded."""
    with open(os.path.join(step_dir, "metadata.json")) as f:
        keys = json.load(f)["keys"]
    data = np.load(os.path.join(step_dir, "arrays.npz"))
    out = {}
    for k, info in keys.items():
        a = data[k]
        if info["dtype"] == "bfloat16":
            a = torch.from_numpy(a).view(torch.bfloat16).float().numpy()
        out[k] = (data[k], a.astype(np.float64))
    return keys, out


def step_dir(d, step):
    return os.path.join(d, f"step_{step:08d}")


def copy_step(src_step_dir, dst_root):
    """A fresh checkpoint directory holding one step: the caller's own
    copy to resume from (the resumed run writes beside it)."""
    shutil.rmtree(dst_root, ignore_errors=True)
    os.makedirs(dst_root)
    shutil.copytree(src_step_dir, os.path.join(
        dst_root, os.path.basename(src_step_dir)))


def plain_continuation(cfg, dist, ckpt_step_dir, like):
    """From a checkpoint to step STEPS the plain way: restored onto the
    whole tree (not in place), then functional train steps on ``dist``
    (None: one device)."""
    root, name = os.path.split(ckpt_step_dir)
    start = int(name.split("_")[1])
    state = CheckpointManager(root).restore(
        start, {"params": like, "opt": adamw_init(like)})
    p, o = state["params"], state["opt"]
    step = make_train_step(cfg, dist, OPT)
    src = source(cfg)
    for s in range(start, STEPS):
        p, o, _ = step(p, o, src.batch(s))
    return p


def run_case(name, arrays, fdist, edist, base, layout, me, from18):
    cfg = case_config(name)
    ref = unflatten(arrays, f"{name}/params")
    src = source(cfg)
    d = os.path.join(base, layout, name)
    fleet_dir, twin_dir = os.path.join(d, "fleet"), os.path.join(d,
                                                                 f"twin{me}")
    lead = fdist.comm.proc == 0
    barrier = fdist.comm.barrier

    def fleet_params():
        return TT.transformer_from_numpy(ref, cfg, device="cpu", dist=fdist)

    def whole_params():
        return TT.transformer_from_numpy(ref, cfg, device="cpu")

    res = {}
    # the fleet run and its emulated twin
    flog, elog = [], []
    given = fleet_params()
    tr = trainer(cfg, fleet_dir, fdist, log=flog)
    out = tr.fit(given, src, resume=False)
    res["consumed"] = out["params"] is given and all(
        a is b for a, b in zip(_leaves(out["params"]), _leaves(given)))
    final = _map(torch.clone, out["params"])
    te = trainer(cfg, twin_dir, edist, log=elog)
    te.fit(whole_params(), src, resume=False)
    steps = []
    for (fl, fn, fp), (el, en, ep) in zip(flog, elog):
        eq, err = compare(fp, ep, cfg, fdist)
        steps.append({"loss": [float(el), float(fl)],
                      "grad_norm": [float(en), float(fn)],
                      "loss_equal": bool(torch.equal(fl, el)),
                      "norm_equal": bool(torch.equal(fn, en)),
                      "params_equal": eq, "param_max_err": err})
    res["steps"] = steps
    res["last_step"] = out["last_step"]
    res["writes"] = sum(1 for r in tr.ckpt.timings
                        if r["op"] == "save" and r["bytes"])
    res["saves"] = sum(1 for r in tr.ckpt.timings if r["op"] == "save")
    barrier()
    if lead:
        res["all_steps"] = tr.ckpt.all_steps()
        res["tmp_left"] = sorted(n for n in os.listdir(fleet_dir)
                                 if n.endswith(".tmp"))
        cks = {}
        for s in res["all_steps"]:
            fkeys, fa = npz_arrays(step_dir(fleet_dir, s))
            ekeys, ea = npz_arrays(step_dir(twin_dir, s))
            cks[s] = {"keys_equal": fkeys == ekeys,
                      "equal": all(np.array_equal(fa[k][0], ea[k][0])
                                   for k in fa),
                      "max_err": max(float(np.abs(fa[k][1] - ea[k][1]).max())
                                     for k in fa)}
        res["checkpoints"] = cks
        res["keys"] = fkeys
        # a one-device Trainer's checkpoint of the same model
        one = os.path.join(d, "one")
        trainer(cfg, one, None, steps=EVERY).fit(whole_params(), src,
                                                 resume=False)
        res["one_device_keys"] = npz_arrays(step_dir(one, EVERY))[0]
    # resume after the last checkpoint is deleted
    if lead:
        shutil.rmtree(step_dir(fleet_dir, STEPS))
    barrier()
    tr2 = trainer(cfg, fleet_dir, fdist)
    again = tr2.fit(fleet_params(), src, resume=True)
    res["resume"] = {
        "first_step": again["history"][0]["step"],
        "equal": all(torch.equal(a, b) for a, b in
                     zip(_leaves(again["params"]), _leaves(final)))}
    # a wrong shape on restore raises on every process
    like = {"params": fleet_params(), "opt": None}
    like["opt"] = adamw_init(like["params"])
    like["params"]["embed"] = torch.zeros(
        like["params"]["embed"].shape[0] + 1,
        *like["params"]["embed"].shape[1:])
    try:
        tr2.ckpt.restore(EVERY, like, shards=fdist.leaf_splits(like, cfg))
        res["shape_mismatch"] = "restored"
    except ValueError as e:
        res["shape_mismatch"] = str(e)
    # restore across grids, continued to STEPS by a fleet Trainer
    cross = {}
    if layout == "data1_model8-2x4":
        targets = [("one_device->fleet", step_dir(os.path.join(d, "one"),
                                                  EVERY))]
    else:
        targets = [("data1_model8->fleet", os.path.join(
            from18, name, "fleet", f"step_{EVERY:08d}"))]
    for what, ckpt in targets:
        mine = os.path.join(d, what.replace(">", ""))
        if lead:
            copy_step(ckpt, mine)
        barrier()
        got = trainer(cfg, mine, fdist).fit(fleet_params(), src,
                                            resume=True)["params"]
        want = plain_continuation(cfg, edist, ckpt, whole_params())
        eq, err = compare(got, want, cfg, fdist)
        cross[what] = {"equal": eq, "max_err": err}
    if layout == "data1_model8-2x4" and lead:
        mine = os.path.join(d, "fleet_to_one")
        copy_step(step_dir(fleet_dir, EVERY), mine)
        got = trainer(cfg, mine, None).fit(whole_params(), src,
                                           resume=True)["params"]
        want = plain_continuation(cfg, None, step_dir(fleet_dir, EVERY),
                                  whole_params())
        cross["fleet->one_device"] = {
            "equal": all(torch.equal(a, b) for a, b in
                         zip(_leaves(got), _leaves(want))),
            "max_err": 0.0}
    res["cross"] = cross
    barrier()
    # SIGTERM on one process
    if name == PREEMPT_CASE:
        res["preempt"] = {}
        for variant, (where, at, _) in PREEMPTS.items():
            pre = os.path.join(d, f"preempt_{variant}")
            before = signal.getsignal(signal.SIGTERM)
            tp = trainer(cfg, pre, fdist, every=100)
            feed = Preempt(src, fdist.comm, PREEMPT_PROCESS, where, at)
            try:
                po = tp.fit(fleet_params(), feed, resume=False)
            finally:
                feed.restore()
            got = {"last_step": po["last_step"],
                   "handler_restored":
                       signal.getsignal(signal.SIGTERM) is before,
                   "saves": sum(1 for r in tp.ckpt.timings
                                if r["op"] == "save")}
            barrier()
            if lead:
                got["all_steps"] = tp.ckpt.all_steps()
                got["tmp_left"] = [n for n in os.listdir(pre)
                                   if n.endswith(".tmp")]
            res["preempt"][variant] = got
    return res


def main(out_dir, layout, grid, from18):
    shape = tuple(int(n) for n in grid.split("x"))
    initialize(timeout=90.0)
    topo = Topology.multiprocess(device="cpu", mesh=make_mesh(shape, AXES))
    fdist = make_context(topo)
    edist = make_context(make_mesh(shape, AXES))
    arrays = dict(np.load(os.path.join(out_dir, "cases.npz")))
    me = topo.process_index
    res = {"span": list(fdist.span),
           "cases": {name: run_case(name, arrays, fdist, edist, out_dir,
                                    layout, me, from18)
                     for name in CASES}}
    with open(os.path.join(out_dir, f"{layout}.rank{me}.json"), "w") as f:
        json.dump(res, f)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(*sys.argv[1:5])
