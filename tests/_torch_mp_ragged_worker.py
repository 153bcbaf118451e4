"""One worker of the CPU fleets that ``test_torch_ragged_grid`` launches
(``launch_local(n, w, device="cpu", argv=[python, this, dir, grid,
source])``): the expert-parallel LM on a grid whose process spans cut
across model groups, or on a (pod, data, model) grid, over n processes
of w ranks each (``Topology.multiprocess(mesh=...)``).

``grid`` names the layout: "3x2" (data 3, model 2), "3x4" (data 3,
model 4) or "2x2x2" (pod 2, data 2, model 2). Every process runs, at
olmoe-smoke width, against the emulated grid of the same shape in the
same process:

* its span: the (group, model rank) pairs, the groups it touches, the
  model ranks whose experts it holds (not always a run), the groups it
  counts;
* ``_moe_ep`` (shiro and classic dispatch) on every rank it runs,
  ``torch.equal`` rank by rank, with the dispatch counts;
* the forward, ``decode_step`` (unsharded and sequence-sharded) and the
  batcher;
* ``STEPS`` ``make_train_step`` steps of the EP model at capacity 8.0
  (loss, grad norm, every parameter it holds);
* on "3x2" with a checkpoint directory: ``Trainer.fit`` to ``FIT_STEPS``
  (one checkpoint), its keys, shapes and dtypes against a one-device
  ``Trainer``'s, and its restores onto one device and the emulated
  (1, 8) grid; on "3x4" given that checkpoint (``source``): its restore
  onto this fleet against the emulated (3, 4) grid's.

Writes ``<dir>/<grid>.rank<i>.json``. It imports no JAX.
"""
import dataclasses
import json
import os
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
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig, _leaves, _map, adamw_init
from repro_torch.serving import scheduler as TS
from repro_torch.train.steps import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

GRIDS = {"3x2": ((3, 2), ("data", "model")),
         "3x4": ((3, 4), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SEQ, SMAX, NEW = 7, 16, 4
LENGTHS = [3, 6, 4, 5, 2, 7]
STEPS, FIT_STEPS, FIT_SEQ = 3, 2, 16
OPT = AdamWConfig(lr=1e-3)


def batch_size(grid):
    """Two rows a batch group."""
    shape = GRIDS[grid][0]
    return 2 * int(np.prod(shape[:-1]))


def _gen(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def ep_config():
    return dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                               capacity_factor=8.0)


def span_info(fdist):
    s = fdist.local_span
    return {"span": list(fdist.span), "ranks": [list(r) for r in s.ranks],
            "groups": list(s.groups), "models": list(s.models),
            "counted": list(fdist.counted_groups),
            "counts_rows": fdist.counts_rows, "is_block": s.is_block,
            "group_processes": fdist.group_processes(),
            "local_rows": list(fdist.local_rows(12))}


def moe_ep(cfg, fdist, edist, B):
    """``_moe_ep`` on every rank this process runs against the emulated
    grid's, rank by rank."""
    gen = torch.Generator().manual_seed(0)
    p = TM.init_moe_params(gen, cfg, torch.float32, device="cpu")
    x = torch.from_numpy(_gen(1, (B, 8, cfg.d_model)))
    mine = {k: (TM.local_experts(v, cfg, fdist) if k != "router" else v)
            for k, v in p.items()}
    span, per = fdist.local_span, B // fdist.batch_size_divisor
    g0 = span.groups[0]
    res = {"experts_held": int(mine["w1"].shape[0])}
    for shiro in (True, False):
        with TM.record_dispatch() as erec:
            want = TM._moe_ep(p, x, cfg, edist, shiro, all_ranks=True)
        with TM.record_dispatch() as frec:
            got = TM._moe_ep(mine, fdist.local_batch(x), cfg, fdist, shiro,
                             all_ranks=True)
            y = TM._moe_ep(mine, fdist.local_batch(x), cfg, fdist, shiro)
        if span.is_block:
            nm, m0 = len(span.models), span.models[0]
            lo, hi = fdist.local_rows(B)
            ranks_equal = torch.equal(got, want[m0:m0 + nm, lo:hi])
        else:
            ranks_equal = all(
                torch.equal(got[r], want[m, g * per:(g + 1) * per])
                for r, (g, m) in enumerate(span.ranks))
        lo, hi = fdist.local_rows(B)
        # each group's output from the first rank of it held here
        firsts = torch.cat([want[span.ranks[r0][1], g * per:(g + 1) * per]
                            for g, r0, _, _ in span.runs()])
        key = "shiro" if shiro else "classic"
        res[key] = {"ranks_equal": bool(ranks_equal),
                    "y_equal": bool(torch.equal(y, firsts)),
                    "rows_block": [lo, hi], "g0": g0,
                    "sent": [int(r["sent"]) for r in frec[:1]],
                    "dropped": [int(r["dropped"]) for r in frec[:1]],
                    "emulated_sent": [int(r["sent"]) for r in erec],
                    "emulated_dropped": [int(r["dropped"]) for r in erec]}
    return res


def lm(fdist, edist, B):
    """The olmoe-smoke LM on the fleet against the emulated grid: the
    forward, teacher-forced decode steps (unsharded and sequence-sharded)
    and the batcher."""
    res = {}
    base = get_smoke_config("olmoe-1b-7b")
    toks = np.random.default_rng(0).integers(
        0, base.vocab_size, (B, SEQ)).astype(np.int32)
    lo, hi = fdist.local_rows(B)
    for seq_shard in (False, True):
        cfg = dataclasses.replace(base, kv_seq_shard=seq_shard)
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        mine = TT.shard_experts(params, cfg, fdist)
        want = TT.forward(params, cfg, edist, {"tokens": torch.from_numpy(
            toks)})
        got = TT.forward(mine, cfg, fdist, {"tokens": torch.from_numpy(
            toks)})
        ec = TT.init_decode_cache(cfg, B, SMAX, device="cpu")
        fc = TT.init_decode_cache(cfg, B, SMAX, device="cpu")
        steps = []
        for j in range(SEQ):
            t = torch.from_numpy(toks[:, j:j + 1])
            le, ec = TT.decode_step(params, cfg, edist, t, ec)
            lf, fc = TT.decode_step(mine, cfg, fdist, t, fc)
            steps.append({"equal": bool(torch.equal(lf, le[lo:hi])),
                          "max_err": float((lf - le[lo:hi]).abs().max())})
        res["seqshard" if seq_shard else "unsharded"] = {
            "forward_equal": bool(torch.equal(got, want[lo:hi])),
            "forward_max_err": float((got - want[lo:hi]).abs().max()),
            "steps": steps,
            "cache_equal": bool(torch.equal(fc.k[:, lo:hi], ec.k[:, lo:hi])
                                and torch.equal(fc.v[:, lo:hi],
                                                ec.v[:, lo:hi])),
            "batcher": batcher(cfg, params, mine, fdist, edist, B)}
    return res


def batcher(cfg, params, mine, fdist, edist, B):
    def requests():
        rng = np.random.default_rng(1)
        return [TS.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=NEW)
            for i, n in enumerate(LENGTHS)]

    out = {}
    for name, p, dist in (("fleet", mine, fdist), ("emulated", params,
                                                   edist)):
        reqs = requests()
        b = TS.ContinuousBatcher(cfg, p, B, SMAX, dist=dist)
        for r in reqs:
            b.submit(r)
        stats = b.run()
        out[name] = {"outputs": [r.output for r in reqs],
                     "stats": [stats.served, stats.generated_tokens,
                               stats.decode_steps]}
    return out


def train(fdist, edist, B):
    """``STEPS`` EP train steps on the fleet and on the emulated grid."""
    cfg = ep_config()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 16)).astype(np.int32)
    batch = {"tokens": toks}
    eparams = TT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    fparams = TT.shard_experts(_map(torch.clone, eparams), cfg, fdist)
    estep = make_train_step(cfg, edist, OPT)
    fstep = make_train_step(cfg, fdist, OPT)
    eo, fo = adamw_init(eparams), adamw_init(fparams)
    steps = []
    for _ in range(STEPS):
        fdist.comm.reset()
        eparams, eo, em = estep(eparams, eo, batch)
        fparams, fo, fm = fstep(fparams, fo, batch)
        pe = _leaves(TT.shard_experts(eparams, cfg, fdist))
        pf = _leaves(fparams)
        steps.append({
            "loss": [float(em["loss"]), float(fm["loss"])],
            "grad_norm": [float(em["grad_norm"]), float(fm["grad_norm"])],
            "shapes_equal": all(a.shape == b.shape for a, b in zip(pe, pf)),
            "param_max_err": max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(pe, pf)),
            "fold_bytes": fdist.comm.transport()["fold_bytes"],
            "bwd_exchanges": fdist.comm.transport()["bwd_exchanges"]})
    return steps


def _trainer(ckpt_dir, dist):
    return Trainer(ep_config(), OPT, TrainerConfig(
        total_steps=FIT_STEPS, ckpt_every=FIT_STEPS, ckpt_dir=ckpt_dir,
        log_every=1, straggler_warmup=100), dist)


def _source(B):
    return SyntheticLM(ep_config().vocab_size, FIT_SEQ, B, seed=0)


def _meta(step_dir):
    with open(os.path.join(step_dir, "metadata.json")) as f:
        return json.load(f)["keys"]


def _like(dist):
    cfg = ep_config()
    p = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    if dist is not None and dist.is_fleet:
        p = TT.shard_experts(p, cfg, dist)
    return {"params": p, "opt": adamw_init(p)}


def _restored(step_dir, dist):
    """The checkpoint restored onto ``dist``'s grid (one device: None)."""
    root, name = os.path.split(step_dir)
    like = _like(dist)
    shards = dist.leaf_splits(like, ep_config()) \
        if dist is not None and dist.is_fleet else None
    return CheckpointManager(root, dist=dist).restore(
        int(name.split("_")[1]), like, shards=shards)


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def fit(fdist, edist, B, out_dir, grid):
    """``Trainer.fit`` on the fleet and its twin, then the restores."""
    cfg = ep_config()
    me = fdist.comm.proc
    base = os.path.join(out_dir, grid)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tf = _trainer(os.path.join(base, "fleet"), fdist)
    fo = tf.fit(TT.shard_experts(_map(torch.clone, params), cfg, fdist),
                _source(B), resume=False)
    te = _trainer(os.path.join(base, f"twin{me}"), edist)
    eo = te.fit(_map(torch.clone, params), _source(B), resume=False)
    step = os.path.join(base, "fleet", f"step_{FIT_STEPS:08d}")
    res = {"history": [[h["loss"] for h in eo["history"]],
                       [h["loss"] for h in fo["history"]]],
           "writes": sum(1 for r in tf.ckpt.timings
                         if r["op"] == "save" and r["bytes"]),
           "step_dir": step}
    fdist.comm.barrier()
    if me == 0:
        one = os.path.join(base, "one")
        _trainer(one, None).fit(_map(torch.clone, params), _source(B),
                                resume=False)
        keys = _meta(step)
        twin = np.load(os.path.join(base, f"twin{me}",
                                    f"step_{FIT_STEPS:08d}", "arrays.npz"))
        mine = np.load(os.path.join(step, "arrays.npz"))
        res.update(
            keys=keys,
            one_device_keys=_meta(os.path.join(one,
                                               f"step_{FIT_STEPS:08d}")),
            twin_max_err=max(float(np.abs(mine[k].astype(np.float64)
                                          - twin[k]).max()) for k in keys))
        whole = _restored(step, None)
        res["restore_one_device"] = _equal(whole, _restored(
            step, make_context(make_mesh((1, 8), ("data", "model")))))
        res["restore_matches_file"] = all(
            np.array_equal(t.numpy(), mine[k]) for k, t in zip(
                sorted(keys), [dict(_flat(whole))[k] for k in sorted(keys)]))
    return res


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def restore(fdist, edist, source):
    """A checkpoint of another grid restored onto this fleet, against
    the emulated grid's restore cut to this process's model ranks."""
    cfg = ep_config()
    got = _restored(source, fdist)
    want = _restored(source, edist)
    cut = {"params": TT.shard_experts(want["params"], cfg, fdist),
           "opt": {k: TT.shard_experts(want["opt"][k], cfg, fdist)
                   for k in ("m", "v")} | {"step": want["opt"]["step"]}}
    return {"equal": _equal(got, cut),
            "experts": int(got["params"]["layers"]["moe"]["w1"].shape[1])}


def main(out_dir, grid, source=None):
    shape, axes = GRIDS[grid]
    initialize(timeout=90.0)
    topo = Topology.multiprocess(device="cpu", mesh=make_mesh(shape, axes))
    fdist = make_context(topo)
    edist = make_context(make_mesh(shape, axes))
    B = batch_size(grid)
    res = {"info": span_info(fdist),
           "moe": moe_ep(ep_config(), fdist, edist, B),
           "lm": lm(fdist, edist, B),
           "train": train(fdist, edist, B)}
    if grid == "3x2":
        res["fit"] = fit(fdist, edist, B, out_dir, grid)
    if source:
        res["restore"] = restore(fdist, edist, source)
    with open(os.path.join(out_dir, f"{grid}.rank{topo.process_index}.json"),
              "w") as f:
        json.dump(res, f)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(*sys.argv[1:4])
