"""One worker of the CPU fleets that ``test_torch_process_mesh`` launches
(``launch_local(n, w, device="cpu", argv=[python, this, out, "DxM"])``):
a (data D, model M) grid over n processes of w ranks each.

Every process runs the grid's collectives and the expert-parallel LM on
its span of the ranks (``Topology.multiprocess(mesh=...)``) and writes
what it saw to ``<out>/rank<i>.json`` (outputs to ``<out>/rank<i>.npz``):
the fleet ``MeshComm``'s all_to_all / pmax / psum and their gradients
against ``MeshComm``'s on the stacked tensor, ``_moe_ep`` at
olmoe-smoke width (shiro and classic dispatch) against the emulated run
of the same grid, and the forward, ``decode_step`` (unsharded and
sequence-sharded) and the batcher's tokens against the emulated run's.
It imports no JAX; the test compares the outputs with the JAX package.
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
from repro_torch.serving import scheduler as TS

AXES = ("data", "model")
BATCH, SEQ, SMAX = 4, 7, 16
LENGTHS, NEW = [3, 6, 4, 5, 2, 7], 4


def _gen(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def collectives(shape, fdist, edist):
    """all_to_all (activations and meta), pmax and psum on the fleet
    against MeshComm on the stacked tensor, values and input grads."""
    D, M = shape
    lo, hi = fdist.span
    lay = fdist.layout
    cases = {
        "all_to_all": (lambda c, x: c.all_to_all(x, lay, "model"),
                       (M, 3, 5)),
        "all_to_all_meta": (lambda c, x: c.all_to_all(x, lay, "model",
                                                      meta=True), (M, 2, 5)),
        "pmax": (lambda c, x: c.pmax(x, lay, "model"), (3, 5)),
        "psum": (lambda c, x: c.psum(x, lay, "model"), (3, 5)),
    }
    res = {}
    for i, (name, (op, rest)) in enumerate(cases.items()):
        fdist.comm.reset()
        edist.comm.reset()
        x = torch.from_numpy(_gen(40 + i, (D, M) + rest))
        xe = x.clone().requires_grad_()
        want = op(edist.comm, xe)
        r = torch.from_numpy(_gen(60 + i, tuple(want.shape)))
        (want * r).sum().backward()
        xf = x.reshape((D * M,) + rest)[lo:hi].clone().requires_grad_()
        got = op(fdist.comm, xf)
        flat = lambda t: t.reshape((D * M,) + tuple(t.shape[2:]))  # noqa
        (got * flat(r)[lo:hi]).sum().backward()
        res[name] = {
            "equal": bool(torch.equal(got, flat(want.detach())[lo:hi])),
            "grad_equal": bool(torch.equal(xf.grad, flat(xe.grad)[lo:hi])),
            "rows": [fdist.comm.fleet_rows(ax, direction=d)
                     for ax in ("model", "model:meta")
                     for d in ("fwd", "bwd")],
            "local_rows": [edist.comm.rows(ax, d)
                           for ax in ("model", "model:meta")
                           for d in ("fwd", "bwd")],
            "crossing": [fdist.comm.fleet_rows(None, crossing=True,
                                               direction=d)
                         for d in ("fwd", "bwd")]}
    return res


def moe_ep(cfg, fdist, edist, arrays):
    """``_moe_ep`` on the fleet (experts of its model ranks only) against
    the emulated grid's, every model rank's output, shiro and classic."""
    res = {}
    gen = torch.Generator().manual_seed(0)
    p = TM.init_moe_params(gen, cfg, torch.float32, device="cpu")
    x = torch.from_numpy(_gen(1, (BATCH, 8, cfg.d_model)))
    ng, nm, g_lo, m_lo = fdist.local_grid
    lo, hi = fdist.local_rows(BATCH)
    mine = {k: (TM.local_experts(v, cfg, fdist) if k != "router" else v)
            for k, v in p.items()}
    arrays.update({f"moe/{k}": v.numpy() for k, v in p.items()})
    arrays["moe/x"] = x.numpy()
    for shiro in (True, False):
        edist.comm.reset()
        fdist.comm.reset()
        with TM.record_dispatch() as erec:
            want = TM._moe_ep(p, x, cfg, edist, shiro, all_ranks=True)
        with TM.record_dispatch() as frec:
            got = TM._moe_ep(mine, fdist.local_batch(x), cfg, fdist, shiro,
                             all_ranks=True)
        key = "shiro" if shiro else "classic"
        arrays[f"moe/{key}"] = got[0].numpy()
        res[key] = {
            "equal": bool(torch.equal(got, want[m_lo:m_lo + nm, lo:hi])),
            "ranks_equal": all(torch.equal(got[m], got[0])
                               for m in range(nm)),
            "rows": [fdist.comm.fleet_rows(ax) for ax in
                     ("model", "model:meta")],
            "local_rows": [edist.comm.rows(ax) for ax in
                           ("model", "model:meta")],
            "crossing": fdist.comm.fleet_rows(None, crossing=True),
            "cap": frec[0]["cap"],
            "sent": [int(r["sent"]) for r in frec],
            "dropped": [int(r["dropped"]) for r in frec],
            "emulated_sent": [int(r["sent"]) for r in erec],
            "emulated_dropped": [int(r["dropped"]) for r in erec]}
    res["rows_block"] = [lo, hi]
    return res


def lm(fdist, edist, arrays):
    """The olmoe-smoke LM on the fleet against the emulated grid: the
    forward, teacher-forced decode steps (unsharded and sequence-sharded)
    and the batcher."""
    res = {}
    base = get_smoke_config("olmoe-1b-7b")
    toks = np.random.default_rng(0).integers(
        0, base.vocab_size, (BATCH, SEQ)).astype(np.int32)
    lo, hi = fdist.local_rows(BATCH)
    for seq_shard in (False, True):
        cfg = dataclasses.replace(base, kv_seq_shard=seq_shard)
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        mine = TT.shard_experts(params, cfg, fdist)
        key = "seqshard" if seq_shard else "unsharded"
        want = TT.forward(params, cfg, edist, {"tokens": torch.from_numpy(
            toks)})
        got = TT.forward(mine, cfg, fdist, {"tokens": torch.from_numpy(
            toks)})
        ec = TT.init_decode_cache(cfg, BATCH, SMAX, device="cpu")
        fc = TT.init_decode_cache(cfg, BATCH, SMAX, device="cpu")
        steps = []
        for j in range(SEQ):
            t = torch.from_numpy(toks[:, j:j + 1])
            le, ec = TT.decode_step(params, cfg, edist, t, ec)
            lf, fc = TT.decode_step(mine, cfg, fdist, t, fc)
            steps.append({
                "equal": bool(torch.equal(lf, le[lo:hi])),
                "max_err": float((lf - le[lo:hi]).abs().max()),
                "tokens_equal": bool(torch.equal(
                    lf[:, -1].argmax(-1), le[lo:hi, -1].argmax(-1)))})
            arrays[f"lm/{key}/step{j}"] = lf.numpy()
        arrays[f"lm/{key}/forward"] = got.numpy()
        res[key] = {
            "forward_equal": bool(torch.equal(got, want[lo:hi])),
            "forward_max_err": float((got - want[lo:hi]).abs().max()),
            "forward_tokens_equal": bool(torch.equal(
                got.argmax(-1), want[lo:hi].argmax(-1))),
            "steps": steps,
            "cache_equal": bool(torch.equal(fc.k[:, lo:hi], ec.k[:, lo:hi])),
            "batcher": batcher(cfg, params, mine, fdist, edist)}
    res["rows_block"] = [lo, hi]
    return res


def batcher(cfg, params, mine, fdist, edist):
    def requests():
        rng = np.random.default_rng(1)
        return [TS.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=NEW)
            for i, n in enumerate(LENGTHS)]

    out = {}
    for name, p, dist in (("fleet", mine, fdist), ("emulated", params,
                                                   edist)):
        reqs = requests()
        b = TS.ContinuousBatcher(cfg, p, 4, SMAX, dist=dist)
        for r in reqs:
            b.submit(r)
        stats = b.run()
        out[name] = {"outputs": [r.output for r in reqs],
                     "stats": [stats.served, stats.generated_tokens,
                               stats.decode_steps]}
    return out


def main(out_dir, grid):
    shape = tuple(int(n) for n in grid.split("x"))
    initialize(timeout=90.0)
    topo = Topology.multiprocess(device="cpu", mesh=make_mesh(shape, AXES))
    fdist = make_context(topo)
    edist = make_context(make_mesh(shape, AXES))
    arrays = {}
    res = {"span": list(fdist.span), "lead": list(fdist.lead),
           "local_grid": list(fdist.local_grid),
           "tiers": list(topo.tiers),
           "collectives": collectives(shape, fdist, edist)}
    cfg = get_smoke_config("olmoe-1b-7b")
    res["moe"] = moe_ep(cfg, fdist, edist, arrays)
    res["lm"] = lm(fdist, edist, arrays)
    with open(os.path.join(out_dir, f"rank{topo.process_index}.json"),
              "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out_dir, f"rank{topo.process_index}.npz"),
             **arrays)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1], sys.argv[2])
