"""One worker of the CPU fleets that ``test_torch_families_fleet`` launches
(``launch_local(n, w, device="cpu", argv=[python, this, dir, "DxM"])``):
a (data D, model M) grid over n processes of w ranks each.

For each of the hybrid, encdec, vlm and audio smoke configs (weights from
``init_params`` with seed 0, the batch from numpy seed 1), every process
runs ``forward``, ``lm_loss``, one ``decode_step`` (the encdec's given
the encoder's output) and ``STEPS`` ``make_train_step`` steps on the
fleet (its rows) and the same on the emulated ``make_mesh`` grid of the
same shape in the same process, and writes to ``<dir>/rank<i>.json``
whether each result of its rows is ``torch.equal`` to the emulated one,
and the largest differences. It imports no JAX.
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
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init
from repro_torch.train.steps import make_train_step

AXES = ("data", "model")
STEPS = 2
ARCHS = ("zamba2-2.7b", "seamless-m4t-medium", "llava-next-mistral-7b",
         "audio")
B, S = 4, 8
OPT = AdamWConfig(lr=1e-3)


def case_config(arch):
    """The smoke config; "audio" is llava's with the audio family and
    frontend."""
    if arch == "audio":
        return dataclasses.replace(get_smoke_config("llava-next-mistral-7b"),
                                   family="audio", frontend="audio",
                                   name="audio-smoke")
    return get_smoke_config(arch)


def case_batch(cfg):
    """numpy tokens [B, S] and the family's frame / patch embeddings."""
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    emb = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)
                              ).astype(np.float32)
    if cfg.family == "encdec":
        out["enc_embeds"] = emb
    elif cfg.frontend is not None:
        out["prefix_embeds"] = emb
    return out


def compare(e, f):
    """(torch.equal, largest absolute difference) of two tensors."""
    return (bool(torch.equal(e, f)),
            float((e.float() - f.float()).abs().max()))


def run_case(arch, fdist, edist):
    cfg = case_config(arch)
    batch = case_batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lo, hi = fdist.local_rows(B)
    out = {"rows": [lo, hi]}
    with torch.no_grad():
        out["forward"] = compare(TT.forward(params, cfg, edist, tb)[lo:hi],
                                 TT.forward(params, cfg, fdist, tb))
        # each process's share of the loss, folded over the processes
        fl = fdist.comm.fold(TT.lm_loss(params, cfg, fdist, tb))
        out["loss"] = compare(TT.lm_loss(params, cfg, edist, tb), fl)
        enc = (TT._encode(params, cfg, edist, tb["enc_embeds"])
               if cfg.family == "encdec" else None)
        tok = tb["tokens"][:, :1]
        ec = TT.init_decode_cache(cfg, B, S + 4, device="cpu")
        fc = TT.init_decode_cache(cfg, B, S + 4, device="cpu")
        el, ec = TT.decode_step(params, cfg, edist, tok, ec, enc)
        fl, fc = TT.decode_step(params, cfg, fdist, tok, fc, enc)
        out["decode"] = compare(el[lo:hi], fl)
        caches = [f.name for f in dataclasses.fields(ec)
                  if isinstance(getattr(ec, f.name), torch.Tensor)]
        # the fleet's step wrote its rows of every cache, and no other
        out["cache"] = [compare(getattr(ec, n)[:, lo:hi],
                                getattr(fc, n)[:, lo:hi]) for n in caches]
        out["cache_rest_zero"] = all(
            not getattr(fc, n)[:, :lo].any() and
            not getattr(fc, n)[:, hi:].any() for n in caches)
    estep = make_train_step(cfg, edist, OPT)
    fstep = make_train_step(cfg, fdist, OPT)
    ep, fp = params, params
    eo, fo = adamw_init(ep), adamw_init(fp)
    steps = []
    for _ in range(STEPS):
        ep, eo, em = estep(ep, eo, batch)
        fp, fo, fm = fstep(fp, fo, batch)
        pe, pf = _leaves(ep), _leaves(fp)
        steps.append({
            "loss": [float(em["loss"]), float(fm["loss"])],
            "grad_norm": [float(em["grad_norm"]), float(fm["grad_norm"])],
            "loss_equal": bool(torch.equal(em["loss"], fm["loss"])),
            "norm_equal": bool(torch.equal(em["grad_norm"],
                                           fm["grad_norm"])),
            "params_equal": all(torch.equal(a, b) for a, b in zip(pe, pf)),
            "param_max_err": max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(pe, pf))})
    out["steps"] = steps
    return out


def main(out_dir, grid):
    shape = tuple(int(n) for n in grid.split("x"))
    initialize(timeout=90.0)
    topo = Topology.multiprocess(device="cpu", mesh=make_mesh(shape, AXES))
    fdist = make_context(topo)
    edist = make_context(make_mesh(shape, AXES))
    res = {"span": list(fdist.span),
           "cases": {arch: run_case(arch, fdist, edist) for arch in ARCHS}}
    with open(os.path.join(out_dir, f"rank{topo.process_index}.json"),
              "w") as f:
        json.dump(res, f)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1], sys.argv[2])
