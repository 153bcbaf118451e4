"""The expert-parallel LM on fleet grids whose process spans cut across
model groups, and on a (pod, data, model) grid across processes (CPU,
gloo).

Module-scoped fleets run ``tests/_torch_mp_ragged_worker.py`` over
``Topology.multiprocess(mesh=...)``:

* (data 3, model 2) over 2 processes × 3 ranks: process 0 runs group 0
  whole and model rank 0 of group 1, process 1 the rest;
* (data 3, model 4) over 4 × 3: processes 1 and 2 hold the experts of
  model ranks {0, 1, 3} and {0, 2, 3};
* (pod 2, data 2, model 2) over 2 × 4 (one pod a process) and 4 × 2.

On each, ``_moe_ep`` (shiro and classic) on every rank, the forward,
``decode_step`` (unsharded and sequence-sharded) and the batcher are
``torch.equal`` to the emulated grid of the same shape; three EP train
steps are within ``test_torch_lm_fleet_train``'s ``TWIN_TOL`` (no data
group spans the fleet). ``Trainer.fit`` on the (3, 2) fleet writes one
checkpoint with a one-device run's keys, shapes and dtypes; it restores
onto one device, the emulated (1, 8) grid and the (3, 4) fleet (whose
launch takes it), each ``torch.equal`` to the emulated restore. The
emulated (3, 2) EP forward is held to the reference's ``shard_map`` on a
(3, 2) mesh of six host devices within 2e-4.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_ragged_worker as W  # noqa: E402
from test_torch_lm_fleet_train import TWIN_TOL  # noqa: E402

FLEET_TIMEOUT = 240.0
# name -> (processes, ranks per process, grid); the first three launch
# together, then (3, 4) restores the (3, 2) fleet's checkpoint
FLEETS = {"data3_model2-2x3": (2, 3, "3x2"),
          "pod2_data2_model2-2x4": (2, 4, "2x2x2"),
          "pod2_data2_model2-4x2": (4, 2, "2x2x2"),
          "data3_model4-4x3": (4, 3, "3x4")}
TOL = 2e-4


def _launch(out, name, source=None):
    from repro_torch.launch.multiprocess import launch_local

    nproc, local, grid = FLEETS[name]
    sub = out / name
    sub.mkdir()
    rc = launch_local(nproc, local, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=[sys.executable,
                            str(HERE / "_torch_mp_ragged_worker.py"),
                            str(sub), grid] + ([source] if source else []))
    assert rc == 0, f"the {name} fleet failed (exit {rc})"
    return [json.loads((sub / f"{grid}.rank{r}.json").read_text())
            for r in range(nproc)]


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    out = tmp_path_factory.mktemp("ragged")
    names = list(FLEETS)[:3]
    with ThreadPoolExecutor(len(names)) as pool:
        runs = {n: pool.submit(_launch, out, n) for n in names}
        return out, {n: run.result() for n, run in runs.items()}


@pytest.fixture(scope="module")
def fleets(first):
    out, res = first
    source = res["data3_model2-2x3"][0]["fit"]["step_dir"]
    return {**res, "data3_model4-4x3": _launch(out, "data3_model4-4x3",
                                               source)}


# (group, model rank) pairs of each process, and its model ranks
SPANS = {
    "data3_model2-2x3": [([(0, 0), (0, 1), (1, 0)], [0, 1], [0, 1]),
                         ([(1, 1), (2, 0), (2, 1)], [0, 1], [2])],
    "data3_model4-4x3": [([(0, 0), (0, 1), (0, 2)], [0, 1, 2], [0]),
                         ([(0, 3), (1, 0), (1, 1)], [0, 1, 3], [1]),
                         ([(1, 2), (1, 3), (2, 0)], [0, 2, 3], [2]),
                         ([(2, 1), (2, 2), (2, 3)], [1, 2, 3], [])],
}


@pytest.mark.parametrize("name", list(FLEETS))
def test_spans(fleets, name):
    res = fleets[name]
    nproc, local, grid = FLEETS[name]
    shape = W.GRIDS[grid][0]
    M, G = shape[-1], int(np.prod(shape[:-1]))
    counted = []
    for q, r in enumerate(res):
        info = r["info"]
        assert info["span"] == [q * local, (q + 1) * local]
        ranks = [list(divmod(i, M)) for i in range(q * local,
                                                   (q + 1) * local)]
        assert info["ranks"] == ranks
        assert info["models"] == sorted({m for _, m in ranks})
        assert info["counted"] == [g for g, m in ranks if m == 0]
        assert info["counts_rows"] == bool(info["counted"])
        counted += info["counted"]
        if name in SPANS:
            want = SPANS[name][q]
            assert ([tuple(x) for x in info["ranks"]], info["models"],
                    info["counted"]) == want
        per = 12 // G  # local_rows(12)
        assert info["local_rows"] == [info["groups"][0] * per,
                                      (info["groups"][-1] + 1) * per]
    assert sorted(counted) == list(range(G))  # each group counted once
    holders = [[q for q, r in enumerate(res) if g in r["info"]["groups"]]
               for g in range(G)]
    assert all(r["info"]["group_processes"] == holders for r in res)


@pytest.mark.parametrize("dispatch", ["shiro", "classic"])
@pytest.mark.parametrize("name", list(FLEETS))
def test_moe_ep_equals_emulated(fleets, name, dispatch):
    res = fleets[name]
    cfg = W.ep_config()
    M = W.GRIDS[FLEETS[name][2]][0][-1]
    for r in res:
        got = r["moe"][dispatch]
        assert got["ranks_equal"], f"{name} span {r['info']['span']}"
        assert got["y_equal"], f"{name} span {r['info']['span']}"
        assert r["moe"]["experts_held"] == \
            len(r["info"]["models"]) * cfg.n_experts // M
    for key in ("sent", "dropped"):  # counted once per data group
        total = np.sum([r["moe"][dispatch][key] for r in res], axis=0)
        assert list(total) == res[0]["moe"][dispatch][f"emulated_{key}"]


@pytest.mark.parametrize("mode", ["unsharded", "seqshard"])
@pytest.mark.parametrize("name", list(FLEETS))
def test_forward_decode_and_batcher_equal_emulated(fleets, name, mode):
    res = fleets[name]
    first = res[0]["lm"][mode]["batcher"]["fleet"]
    for r in res:
        got = r["lm"][mode]
        where = f"{name} {mode} span {r['info']['span']}"
        assert got["forward_equal"], where
        for j, step in enumerate(got["steps"]):
            assert step["equal"], f"{where} step {j}"
        assert got["cache_equal"], where
        b = got["batcher"]
        assert b["fleet"] == b["emulated"] == first, where
    assert sum(len(o) for o in first["outputs"]) == len(W.LENGTHS) * W.NEW


@pytest.mark.parametrize("name", list(FLEETS))
def test_train_steps_within_twin_tol(fleets, name):
    res = fleets[name]
    for r in res:
        assert len(r["train"]) == W.STEPS
        for i, step in enumerate(r["train"]):
            where = f"{name} span {r['info']['span']} step {i + 1}"
            e_loss, f_loss = step["loss"]
            e_norm, f_norm = step["grad_norm"]
            assert step["shapes_equal"], where
            assert abs(f_loss - e_loss) <= TWIN_TOL["loss"] * abs(e_loss)
            assert abs(f_norm - e_norm) <= TWIN_TOL["grad_norm"] * e_norm
            assert step["param_max_err"] <= TWIN_TOL["param"], where
            assert step["fold_bytes"] > 0, where
    for i in range(W.STEPS):  # the same global loss and norm everywhere
        vals = {(r["train"][i]["loss"][1], r["train"][i]["grad_norm"][1])
                for r in res}
        assert len(vals) == 1, f"{name} step {i + 1}: {vals}"


def test_fit_checkpoint_and_restores(fleets):
    runs = [r["fit"] for r in fleets["data3_model2-2x3"]]
    lead = runs[0]
    assert [r["writes"] for r in runs] == [1, 0]  # one writer
    assert lead["keys"] == lead["one_device_keys"]  # shapes and dtypes too
    assert lead["twin_max_err"] <= TWIN_TOL["param"]
    for r in runs:
        e, f = r["history"]
        assert len(f) == W.FIT_STEPS
        assert all(abs(a - b) <= TWIN_TOL["loss"] * abs(a)
                   for a, b in zip(e, f))
    assert lead["restore_one_device"] and lead["restore_matches_file"]
    for r in fleets["data3_model4-4x3"]:
        got = r["restore"]
        assert got["equal"], r["info"]["span"]
        assert got["experts"] == len(r["info"]["models"]) * \
            W.ep_config().n_experts // 4


@pytest.mark.parametrize("dispatch", ["shiro", "classic"])
def test_emulated_ragged_ep_matches_reference(dispatch):
    """The emulated (data 3, model 2) grid's EP forward (the twin every
    ragged fleet above equals) against the reference's ``shard_map`` on
    a (3, 2) mesh of the first six host devices."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config as jax_smoke
    from repro.distributed.context import DistContext as RDist
    from repro.models import moe as RM
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as TM

    cfg = dataclasses.replace(W.ep_config(),
                              shiro_dispatch=dispatch == "shiro")
    p = TM.init_moe_params(torch.Generator().manual_seed(0), cfg,
                           torch.float32, device="cpu")
    x = torch.from_numpy(W._gen(1, (6, 8, cfg.d_model)))
    got = TM.moe_layer(p, x, cfg, make_context(make_mesh((3, 2),
                                                         ("data", "model"))))
    mesh = Mesh(np.array(jax.devices()[:6]).reshape(3, 2),
                ("data", "model"))
    rdist = RDist(mesh=mesh, batch_axes=("data",), model_axis="model")
    rcfg = dataclasses.replace(jax_smoke("olmoe-1b-7b"),
                               capacity_factor=cfg.capacity_factor,
                               shiro_dispatch=cfg.shiro_dispatch)
    rp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want = np.asarray(jax.jit(lambda p, x: RM.moe_layer(p, x, rcfg, rdist))(
        rp, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
