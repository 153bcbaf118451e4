"""The LM train step on a fleet's grid (CPU, gloo).

One module-scoped fleet per layout (``launch_local(n, w, device="cpu")``)
runs ``tests/_torch_mp_lm_train_worker.py``, every case in one launch:

* (data 2, model 4) over 2 processes × 4 ranks: each data group inside
  one process, every expert in each;
* (data 2, model 4) over 4 × 2: a data group split over two processes;
* (data 1, model 8) over 2 × 4: the model axis crosses the processes and
  the experts are split.

Cases: the qwen2 smoke dense step at d_model 64, 4 heads, 2 kv heads
(``tests/test_system.py``'s), the olmoe smoke EP step at capacity 8.0,
and the dense step with ``microbatches=2``; three AdamW steps each, the
reference's initial weights carried over. Each step's loss, grad norm and
every parameter a process holds are held to the emulated grid of the same
shape: ``torch.equal`` where one data group spans the fleet (every sum in
the emulated run's order), within ``TWIN_TOL`` where several data groups
do (each group's weight gradients are products over its own rows,
added after; the emulated run's products run over every group's rows at
once). The first step's loss is within 5e-3 of the reference's unsharded
step, as ``test_system.py`` holds its sharded one.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_lm_train_worker as W  # noqa: E402

FLEET_TIMEOUT = 240.0
# (processes, ranks per process, grid)
FLEETS = {"data2_model4-2x4": (2, 4, (2, 4)),
          "data2_model4-4x2": (4, 2, (2, 4)),
          "data1_model8-2x4": (2, 4, (1, 8))}
EXACT = ("data1_model8-2x4",)  # one data group: the emulated order
# several data groups: float32 weight gradients from per-group products
TWIN_TOL = dict(loss=1e-6, grad_norm=1e-5, param=1e-6)
REF_TOL = 5e-3


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def reference():
    """Each case's reference params, batch and unsharded first-step loss."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.transformer import init_params
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.train.steps import make_train_step

    arrays, losses = {}, {}
    for name, (arch, changes, mb) in W.CASES.items():
        cfg = dataclasses.replace(jax_smoke(arch), **changes)
        params = init_params(jax.random.PRNGKey(0), cfg)
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (8, 16)).astype(np.int32)
        step = jax.jit(make_train_step(cfg, None, AdamWConfig(lr=1e-3), mb))
        _, _, m = step(params, adamw_init(params), {"tokens": toks})
        losses[name] = float(m["loss"])
        arrays.update(_flatten(params, f"{name}/params"))
        arrays[f"{name}/tokens"] = toks
    return arrays, losses


@pytest.fixture(scope="module", params=list(FLEETS))
def fleet(request, reference, tmp_path_factory):
    from repro_torch.launch.multiprocess import launch_local

    nproc, local, shape = FLEETS[request.param]
    out = tmp_path_factory.mktemp("lm_fleet")
    np.savez(out / "cases.npz", **reference[0])
    rc = launch_local(nproc, local, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=[sys.executable,
                            str(HERE / "_torch_mp_lm_train_worker.py"),
                            str(out), "x".join(map(str, shape))])
    assert rc == 0, f"the fleet failed (exit {rc})"
    res = [json.loads((out / f"rank{r}.json").read_text())
           for r in range(nproc)]
    return request.param, res


def test_fleet_groups_and_counting_processes(fleet):
    name, res = fleet
    nproc, local, (D, M) = FLEETS[name]
    per = nproc // D if nproc >= D else 1
    want = [list(range(g * per, (g + 1) * per)) for g in range(D)]
    for r in res:
        assert r["groups"] == want
    counting = [r["cases"]["dense"]["counts_rows"] for r in res]
    # one process per data group counts its rows: the one with model rank 0
    assert sum(counting) == D
    assert all(counting[g[0]] for g in want)
    cfg, _ = W.case_config("ep")
    held = [r["cases"]["ep"]["experts_held"] for r in res]
    assert held == [min(local, M) * cfg.n_experts // M] * nproc


@pytest.mark.parametrize("case", list(W.CASES))
def test_fleet_step_equals_emulated_twin(fleet, case):
    name, res = fleet
    for r in res:
        for i, step in enumerate(r["cases"][case]["steps"]):
            where = f"{name} {case} span {r['span']} step {i + 1}"
            e_loss, f_loss = step["loss"]
            e_norm, f_norm = step["grad_norm"]
            if name in EXACT:
                assert step["loss_equal"], where
                assert step["norm_equal"], where
                assert step["params_equal"], where
            else:
                assert abs(f_loss - e_loss) <= TWIN_TOL["loss"] * abs(e_loss)
                assert abs(f_norm - e_norm) <= TWIN_TOL["grad_norm"] * e_norm
                assert step["param_max_err"] <= TWIN_TOL["param"], where
    # every process reports the same global loss and norm
    for i in range(len(res[0]["cases"][case]["steps"])):
        vals = {tuple(r["cases"][case]["steps"][i]["loss"][1:]
                      + r["cases"][case]["steps"][i]["grad_norm"][1:])
                for r in res}
        assert len(vals) == 1, f"{name} {case} step {i + 1}: {vals}"


@pytest.mark.parametrize("case", list(W.CASES))
def test_fleet_first_loss_within_5e3_of_reference(fleet, reference, case):
    name, res = fleet
    want = reference[1][case]
    for r in res:
        assert abs(r["cases"][case]["steps"][0]["loss"][1] - want) < REF_TOL


def test_ep_step_crosses_processes_both_ways(fleet):
    name, res = fleet
    crossing = name != "data2_model4-2x4"
    for r in res:
        step = r["cases"]["ep"]["steps"][0]
        assert (step["bwd_exchanges"] > 0) == crossing
        # the fold sends every whole leaf once there are two data groups
        # or a group over two processes
        assert step["fold_bytes"] > 0
