"""The hybrid, encdec, vlm and audio families on a fleet's grid (CPU, gloo).

One module-scoped fleet per layout (``launch_local(2, 4,
device="cpu")``) runs ``tests/_torch_mp_families_worker.py``, every
family in one launch:

* (data 1, model 8) over 2 processes × 4 ranks: one data group spans the
  fleet, so each process runs the whole batch and every result is
  ``torch.equal`` to the emulated grid's (every sum in its order);
* (data 2, model 4) over 2 × 4: each process holds one data group's
  rows. Forward, ``lm_loss``, the decode step and its cache writes are
  its rows of the emulated grid's; each train step's weight gradients
  are products over one group's rows, folded after, where the emulated
  grid's run over both groups' rows at once, so the steps hold relative
  loss 1e-6, grad norm 1e-5 and parameters 1e-6 (float32).

The zamba2, seamless, llava and audio smoke configs (the ``audio``
family is llava's smoke config with family and frontend "audio"), B 4 ×
S 8, one decode step, two AdamW steps. And the emulated grid's forward
against ``repro``'s at 2e-4 on both grids.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_families_worker as W  # noqa: E402

FLEET_TIMEOUT = 240.0
# name -> (processes, ranks per process, grid)
FLEETS = {"data1_model8-2x4": (2, 4, (1, 8)),
          "data2_model4-2x4": (2, 4, (2, 4))}
EXACT = ("data1_model8-2x4",)
TWIN_TOL = dict(loss=1e-6, grad_norm=1e-5, param=1e-6)
# forward / decode on two data groups: each process's rows of the same
# products, within float32 rounding of the logits
ROWS_TOL = 1e-5
LOGITS = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", params=list(FLEETS))
def fleet(request, tmp_path_factory):
    from repro_torch.launch.multiprocess import launch_local

    nproc, local, shape = FLEETS[request.param]
    out = tmp_path_factory.mktemp("families_fleet")
    rc = launch_local(nproc, local, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=[sys.executable,
                            str(HERE / "_torch_mp_families_worker.py"),
                            str(out), "x".join(map(str, shape))])
    assert rc == 0, f"the fleet failed (exit {rc})"
    res = [json.loads((out / f"rank{r}.json").read_text())
           for r in range(nproc)]
    return request.param, res


def _held(name, what, equal_err):
    equal, err = equal_err
    if name in EXACT:
        assert equal, what
    else:
        assert err <= ROWS_TOL, what


@pytest.mark.parametrize("arch", W.ARCHS)
def test_family_runs_its_rows_as_the_emulated_grid(fleet, arch):
    """Forward logits, the loss's fold, one decode step and the cache rows
    it writes (and no other rows) against the emulated grid's."""
    name, res = fleet
    D = FLEETS[name][2][0]
    for r in res:
        case = r["cases"][arch]
        lo, hi = case["rows"]
        # its data groups' rows
        assert hi - lo == W.B // D * max(D // len(res), 1)
        where = f"{name} {arch} span {r['span']}"
        _held(name, where + " forward", case["forward"])
        _held(name, where + " loss", case["loss"])
        _held(name, where + " decode", case["decode"])
        for i, c in enumerate(case["cache"]):
            _held(name, f"{where} cache field {i}", c)
        assert case["cache_rest_zero"], where


@pytest.mark.parametrize("arch", W.ARCHS)
def test_family_train_steps_equal_the_emulated_twin(fleet, arch):
    name, res = fleet
    for r in res:
        for i, step in enumerate(r["cases"][arch]["steps"]):
            where = f"{name} {arch} span {r['span']} step {i + 1}"
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
    steps = [r["cases"][arch]["steps"] for r in res]
    for i in range(len(steps[0])):
        vals = {(s[i]["loss"][1], s[i]["grad_norm"][1]) for s in steps}
        assert len(vals) == 1, f"{name} {arch} step {i + 1}: {vals}"


@pytest.mark.parametrize("grid", [(1, 8), (2, 4)])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_emulated_grid_forward_matches_reference(arch, grid):
    """The twin the fleet is held to, against ``repro``'s unsharded
    forward on the reference's weights (2e-4)."""
    import dataclasses

    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import transformer as RT
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT

    tcfg = W.case_config(arch)
    if arch == "audio":
        rcfg = dataclasses.replace(ref_smoke("llava-next-mistral-7b"),
                                   family="audio", frontend="audio",
                                   name="audio-smoke")
    else:
        rcfg = ref_smoke(arch)
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    tp = TT.transformer_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    batch = W.case_batch(tcfg)
    want = np.asarray(RT.forward(params, rcfg, None,
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()}))
    dist = make_context(make_mesh(grid, W.AXES))
    with torch.no_grad():
        got = TT.forward(tp, tcfg, dist,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, **LOGITS)
