"""The expert-parallel LM across real processes on the CPU: a fleet's
``MeshComm`` (``comm.ProcessMeshComm``), ``_moe_ep`` on a span of the
grid, the sequence-sharded decode and the batcher.

Three module-scoped fleets (``launch_local(n, w, device="cpu")``, gloo, a
deadline on every wait) run ``tests/_torch_mp_mesh_worker.py`` on a
(data, model) grid over ``Topology.multiprocess(mesh=...)``:

* (data 2, model 4) over 2 processes × 4 ranks: each data group inside
  one process, so nothing crosses;
* (data 2, model 4) over 4 processes × 2 ranks and (data 1, model 8)
  over 2 × 4: the model axis crosses the process boundary.

On each, the fleet's all_to_all (activations and meta), pmax and psum
and their input gradients equal ``MeshComm``'s on the stacked tensor bit
for bit, with the emulated log's rows; ``_moe_ep`` at olmoe-smoke width
(shiro and classic dispatch, each process holding the experts of its
model ranks only) equals the emulated run of the same grid bit for bit
on every model rank, with its rows and its dispatch counts, and the
reference's ``_moe_ep`` within 2e-4; the forward, ``decode_step``
(unsharded and sequence-sharded) and the batcher give the emulated run's
tokens, logits within 2e-4.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_mesh_worker as W  # noqa: E402

FLEET_TIMEOUT = 180.0
TOL = dict(rtol=2e-4, atol=2e-4)
# (processes, ranks per process, grid)
FLEETS = {"data2_model4-2x4": (2, 4, (2, 4)),
          "data2_model4-4x2": (4, 2, (2, 4)),
          "data1_model8-2x4": (2, 4, (1, 8))}
CROSSING = ("data2_model4-4x2", "data1_model8-2x4")


@pytest.fixture(scope="module", params=list(FLEETS))
def fleet(request, tmp_path_factory):
    from repro_torch.launch.multiprocess import launch_local

    nproc, local, shape = FLEETS[request.param]
    out = tmp_path_factory.mktemp("mesh_fleet")
    rc = launch_local(nproc, local, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=[sys.executable,
                            str(HERE / "_torch_mp_mesh_worker.py"), str(out),
                            "x".join(map(str, shape))])
    assert rc == 0, f"the fleet failed (exit {rc})"
    res = [json.loads((out / f"rank{r}.json").read_text())
           for r in range(nproc)]
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(nproc)]
    return request.param, res, arrays


def test_fleet_grid_spans(fleet):
    name, res, _ = fleet
    nproc, local, (D, M) = FLEETS[name]
    for i, r in enumerate(res):
        assert r["span"] == [i * local, (i + 1) * local]
        assert r["lead"] == [local] and r["tiers"] == [nproc, local]
        ng, nm, g_lo, m_lo = r["local_grid"]
        assert ng * nm == local and g_lo * M + m_lo == i * local


@pytest.mark.parametrize("op", ["all_to_all", "all_to_all_meta", "pmax",
                                "psum"])
def test_fleet_meshcomm_equals_meshcomm(fleet, op):
    name, res, _ = fleet
    for r in res:
        got = r["collectives"][op]
        assert got["equal"], f"{name} span {r['span']}: {op} != MeshComm"
        assert got["grad_equal"], f"{name} span {r['span']}: d{op}"
        assert got["rows"] == got["local_rows"]
        assert got["crossing"][0] == got["crossing"][1]
        assert (got["crossing"][0] > 0) == (name in CROSSING)
    meta = op == "all_to_all_meta"
    rows = res[0]["collectives"][op]["rows"]
    assert (rows[2] > 0) == meta and (rows[0] > 0) != meta


@pytest.mark.parametrize("dispatch", ["shiro", "classic"])
def test_moe_ep_equals_emulated(fleet, dispatch):
    name, res, _ = fleet
    D, M = FLEETS[name][2]
    for r in res:
        got = r["moe"][dispatch]
        assert got["equal"], f"{name} span {r['span']}: y != emulated"
        assert got["ranks_equal"]
        assert got["rows"] == got["local_rows"]
        # two exchanges of [Dsz, M, M, cap] activation rows a layer
        assert got["rows"][0] == 2 * D * M * M * got["cap"]
        assert (got["crossing"] > 0) == (name in CROSSING)
    for key in ("sent", "dropped"):  # counted once per data group
        total = np.sum([r["moe"][dispatch][key] for r in res], axis=0)
        assert list(total) == res[0]["moe"][dispatch][f"emulated_{key}"]


@pytest.mark.parametrize("dispatch", ["shiro", "classic"])
def test_moe_ep_matches_reference(fleet, dispatch):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.distributed.context import DistContext as RDist
    from repro.launch.mesh import make_mesh as r_make_mesh
    from repro.models import moe as RM

    name, res, arrays = fleet
    shape = FLEETS[name][2]
    cfg = dataclasses.replace(jax_smoke("olmoe-1b-7b"),
                              shiro_dispatch=dispatch == "shiro")
    rdist = RDist(mesh=r_make_mesh(shape, W.AXES), batch_axes=("data",),
                  model_axis="model")
    p = {k: jnp.asarray(arrays[0][f"moe/{k}"])
         for k in ("router", "w1", "w3", "w2")}
    want = np.asarray(jax.jit(lambda p, x: RM.moe_layer(p, x, cfg, rdist))(
        p, jnp.asarray(arrays[0]["moe/x"])))
    for r, arr in zip(res, arrays):
        lo, hi = r["moe"]["rows_block"]
        np.testing.assert_allclose(arr[f"moe/{dispatch}"], want[lo:hi], **TOL)


@pytest.mark.parametrize("mode", ["unsharded", "seqshard"])
def test_lm_forward_and_decode_equal_emulated(fleet, mode):
    name, res, _ = fleet
    for r in res:
        got = r["lm"][mode]
        assert got["forward_tokens_equal"]
        assert got["forward_max_err"] <= TOL["atol"]
        for j, step in enumerate(got["steps"]):
            assert step["tokens_equal"], f"{name} {mode} step {j}"
            assert step["max_err"] <= TOL["atol"], f"{name} {mode} step {j}"
        assert got["cache_equal"]


@pytest.mark.parametrize("mode", ["unsharded", "seqshard"])
def test_batcher_tokens_equal_emulated(fleet, mode):
    name, res, _ = fleet
    first = res[0]["lm"][mode]["batcher"]["fleet"]
    for r in res:
        b = r["lm"][mode]["batcher"]
        assert b["fleet"] == b["emulated"], f"{name} span {r['span']}"
        assert b["fleet"] == first  # every process holds the same tokens
    assert sum(len(o) for o in first["outputs"]) == len(W.LENGTHS) * W.NEW
