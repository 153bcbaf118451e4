"""Gradients across two real processes on the CPU: ``ProcessComm`` under
autograd, the executors on a rank span, and GCN / GAT training.

One module-scoped fleet (``launch_local(2, 4, device="cpu")``, gloo, a
deadline on every wait) runs ``tests/_torch_mp_autograd_worker.py`` in
each process; the tests read what the processes wrote.

* Each collective kind (all_to_all, ppermute / shift, group all_to_all,
  group shift, local reduce-scatter, local all-gather, B's replication,
  lane shifts, the replica reduce-scatter), on the layouts
  ``test_torch_process_comm`` uses: the input gradient of a random
  linear functional of its result is ``torch.equal`` to ``LocalComm``'s
  rows, and its backward moves the forward's rows, across processes
  too.
* ``dB`` of ½‖h(b)‖² through every coo tier (flat single / staged /
  overlapped, hier single / overlapped, replicated): each process's rows
  ``torch.equal`` to the emulated run's, within 1e-4 (5e-3 overlapped,
  ``tests/test_overlap.py:207``) of the reference's ``jax.grad``; the
  backward's rows per axis equal the forward's, its crossing rows the
  forward's and ``plan_crossing_rows()``. A bsr SpMM under grad raises.
* A GCN (12 → 16 → 16 → 5) and a GAT (12 → 16 → 5) on the flat and the
  hier tier, 3 AdamW steps with the gradients summed over the processes:
  first-step loss within 2e-4 and every gradient within rtol 2e-3 /
  atol 2e-4 (``tests/test_sddmm.py:265``) of the reference's
  ``jax.value_and_grad``; the parameters equal on both processes after
  every step. ``examples/torch_gnn_training.py --nproc 2`` prints one
  process's loss curve, the one-process run's.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_autograd_worker as W  # noqa: E402

FLEET_TIMEOUT = 180.0
HANDLE_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_api.py:297
OVERLAP_TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_overlap.py:207
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_sddmm.py:265
COLLECTIVES = [c[0] for c in W.collective_cases()]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    from repro_torch.launch.multiprocess import launch_local

    out = tmp_path_factory.mktemp("autograd_fleet")
    rc = launch_local(2, 4, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=[sys.executable,
                            str(HERE / "_torch_mp_autograd_worker.py"),
                            str(out)])
    assert rc == 0, f"the fleet failed (exit {rc})"
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)]
    return res, arrays


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_grad_equals_localcomm(fleet, name):
    res, _ = fleet
    for r in res:
        got = r["comm"][name]
        assert got["equal"], f"span {r['span']}: d{name} != LocalComm's"
        fwd, bwd = got["rows"]
        assert fwd == bwd == got["local_rows"][0] == got["local_rows"][1]
        assert got["crossing"][0] == got["crossing"][1]
        assert got["bwd_exchanges"] == (got["crossing"][0] > 0)


@pytest.mark.parametrize("name", list(W.CONFIGS))
def test_handle_grad_equals_emulated_rows(fleet, name):
    res, _ = fleet
    for r in res:
        got = r["exec"][name]
        assert got["equal"], f"{name}: span {r['span']} dB != emulated"
        assert got["c_equal"]
        for axis, (fwd, bwd, e_fwd, e_bwd) in got["rows"].items():
            assert fwd == bwd == e_fwd == e_bwd > 0, f"{name} axis {axis}"
        assert got["crossing"][0] == got["crossing"][1] > 0
        if got["plan_crossing"] is not None:
            assert got["crossing"][0] == got["plan_crossing"]
        assert got["transport"]["bwd_exchanges"] >= 1
    assert res[0]["exec"][name]["strategy"] == name.split("_")[0]


def test_bsr_spmm_under_grad_raises_on_a_fleet(fleet):
    res, _ = fleet
    assert all(r["exec"]["bsr_raises"] for r in res)


@pytest.mark.parametrize("name", list(W.CONFIGS))
def test_handle_grad_matches_reference_jax_grad(fleet, name):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.core as R
    from repro.core.sparse import power_law_sparse

    a = power_law_sparse(64, 64, 400, 1.2, 2)
    port = W.matrix()
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(port, f), getattr(a, f))
    ref = R.compile_spmm(a, W.P, R.SpmmConfig(**W.CONFIGS[name]))
    b = W._gen(0, (64, W.N_COLS))
    want = np.asarray(jax.jit(jax.grad(
        lambda x: 0.5 * jnp.sum(ref(x) ** 2)))(jnp.asarray(b)))
    res, arrays = fleet
    tol = OVERLAP_TOL if W.CONFIGS[name].get("overlap") else HANDLE_TOL
    per = 64 // W.P
    for r, arr in zip(res, arrays):
        lo, hi = r["span"]
        np.testing.assert_allclose(arr[f"db/{name}"],
                                   want[lo * per:hi * per], **tol)


def _reference_grads(name):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.core as R
    from repro.core.sparse import power_law_sparse
    from repro.models import gnn as r_gnn

    kind = name.split("-")[0]
    hier = W.MODELS[name].get("hier")
    adj = r_gnn.normalize_adjacency(power_law_sparse(64, 64, 400, 1.2, 2))
    n = adj.shape[0]
    rng = np.random.default_rng(1 if kind == "gcn" else 3)
    dims = W.GCN_DIMS if kind == "gcn" else W.GAT_DIMS
    feats = jnp.asarray(rng.standard_normal((n, dims[0])).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, dims[-1], n))
    if kind == "gcn":
        from repro_torch.models.gnn import gcn_params
        ref = R.compile_spmm(adj, W.P, R.SpmmConfig(hier=hier))
        params = gcn_params(dims, seed=0)
        spmm = r_gnn.make_spmm_fn(ref)
        loss = lambda p: r_gnn.gcn_loss(p, feats, labels, spmm)  # noqa: E731
    else:
        from repro_torch.models.gnn import gat_params
        ref = R.compile_fused(adj, W.P, edge="leaky_relu", hier=hier)
        params = gat_params(dims, W.ATT, seed=0)
        loss = lambda p: r_gnn.gat_loss(p, feats, labels, ref)  # noqa: E731
    rp = [{k: jnp.asarray(v) for k, v in lp.items()} for lp in params]
    value, grads = jax.jit(jax.value_and_grad(loss))(rp)
    return float(value), grads


@pytest.mark.parametrize("name", list(W.MODELS))
def test_training_first_step_matches_reference(fleet, name):
    want_loss, want_g = _reference_grads(name)
    res, arrays = fleet
    for r, arr in zip(res, arrays):
        got = r["train"][name]
        assert got["strategy"] == ("hier" if "hier" in name else "flat")
        np.testing.assert_allclose(got["losses"][0], want_loss, rtol=2e-4,
                                   atol=2e-4)
        for i, pname in enumerate(got["names"]):
            _, layer, field = pname.split(".")
            np.testing.assert_allclose(arr[f"{name}/grad{i}"],
                                       np.asarray(want_g[int(layer)][field]),
                                       **GRAD_TOL, err_msg=pname)


@pytest.mark.parametrize("name", list(W.MODELS))
def test_training_params_equal_across_processes(fleet, name):
    res, arrays = fleet
    assert res[0]["train"][name]["losses"] == res[1]["train"][name]["losses"]
    n_params = len(res[0]["train"][name]["names"])
    for step in range(W.STEPS):
        for i in range(n_params):
            key = f"{name}/step{step}/p{i}"
            assert np.array_equal(arrays[0][key], arrays[1][key]), key
    for i in range(n_params):  # the step moved the parameters
        assert not np.array_equal(arrays[0][f"{name}/step0/p{i}"],
                                  arrays[0][f"{name}/step{W.STEPS - 1}/p{i}"])


@pytest.mark.parametrize("name", list(W.MODELS))
def test_training_backward_moves_the_forward_rows(fleet, name):
    """Each layer's call moves the same rows; after the step's backward
    the log holds the last call's forward and every call's backward."""
    res, _ = fleet
    layers = len(W.GCN_DIMS if name.startswith("gcn") else W.GAT_DIMS) - 1
    got = res[0]["train"][name]
    assert got["rows"][1] == layers * got["rows"][0] > 0
    assert got["crossing"][1] == layers * got["crossing"][0] > 0


def test_gnn_training_example_runs_on_a_fleet():
    """``examples/torch_gnn_training.py --nproc 2``: the launcher's fleet
    trains, and only process 0 prints the loss curve, which is the one
    process's curve."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    run = [sys.executable, str(HERE.parent / "examples" /
                               "torch_gnn_training.py"),
           "--device", "cpu", "--epochs", "3", "--nodes", "128",
           "--edges", "1024"]
    curves = []
    for extra in (["--nproc", "2"], []):
        out = subprocess.run(run + extra, env=env, capture_output=True,
                             text=True, timeout=FLEET_TIMEOUT)
        assert out.returncode == 0, out.stderr[-2000:]
        curves.append([line for line in out.stdout.splitlines()
                       if line.strip().startswith("epoch")])
    fleet, single = curves
    assert len(fleet) == 3 and len(single) == 3
    for a, b in zip(fleet, single):  # the same losses to 4 decimals
        assert a == b
