"""The launcher and the topology of the port's multi-process tier (CPU).

Counterparts of the reference's Supervisor / heartbeat tests
(``tests/test_faults.py``: fake spawns, the same assertions) against
``repro_torch.launch.multiprocess``; ``worker_smoke`` through
``launch_local(2, 4, device="cpu")``; the supervised kill and degrade
drills of a real 2-process fleet; and the ``Topology`` parity tests of
``tests/test_session.py`` — ``from_mesh(...).network()``, intrinsic tiers
winning in ``auto_grouping``, ``make_context(Topology.from_mesh(mesh))`` —
with the derived networks equal to the reference's. Every wait has a
deadline.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.context import make_context
from repro_torch.distributed.topology import Topology, TopologyError
from repro_torch.launch import multiprocess as mp
from repro_torch.launch.mesh import make_mesh, make_spmm_mesh
from repro_torch.robustness.faults import EPOCH_ENV, FAULTS_ENV, KILL_EXIT_CODE

ROOT = Path(__file__).resolve().parents[1]
P = 8
FLEET_TIMEOUT = 240


# ---------------------------------------------------------------------------
# worker_kill / stalls -> Supervisor (fake spawns, no fleet)
# ---------------------------------------------------------------------------


def _exit_proc(code=0, sleep=0.0):
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import sys, time; time.sleep({sleep}); sys.exit({code})"])


def _policy(**over):
    kw = dict(heartbeat_timeout=30.0, max_restarts=2, backoff=0.0,
              backoff_max=0.0, poll=0.02, timeout=30.0)
    kw.update(over)
    return mp.SupervisorPolicy(**kw)


def test_supervisor_restarts_killed_fleet(capsys):
    def spawn(rank, nproc, epoch, coord, rundir):
        # rank 1 dies like a preempted host in the first epoch only —
        # the restarted fleet (epoch 1) runs clean
        code = KILL_EXIT_CODE if (epoch == 0 and rank == 1) else 0
        return _exit_proc(code)

    sup = mp.Supervisor(2, 4, policy=_policy(), spawn=spawn)
    assert sup.run() == 0
    assert sup.report["restarts"] == 1 and not sup.report["degraded"]
    assert sup.report["incidents"][0]["kind"] == "died"
    assert f"exit {KILL_EXIT_CODE}" in sup.report["incidents"][0]["detail"]
    assert "recovered" in capsys.readouterr().out


def test_supervisor_degrades_to_surviving_fleet(capsys):
    def spawn(rank, nproc, epoch, coord, rundir):
        # the full fleet keeps dying; a one-process fleet survives
        return _exit_proc(0 if nproc == 1 else 23)

    sup = mp.Supervisor(2, 4, policy=_policy(max_restarts=1), spawn=spawn)
    assert sup.run() == 0
    assert sup.report["degraded"] and sup.report["nproc"] == 1
    assert len(sup.report["incidents"]) == 2  # initial + 1 restart
    assert "DEGRADED" in capsys.readouterr().out


def test_supervisor_gives_up_after_exhausting_everything():
    sup = mp.Supervisor(2, 4, policy=_policy(max_restarts=0),
                        spawn=lambda *a: _exit_proc(3))
    assert sup.run() == 1
    assert sup.report["nproc"] == 1 and sup.report["degraded"]


def test_supervisor_detects_stalled_worker():
    # the worker neither exits nor makes progress; with no heartbeat
    # file the launch time is the reference, so the stall trips fast
    sup = mp.Supervisor(1, 4,
                        policy=_policy(heartbeat_timeout=0.3,
                                       max_restarts=0),
                        spawn=lambda *a: _exit_proc(0, sleep=60))
    t0 = time.perf_counter()
    assert sup.run() == 1
    assert time.perf_counter() - t0 < 20.0  # bounded: it never hangs
    assert sup.report["incidents"][0]["kind"] == "stalled"
    assert "no progress" in sup.report["incidents"][0]["detail"]


def test_supervisor_ladder_env_covers_every_fleet_size():
    sup = mp.Supervisor(3, 4, policy=_policy(), spawn=lambda *a: None)
    assert sup._ladder_env() == "4,8,12"


def test_heartbeat_roundtrip(tmp_path, monkeypatch):
    mp.write_heartbeat(str(tmp_path), 0, stage="serve", progress=7)
    hb = mp.read_heartbeat(str(tmp_path), 0)
    assert hb["stage"] == "serve" and hb["progress"] == 7
    assert hb["progress_time"] <= time.time()
    assert mp.read_heartbeat(str(tmp_path), 1) is None
    # no rundir env -> heartbeats are off (the unsupervised path)
    monkeypatch.delenv(mp.RUNDIR_ENV, raising=False)
    assert mp.Heartbeat.maybe_start(0) is None


def test_supervisor_policy_from_env(monkeypatch):
    monkeypatch.setenv(mp.MAX_RESTARTS_ENV, "5")
    monkeypatch.setenv(mp.BACKOFF_ENV, "0.25")
    pol = mp.SupervisorPolicy.from_env(heartbeat_timeout=7.0)
    assert (pol.max_restarts, pol.backoff, pol.heartbeat_timeout) == \
        (5, 0.25, 7.0)


# ---------------------------------------------------------------------------
# real fleets on the CPU
# ---------------------------------------------------------------------------


def test_worker_smoke_through_launch_local():
    assert mp.launch_local(2, 4, timeout=FLEET_TIMEOUT, device="cpu") == 0


def test_launch_local_propagates_a_failed_worker():
    code = "import os, sys; sys.exit(7 if os.environ['REPRO_MP_RANK'] == '1' \
else 0)"
    t0 = time.perf_counter()
    assert mp.launch_local(2, 4, timeout=FLEET_TIMEOUT, device="cpu",
                           argv=[sys.executable, "-c", code]) == 7
    assert time.perf_counter() - t0 < 60.0


def _launcher(*flags, faults=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop(EPOCH_ENV, None)
    if faults is not None:
        env[FAULTS_ENV] = json.dumps(faults)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multiprocess",
         "--nproc", "2", "--local-devices", "4", "--device", "cpu",
         "--timeout", str(FLEET_TIMEOUT), *flags],
        env=env, capture_output=True, text=True, timeout=FLEET_TIMEOUT + 60)


def test_supervised_kill_drill_recovers():
    kill = {"kind": "worker_kill", "site": "stage:serve", "rank": 1,
            "epoch": 0}
    proc = _launcher("--supervise", "--backoff", "0", faults=[kill])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "recovered after 1 restart(s) (nproc=2)" in proc.stdout
    assert f"worker 1 died (exit {KILL_EXIT_CODE}) in epoch 0" in proc.stderr
    assert proc.stdout.count("replan hot-swap OK") == 2


def test_supervised_degrade_drill_serves_the_surviving_rung():
    kills = [{"kind": "worker_kill", "site": "stage:serve", "rank": 1,
              "epoch": e} for e in range(3)]
    proc = _launcher("--supervise", "--max-restarts", "0", "--backoff", "0",
                     faults=kills)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "recovered DEGRADED" in proc.stdout
    assert "on_resize -> surviving rung P=4 of ladder (4, 8)" in proc.stdout
    assert "smoke N=8,16 == dense reference  OK" in proc.stdout


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


def test_cuda_worker_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp.initialize("127.0.0.1:1", 2, 0, device="cuda", timeout=5)


def test_multiprocess_needs_a_fleet():
    with pytest.raises(TopologyError, match=">= 2 processes"):
        Topology.multiprocess(device="cpu")


def test_local_topology_stays_byte_stable():
    t = Topology.local(P, "cpu")
    assert t.describe() == {"kind": "local", "P": P, "tiers": None,
                            "n_hosts": 1, "platform": "cpu"}
    assert (t.is_multiprocess, t.span) == (False, (0, P))
    b = np.arange(P * 6, dtype=np.float32).reshape(P * 2, 3)
    assert torch.equal(t.put_global(b), torch.from_numpy(b))
    with pytest.raises(TopologyError, match="cannot narrow"):
        t.narrow(2 * P)


def test_topology_network_derivation():
    from repro_torch.core.comm_model import TSUBAME_LIKE

    # flat local substrate: no structure => the configured default
    assert Topology.local(P, "cpu").network() is TSUBAME_LIKE
    # a two-axis mesh derives its own two-tier spec; the inner axis is
    # the fast-tier group
    t = Topology.from_mesh(make_spmm_mesh(P, groups=2), device="cpu")
    net = t.network()
    assert t.kind == "mesh" and t.tiers == (2, 4)
    assert net.group_size == 4 and net.name == "derived-cpu-2x4"
    assert net.bw_intra > net.bw_inter


def test_topology_auto_grouping_prefers_intrinsic_tiers():
    from repro_torch.core.comm_model import TSUBAME_LIKE

    # TSUBAME group_size=4 would guess (2, 4); the mesh's own (4, 2)
    # structure must win
    topo = Topology.from_mesh(make_spmm_mesh(P, groups=4), device="cpu")
    assert topo.auto_grouping(TSUBAME_LIKE) == (4, 2)
    assert Topology.local(P, "cpu").auto_grouping(TSUBAME_LIKE) == (2, 4)
    # a one-axis mesh has no tiers
    assert Topology.from_mesh(make_spmm_mesh(P), device="cpu").tiers is None


def test_make_context_accepts_topology():
    mesh = make_mesh((2, 4), ("data", "model"))
    dist = make_context(Topology.from_mesh(mesh, device="cpu"))
    assert dist.mesh is mesh and dist.model_size == 4
    with pytest.raises(TopologyError, match="named"):
        make_context(Topology.local(4, "cpu"))


@pytest.mark.parametrize("groups", [2, 4])
def test_derived_network_equals_reference(groups):
    pytest.importorskip("jax")
    from repro.distributed.topology import Topology as RTopology
    from repro.launch.mesh import make_spmm_mesh as r_make_spmm_mesh

    want = RTopology.from_mesh(r_make_spmm_mesh(P, groups=groups)).network()
    got = Topology.from_mesh(make_spmm_mesh(P, groups=groups),
                             device="cpu").network()
    assert (got.name, got.bw_intra, got.bw_inter, got.lat_intra,
            got.lat_inter, got.group_size) == \
        (want.name, want.bw_intra, want.bw_inter, want.lat_intra,
         want.lat_inter, want.group_size)


def test_launcher_imports_no_jax():
    code = ("import sys, repro_torch.launch.multiprocess, "
            "repro_torch.distributed.comm; bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'shiro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
