"""``SpmmFleet`` tenants on the groups of a process fleet (CPU, gloo),
against the emulated fleet and the JAX package.

Two module-scoped fleets run ``tests/_torch_mp_fleet_worker.py``:
``launch_local(2, 4, device="cpu")`` (split (4, 4): one group a process,
each process with an empty span in the other group) and 4 × 2 (each group
over two processes). Split (2, 6) puts group 1 across the processes on
both. On each:

* placements, scores, group loads, imbalance, rebalance moves, counters
  and events equal the reference's ``SpmmFleet`` on eight host devices as
  a (2, 4) mesh (``Topology.from_mesh(make_spmm_mesh(8, groups=2))``:
  a carved group has no tiers on either side, so ``net="auto"`` scores
  every group on the model's default network), and the reshard routes its
  ``ReshardSpec``'s;
* every served C row is ``torch.equal`` to the same tenant's on
  ``SpmmFleet(Topology.local(8), ...)`` and within 2e-4 of float64;
* after a migration across the process boundary the resident B and C
  slabs equal the served rows under the new partition; the moved rows are
  ``ReshardSpec.moved_rows()`` and the rows that crossed processes are
  counted beside them;
* a ``fleet_migrate_fail`` fault on process 1 alone rolls the migration
  back on every process, with the same counters and events;
* ``dropped_waves`` stays 0.
"""
import functools
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_fleet_worker as W  # noqa: E402

FLEET_TIMEOUT = 240.0
LAYOUTS = {"2x4": (2, 4), "4x2": (4, 2)}
TOL = 2e-4


def _launch(out, layout):
    from repro_torch.launch.multiprocess import launch_local

    n, local = LAYOUTS[layout]
    rc = launch_local(n, local, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=[sys.executable,
                            str(HERE / "_torch_mp_fleet_worker.py"),
                            str(out)])
    assert rc == 0, f"the {layout} fleet failed (exit {rc})"
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(n)]


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        runs = {layout: pool.submit(
            _launch, tmp_path_factory.mktemp(f"spmm_fleet{layout}"), layout)
            for layout in LAYOUTS}
        return {layout: run.result() for layout, run in runs.items()}


# ----- the reference ------------------------------------------------------


def _json(x):
    return json.loads(json.dumps(x, default=str))


def _ref_state(fleet):
    return _json({
        "placements": fleet.placements(),
        "scores": {n: {str(g): list(v) for g, v in t.scores.items()}
                   for n, t in fleet.tenants.items()},
        "group_loads": fleet.group_loads(), "imbalance": fleet.imbalance(),
        "migrations": fleet.migrations,
        "failed_migrations": fleet.failed_migrations,
        "current_P": {n: t.session.current_P
                      for n, t in fleet.tenants.items()},
        "events": fleet.events})


def _ref_routes(old, new):
    from repro.core.sparse import block_rows
    from repro.serving.fleet import ReshardSpec

    b = ReshardSpec.between(block_rows(old.shape[1], old.P),
                            block_rows(new.shape[1], new.P))
    c = ReshardSpec.between(tuple(old.bounds), tuple(new.bounds))
    return ({"b": [list(r) for r in b.routes],
             "c": [list(r) for r in c.routes]},
            [b.moved_rows(), c.moved_rows()])


@functools.lru_cache(maxsize=None)
def reference(split):
    """The reference fleet through the worker's steps: its states, moves,
    routes and moved rows."""
    from repro.core.api import SpmmConfig
    from repro.core.sparse import power_law_sparse
    from repro.distributed.topology import Topology
    from repro.launch.mesh import make_spmm_mesh
    from repro.robustness import Fault, inject
    from repro.serving.fleet import SpmmFleet

    sizes, tenants = W.SPLITS[split]
    fleet = SpmmFleet(Topology.from_mesh(make_spmm_mesh(W.P, groups=2)),
                      sizes, config=SpmmConfig(**W.CONFIG))
    mats = {n: power_law_sparse(s[0], s[0], s[1], 1.2, seed=s[2])
            for n, s in tenants.items()}
    ladder = W.LADDER26 if split == "g26" else None
    for n, a in mats.items():
        fleet.admit(n, a, p_ladder=ladder)
    out = {"admitted": _ref_state(fleet)}
    rounds = [0]

    def serve():
        rounds[0] += 1
        for n, s in tenants.items():
            fleet.submit(n, W.operand(n, s, rounds[0]))
        fleet.serve()

    def plan(n):
        return fleet.tenants[n].session.handle().plan

    serve()
    if split == "g44":
        old = {n: plan(n) for n in mats}
        out["moves"] = [list(m) for m in fleet.rebalance()]
        name = out["moves"][0][0]
        out["rebalance"] = _ref_routes(old[name], plan(name))
        serve()
        src = fleet.placements()[name]
        with inject([Fault(kind="wave_error", site="fleet_migrate_fail")]):
            out["rollback_ok"] = fleet.migrate(name, 1 - src)
        serve()
    else:
        out["steps"] = []
        for dst in ((1,) if fleet.placements()["s"] == 0 else (0, 1)):
            old = plan("s")
            ok = fleet.migrate("s", dst)
            out["steps"].append((ok,) + _ref_routes(old, plan("s")))
            serve()
    out["state"] = _ref_state(fleet)
    return out


# ----- the tests ----------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("split", list(W.SPLITS))
def test_decisions_equal_reference(fleets, layout, split):
    want = reference(split)
    for r in fleets[layout]:
        got = r[split]
        assert got["admitted"] == want["admitted"]
        assert got["state"] == want["state"], f"{layout} {split}"
        assert got["state"] == got["twin_state"]  # the emulated fleet's
        if split == "g44":
            assert got["moves"] == want["moves"] == got["twin_moves"]
            assert (got["rebalance"]["routes"], got["rebalance"]["moved"]) \
                == tuple(want["rebalance"])
        else:
            assert [(s["ok"], s["routes"], s["moved"])
                    for s in got["steps"]] == \
                [(ok, routes, moved) for ok, routes, moved in want["steps"]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("split", list(W.SPLITS))
def test_served_rows_equal_emulated_fleet(fleets, layout, split):
    res = fleets[layout]
    for r in res:
        for s in r[split]["served"]:
            where = f"{layout} {split} {s['tenant']} round {s['round']}"
            assert s["equal"], where
            assert s["err64"] <= TOL, where
    # the processes' rows tile each served C once
    sizes, tenants = W.SPLITS[split]
    for i, s in enumerate(res[0][split]["served"]):
        assert sum(r[split]["served"][i]["rows"] for r in res) == \
            tenants[s["tenant"]][0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rebalance_reshards_across_processes(fleets, layout):
    for r in fleets[layout]:
        got = r["g44"]["rebalance"]
        assert got["resident_b"] and got["resident_c"], r["spans"]
        rec = got["reshard"]
        # the same P on both sides: the reference moves no row between
        # ranks, but every row leaves its process (group 1 -> group 0)
        n = W.TENANTS[rec["tenant"]][0]
        assert [rec["b_rows"], rec["c_rows"]] == got["moved"] == [0, 0]
        assert rec["b_rows_crossing"] == rec["c_rows_crossing"] == n
        assert rec["bytes_crossing"] == 2 * n * W.N_COLS * 4


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_straddling_group_migration(fleets, layout):
    res = fleets[layout]
    n = W.STRADDLE["s"][0]
    for r in res:
        (step,) = r["g26"]["steps"]
        assert step["ok"] and step["ok_twin"] and step["to"] == 1
        assert step["resident_b"] and step["resident_c"]
        rec = step["reshard"]
        assert [rec["b_rows"], rec["c_rows"]] == step["moved"]
        assert 0 < step["moved"][0] < n
        # rows whose old rank (group 0, ranks [0, 2)) and new rank (group
        # 1, ranks [2, 8)) sit on different processes: some on 2 × 4,
        # all on 4 × 2
        w = LAYOUTS[layout][1]
        cross = sum(hi - lo for s, d, lo, hi in step["routes"]["b"]
                    if s // w != (2 + d) // w)
        assert cross == (n if layout == "4x2" else n * 2 // 3)
        assert rec["b_rows_crossing"] == rec["c_rows_crossing"] == cross
        assert rec["bytes_crossing"] == 2 * cross * W.N_COLS * 4
    assert len({json.dumps(r["g26"]["steps"][0]["reshard"])
                for r in res}) == 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_process_fault_rolls_back_everywhere(fleets, layout):
    res = fleets[layout]
    for i, r in enumerate(res):
        rb = r["g44"]["rollback"]
        assert rb["fired"] == int(i == W.FAULT_PROCESS)
        assert not rb["ok"] and not rb["ok_twin"]
        st = r["g44"]["state"]
        assert (st["migrations"], st["failed_migrations"]) == (1, 1)
        assert st["events"][-1]["action"] == "migrate_rollback"
    assert len({json.dumps(r["g44"]["state"]) for r in res}) == 1
    assert reference("g44")["rollback_ok"] is False


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_no_wave_dropped(fleets, layout):
    for r in fleets[layout]:
        for split in W.SPLITS:
            assert set(r[split]["dropped"].values()) == {0}
