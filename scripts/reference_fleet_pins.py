"""The decisions ``chip_smoke.py`` pins for its two fleet phases, 11
(``EXPECT_MP``: SpMM handles) and 12 (``EXPECT_MP_TRAIN``: the GCN / GAT
training handles), derived with the JAX package's host planner on the
CPU.

Both phases' cells run on a quarter of ogbn-arxiv's size (169,344 / 4
nodes, 1,166,243 // 4 edges; ``chip_smoke.LIFE_SCALE``, the generators
and seeds of the full-size cells), on a fleet of 2 processes × 4 ranks
on a GPU: ``net="auto"`` derives ``derived-gpu-2x4`` (450 / 25 GB/s,
group 4) and ``hier="auto"`` takes the fleet's tiers (2, 4). This script
builds the same matrices with ``repro.core.sparse`` (phase 12's through
``repro.models.gnn.normalize_adjacency``), stands a reference
``Topology`` of that shape in for the fleet (eight stand-in devices on
the platform "gpu": the planner reads only the platform and the tiers,
never a device), runs ``repro.core.api._plan_and_tune`` for each cell's
config, and prints both tables as Python literals. Phase 11's also
holds the padded rows a call sends between the two processes (the
count ``DistSpmm.plan_crossing_rows`` makes, on the reference's
schedule) and the unpadded slow-tier rows (B, C) of the plan and of its
flat plan. ``--scale 1`` gives the full-size pins, which the script
reproduces as a check of itself.

Phase 11 (b)'s fleet sessions get theirs too. ``EXPECT_MP_DISPATCH``:
olmoe-1b-7b's dispatch of 1024 tokens over M = 8 (``--quick``: its smoke
config), the handle's decisions, then ``dispatch_session`` through
``maybe_replan``'s three branches (the planned routing, its values
halved, the seed-1 routing): each step's decisions and return, and the
events. ``EXPECT_MP_RUNG``: a session with rungs (4, 6, 8) on the
power-law (flat, coo) and uniform (``hier="auto"``, bsr) matrices, the
decisions at each step (rung 8, ``on_resize(6)``, ``on_resize(4)``, the
carved group [2, 6), back to 8) and the events. Both run the reference's
``SpmmSession`` itself on eight host devices as a (2, 4) mesh with the
fleet's derived network named (``net=derived-gpu-2x4``), and each rung's
decisions are checked against ``_plan_and_tune`` on the fleet stand-in.
The quick rungs use 4080 nodes (4096 rounded down to 24 | M: six ranks
need equal row blocks).

``EXPECT_MP_FLEET``: phase 11 (b)'s ``mp_fleet``, the reference's
``SpmmFleet`` on the same (2, 4) stand-in with ``SpmmConfig(n_dense_hint=
128)`` (a carved group has no tiers, so ``net="auto"`` scores each group
on the model's default network, as the port's carved groups do). Split
(4, 4): phase 9's three tenants (h1 the quarter power-law matrix, h2 its
seed-1 twin, lt the 16,384-node one; ``--quick``: 1,024) admitted, a
served round, ``rebalance()``, a served round, a migration that an
injected ``fleet_migrate_fail`` rolls back: the admissions, scores,
imbalance before and after, moves, each migration's B / C reshard routes
and moved rows, the counters and the events. Split (2, 6): h1 with rungs
(2, 6) (its rows cut to a multiple of 24 under ``--quick``), a served
round and a migration into group 1: the same fields.

Run from the repo root (host planning only, a few minutes of CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_fleet_pins.py
"""
import argparse
import dataclasses
import json
import os
import pprint
from types import SimpleNamespace

import numpy as np

# the sessions' handles live on eight host devices
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.core.api import SpmmConfig, _plan_and_tune  # noqa: E402
from repro.core.comm_model import NetworkSpec  # noqa: E402
from repro.core.session import SpmmSession  # noqa: E402
from repro.core.sparse import (block_rows, power_law_sparse,  # noqa: E402
                               random_sparse)
from repro.distributed.topology import Topology  # noqa: E402
from repro.launch.mesh import make_spmm_mesh  # noqa: E402
from repro.models.gnn import normalize_adjacency  # noqa: E402
from repro.models.moe import dispatch_matrix, dispatch_session  # noqa: E402
from repro.robustness import Fault, inject  # noqa: E402
from repro.serving.fleet import ReshardSpec, SpmmFleet  # noqa: E402

M_FULL, NNZ_FULL, SCALE = 169_344, 1_166_243, 4
NPROC, LOCAL = 2, 4
# (what, matrix, config fields): chip_smoke.MP_CELLS and MP_TRAIN_CELLS
MP_CELLS = (("mp-powerlaw-arxiv flat", "power_law", dict(backends=("coo",))),
            ("mp-powerlaw-arxiv hier", "power_law",
             dict(backends=("coo",), hier="auto")),
            ("mp-uniform-arxiv hier", "uniform",
             dict(backends=("bsr",), hier="auto")))
MP_TRAIN_CELLS = (("mp-gcn-train-arxiv flat", "power_law", {}),
                  ("mp-gcn-train-arxiv hier", "power_law",
                   dict(hier="auto")),
                  ("mp-gat-train-arxiv", "uniform",
                   dict(kernel="fused", edge="leaky_relu")))
MP_KEYS = ("strategy", "G", "L", "net", "schedule_kind", "schedule_K",
           "overlap", "modeled_time_flat", "modeled_time_hier",
           "volume_rows", "volume_rows_padded")
# chip_smoke.MP_RUNG_CELLS / MP_DISPATCH
MP_RUNG_CELLS = (("mp-powerlaw-arxiv flat", "power_law",
                  dict(backends=("coo",))),
                 ("mp-uniform-arxiv hier", "uniform",
                  dict(backends=("bsr",), hier="auto")))
MP_LADDER = (4, 6, 8)
RUNG_STEPS = ("p8", "p6", "p4", "group26", "back8")
DISPATCH = dict(arch="olmoe-1b-7b", tokens=1024, M=8)
DRIFTS = ("drift_ok", "values_refresh", "drift_replan")
DISPATCH_KEYS = ("strategy", "plan_strategy", "net", "shape", "backends",
                 "schedule_kind", "schedule_K", "overlap",
                 "modeled_time_schedule", "volume_rows",
                 "volume_rows_padded", "volume_rows_padded_single",
                 "pattern_nnz")
# the network ``net="auto"`` derives on the GPU fleet
FLEET_NET = NetworkSpec("derived-gpu-2x4", 450e9, 25e9, group_size=LOCAL)
TRAIN_KEYS = ("strategy", "G", "L", "net", "schedule_kind", "schedule_K",
              "overlap", "modeled_time_flat", "modeled_time_hier",
              "modeled_time_schedule", "modeled_time_fused", "volume_rows",
              "volume_rows_padded")


def fleet_topology() -> Topology:
    """2 processes × 4 GPU ranks, as ``Topology.multiprocess()`` gives it
    on such a fleet."""
    devs = tuple(SimpleNamespace(platform="gpu", id=i)
                 for i in range(NPROC * LOCAL))
    return Topology(kind="multiprocess", devices=devs, tiers=(NPROC, LOCAL),
                    n_hosts=NPROC, process_index=0, local_device_count=LOCAL)


def crossing_rows(sched, hier, P: int) -> int:
    """The padded rows one call sends between processes (the port's
    ``DistSpmm.plan_crossing_rows``): a shift-d peer is remote when it
    sits on the other process (a hier shift moves every rank by d·L)."""
    w, stride = P // NPROC, 1 if hier is None else hier.L

    def crossing(d):
        return sum(q // w != (q + d * stride) % P // w for q in range(P))

    if sched.kind == "single":
        return (sched.max_b + sched.max_c) * sum(crossing(d)
                                                 for d in range(sched.P))
    return sum((sched.slots_b[d - 1] + sched.slots_c[d - 1]) * crossing(d)
               for d in range(1, sched.P))


def slow_tier_rows(plan):
    """(B rows, C rows) of a flat plan between ranks of different
    processes (``HierPlan.inter_group_rows_flat``)."""
    b = c = 0
    for (p, q), pp in plan.pair_plans.items():
        if p // LOCAL != q // LOCAL:
            b += pp.col_ids.size
            c += pp.row_ids.size
    return b, c


def plan_cells(cells, mats, keys, fleet_rows: bool,
               P_of=lambda what: NPROC * LOCAL) -> dict:
    topo, out = fleet_topology(), {}
    for what, mat, fields in cells:
        plan, hier, sched, dec = _plan_and_tune(
            mats[mat], P_of(what), SpmmConfig(**fields), topo)
        # the fields ``DistSpmm.stats()`` adds to the decisions
        stats = dict(dec, strategy="flat" if hier is None else "hier",
                     schedule_kind=sched.kind,
                     schedule_K=sched.K if sched.kind == "bucketed" else 1,
                     overlap=bool(dec.get("overlap", False)),
                     volume_rows=plan.volume_rows(),
                     volume_rows_padded=sched.volume_rows_padded())
        if hier is not None:
            stats.update(G=hier.G, L=hier.L)
        got = {k: float(stats[k]) if isinstance(stats[k], float)
               else stats[k] for k in keys if k in stats}
        if fleet_rows:
            got["crossing_padded"] = crossing_rows(sched, hier,
                                                   NPROC * LOCAL)
            got["slow_tier_rows"] = (tuple(hier.inter_group_rows())
                                     if hier is not None
                                     else slow_tier_rows(plan))
            got["slow_tier_rows_flat_plan"] = slow_tier_rows(plan)
        out[what] = got
    return out


def _json(x):
    return json.loads(json.dumps(x, default=list))


def _stats(h, keys):
    st = h.stats()
    return _json({k: st[k] for k in keys if k in st})


def mesh_topology() -> Topology:
    """Eight host devices as the fleet's (2, 4): the same tiers."""
    return Topology.from_mesh(make_spmm_mesh(NPROC * LOCAL, groups=NPROC))


def rung_sessions(mats) -> dict:
    """Each rung cell's session through the steps phase 11 (b) takes:
    {what: {step: decisions, "events": [...]}}; every rung's decisions
    also equal ``_plan_and_tune``'s on the fleet stand-in."""
    topo, out = mesh_topology(), {}
    planned = plan_cells([(f"{w} P={P}", m, f) for w, m, f in MP_RUNG_CELLS
                          for P in MP_LADDER], mats, MP_KEYS, False,
                         P_of=lambda what: int(what.rsplit("=", 1)[1]))
    for what, mat, fields in MP_RUNG_CELLS:
        sess = SpmmSession.build(mats[mat], topo,
                                 SpmmConfig(**fields, net=FLEET_NET),
                                 p_ladder=MP_LADDER)
        steps = {"p8": sess.handle, "p6": lambda: sess.on_resize(6),
                 "p4": lambda: sess.on_resize(4),
                 "group26": lambda: sess.adopt_topology(
                     topo.subtopology(slice(2, 6))),
                 "back8": lambda: sess.on_resize(topo)}
        got = {}
        for step in RUNG_STEPS:
            h = steps[step]()
            got[step] = _stats(h, MP_KEYS)
            assert got[step] == _json(planned[f"{what} P={h.plan.P}"]), \
                (what, step)
        got["events"] = [{k: v for k, v in e.items() if k != "topology"}
                         for e in _json(sess.events)]
        out[what] = got
    return out


def dispatch_pins(cfg) -> dict:
    """The dispatch handle and session on the fleet's network."""
    T, M = DISPATCH["tokens"], DISPATCH["M"]
    a = dispatch_matrix(cfg, T, M)
    config = SpmmConfig(strategy="joint", schedule="auto", net=FLEET_NET)
    sess = dispatch_session(cfg, T, M, where=mesh_topology(), config=config)
    out = {"handle": _stats(sess.handle(), DISPATCH_KEYS)}
    # the handle's decisions on the stand-in, with net="auto"
    plan, hier, sched, dec = _plan_and_tune(
        a, M, SpmmConfig(strategy="joint", schedule="auto"),
        fleet_topology())
    assert (dec["net"], sched.volume_rows_padded()) == (
        out["handle"]["net"], out["handle"]["volume_rows_padded"])
    drifted = {"drift_ok": a,
               "values_refresh": dataclasses.replace(a, data=a.data * 0.5),
               "drift_replan": dispatch_matrix(cfg, T, M, seed=1)}
    for name in DRIFTS:
        out[f"replan-{name}"] = list(sess.maybe_replan(drifted[name]))
        out[name] = _stats(sess.handle(), DISPATCH_KEYS)
    out["events"] = _json(sess.events)
    return out


# chip_smoke.MP_FLEET: phase 9's tenants (chip_smoke.FLEET_*), on a fleet
MP_FLEET = dict(cols=128, h2_seed=1, light=dict(m=16_384, nnz=7 * 16_384,
                                                seed=0),
                light_quick=dict(m=1024, nnz=7 * 1024, seed=0),
                split=(4, 4), order=("h1", "h2", "lt"), straddle=(2, 6),
                ladder=(2, 6))


def _routes(old, new) -> dict:
    """A migration's reshard routes and moved rows (B, then C)."""
    b = ReshardSpec.between(block_rows(old.shape[1], old.P),
                            block_rows(new.shape[1], new.P))
    c = ReshardSpec.between(tuple(old.bounds), tuple(new.bounds))
    return {"b_routes": [list(r) for r in b.routes],
            "c_routes": [list(r) for r in c.routes],
            "moved": [b.moved_rows(), c.moved_rows()]}


def _fleet_state(fleet) -> dict:
    return _json({"placements": fleet.placements(),
                  "scores": {n: {g: list(v) for g, v in t.scores.items()}
                             for n, t in fleet.tenants.items()},
                  "imbalance": fleet.imbalance(),
                  "migrations": fleet.migrations,
                  "failed_migrations": fleet.failed_migrations,
                  "events": fleet.events})


def mp_fleet_pins(m: int, nnz: int, light: dict) -> dict:
    """The reference fleet through ``mp_fleet``'s steps."""
    topo = mesh_topology()
    cfg = SpmmConfig(n_dense_hint=MP_FLEET["cols"])
    mats = {"h1": power_law_sparse(m, m, nnz, 0.8, seed=0),
            "h2": power_law_sparse(m, m, nnz, 0.8,
                                   seed=MP_FLEET["h2_seed"]),
            "lt": power_law_sparse(light["m"], light["m"], light["nnz"],
                                   0.8, seed=light["seed"])}

    def serve(fleet):
        for n, t in fleet.tenants.items():
            fleet.submit(n, np.zeros((mats[n].shape[1], MP_FLEET["cols"]),
                                     np.float32))
        fleet.serve()

    def plan(fleet, n):
        return fleet.tenants[n].session.handle().plan

    fleet = SpmmFleet(topo, MP_FLEET["split"], config=cfg)
    for n in MP_FLEET["order"]:
        fleet.admit(n, mats[n])
    out = {"admitted": _fleet_state(fleet)}
    serve(fleet)
    old = {n: plan(fleet, n) for n in mats}
    out["moves"] = [list(mv) for mv in fleet.rebalance()]
    out["rebalance"] = [_routes(old[n], plan(fleet, n))
                        for n, _ in out["moves"]]
    serve(fleet)
    name = out["moves"][0][0] if out["moves"] else "h1"
    src = fleet.placements()[name]
    with inject([Fault(kind="wave_error", site="fleet_migrate_fail")]):
        out["rollback"] = [name, 1 - src, fleet.migrate(name, 1 - src)]
    out["state"] = _fleet_state(fleet)
    # split (2, 6): a migration into the straddling group
    m26 = m - m % 24
    a26 = mats["h1"] if m26 == m else power_law_sparse(m26, m26, nnz, 0.8,
                                                       seed=0)
    mats["h1"] = a26
    f26 = SpmmFleet(topo, MP_FLEET["straddle"], config=cfg)
    f26.admit("h1", a26, p_ladder=MP_FLEET["ladder"])
    out["straddle_admitted"] = _fleet_state(f26)
    serve(f26)
    out["straddle"] = []
    for dst in ((1,) if f26.placements()["h1"] == 0 else (0, 1)):
        old = plan(f26, "h1")
        ok = f26.migrate("h1", dst)
        out["straddle"].append(dict(to=dst, ok=ok,
                                    **_routes(old, plan(f26, "h1"))))
        serve(f26)
    out["straddle_state"] = _fleet_state(f26)
    out["straddle_rows"] = m26
    return out


def matrices(m: int, nnz: int) -> dict:
    return {"power_law": power_law_sparse(m, m, nnz, 0.8, seed=0),
            "uniform": random_sparse(m, m, nnz / m ** 2, seed=0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=SCALE,
                    help="nodes and edges / SCALE (1: the full-size cells)")
    args = ap.parse_args()
    mp, train, rungs, disp, fleets = {}, {}, {}, {}, {}
    for key, m0, nnz0 in (("full", M_FULL, NNZ_FULL),
                          ("quick", 16_384, 7 * 16_384)):
        m, nnz = m0 // args.scale, nnz0 // args.scale
        print(f"# {key}: {m} nodes, {nnz} edges")
        mats = matrices(m, nnz)
        mp[key] = plan_cells(MP_CELLS, mats, MP_KEYS, True)
        m_r = m - m % 24  # equal row blocks over 4, 6 and 8 ranks
        if m_r != m:
            print(f"# {key} rungs: {m_r} nodes")
        rungs[key] = rung_sessions(mats if m_r == m else matrices(m_r, nnz))
        disp[key] = dispatch_pins((get_config if key == "full"
                                   else get_smoke_config)(DISPATCH["arch"]))
        fleets[key] = mp_fleet_pins(
            m, nnz, MP_FLEET["light" if key == "full" else "light_quick"])
        mats = {k: normalize_adjacency(a) for k, a in mats.items()}
        train[key] = plan_cells(MP_TRAIN_CELLS, mats, TRAIN_KEYS, False)
    print("EXPECT_MP =", pprint.pformat(mp))
    print("EXPECT_MP_TRAIN =", pprint.pformat(train))
    print("EXPECT_MP_RUNG =", pprint.pformat(rungs))
    print("EXPECT_MP_DISPATCH =", pprint.pformat(disp))
    print("EXPECT_MP_FLEET =", pprint.pformat(fleets))


if __name__ == "__main__":
    main()
