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

Run from the repo root (host planning only, a few minutes of CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_fleet_pins.py
"""
import argparse
import pprint
from types import SimpleNamespace

from repro.core.api import SpmmConfig, _plan_and_tune
from repro.core.sparse import power_law_sparse, random_sparse
from repro.distributed.topology import Topology
from repro.models.gnn import normalize_adjacency

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


def plan_cells(cells, mats, keys, fleet_rows: bool) -> dict:
    topo, out = fleet_topology(), {}
    for what, mat, fields in cells:
        plan, hier, sched, dec = _plan_and_tune(
            mats[mat], NPROC * LOCAL, SpmmConfig(**fields), topo)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=SCALE,
                    help="nodes and edges / SCALE (1: the full-size cells)")
    args = ap.parse_args()
    mp, train = {}, {}
    for key, m0, nnz0 in (("full", M_FULL, NNZ_FULL),
                          ("quick", 16_384, 7 * 16_384)):
        m, nnz = m0 // args.scale, nnz0 // args.scale
        print(f"# {key}: {m} nodes, {nnz} edges")
        mats = {"power_law": power_law_sparse(m, m, nnz, 0.8, seed=0),
                "uniform": random_sparse(m, m, nnz / m ** 2, seed=0)}
        mp[key] = plan_cells(MP_CELLS, mats, MP_KEYS, True)
        mats = {k: normalize_adjacency(a) for k, a in mats.items()}
        train[key] = plan_cells(MP_TRAIN_CELLS, mats, TRAIN_KEYS, False)
    print("EXPECT_MP =", pprint.pformat(mp))
    print("EXPECT_MP_TRAIN =", pprint.pformat(train))


if __name__ == "__main__":
    main()
