"""The decisions ``chip_smoke.py`` pins for its phase 9 (serving waves and
the SpmmFleet), derived with the JAX package's host planner on the CPU.

Phase 9 runs on a quarter of ogbn-arxiv's size (169,344 / 4 nodes,
1,166,243 // 4 edges; the same generators and seeds as phase 8's
measured cells, ``chip_smoke.LIFE_SCALE``). This script builds the same
matrices with ``repro.core.sparse`` and prints, as Python literals:

* the rungs of ``SpmmSession.build(power-law, 8, SpmmConfig(hier="auto"),
  p_ladder=(4, 8))`` (``EXPECT_SERVE_LADDER``);
* the three tenants' placements and scores on ``SpmmFleet(Topology.
  local(8), (4, 4), SpmmConfig(n_dense_hint=128))`` in both admission
  orders, the modeled imbalance before and after ``rebalance`` and its
  moves, and the uniform tenant on ``(4, 2)`` with ``backends=("bsr",
  "coo")``, ``p_ladder=(2, 4)``: its group, scores, the move's P and the
  B / C rows a reshard moves (``EXPECT_FLEET``).

Run from the repo root (host planning only, a few minutes of CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python scripts/reference_phase9_pins.py [--quick]
"""
import argparse
import os
import pprint

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

from repro.core.api import SpmmConfig  # noqa: E402
from repro.core.session import SpmmSession  # noqa: E402
from repro.core.sparse import (  # noqa: E402
    block_rows, power_law_sparse, random_sparse,
)
from repro.distributed.topology import Topology  # noqa: E402
from repro.serving.fleet import ReshardSpec, SpmmFleet  # noqa: E402

M_FULL, NNZ_FULL, SCALE = 169_344, 1_166_243, 4
N_COLS = 128
FLEET_H2_SEED = 1
FLEET_LIGHT = dict(m=16_384, nnz=7 * 16_384, seed=0)
FLEET_LIGHT_QUICK = dict(m=1024, nnz=7 * 1024, seed=0)  # below --quick's
RUNG_KEYS = ("strategy", "P", "G", "L", "schedule_kind", "schedule_K",
             "overlap", "modeled_time_flat", "modeled_time_hier",
             "volume_rows", "volume_rows_padded",
             "volume_rows_padded_single", "pattern_nnz")


def matrices(quick: bool):
    m = (16_384 if quick else M_FULL) // SCALE
    nnz = (7 * 16_384 if quick else NNZ_FULL) // SCALE
    return (m, nnz, random_sparse(m, m, nnz / m ** 2, seed=0),
            power_law_sparse(m, m, nnz, 0.8, seed=0))


def ladder(a_p):
    s = SpmmSession.build(a_p, 8, SpmmConfig(hier="auto"), p_ladder=(4, 8))
    out = {}
    for p in (8, 4):
        st = s.on_resize(p).stats()
        out[p] = {k: st[k] for k in RUNG_KEYS if k in st
                  and not (k in ("G", "L") and st["strategy"] != "hier")}
    return out


def fleet(m, nnz, a_u, a_p, lt):
    mats = {"h1": a_p,
            "h2": power_law_sparse(m, m, nnz, 0.8, seed=FLEET_H2_SEED),
            "lt": power_law_sparse(lt["m"], lt["m"], lt["nnz"], 0.8,
                                   seed=lt["seed"])}
    cfg = SpmmConfig(n_dense_hint=N_COLS)
    placements = []
    for order in (("lt", "h2", "h1"), ("h1", "h2", "lt")):
        f = SpmmFleet(Topology.local(8), group_sizes=(4, 4), config=cfg)
        for name in order:
            f.admit(name, mats[name])
        placements.append(f.placements())
    assert placements[0] == placements[1], placements
    scores = {n: t.scores for n, t in f.tenants.items()}
    imb = f.imbalance()
    plans = {n: t.session.handle().plan for n, t in f.tenants.items()}
    moves = f.rebalance()
    after = f.imbalance()
    name = moves[0][0] if moves else None
    moved = {"b_rows": 0, "c_rows": 0}
    if name is not None:
        old = plans[name]
        new = f.tenants[name].session.handle().plan
        moved = {"b_rows": ReshardSpec.between(
                     block_rows(old.shape[1], old.P),
                     block_rows(new.shape[1], new.P)).moved_rows(),
                 "c_rows": ReshardSpec.between(
                     tuple(old.bounds), tuple(new.bounds)).moved_rows()}

    cross_cfg = SpmmConfig(backends=("bsr", "coo"), n_dense_hint=N_COLS)
    g = SpmmFleet(Topology.local(8), group_sizes=(4, 2), config=cross_cfg)
    gi = g.admit("u", a_u, p_ladder=(2, 4))
    t = g.tenants["u"]
    old = t.session.handle().plan
    assert g.migrate("u", 1 - gi)
    new = t.session.handle().plan
    cross = dict(group=gi, scores=t.scores, P=(old.P, new.P), moved={
        "b_rows": ReshardSpec.between(block_rows(old.shape[1], old.P),
                                      block_rows(new.shape[1], new.P)
                                      ).moved_rows(),
        "c_rows": ReshardSpec.between(tuple(old.bounds), tuple(new.bounds)
                                      ).moved_rows()})
    return dict(placements=placements[0], scores=scores,
                imbalance=(imb, after), moves=moves, moved=moved,
                cross=cross)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="chip_smoke.py --quick's sizes (16,384 // 4 nodes)")
    args = ap.parse_args()
    m, nnz, a_u, a_p = matrices(args.quick)
    print(f"# {m} nodes, {nnz} edges (uniform nnz {a_u.nnz}, power-law "
          f"nnz {a_p.nnz})")
    print("EXPECT_SERVE_LADDER =", pprint.pformat(ladder(a_p)))
    lt = FLEET_LIGHT_QUICK if args.quick else FLEET_LIGHT
    print("EXPECT_FLEET =", pprint.pformat(fleet(m, nnz, a_u, a_p, lt)))


if __name__ == "__main__":
    main()
