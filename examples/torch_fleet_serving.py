"""Multi-tenant fleet serving with a forced rebalance migration.

    PYTHONPATH=src python examples/torch_fleet_serving.py
    PYTHONPATH=src python examples/torch_fleet_serving.py --device cpu

The PyTorch counterpart of ``examples/fleet_serving.py``: carves
``Topology.local(8)`` into two groups of 4 ranks (on one device, each
group a span of the emulated ranks), admits three sparsity patterns (two
heavy, one light — the heavies' fingerprint hashes land them on the SAME
group, a deliberately imbalanced start), serves a wave per tenant, then
lets ``fleet.rebalance()`` migrate one heavy tenant to the idle group by
the host-side ``ReshardSpec`` path. A drift replan on the migrated tenant
closes the loop. The run asserts the serving contract the fleet
guarantees — ``dropped_waves == 0`` for every tenant across admit ->
migrate -> drift — and prints one ``dropped_waves=0`` line per tenant.
"""
import argparse

import numpy as np

from repro_torch import SpmmConfig, SpmmFleet, Topology
from repro_torch.core.sparse import power_law_sparse

# n_dense_hint drives the beta (volume) term of the placement model so
# heavy and light patterns score differently; at tiny hints every
# pattern is alpha-dominated and no rebalance would ever trigger
FLEET_CFG = SpmmConfig(n_dense_hint=4096)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    fleet = SpmmFleet(Topology.local(8, args.device), group_sizes=(4, 4),
                      config=FLEET_CFG, rebalance_threshold=0.25)

    patterns = {
        "heavy-a": power_law_sparse(512, 512, 16000, 1.2, seed=0),
        "heavy-b": power_law_sparse(512, 512, 16000, 1.2, seed=3),
        "light": power_law_sparse(64, 64, 300, 1.2, seed=0),
    }
    for name, a in patterns.items():
        gi = fleet.admit(name, a)
        print(f"admitted {name!r} -> group {gi}")

    rng = np.random.default_rng(0)
    bs = {name: rng.standard_normal((a.shape[1], 8)).astype(np.float32)
          for name, a in patterns.items()}
    for name, b in bs.items():
        fleet.submit(name, b)
    served = fleet.serve()
    print(f"round 1 served: { {n: len(v) for n, v in served.items()} }")

    imb = fleet.imbalance()
    print(f"imbalance {imb:.2f} vs threshold {fleet.threshold:.2f}")
    moves = fleet.rebalance()
    assert moves, "expected the imbalanced start to force a migration"
    for name, dst in moves:
        print(f"migrated {name!r} -> group {dst} "
              f"(imbalance now {fleet.imbalance():.2f})")

    # the migrated tenant's pattern drifts; the replan + warm swap stays
    # off the wave path and re-scores the tenant's placement
    migrated = moves[0][0]
    drift, replanned = fleet.maybe_replan(
        migrated, power_law_sparse(512, 512, 16000, 1.2, seed=91))
    print(f"drift {drift:.2f} on {migrated!r} -> replanned={replanned}")

    for name, b in bs.items():
        fleet.submit(name, b)
    fleet.serve()

    stats = fleet.stats()
    assert stats["migrations"] >= 1
    for name, t in stats["tenants"].items():
        dropped = t["server"]["dropped_waves"]
        print(f"tenant={name} group={t['group']} waves={t['server']['waves']} "
              f"served={t['server']['served']} dropped_waves={dropped}")
        assert dropped == 0, f"tenant {name!r} dropped a wave"
    print(f"fleet ok: {stats['migrations']} migration(s), "
          f"0 dropped waves across {len(stats['tenants'])} tenants")


if __name__ == "__main__":
    main()
