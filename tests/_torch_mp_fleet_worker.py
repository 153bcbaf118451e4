"""One worker of the CPU fleets that ``test_torch_fleet_processes``
launches (``launch_local(n, w, device="cpu", argv=[python, this, out])``):
``SpmmFleet`` tenants on the groups of a process fleet.

Every process runs the same steps on ``SpmmFleet(Topology.multiprocess(),
...)`` and on the emulated twin, ``SpmmFleet(Topology.local(8), ...)``
of the same split, in the same process, and writes what it saw to
``<out>/rank<i>.json`` (its C rows to ``<out>/rank<i>.npz``):

* split (4, 4): three tenants admitted (two 512-node power-law heavies
  and a 64-node light one, ``tests/test_torch_fleet.py``'s), a served
  round, ``rebalance()`` (a heavy moves between the groups, across the
  process boundary), a served round, a migration that a fault injected
  on process 1 ALONE rolls back on every process, a served round;
* split (2, 6): one 384-node tenant with rungs (2, 6) (2, 6 and 8 ranks
  hold equal row blocks), a served round and a migration into group 1
  (ranks [2, 8): it straddles the processes), then a served round.

Recorded: placements, scores, group loads, imbalance, counters, events,
each migration's reshard routes (B and C), its moved rows and the rows
and bytes that crossed processes; each served C's rows against the
twin's (``torch.equal``) and float64's; after each migration, the
resident B and C slabs against the served B and C rows under the new
partition; ``dropped_waves``. It imports no JAX; the test compares the
decisions with the JAX package.
"""
import json
import os
import sys

import numpy as np
import torch

from repro_torch import ReshardSpec, SpmmConfig, SpmmFleet, Topology
from repro_torch.core.sparse import block_rows, power_law_sparse
from repro_torch.launch.multiprocess import initialize, shutdown
from repro_torch.robustness.faults import Fault, inject

P, N_COLS = 8, 8
CONFIG = dict(n_dense_hint=4096)
# tests/test_torch_fleet.py's tenants: the fingerprint hash puts both
# heavies on group 1 and the light one on group 0, which rebalance fixes
TENANTS = {"h0": (512, 16000, 0), "h3": (512, 16000, 3), "lt": (64, 300, 0)}
STRADDLE = {"s": (384, 9000, 5)}  # the (2, 6) split's tenant
FAULT_PROCESS = 1  # the one process whose fleet_migrate_fail fires
SPLITS = {"g44": ((4, 4), TENANTS), "g26": ((2, 6), STRADDLE)}
LADDER26 = (2, 6)  # a rung for each group: group 1 serves on all 6 ranks


def matrix(spec):
    n, nnz, seed = spec
    return power_law_sparse(n, n, nnz, 1.2, seed=seed)


def operand(name, spec, round_):
    seed = 100 + 10 * round_ + sorted(TENANTS | STRADDLE).index(name)
    return np.random.default_rng(seed).standard_normal(
        (spec[0], N_COLS)).astype(np.float32)


def dense64(a):
    out = np.zeros(a.shape, np.float64)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    np.add.at(out, (rows, a.indices), a.data.astype(np.float64))
    return out


def state(fleet):
    """The host-side fleet state, JSON-ready."""
    return json.loads(json.dumps({
        "placements": fleet.placements(),
        "scores": {n: {str(g): list(v) for g, v in t.scores.items()}
                   for n, t in fleet.tenants.items()},
        "group_loads": fleet.group_loads(), "imbalance": fleet.imbalance(),
        "migrations": fleet.migrations,
        "failed_migrations": fleet.failed_migrations,
        "current_P": {n: t.session.current_P
                      for n, t in fleet.tenants.items()},
        "events": fleet.events}, default=str))


class Run:
    """One split on the process fleet and on its emulated twin. The
    operands go in as numpy arrays, or with ``tensors`` as whole tensors
    on the fleet's device (the residents are then views of them)."""

    def __init__(self, topo, sizes, tenants, arrays, key, ladder=None,
                 tensors=False):
        self.mats = {n: matrix(s) for n, s in tenants.items()}
        self.specs, self.arrays, self.key = tenants, arrays, key
        self.tensors = tensors
        cfg = SpmmConfig(**CONFIG)
        self.fleet = SpmmFleet(topo, sizes, config=cfg, device="cpu")
        self.twin = SpmmFleet(Topology.local(P, "cpu"), sizes, config=cfg,
                              device="cpu")
        self.served, self.rounds = [], 0
        self.whole = {}  # tenant -> the last served (B, twin's C)
        for name, a in self.mats.items():
            self.fleet.admit(name, a, p_ladder=ladder)
            self.twin.admit(name, a, p_ladder=ladder)

    def serve(self):
        self.rounds += 1
        bs = {n: operand(n, s, self.rounds) for n, s in self.specs.items()}
        for n in self.mats:
            b = torch.from_numpy(bs[n]) if self.tensors else bs[n]
            self.fleet.submit(n, b)
            self.twin.submit(n, b)
        got, want = self.fleet.serve(), self.twin.serve()
        for n in self.mats:
            (c,), (ce,) = got[n], want[n]
            h = self.fleet.tenants[n].session.handle()
            blocks = h.row_blocks()
            rows = torch.cat([ce[lo:hi] for lo, hi in blocks]) if blocks \
                else ce[:0]
            c64 = dense64(self.mats[n]) @ bs[n].astype(np.float64)
            mine = np.concatenate([c64[lo:hi] for lo, hi in blocks]) \
                if blocks else c64[:0]
            self.arrays[f"{self.key}/{n}/round{self.rounds}"] = c.numpy()
            self.whole[n] = (bs[n], ce)
            self.served.append({
                "tenant": n, "round": self.rounds, "P": h.P,
                "blocks": blocks, "rows": int(c.shape[0]),
                "equal": bool(torch.equal(c, rows)),
                "err64": float(np.abs(c.numpy() - mine).max())
                if c.numel() else 0.0})

    def migrate(self, name, dst, fault_here=False):
        """Both fleets migrate; on the fleet a fault may fire on this
        process only. Returns the fleet's outcome and its residents'
        check."""
        old = self.fleet.tenants[name].session.handle().plan
        faults = [Fault(kind="wave_error", site="fleet_migrate_fail")] \
            if fault_here else []
        with inject(faults) as plan:
            ok = self.fleet.migrate(name, dst)
        fired = plan.fired("wave_error")
        # the twin takes the decision the fleet agreed on
        with inject([] if ok else [Fault(kind="wave_error",
                                         site="fleet_migrate_fail")]):
            ok_twin = self.twin.migrate(name, dst)
        out = {"ok": ok, "ok_twin": ok_twin, "fired": fired,
               "routes": None}
        if ok:
            out.update(self.residents(name, old))
        return out

    def residents(self, name, old):
        """The tenant's resident slabs after a migration against the
        served B and C rows under the new partition."""
        t = self.fleet.tenants[name]
        h = t.session.handle()
        new = h.plan
        lo, hi = h.topology.span
        b, c = self.whole[name]
        b = torch.from_numpy(b)
        b_bounds = block_rows(new.shape[1], new.P)[lo:hi]
        c_bounds = list(new.bounds)[lo:hi]
        spec_b = ReshardSpec.between(block_rows(old.shape[1], old.P),
                                     block_rows(new.shape[1], new.P))
        spec_c = ReshardSpec.between(tuple(old.bounds), tuple(new.bounds))
        return {
            "span": [lo, hi],
            "resident_b": len(t.resident_b) == hi - lo and all(
                torch.equal(r, b[x:y])
                for r, (x, y) in zip(t.resident_b, b_bounds)),
            "resident_c": len(t.resident_c) == hi - lo and all(
                torch.equal(r, c[x:y])
                for r, (x, y) in zip(t.resident_c, c_bounds)),
            "routes": {"b": [list(r) for r in spec_b.routes],
                       "c": [list(r) for r in spec_c.routes]},
            "moved": [spec_b.moved_rows(), spec_c.moved_rows()],
            "reshard": self.fleet.reshards[-1]}

    def dropped(self):
        return {n: t.server.stats.dropped_waves
                for fl in (self.fleet, self.twin)
                for n, t in fl.tenants.items()}


def run_g44(topo, arrays, me):
    run = Run(topo, *SPLITS["g44"], arrays, "g44")
    res = {"admitted": state(run.fleet), "twin_admitted": state(run.twin)}
    run.serve()
    old = {n: t.session.handle().plan for n, t in run.fleet.tenants.items()}
    moves = run.fleet.rebalance()
    twin_moves = run.twin.rebalance()
    res["moves"] = [list(m) for m in moves]
    res["twin_moves"] = [list(m) for m in twin_moves]
    name = moves[0][0]
    res["rebalance"] = run.residents(name, old[name])
    run.serve()
    src = run.fleet.placements()[name]
    res["rollback"] = run.migrate(name, 1 - src,
                                  fault_here=me == FAULT_PROCESS)
    run.serve()
    res.update(state=state(run.fleet), twin_state=state(run.twin),
               served=run.served, dropped=run.dropped(),
               reshards=run.fleet.reshards)
    return res


def run_g26(topo, arrays):
    run = Run(topo, *SPLITS["g26"], arrays, "g26", ladder=LADDER26,
              tensors=True)
    res = {"admitted": state(run.fleet)}
    run.serve()
    name = "s"
    steps = []
    for dst in ((1,) if run.fleet.placements()[name] == 0 else (0, 1)):
        old = run.fleet.tenants[name].session.handle().plan
        ok = run.fleet.migrate(name, dst)
        ok_twin = run.twin.migrate(name, dst)
        step = {"to": dst, "ok": ok, "ok_twin": ok_twin}
        step.update(run.residents(name, old))
        steps.append(step)
        run.serve()
    res.update(steps=steps, state=state(run.fleet),
               twin_state=state(run.twin), served=run.served,
               dropped=run.dropped(), reshards=run.fleet.reshards)
    return res


def main(out_dir):
    topo = initialize(timeout=90.0)
    arrays = {}
    fleet_topo = Topology.multiprocess(device="cpu")
    me = fleet_topo.process_index
    res = {"spans": [list(s) for s in fleet_topo.spans],
           "g44": run_g44(fleet_topo, arrays, me),
           "g26": run_g26(fleet_topo, arrays)}
    del topo
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(res, f, default=str)
    np.savez(os.path.join(out_dir, f"rank{me}.npz"), **arrays)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1])
