"""One worker of the 2-process CPU fleet that ``test_torch_process_comm``
launches (``launch_local(2, 4, device="cpu", argv=[python, this, out])``).

Every process runs the same checks on its span of the P = 8 ranks and
writes what it saw to ``<out>/rank<i>.json`` (and its C rows to
``<out>/rank<i>.npz``): each ``ProcessComm`` collective against
``LocalComm`` on the stacked tensor, every executor body on each tier
against the emulated run of the same plan (``Topology.local(8)``), the
rows per axis and across processes, and one flat SDDMM and one hier
FusedMM. It imports no JAX; the test compares the rows with the JAX
package.
"""
import json
import os
import sys

import numpy as np
import torch

from repro_torch.core.api import SpmmConfig, compile_spmm, materialize_payload
from repro_torch.core.sparse import power_law_sparse, random_sparse
from repro_torch.distributed.comm import LocalComm
from repro_torch.distributed.topology import Topology
from repro_torch.launch.multiprocess import initialize, shutdown

P, N_COLS = 8, 16

MATRICES = {
    "powerlaw": lambda: power_law_sparse(1024, 1024, 8192, 1.2, 2),
    "uniform": lambda: random_sparse(1024, 1024, 0.008, 1),
}
# tier -> SpmmConfig fields; body -> schedule fields (the replicated tier
# is staged only)
# ``hier="auto"`` takes the fleet's tiers, (2, 4), and the model keeps
# the two-tier executor on both matrices
TIERS = {"flat": dict(hier=None), "hier_auto": dict(hier="auto"),
         "hier42": dict(hier=(4, 2)), "repl2": dict(replicate=2)}
BODIES = {"single": dict(schedule="single", overlap=False),
          "staged": dict(schedule=2, overlap=False),
          "overlap": dict(schedule=2, overlap=True)}
BACKENDS = ("coo", "bsr")
DECISION_KEYS = ("strategy", "schedule_kind", "schedule_K", "overlap",
                 "volume_rows", "volume_rows_padded", "modeled_time_flat",
                 "modeled_time_hier", "hier_candidate", "G", "L",
                 "replicate", "net")


def exec_cases():
    """(matrix, tier, body) of every executor check."""
    out = []
    for m in MATRICES:
        for tier in TIERS:
            for body in (("staged",) if tier == "repl2" else BODIES):
                out.append((m, tier, body))
    return out


def case_name(m, tier, body, backend=None):
    return "-".join([m, tier, body] + ([backend] if backend else []))


def config(tier, body):
    fields = dict(backends=("coo", "bsr"), **TIERS[tier])
    if tier != "repl2":
        fields.update(BODIES[body])
    return SpmmConfig(**fields)


def _gen(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def comm_checks(lo, hi):
    """Each collective of a ProcessComm on rows [lo, hi) of one stacked
    tensor against LocalComm's on the whole: {name: result}."""
    out = {}

    def check(name, groups, replicas, op, x, want_of=None):
        loc = LocalComm(P, groups, replicas)
        proc = Topology.multiprocess(device="cpu").comm(groups, replicas)
        want = op(loc, x)
        got = op(proc, x[lo:hi])
        want = want[lo:hi] if want_of is None else want_of(want)
        out[name] = {"equal": bool(torch.equal(got, want)),
                     "shape": list(got.shape),
                     "fleet_rows": proc.fleet_rows(),
                     "local_rows": loc.rows(),
                     "fleet_crossing": proc.fleet_rows(crossing=True)}

    t = lambda seed, *shape: torch.from_numpy(_gen(seed, shape))  # noqa
    check("all_to_all", 1, 1, lambda c, x: c.all_to_all(x), t(1, P, P, 3, 5))
    perm = [(0, 5), (5, 2), (2, 7), (3, 0), (6, 6)]
    check("ppermute_partial", 1, 1, lambda c, x: c.ppermute(x, perm),
          t(2, P, 3, 5))
    check("shift3", 1, 1, lambda c, x: c.shift(x, 3), t(3, P, 4, 5))
    for G in (2, 4):
        L = P // G
        check(f"group_all_to_all_G{G}", G, 1,
              lambda c, x: c.group_all_to_all(x), t(4, P, G, 3, 5))
        check(f"group_shift_G{G}", G, 1, lambda c, x: c.group_shift(x, 1),
              t(5, P, 3, 5))
        check(f"local_psum_scatter_G{G}_dim1", G, 1,
              lambda c, x: c.local_psum_scatter(x, dim=1),
              t(6, P, 2, L * 3, 5))
        check(f"local_psum_scatter_G{G}_dim0", G, 1,
              lambda c, x: c.local_psum_scatter(x, dim=0),
              t(7, P, L * 2, 5))
        check(f"local_all_gather_G{G}", G, 1,
              lambda c, x: c.local_all_gather(x), t(8, P, 3, 5))
    for C in (2, 4):
        S = P // C
        x = t(9, P, 3, 5)  # rank p's row block of B at x[p]
        check(f"replicate_c{C}", 1, C,
              lambda c, x: c.replicate(x.reshape(S, C * 3, 5)
                                       if isinstance(c, LocalComm) else x),
              x)
        shifts = tuple((r + 1) % S for r in range(C))
        check(f"lane_shift_c{C}", 1, C,
              lambda c, x: c.lane_shift(x, shifts, range(C)), t(10, P, 3, 5))
        check(f"lane_shift_c{C}_lane1", 1, C,
              lambda c, x: c.lane_shift(x, shifts, (1,)), t(11, P, 3, 5))
        # LocalComm's result is [s, c, rows / c, ...] in (g, r) order;
        # ProcessComm's is its ranks (r, g) in rank order
        check(f"replica_psum_scatter_c{C}", 1, C,
              lambda c, x: c.replica_psum_scatter(x), t(12, P, 2 * C, 5),
              want_of=lambda w: torch.stack(
                  [w[p % S, p // S] for p in range(lo, hi)]))
    return out


def main(out_dir):
    topo = initialize()
    lo, hi = topo.span
    res = {"span": [lo, hi], "topology": topo.describe(),
           "network": topo.network().name,
           "auto_grouping": list(topo.auto_grouping(topo.network()))}
    narrow = topo.narrow(4)  # a rung below the fleet: process 1 empty
    res["narrow4"] = {"spans": [list(s) for s in narrow.spans],
                      "describe": narrow.describe()}
    res["comm"] = comm_checks(lo, hi)

    rows = {}
    res["exec"], res["decisions"], res["blocks"] = {}, {}, {}
    b_host = _gen(20, (1024, N_COLS))
    for m, tier, body in exec_cases():
        a = MATRICES[m]()
        h = compile_spmm(a, topo, config(tier, body))
        emu = materialize_payload(h.save_payload(), Topology.local(P, "cpu"))
        name = case_name(m, tier, body)
        st = h.stats()
        res["decisions"][name] = {k: st.get(k) for k in DECISION_KEYS}
        res["blocks"][name] = h.row_blocks()
        for be in BACKENDS:
            c = h(b_host, backend=be)
            c_emu = emu(b_host, backend=be)
            want = torch.cat([c_emu[s:e] for s, e in h.row_blocks()])
            # a tensor that is this process's slab passes through
            c_again = h(torch.from_numpy(b_host[lo * 128:hi * 128].copy()),
                        backend=be)
            axes = {ax: [h.comm.fleet_rows(ax), emu.comm.rows(ax)]
                    for ax in (None, "x", "g", "l", "s", "r")}
            res["exec"][case_name(m, tier, body, be)] = {
                "equal": bool(torch.equal(c, want)),
                "slab_equal": bool(torch.equal(c_again, c)),
                "rows": {str(k): v for k, v in axes.items()},
                "crossing": h.comm.fleet_rows(crossing=True),
                "crossing_g": h.comm.fleet_rows("g", crossing=True),
                "plan_crossing": (None if tier == "repl2"
                                  else h.plan_crossing_rows()),
                "volume_rows_padded": st["volume_rows_padded"],
                "transport": h.comm.transport()}
            rows[case_name(m, tier, body, be)] = c.numpy()

    # one flat SDDMM and one hier FusedMM, against the emulated run
    a = MATRICES["powerlaw"]()
    x, y = _gen(30, (1024, 8)), _gen(31, (1024, 8))
    hs = compile_spmm(a, topo, backends=("coo", "bsr"), kernel="sddmm")
    es = materialize_payload(hs.save_payload(), Topology.local(P, "cpu"))
    for be in BACKENDS:
        got, want = hs(x, y, backend=be), es(x, y, backend=be)
        res["exec"][f"sddmm-flat-{be}"] = {"equal": all(
            torch.equal(got[k], want[k][lo:hi]) for k in want)}
    hf = compile_spmm(a, topo, backends=("coo", "bsr"), kernel="fused",
                      hier="auto", edge="leaky_relu")
    ef = materialize_payload(hf.save_payload(), Topology.local(P, "cpu"))
    res["fused_tier"] = [hf.strategy, hf.stats().get("G"),
                         hf.stats().get("L")]
    for be in BACKENDS:
        got, want = hf(x, y, b_host, backend=be), ef(x, y, b_host, backend=be)
        s, e = hf.row_blocks()[0]
        res["exec"][f"fused-hier_auto-{be}"] = {
            "equal": bool(torch.equal(got, want[s:e]))}
        rows[f"fused-hier_auto-{be}"] = got.numpy()

    with open(os.path.join(out_dir, f"rank{topo.process_index}.json"),
              "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out_dir, f"rank{topo.process_index}.npz"), **rows)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(2)
    main(sys.argv[1])
