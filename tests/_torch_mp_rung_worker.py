"""One worker of the CPU fleets that ``test_torch_fleet_rungs`` launches
(``launch_local(2, 4, device="cpu", argv=[python, this, out])``; a 4 × 2
fleet runs the span tables, the rungs and the replicated tier alone,
``--rungs-only``).

Every process runs the same steps on its span of the ranks and writes
what it saw to ``<out>/rank<i>.json`` (its C rows to ``<out>/rank<i>.npz``):

* the span tables of the fleet narrowed to 6 and 4 ranks and carved to
  the group [2, 6), and the rows ``put_global`` hands this process;
* the MoE dispatch of olmoe-1b-7b's smoke config (T = 256 tokens over
  M = 8 ranks): ``compile_dispatch`` on the fleet's Topology, and
  ``dispatch_session`` through ``maybe_replan``'s three branches
  (``drift_ok``, ``values_refresh``, ``drift_replan``);
* a ladder session (rungs 4, 6, 8) on a power-law (flat) and a uniform
  (``hier="auto"``) matrix, single-round and bucketed overlapped, served
  on coo and bsr at each step: rung 8, ``on_resize(6)``,
  ``on_resize(4)`` (on 2 × 4 process 1 holds no rank; on 4 × 2
  processes 2 and 3 hold none and join the others' exchanges), the
  carved group [2, 6)
  through ``adopt_topology`` and back to the whole fleet;
* a ``SpmmWaveServer`` wave whose fault fails on every process, which
  degrades the session from rung 8 to 6;
* the replicated tier (c = 2) on the narrowed and carved topologies.

Each handle's C rows are held against the emulated run of the same plan
(``Topology.local(P)``), with its rows per axis. It imports no JAX; the
test compares decisions and events with the JAX package.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.api import SpmmConfig, compile_spmm, materialize_payload
from repro_torch.core.planner import plan_build_count
from repro_torch.core.session import SpmmSession
from repro_torch.core.sparse import power_law_sparse, random_sparse
from repro_torch.distributed.topology import Topology
from repro_torch.launch.multiprocess import initialize, shutdown
from repro_torch.models.moe import (compile_dispatch, dispatch_matrix,
                                    dispatch_session)
from repro_torch.robustness.faults import Fault, inject
from repro_torch.serving.scheduler import SpmmRequest, SpmmWaveServer

P, N_COLS, LADDER = 8, 16, (4, 6, 8)
# 1152 = 2^7 · 9 rows: 4, 6 and 8 ranks each hold equal row blocks
MATRICES = {
    "powerlaw": lambda: power_law_sparse(1152, 1152, 9216, 1.2, 2),
    "uniform": lambda: random_sparse(1152, 1152, 0.008, 1),
}
TIERS = {"powerlaw": dict(hier=None), "uniform": dict(hier="auto")}
BODIES = {"single": dict(schedule="single", overlap=False),
          "overlap": dict(schedule=2, overlap=True)}
BACKENDS = ("coo", "bsr")
DISPATCH = dict(arch="olmoe-1b-7b", tokens=256, M=8)
# maybe_replan's three branches, in order: the planned routing again, the
# same pattern with new values, another routing snapshot
DRIFTS = ("drift_ok", "values_refresh", "drift_replan")
# what the session does at each step, in order
STEPS = ("p8", "p6", "p4", "group26", "back8")
DECISION_KEYS = ("strategy", "plan_strategy", "shape", "schedule_kind",
                 "schedule_K", "overlap", "volume_rows",
                 "volume_rows_padded", "volume_rows_padded_single",
                 "modeled_time_flat", "modeled_time_hier",
                 "modeled_time_schedule", "hier_candidate", "G", "L",
                 "replicate", "net", "pattern_nnz")
AXES = (None, "x", "g", "l")


def _gen(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def session_config(m, body):
    return SpmmConfig(backends=BACKENDS, **TIERS[m], **BODIES[body])


def drifted(cfg, name):
    """The dispatch matrix ``maybe_replan`` takes for one branch."""
    a = dispatch_matrix(cfg, DISPATCH["tokens"], DISPATCH["M"])
    if name == "values_refresh":
        return dataclasses.replace(a, data=a.data * 0.5)
    if name == "drift_replan":
        return dispatch_matrix(cfg, DISPATCH["tokens"], DISPATCH["M"],
                               seed=1)
    return a


def decisions(h):
    st = h.stats()
    return json.loads(json.dumps({k: st.get(k) for k in DECISION_KEYS}))


def check(h, b, rows, name, backends=("coo",)):
    """``h(b)`` on each backend against the emulated run of the same
    plan: {equal, rows per axis (fleet, emulated), ...}; C rows kept in
    ``rows[name-backend]``."""
    emu = materialize_payload(h.save_payload(), Topology.local(h.P, "cpu"))
    out = {"span": list(h.comm.span), "spans": [list(s) for s in
                                                h.topology.spans],
           "topology": json.loads(json.dumps(h.topology.describe())),
           "blocks": [list(r) for r in h.row_blocks()],
           "decisions": decisions(h), "equal": {}}
    for be in backends:
        c = h(b, backend=be)
        c_emu = emu(b, backend=be)
        want = torch.cat([c_emu[s:e] for s, e in h.row_blocks()]
                         or [c_emu[:0]])
        out["equal"][be] = bool(torch.equal(c, want))
        out["rows"] = {str(ax): [h.comm.fleet_rows(ax), emu.comm.rows(ax)]
                       for ax in AXES}
        out["shape"] = list(c.shape)
        out["exchanges"] = h.comm.transport()["exchanges"]
        out["crossing"] = [h.comm.fleet_rows(crossing=True),
                           None if h.replicated else h.plan_crossing_rows()]
        rows[f"{name}-{be}"] = c.numpy()
    return out


def topology_checks(topo, b_host):
    out = {}
    for name, t in (("narrow6", topo.narrow(6)), ("narrow4", topo.narrow(4)),
                    ("group26", topo.subtopology(slice(2, 6)))):
        out[name] = {"spans": [list(s) for s in t.spans],
                     "span": list(t.span),
                     "describe": json.loads(json.dumps(t.describe())),
                     "network": t.network().name,
                     "put_global": list(t.put_global(b_host).shape)}
    return out


def replicated_checks(topo, b_host, rows):
    """The replicated tier (c = 2) compiled on each narrowed or carved
    fleet topology."""
    out = {}
    for name, t in (("narrow6", topo.narrow(6)), ("narrow4", topo.narrow(4)),
                    ("group26", topo.subtopology(slice(2, 6)))):
        h = compile_spmm(MATRICES["powerlaw"](), t,
                         SpmmConfig(backends=BACKENDS, replicate=2))
        out[name] = check(h, b_host, rows, f"repl-{name}", BACKENDS)
    return out


def dispatch_checks(topo, rows):
    cfg = get_smoke_config(DISPATCH["arch"])
    T, M = DISPATCH["tokens"], DISPATCH["M"]
    x = _gen(40, (T, cfg.d_model))
    out = {"handle": check(compile_dispatch(cfg, T, M, where=topo), x, rows,
                           "dispatch")}
    sess = dispatch_session(cfg, T, M, where=topo)
    out["session"] = {"build": check(sess.handle(), x, rows,
                                     "dispatch_session-build")}
    for name in DRIFTS:
        drift, replanned = sess.maybe_replan(drifted(cfg, name))
        got = check(sess.handle(), x, rows, f"dispatch_session-{name}")
        out["session"][name] = dict(got, replan=[drift, replanned])
    out["events"] = json.loads(json.dumps(sess.events))
    return out


def rung_checks(topo, b_host, rows):
    out = {}
    for m in MATRICES:
        a = MATRICES[m]()
        for body in BODIES:
            name = f"{m}-{body}"
            sess = SpmmSession.build(a, topo, session_config(m, body),
                                     p_ladder=LADDER)
            builds = plan_build_count()
            steps = {"p8": sess.handle, "p6": lambda: sess.on_resize(6),
                     "p4": lambda: sess.on_resize(4),
                     "group26": lambda: sess.adopt_topology(
                         topo.subtopology(slice(2, 6))),
                     "back8": lambda: sess.on_resize(topo)}
            got = {}
            for step in STEPS:
                got[step] = check(steps[step](), b_host, rows,
                                  f"{name}-{step}", BACKENDS)
            got["plan_builds"] = plan_build_count() - builds
            got["events"] = json.loads(json.dumps(sess.events))
            out[name] = got
    return out


def degrade_checks(topo, b_host, rows):
    """One wave that fails on every process, twice: the server degrades
    the session 8 -> 6 and serves the wave there."""
    sess = SpmmSession.build(MATRICES["powerlaw"](), topo,
                             session_config("powerlaw", "overlap"),
                             p_ladder=LADDER)
    server = SpmmWaveServer(sess, max_batch=2, max_retries=2, backoff=0.0)
    reqs = [SpmmRequest(i, _gen(50 + i, b_host.shape)) for i in range(4)]
    for req in reqs:
        server.submit(req)
    with inject([Fault(kind="wave_error", site="wave", times=2)]) as plan:
        stats = server.run()
    h = sess.handle()
    emu = materialize_payload(h.save_payload(), Topology.local(h.P, "cpu"))
    equal = []
    for req in reqs:
        want = emu(req.b)
        equal.append(bool(torch.equal(req.output, torch.cat(
            [want[s:e] for s, e in h.row_blocks()]))))
        rows[f"degrade-{req.rid}"] = req.output.numpy()
    return {"stats": dataclasses.asdict(stats),
            "fired": plan.fired("wave_error"), "current_P": sess.current_P,
            "span": list(h.comm.span), "blocks": h.row_blocks(),
            "events": [e for e in server.events
                       if e["action"] != "wave_failed"],
            "failed": sum(e["action"] == "wave_failed"
                          for e in server.events),
            "equal": equal}


def main(out_dir, full):
    topo = initialize()
    b_host = _gen(20, (1152, N_COLS))
    rows = {}
    res = {"span": list(topo.span), "spans": [list(s) for s in topo.spans],
           "topology": topology_checks(topo, b_host),
           "rungs": rung_checks(topo, b_host, rows),
           "replicated": replicated_checks(topo, b_host, rows)}
    if full:
        res.update(dispatch=dispatch_checks(topo, rows),
                   degrade=degrade_checks(topo, b_host, rows))
    with open(os.path.join(out_dir, f"rank{topo.process_index}.json"),
              "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out_dir, f"rank{topo.process_index}.npz"), **rows)
    shutdown()


if __name__ == "__main__":
    torch.set_num_threads(2)
    main(sys.argv[1], full=sys.argv[2:] != ["--rungs-only"])
