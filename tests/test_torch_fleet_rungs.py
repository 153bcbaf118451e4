"""The MoE dispatch and the ladder rungs below the fleet across real
processes on the CPU, against the emulated runs and the JAX package.

Two module-scoped fleets run ``tests/_torch_mp_rung_worker.py``:
``launch_local(2, 4, device="cpu")`` (span tables, the dispatch handle
and session, the rungs, the wave server's degrade) and a 4 × 2 fleet
(span tables and rungs, where two processes of a narrowed fleet hold no
rank and still join the others' exchanges). Each process's C rows are
``torch.equal`` to the emulated run of the same plan on
``Topology.local(P)`` and within 2e-4 of float64 (``tests/
test_dist_spmm.py``'s tolerance); rows per axis summed over the processes
equal the emulated log's; no resize re-runs MWVC; decisions, maybe_replan's
branches and the session events equal the reference's
(``repro.models.moe.compile_dispatch`` / ``dispatch_session`` and
``repro.core.session.SpmmSession`` on ``Topology.from_mesh(
make_spmm_mesh(8, groups=G))``, whose network is the fleet's).
"""
import dataclasses
import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_rung_worker as W  # noqa: E402

from repro_torch.distributed.topology import Topology, TopologyError  # noqa: E402,E501

FLEET_TIMEOUT = 300.0
LAYOUTS = {"2x4": (2, 4), "4x2": (4, 2)}
SESSIONS = [f"{m}-{body}" for m in W.MATRICES for body in W.BODIES]
# (narrowed / carved topology, its span table) by layout
SPANS = {
    "2x4": {"narrow6": [[0, 4], [4, 6]], "narrow4": [[0, 4], [4, 4]],
            "group26": [[0, 2], [2, 4]]},
    "4x2": {"narrow6": [[0, 2], [2, 4], [4, 6], [6, 6]],
            "narrow4": [[0, 2], [2, 4], [4, 4], [4, 4]],
            "group26": [[0, 0], [0, 2], [2, 4], [4, 4]]},
}
STEP_TOPOLOGY = {"p8": None, "p6": "narrow6", "p4": "narrow4",
                 "group26": "group26", "back8": None}
TOL = dict(rtol=2e-4, atol=2e-4)


def _launch(out, layout):
    from repro_torch.launch.multiprocess import launch_local

    n, local = LAYOUTS[layout]
    argv = [sys.executable, str(HERE / "_torch_mp_rung_worker.py"), str(out)]
    rc = launch_local(n, local, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=argv + (["--rungs-only"] if layout == "4x2"
                                   else []))
    assert rc == 0, f"the {layout} fleet failed (exit {rc})"
    return ([json.loads((out / f"rank{r}.json").read_text())
             for r in range(n)],
            [dict(np.load(out / f"rank{r}.npz")) for r in range(n)])


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    # both fleets at once: each waits mostly on its own workers
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        runs = {layout: pool.submit(
            _launch, tmp_path_factory.mktemp(f"fleet{layout}"), layout)
            for layout in LAYOUTS}
        return {layout: run.result() for layout, run in runs.items()}


# ----- the reference ------------------------------------------------------


def _ref_topology(layout):
    from repro.distributed.topology import Topology as RTopology
    from repro.launch.mesh import make_spmm_mesh

    return RTopology.from_mesh(make_spmm_mesh(W.P,
                                              groups=LAYOUTS[layout][0]))


def _ref_decisions(h):
    st = h.stats()
    return json.loads(json.dumps({k: st.get(k) for k in W.DECISION_KEYS}))


@functools.lru_cache(maxsize=None)
def reference_rungs(layout, name):
    """The reference session's decisions at each step and its events."""
    from repro.core.api import SpmmConfig
    from repro.core.session import SpmmSession
    from repro.core.sparse import power_law_sparse, random_sparse

    m, body = name.split("-")
    a = {"powerlaw": lambda: power_law_sparse(1152, 1152, 9216, 1.2, 2),
         "uniform": lambda: random_sparse(1152, 1152, 0.008, 1)}[m]()
    port = W.MATRICES[m]()
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(port, f), getattr(a, f))
    topo = _ref_topology(layout)
    sess = SpmmSession.build(a, topo, SpmmConfig(
        backends=W.BACKENDS, **W.TIERS[m], **W.BODIES[body]),
        p_ladder=W.LADDER)
    steps = {"p8": sess.handle, "p6": lambda: sess.on_resize(6),
             "p4": lambda: sess.on_resize(4),
             "group26": lambda: sess.adopt_topology(
                 topo.subtopology(slice(2, 6))),
             "back8": lambda: sess.on_resize(topo)}
    out = {step: _ref_decisions(steps[step]()) for step in W.STEPS}
    out["events"] = json.loads(json.dumps(sess.events, default=str))
    return out


@functools.lru_cache(maxsize=None)
def reference_dispatch():
    """The reference's dispatch handle and session: decisions at each
    step, maybe_replan's returns, the events."""
    from repro.configs import get_smoke_config
    from repro.models.moe import (compile_dispatch, dispatch_matrix,
                                  dispatch_session)

    cfg = get_smoke_config(W.DISPATCH["arch"])
    T, M = W.DISPATCH["tokens"], W.DISPATCH["M"]
    topo = _ref_topology("2x4")
    out = {"handle": _ref_decisions(compile_dispatch(cfg, T, M, topo))}
    sess = dispatch_session(cfg, T, M, where=topo)
    out["build"] = _ref_decisions(sess.handle())
    a = dispatch_matrix(cfg, T, M)
    drifted = {"drift_ok": a,
               "values_refresh": dataclasses.replace(a, data=a.data * 0.5),
               "drift_replan": dispatch_matrix(cfg, T, M, seed=1)}
    for name in W.DRIFTS:
        out[f"replan-{name}"] = list(sess.maybe_replan(drifted[name]))
        out[name] = _ref_decisions(sess.handle())
    out["events"] = json.loads(json.dumps(sess.events))
    return out


# ----- float64 --------------------------------------------------------


def _dense_rows(a, b, blocks):
    import scipy.sparse as sp

    a64 = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                        shape=a.shape)
    parts = [a64[s:e] @ b.astype(np.float64) for s, e in blocks]
    return np.concatenate(parts) if parts else np.zeros((0, b.shape[1]))


def _b_host():
    return W._gen(20, (1152, W.N_COLS))


# ----- span tables --------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("what", ["narrow6", "narrow4", "group26"])
def test_fleet_span_tables(fleets, layout, what):
    res, _ = fleets[layout]
    n, local = LAYOUTS[layout]
    want = SPANS[layout][what]
    P = 4 if what != "narrow6" else 6
    for q, r in enumerate(res):
        assert r["spans"] == [[i * local, (i + 1) * local] for i in range(n)]
        got = r["topology"][what]
        assert got["spans"] == want and got["span"] == want[q]
        d = {"kind": "multiprocess", "P": P, "tiers": None, "n_hosts": n,
             "platform": "cpu"}
        if what == "group26":
            d["group"] = [2, 6]
        assert got["describe"] == d
        # a structureless substrate: the model network, as the reference's
        assert got["network"] == "tsubame4"
        lo, hi = want[q]
        assert got["put_global"] == [(hi - lo) * 1152 // P, W.N_COLS]


def _standin(layout, q):
    n, local = LAYOUTS[layout]
    return Topology(kind="multiprocess", P=n * local,
                    device=Topology.local(1, "cpu").device,
                    tiers=(n, local), n_hosts=n, process_index=q,
                    local_device_count=local)


def _ref_standin(layout, q):
    from types import SimpleNamespace

    from repro.distributed.topology import Topology as RTopology

    n, local = LAYOUTS[layout]
    devs = tuple(SimpleNamespace(platform="cpu", id=i)
                 for i in range(n * local))
    return RTopology(kind="multiprocess", devices=devs, tiers=(n, local),
                     n_hosts=n, process_index=q, local_device_count=local)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("what", ["narrow6", "narrow4", "group26"])
def test_span_tables_without_processes(layout, what):
    """narrow / subtopology on a fleet Topology built without processes:
    the span tables, and describe() / network() as the reference's for
    the same devices."""
    n, _ = LAYOUTS[layout]
    for q in range(n):
        topo, ref = _standin(layout, q), _ref_standin(layout, q)
        cut = {"narrow6": lambda t: t.narrow(6),
               "narrow4": lambda t: t.narrow(4),
               "group26": lambda t: t.subtopology(slice(2, 6))}[what]
        got, want = cut(topo), cut(ref)
        assert [list(s) for s in got.spans] == SPANS[layout][what]
        assert list(got.span) == SPANS[layout][what][q]
        assert got.describe() == want.describe()
        assert got.network().name == want.network().name
        assert got.auto_grouping(got.network()) == \
            want.auto_grouping(want.network())
        assert got.fingerprint() != topo.fingerprint()
        # a carved group narrows within itself
        assert got.narrow(2).group == got.group
        assert [list(s) for s in got.narrow(2).spans] == [
            [min(lo, 2), min(hi, 2)] for lo, hi in SPANS[layout][what]]


def test_span_table_refusals():
    topo = _standin("2x4", 1)
    assert topo.spans == ((0, 4), (4, 8)) and topo.span == (4, 8)
    with pytest.raises(TopologyError, match="cannot narrow"):
        topo.narrow(9)
    with pytest.raises(TopologyError, match="empty"):
        topo.subtopology(slice(3, 3))
    with pytest.raises(TopologyError, match="contiguous"):
        topo.subtopology(slice(0, 8, 2))
    # split carves the fleet into groups, each with its own span table
    g0, g1 = topo.split((3, 5))
    assert (g0.spans, g0.span, g0.group) == (((0, 3), (3, 3)), (3, 3),
                                             (0, 3))
    assert (g1.spans, g1.span, g1.group) == (((0, 1), (1, 5)), (1, 5),
                                             (3, 8))


# ----- the MoE dispatch -----------------------------------------------


def _dispatch_matrix(name):
    from repro_torch.configs import get_smoke_config

    return W.drifted(get_smoke_config(W.DISPATCH["arch"]), name)


def _dispatch_x():
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(W.DISPATCH["arch"])
    return W._gen(40, (W.DISPATCH["tokens"], cfg.d_model))


def _check_case(res, rows, key, got_of, a, b, want_decisions):
    for r, rw in zip(res, rows):
        got = got_of(r)
        assert all(got["equal"].values()), f"{key}: C != emulated"
        for axis, (fleet, emulated) in got["rows"].items():
            assert fleet == emulated, f"{key} axis {axis}"
        # the rows sent between processes, as the plan counts them (a
        # count the port keeps for the flat and hier tiers)
        if got["crossing"][1] is not None:
            assert got["crossing"][0] == got["crossing"][1], key
        assert got["decisions"] == want_decisions
        for be in got["equal"]:
            c = rw[f"{key}-{be}"]
            assert list(c.shape) == got["shape"]
            np.testing.assert_allclose(c, _dense_rows(a, b, got["blocks"]),
                                       err_msg=f"{key}-{be}", **TOL)
    # every process entered the same exchanges
    assert len({got_of(r)["exchanges"] for r in res}) == 1


def test_dispatch_handle(fleets):
    res, rows = fleets["2x4"]
    _check_case(res, rows, "dispatch", lambda r: r["dispatch"]["handle"],
                _dispatch_matrix("build"), _dispatch_x(),
                reference_dispatch()["handle"])
    blocks = [r["dispatch"]["handle"]["blocks"] for r in res]
    assert blocks == [[[0, 316]], [[316, 632]]]


@pytest.mark.parametrize("step", ("build",) + W.DRIFTS)
def test_dispatch_session(fleets, step):
    res, rows = fleets["2x4"]
    ref = reference_dispatch()
    _check_case(res, rows, f"dispatch_session-{step}",
                lambda r: r["dispatch"]["session"][step],
                _dispatch_matrix(step), _dispatch_x(), ref[step])
    if step != "build":
        # maybe_replan takes the same branch on every process
        for r in res:
            assert r["dispatch"]["session"][step]["replan"] == \
                ref[f"replan-{step}"]


def test_dispatch_session_events(fleets):
    res, _ = fleets["2x4"]
    want = reference_dispatch()["events"]
    assert [e["action"] for e in want] == list(W.DRIFTS) + ["replan"]
    for r in res:
        assert r["dispatch"]["events"] == want


# ----- the rungs below the fleet -------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", SESSIONS)
@pytest.mark.parametrize("step", W.STEPS)
def test_rung_equals_emulated(fleets, layout, name, step):
    res, rows = fleets[layout]
    m = name.split("-")[0]
    _check_case(res, rows, f"{name}-{step}",
                lambda r: r["rungs"][name][step], W.MATRICES[m](), _b_host(),
                reference_rungs(layout, name)[step])
    n, local = LAYOUTS[layout]
    which = STEP_TOPOLOGY[step]
    spans = (SPANS[layout][which] if which else
             [[i * local, (i + 1) * local] for i in range(n)])
    for q, r in enumerate(res):
        got = r["rungs"][name][step]
        assert got["spans"] == spans and got["span"] == spans[q]
        if spans[q][0] == spans[q][1]:  # no rank: no C rows
            assert got["blocks"] == [] and got["shape"] == [0, W.N_COLS]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", SESSIONS)
def test_rungs_never_replan(fleets, layout, name):
    res, _ = fleets[layout]
    want = reference_rungs(layout, name)["events"]
    for r in res:
        got = r["rungs"][name]
        assert got["plan_builds"] == 0
        # the adopted group's describe() is the fleet's, the rest the
        # reference's events
        assert [{k: v for k, v in e.items() if k != "topology"}
                for e in got["events"]] == \
            [{k: v for k, v in e.items() if k != "topology"} for e in want]
        adopt = [e for e in got["events"] if e["action"] == "adopt_topology"]
        assert [e["topology"]["group"] for e in adopt] == [[2, 6]]


@functools.lru_cache(maxsize=None)
def reference_replicated(layout, what):
    """The reference's replicated handle (c = 2) on the mesh narrowed or
    carved as the fleet is."""
    from repro.core.api import SpmmConfig, compile_spmm
    from repro.core.sparse import power_law_sparse

    topo = _ref_topology(layout)
    topo = {"narrow6": lambda: topo.narrow(6),
            "narrow4": lambda: topo.narrow(4),
            "group26": lambda: topo.subtopology(slice(2, 6))}[what]()
    return _ref_decisions(compile_spmm(
        power_law_sparse(1152, 1152, 9216, 1.2, 2), topo,
        SpmmConfig(backends=W.BACKENDS, replicate=2)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("what", ["narrow6", "narrow4", "group26"])
def test_replicated_tier_below_the_fleet(fleets, layout, what):
    """B's blocks cross processes here: an empty span's process sends
    and receives its zero-length share of every lane's copy."""
    res, rows = fleets[layout]
    _check_case(res, rows, f"repl-{what}", lambda r: r["replicated"][what],
                W.MATRICES["powerlaw"](), _b_host(),
                reference_replicated(layout, what))
    for r in res:
        assert r["replicated"][what]["spans"] == SPANS[layout][what]


def test_wave_server_degrades_on_every_process(fleets):
    res, rows = fleets["2x4"]
    b_of = {i: W._gen(50 + i, (1152, W.N_COLS)) for i in range(4)}
    a = W.MATRICES["powerlaw"]()
    for q, (r, rw) in enumerate(zip(res, rows)):
        got = r["degrade"]
        assert got["events"] == [{"action": "degrade", "from": 8, "to": 6}]
        assert got["fired"] == 2 and got["failed"] == 2
        assert got["current_P"] == 6 and got["span"] == [[0, 4], [4, 6]][q]
        assert got["stats"]["dropped_waves"] == 0
        assert got["stats"]["served"] == 4 and got["stats"]["waves"] == 2
        assert all(got["equal"])
        for i, b in b_of.items():
            np.testing.assert_allclose(rw[f"degrade-{i}"],
                                       _dense_rows(a, b, got["blocks"]),
                                       **TOL)
