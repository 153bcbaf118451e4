"""The port's ``SpmmSession`` against ``repro.core.session`` (CPU).

Per-rung decisions equal the reference's; ``on_resize`` never re-runs
MWVC; ``maybe_replan`` returns the reference's (drift, replanned); a hot
swap is bit-identical to a cold compile and warm before it serves; a
values-only refresh keeps the handle and every memo entry; the
``memory_budget`` rung filter skips what the reference skips; the bundle
round-trips bit for bit, rejects unknown versions and names a torn file.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core.session import SpmmSession as RSession  # noqa: E402
from repro.distributed.topology import TopologyError as RTopologyError  # noqa: E402,E501
from repro_torch import (  # noqa: E402
    SpmmConfig, SpmmSession, Topology, TopologyError, compile_spmm,
)
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.core.planner import plan_build_count  # noqa: E402
from repro_torch.robustness import Fault, inject  # noqa: E402

P, N = 8, 16


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _b(k=64, n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _model_only(monkeypatch):
    from repro.core import autotune as r_autotune
    from repro_torch.core import autotune

    for mod in (autotune, r_autotune):
        monkeypatch.delenv(mod.CACHE_ENV, raising=False)
        monkeypatch.delenv(mod.MEASURE_ENV, raising=False)


def _build(a, cfg, ladder, where=P, **kw):
    return SpmmSession.build(_port_csr(a), where, SpmmConfig(**cfg),
                             p_ladder=ladder, device="cpu", **kw)


LADDER_CONFIGS = [dict(), dict(hier="auto"),
                  dict(backends=("coo", "bsr"), schedule="auto"),
                  dict(replicate="auto")]


@pytest.mark.parametrize("cfg", LADDER_CONFIGS, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_rung_decisions_equal_reference(cfg, power_law_matrix):
    a = power_law_matrix()
    ref = RSession.build(a, P, R.SpmmConfig(**cfg), p_ladder=(2, 4, 8))
    ours = _build(a, cfg, (2, 4, 8))
    assert ours.ladder == ref.ladder == (2, 4, 8)
    for p in ours.ladder:
        assert ours._rungs[p].payload["decisions"] == \
            ref._rungs[p].payload["decisions"]
    b = _b(seed=1)
    for p in (8, 4, 2):
        h, rh = ours.on_resize(p), ref.on_resize(p)
        assert h.strategy == rh.strategy and h.P == p
        np.testing.assert_allclose(h(b).numpy(), np.asarray(rh(b)),
                                   rtol=2e-4, atol=2e-4)


def test_resize_selects_rungs_without_mwvc(power_law_matrix):
    a = power_law_matrix()
    n0 = plan_build_count()
    s = _build(a, dict(schedule="auto"), (2, 4, 8))
    assert plan_build_count() - n0 == 3  # one MWVC run per rung, upfront
    b = _b(seed=5)
    want = a.to_dense() @ b
    n1 = plan_build_count()
    rungs = []
    for census in (8, 5, 8, 3, 2):
        h = s.on_resize(census)
        rungs.append(s.current_P)
        assert h.P == s.current_P and h.topology.P == s.current_P
        np.testing.assert_allclose(h(b).numpy(), want, rtol=2e-4, atol=2e-4)
    assert rungs == [8, 4, 8, 2, 2]
    assert plan_build_count() == n1  # resizes never re-run MWVC
    assert s.on_resize(8) is s.on_resize(8)  # the rung's handle is cached
    assert [e["rung"] for e in s.events if e["action"] == "resize"][:5] == \
        rungs
    with pytest.raises(TopologyError, match="no ladder rung fits 1"):
        s.on_resize(1)
    # a grown census past the topology: the rung grows a local topology
    grown = _build(a, dict(), (4, 8), where=4)
    assert grown.current_P == 4
    h8 = grown.on_resize(Topology.local(8, "cpu"))
    assert h8.P == 8 and grown.topology.P == 8


def test_ladder_errors_as_the_reference(power_law_matrix):
    a = power_law_matrix()
    with pytest.raises(TopologyError, match="no ladder rung fits"):
        _build(a, dict(), (8,), where=4)
    with pytest.raises(RTopologyError, match="no ladder rung fits"):
        RSession.build(a, 4, p_ladder=(8,))
    with pytest.raises(ValueError, match="ladder rungs must be >= 1"):
        _build(a, dict(), (0, 4), where=4)


@pytest.mark.parametrize("change", ["values", "same", "near", "far"])
def test_maybe_replan_thresholds_equal_reference(change, power_law_matrix):
    a = power_law_matrix()
    if change == "values":
        a_new = dataclasses.replace(a, data=a.data * 2.0)
    elif change == "same":
        a_new = a
    elif change == "near":  # one nonzero moved: under the threshold
        idx = a.indices.copy()
        row0 = slice(a.indptr[0], a.indptr[1])
        free = sorted(set(range(64)) - set(idx[row0].tolist()))
        idx[a.indptr[0]] = free[0]
        order = np.argsort(idx[row0], kind="stable")
        idx[row0] = idx[row0][order]
        data = a.data.copy()
        data[row0] = data[row0][order]
        a_new = dataclasses.replace(a, indices=idx, data=data)
    else:
        a_new = R.power_law_sparse(64, 64, 400, 1.2, seed=41)
    ref = RSession.build(a, P, R.SpmmConfig(schedule="auto"))
    ours = _build(a, dict(schedule="auto"), None)
    h0 = ours.handle()
    got = ours.maybe_replan(_port_csr(a_new))
    assert got == ref.maybe_replan(a_new)
    assert [e["action"] for e in ours.events] == \
        [e["action"] for e in ref.events]
    assert (ours.handle() is h0) == (not got[1])
    assert ours.handle().stats()["drift"] == got[0]


def test_replan_hot_swap_bit_identical_and_warm(power_law_matrix):
    a = power_law_matrix()
    s = _build(a, dict(schedule="auto", backends=("coo", "bsr")), None)
    old = s.handle()
    b = _b(seed=3)
    old_out = old(b)
    old(b, backend="bsr")
    a_new = _port_csr(R.power_law_sparse(64, 64, 400, 1.2, seed=41))
    n0 = plan_build_count()
    swapped = s.replan(a_new)
    assert plan_build_count() - n0 == 1
    assert swapped is s.handle() and swapped is not old
    # warmed before the swap: the outgoing working set, in its order
    assert swapped.cache_info()["keys"] == old.cache_info()["keys"]
    new_out = swapped(b)
    assert swapped.cache_info()["hits"] == 1  # the first call is a hit
    cold = compile_spmm(a_new, P, SpmmConfig(schedule="auto",
                                             backends=("coo", "bsr")),
                        device="cpu")
    assert torch.equal(new_out, cold(b))
    assert torch.equal(swapped(b, backend="bsr"), cold(b, backend="bsr"))
    assert torch.equal(old(b), old_out)  # the old handle keeps serving
    assert s.generation == 1 and s.swaps == 1 and s.replans == 1


@pytest.mark.parametrize("cfg", [dict(schedule=4), dict(hier="auto"),
                                 dict(replicate=2),
                                 dict(schedule=2, overlap=True,
                                      backends=("coo", "bsr"))],
                         ids=["flat", "hier", "replicated", "overlapped"])
def test_values_only_refresh_keeps_every_memo_entry(cfg, power_law_matrix):
    a = power_law_matrix()
    s = _build(a, cfg, (4, 8))
    h0 = s.handle()
    b = _b(seed=5)
    c_old = h0(b)
    keys = h0.cache_info()["keys"]
    a2 = dataclasses.replace(a, data=a.data * np.float32(1.5))
    d, swapped = s.maybe_replan(_port_csr(a2))
    assert (d, swapped) == (0.0, False)
    assert s.handle() is h0
    assert s.stats()["values_refreshes"] == 1 == h0.values_refreshes
    assert h0.stats()["values_refreshes"] == 1
    c_new = h0(b)
    assert h0.cache_info()["keys"] == keys  # no new memo entry
    assert h0.cache_info()["hits"] >= 1
    cold = compile_spmm(_port_csr(a2), P, SpmmConfig(**cfg), device="cpu")
    assert torch.equal(c_new, cold(b))
    np.testing.assert_allclose(c_new.numpy(), 1.5 * c_old.numpy(),
                               rtol=1e-5, atol=1e-5)
    # the other rung picks the new values up when it materializes
    np.testing.assert_allclose(s.on_resize(4)(b).numpy(), a2.to_dense() @ b,
                               rtol=2e-4, atol=2e-4)


def test_refresh_rejects_a_mismatched_pattern(power_law_matrix):
    s = _build(power_law_matrix(), dict(), None)
    other = _port_csr(R.power_law_sparse(64, 64, 400, 1.2, seed=41))
    from repro_torch.core.sparse import pattern_snapshot

    with pytest.raises(ValueError, match="does not match the planned"):
        s._refresh_values(other, pattern_snapshot(other))


def test_memory_budget_skips_what_the_reference_skips(power_law_matrix):
    a = power_law_matrix()
    from repro.core import api as r_api
    from repro.core import autotune as r_autotune
    from repro.distributed.topology import Topology as RTopology

    cfg = R.SpmmConfig(backends=("coo",))
    est = {p: r_autotune.rung_device_bytes(
        *(lambda t: (t[0], t[2], t[3]))(
            r_api._plan_and_tune(a, p, cfg, RTopology.local(P))), cfg)
           for p in (2, 4, 8)}
    budget = min(est.values())
    ref = RSession.build(a, P, R.SpmmConfig(backends=("coo",),
                                            memory_budget=budget),
                         p_ladder=(2, 4, 8))
    ours = _build(a, dict(backends=("coo",), memory_budget=budget),
                  (2, 4, 8))
    assert ours.ladder == ref.ladder and len(ours.ladder) < 3
    assert ours.stats()["skipped_rungs"] == ref.stats()["skipped_rungs"]
    assert ours.events == ref.events
    with pytest.raises(TopologyError, match="memory_budget"):
        _build(a, dict(backends=("coo",), memory_budget=1), (2, 4, 8))
    with pytest.raises(RTopologyError, match="memory_budget"):
        RSession.build(a, P, R.SpmmConfig(memory_budget=1),
                       p_ladder=(2, 4, 8))
    assert _build(a, dict(), (2, 4, 8)).stats()["skipped_rungs"] == {}


def test_bundle_roundtrip_bit_identical(tmp_path, power_law_matrix):
    a = power_law_matrix()
    s = _build(a, dict(schedule="auto", hier="auto"), (4, 8))
    b = _b(seed=6)
    out = s.handle()(b)
    path = str(tmp_path / "bundle")
    s.save(path)
    assert os.path.exists(os.path.join(path, "session.json"))
    assert not os.path.exists(path + ".tmp")  # atomic publish
    meta = json.loads((tmp_path / "bundle" / "session.json").read_text())
    assert set(meta["files"]) == {"rung_P00004.shiro", "rung_P00008.shiro",
                                  "operand.pkl"}
    n0 = plan_build_count()
    loaded = SpmmSession.load(path, P, device="cpu")
    assert plan_build_count() == n0  # loading never re-plans
    assert loaded.ladder == (4, 8)
    assert torch.equal(loaded.handle()(b), out)
    assert loaded.handle().decisions == s.handle().decisions
    loaded.on_resize(4)
    np.testing.assert_allclose(loaded.handle()(b).numpy(), a.to_dense() @ b,
                               rtol=2e-4, atol=2e-4)
    a_new = _port_csr(R.power_law_sparse(64, 64, 400, 1.2, seed=41))
    loaded.replan(a_new)
    np.testing.assert_allclose(loaded.handle()(b).numpy(),
                               a_new.to_dense() @ b, rtol=2e-4, atol=2e-4)
    # the rung payload is the handle's own save format
    h = s.handle()
    plan_file = tmp_path / "plan.shiro"
    h.save(str(plan_file))
    from repro_torch import DistSpmm

    assert torch.equal(DistSpmm.load(str(plan_file), device="cpu")(b), out)


def test_bundle_version_errors(tmp_path, power_law_matrix):
    s = _build(power_law_matrix(), dict(), None)
    path = str(tmp_path / "bundle")
    s.save(path, include_operand=False)
    meta_path = os.path.join(path, "session.json")
    meta = json.loads(open(meta_path).read())
    assert not meta["has_operand"]
    for key, value, match in (("version", 99, "version 99.*Re-save"),
                              ("format", "shiro.SpmmSession",
                               "not a saved SpmmSession")):
        bad = dict(meta, **{key: value})
        with open(meta_path, "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError, match=match):
            SpmmSession.load(path, P, device="cpu")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    loaded = SpmmSession.load(path, P, device="cpu")
    with pytest.raises(ValueError, match="no operand matrix"):
        loaded._replan_rung(P, warm=False)
    with pytest.raises(ValueError, match="no session.json"):
        SpmmSession.load(str(tmp_path / "nope"), P, device="cpu")
    # a rung payload of an unknown version names its file
    import pickle

    rung = os.path.join(path, "rung_P00008.shiro")
    payload = pickle.load(open(rung, "rb"))
    payload["version"] = 7
    pickle.dump(payload, open(rung, "wb"))
    meta["files"] = None  # skip the digests: test the version check
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match=r"rung_P00008.*version 7"):
        SpmmSession.load(path, P, device="cpu")


def test_torn_bundle_names_the_file(tmp_path, power_law_matrix):
    s = _build(power_law_matrix(), dict(schedule="auto"), (2, 4), where=4)
    path = str(tmp_path / "bundle")
    with inject([Fault(kind="torn_checkpoint", site="atomic_dir",
                       file="rung", mode="truncate")]) as plan:
        s.save(path)
    assert plan.fired("torn_checkpoint") == 1
    with pytest.raises(ValueError, match=r"rung_P\d+\.shiro.*truncated"):
        SpmmSession.load(path, 4, device="cpu")
    s.save(path)  # an untorn save replaces it and loads
    b = _b(seed=2)
    assert torch.equal(SpmmSession.load(path, 4, device="cpu").handle()(b),
                       s.handle()(b))


def test_stage_commit_adopt_topology(power_law_matrix):
    a = power_law_matrix()
    s = _build(a, dict(), (2, 4, 8))
    h8 = s.handle()
    b = _b(seed=8)
    h8(b)
    n0 = plan_build_count()
    staged = s.stage_topology(4)
    assert s.current_P == 8 and s.handle() is h8  # staging mutates nothing
    assert staged.P == 4 and staged.rung.handle.cache_info()["keys"] == \
        h8.cache_info()["keys"]
    h4 = s.commit_topology(staged)
    assert s.current_P == 4 and s.topology.P == 4 and h4.P == 4
    assert plan_build_count() == n0  # staging reuses the rung's plan
    np.testing.assert_allclose(h4(b).numpy(), a.to_dense() @ b,
                               rtol=2e-4, atol=2e-4)
    assert s.adopt_topology(2).P == 2 and s.stats()["current_P"] == 2
    assert "handle" in s.stats() and repr(s).startswith("SpmmSession(")


def test_lifecycle_stats_equal_reference(power_law_matrix):
    a = power_law_matrix()
    ref = RSession.build(a, P, R.SpmmConfig(schedule="auto"),
                         p_ladder=(4, 8))
    ours = _build(a, dict(schedule="auto"), (4, 8))
    keys = ("drift", "drift_threshold", "donated_buffers",
            "values_refreshes", "measured_time", "decision_source",
            "total_allocation_size")
    h, rh = ours.handle(), ref.handle()
    assert {k: h.stats()[k] for k in keys} == \
        {k: rh.stats()[k] for k in keys if k != "total_allocation_size"} | \
        {"total_allocation_size": None}
    other = R.power_law_sparse(64, 64, 400, 1.2, seed=41)
    assert h.drift(_port_csr(other)) == rh.drift(other) > 0.0
    assert h.stats()["drift"] == rh.stats()["drift"]
    session_keys = ("ladder", "current_P", "generation", "replans", "swaps",
                    "values_refreshes", "skipped_rungs", "pattern_nnz",
                    "pattern_fingerprint", "drift_threshold", "materialized")
    assert {k: ours.stats()[k] for k in session_keys} == \
        {k: ref.stats()[k] for k in session_keys}
