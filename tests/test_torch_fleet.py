"""The port's SpmmFleet, ReshardSpec and topology groups against the
reference's (``tests/test_fleet.py``, every case, at its sizes and seeds).

Each scenario runs through both packages on the same numpy inputs: the
placements, per-group scores, imbalance, migrations, routes, moved rows
and every counter are equal to the reference's; each served C is
``torch.equal`` to the port's cold ``compile_spmm`` on the (pattern, P)
it was served under and within 2e-4 of the reference's served C.

One card emulates every rank, so the reference's assertions on a group's
``devices`` become assertions on its (P, device, group): a group is a
contiguous span of the emulated ranks on the parent's device, named by
its absolute ``group`` span.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core.api import SpmmConfig as RConfig  # noqa: E402
from repro.core.sparse import block_rows as r_block_rows  # noqa: E402
from repro.core.sparse import power_law_sparse  # noqa: E402
from repro.distributed.topology import Topology as RTopology  # noqa: E402
from repro.robustness import Fault as RFault  # noqa: E402
from repro.robustness import faults as r_faults  # noqa: E402
from repro.robustness import inject as r_inject  # noqa: E402
from repro.serving.fleet import ReshardSpec as RReshardSpec  # noqa: E402
from repro.serving.fleet import SpmmFleet as RFleet  # noqa: E402
from repro_torch import (  # noqa: E402
    ReshardSpec, SpmmConfig, SpmmFleet, SpmmSession, Topology,
    TopologyError, compile_spmm,
)
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.core.planner import plan_build_count  # noqa: E402
from repro_torch.core.sparse import block_rows  # noqa: E402
from repro_torch.robustness import Fault, faults, inject  # noqa: E402

# the reference's fingerprint-hash placement parities: both heavies land
# on group 1, the light tenant on group 0 — a load-suboptimal arrangement
# rebalance() must fix with one migration (tests/test_fleet.py)
HEAVY_SEEDS = (0, 3)
LIGHT_SEED = 0
FLEET_CFG = dict(n_dense_hint=4096)
TOL = 2e-4
# Topology.local(8, "cpu").fingerprint() on the tree before groups: an
# ungrouped topology's describe() gained no key, so autotune cache
# entries written then still hit
UNGROUPED_FINGERPRINT = "fd0e1904bd7f8a27e9dd5f5bda8b327080dae98c"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from repro.core import autotune as r_autotune
    from repro_torch.core import autotune

    for mod in (autotune, r_autotune):
        monkeypatch.delenv(mod.CACHE_ENV, raising=False)
        monkeypatch.delenv(mod.MEASURE_ENV, raising=False)
    for mod in (faults, r_faults):
        monkeypatch.delenv(mod.FAULTS_ENV, raising=False)
        mod.uninstall()
    monkeypatch.delenv("REPRO_FLEET_REBALANCE_THRESHOLD", raising=False)
    yield
    faults.uninstall()
    r_faults.uninstall()


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _heavy(seed):
    return power_law_sparse(512, 512, 16000, 1.2, seed=seed)


def _light(seed):
    return power_law_sparse(64, 64, 300, 1.2, seed=seed)


def _b(rows, seed=7, cols=8):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, cols)).astype(np.float32)


def _fleets(group_sizes, **kw):
    """The port's fleet (CPU) and the reference's, on 8 ranks."""
    cfg = kw.pop("config", None)
    ours = SpmmFleet(Topology.local(8, "cpu"), group_sizes,
                     config=None if cfg is None else SpmmConfig(**cfg), **kw)
    ref = RFleet(RTopology.local(8), group_sizes,
                 config=None if cfg is None else RConfig(**cfg), **kw)
    return ours, ref


def _cold(a, P, cfg=None):
    return compile_spmm(_port_csr(a), P, SpmmConfig(**(cfg or {})),
                        device="cpu")


def _check_c(got: torch.Tensor, cold: torch.Tensor, ref) -> None:
    assert got.device.type == "cpu" and torch.equal(got, cold)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def _same_state(ours, ref) -> None:
    """Host-side fleet state equal to the reference's."""
    assert ours.placements() == ref.placements()
    assert ours.group_loads() == ref.group_loads()
    assert ours.imbalance() == ref.imbalance()
    assert (ours.migrations, ours.failed_migrations) == \
        (ref.migrations, ref.failed_migrations)
    assert ours.events == ref.events
    for name, t in ours.tenants.items():
        r = ref.tenants[name]
        assert t.scores == r.scores and t.group_idx == r.group_idx
        assert t.session.current_P == r.session.current_P
    so, sr = ours.stats(), ref.stats()
    assert so["tenants"] == sr["tenants"]


# ---------------------------------------------------------------------------
# topology carving
# ---------------------------------------------------------------------------


def test_topology_split_groups():
    topo = Topology.local(8, "cpu")
    g0, g1 = topo.split((4, 4))
    r0, r1 = RTopology.local(8).split((4, 4))
    assert g0.P == g1.P == 4
    assert g0.group == r0.group == (0, 4) and g1.group == r1.group == (4, 8)
    # one device emulates every rank: a group is a span of the parent's
    # ranks on the parent's device (the reference: a slice of devices)
    assert g0.device == g1.device == topo.device
    assert (g0.kind, g1.kind) == (topo.kind, topo.kind)
    # whole-fleet describe()/fingerprint() stay byte-stable: no "group"
    assert "group" not in topo.describe()
    assert topo.fingerprint() == UNGROUPED_FINGERPRINT
    assert g0.describe()["group"] == (0, 4)
    # carved groups are distinct substrates even at identical shape
    assert len({g0.fingerprint(), g1.fingerprint(), topo.fingerprint()}) == 3
    # nested carving keeps the ABSOLUTE span
    inner = g1.subtopology(slice(1, 3))
    assert inner.group == (5, 7) and inner.P == 2
    assert inner.group == r1.subtopology(slice(1, 3)).group
    # a trailing remainder may stay uncarved
    h0, h1 = topo.split((4, 2))
    assert h1.group == (4, 6) and h1.P == 2
    # narrowing a group keeps its span, as the reference's replace does
    assert g1.narrow(2).group == (4, 8) == r1.narrow(2).group


@pytest.mark.parametrize("call,match", [
    (lambda t: t.split((5, 4)), "sum to"),
    (lambda t: t.split((4, 0)), ">= 1"),
    (lambda t: t.split(()), "at least one"),
    (lambda t: t.subtopology(slice(0, 8, 2)), "contiguous"),
    (lambda t: t.subtopology(slice(4, 4)), "empty"),
])
def test_topology_split_errors(call, match):
    with pytest.raises(TopologyError, match=match) as ours:
        call(Topology.local(8, "cpu"))
    with pytest.raises(ValueError) as ref:
        call(RTopology.local(8))
    assert str(ours.value) == str(ref.value)


def test_resolve_expect_p_mismatch_is_actionable():
    with pytest.raises(TopologyError, match="exactly 4 rank"):
        Topology.resolve(8, "cpu", expect_p=4)
    with pytest.raises(TopologyError, match="accepted coercions"):
        Topology.resolve(Topology.local(8, "cpu"), expect_p=4)
    assert Topology.resolve(4, "cpu", expect_p=4).P == 4
    # None: the reference's every local device; here the ranks asked for
    assert Topology.resolve(None, "cpu", expect_p=8).P == 8
    with pytest.raises(TopologyError, match="needs expect_p"):
        Topology.resolve(None, "cpu")


# ---------------------------------------------------------------------------
# ReshardSpec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((10, 4), (10, 2)), ((64, 2), (64, 4)),
                                     ((169344, 4), (169344, 8)),
                                     ((7, 3), (7, 3))])
def test_reshard_spec_routes_and_apply(src, dst):
    assert block_rows(*src) == r_block_rows(*src)
    spec = ReshardSpec.between(block_rows(*src), block_rows(*dst))
    ref = RReshardSpec.between(r_block_rows(*src), r_block_rows(*dst))
    assert (spec.rows, spec.src_bounds, spec.dst_bounds, spec.routes) == \
        (ref.rows, ref.src_bounds, ref.dst_bounds, ref.routes)
    assert spec.moved_rows() == ref.moved_rows()
    for r in range(src[1]):
        assert spec.send_ranges(r) == ref.send_ranges(r)
    for r in range(dst[1]):
        assert spec.recv_ranges(r) == ref.recv_ranges(r)
    if src[0] > 100:
        return
    x = np.arange(src[0] * 3.0).reshape(src[0], 3)
    shards = [x[lo:hi] for lo, hi in block_rows(*src)]
    out = spec.apply(shards)
    assert len(out) == dst[1] and all(isinstance(o, np.ndarray) for o in out)
    np.testing.assert_array_equal(np.concatenate(out), x)
    for d, (lo, hi) in enumerate(block_rows(*dst)):
        np.testing.assert_array_equal(out[d], x[lo:hi])
    # tensors: concatenated on their device, the same rows
    t_out = spec.apply([torch.from_numpy(s) for s in shards])
    assert all(isinstance(o, torch.Tensor) for o in t_out)
    assert torch.equal(torch.cat(t_out), torch.from_numpy(x))
    # send/recv views agree with the route set
    sends = [(s, d, lo, hi) for s in range(src[1])
             for d, lo, hi in spec.send_ranges(s)]
    recvs = [(s, d, lo, hi) for d in range(dst[1])
             for s, lo, hi in spec.recv_ranges(d)]
    assert sorted(sends) == sorted(recvs) == sorted(spec.routes)
    # rows covered exactly once
    assert sum(hi - lo for _, _, lo, hi in spec.routes) == src[0]


def test_reshard_spec_rejects_mismatched_partitions():
    with pytest.raises(ValueError, match="different row counts"):
        ReshardSpec.between(block_rows(10, 2), block_rows(12, 2))
    spec = ReshardSpec.between(block_rows(8, 2), block_rows(8, 4))
    with pytest.raises(ValueError, match="source shard"):
        spec.apply([np.zeros((8, 1))])


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_fleet_placement_is_order_independent():
    """Same (patterns, topology, cfg) admitted in ANY order -> identical
    group assignments, the reference's, and every served C bit-identical
    to a cold single-session compile at the group's P."""
    tenants = [("h1", _heavy(HEAVY_SEEDS[0])),
               ("h2", _heavy(HEAVY_SEEDS[1])),
               ("lt", _light(LIGHT_SEED))]
    placements = []
    for order in (tenants, tenants[::-1]):
        ours, ref = _fleets((4, 4), config=FLEET_CFG)
        for name, a in order:
            assert ours.admit(name, _port_csr(a)) == ref.admit(name, a)
        _same_state(ours, ref)
        placements.append(ours.placements())
    assert placements[0] == placements[1]
    # the pinned arrangement the migration tests rely on
    assert placements[0] == {"h1": 1, "h2": 1, "lt": 0}

    for name, a in tenants:
        ours.submit(name, _b(a.shape[1]))
        ref.submit(name, _b(a.shape[1]))
    served, r_served = ours.serve(), ref.serve()
    for name, a in tenants:
        t = ours.tenants[name]
        assert (t.session.topology.P, t.session.topology.device,
                t.session.topology.group) == \
            (4, ours.topology.device, ours.groups[t.group_idx].group)
        _check_c(served[name][0], _cold(a, 4, FLEET_CFG)(_b(a.shape[1])),
                 r_served[name][0])


def test_fleet_admission_respects_memory_budget():
    a = _port_csr(_heavy(HEAVY_SEEDS[0]))
    fleet = SpmmFleet(Topology.local(8, "cpu"), group_sizes=(4, 4))
    with pytest.raises(TopologyError, match="memory_budget"):
        fleet.admit("big", a, SpmmConfig(memory_budget=1))
    with pytest.raises(ValueError, match="already admitted"):
        fleet.admit("dup", a)
        fleet.admit("dup", a)


# ---------------------------------------------------------------------------
# the acceptance scenario
# ---------------------------------------------------------------------------


def test_fleet_migration_drift_serving():
    """admit -> rebalance-migration -> drift-replan, dropped_waves == 0
    per tenant, C bit-identical to cold compiles throughout, every host
    decision the reference's."""
    h1, h2, lt = (_heavy(HEAVY_SEEDS[0]), _heavy(HEAVY_SEEDS[1]),
                  _light(LIGHT_SEED))
    ours, ref = _fleets((4, 4), config=FLEET_CFG, rebalance_threshold=0.25)
    for name, a in [("h1", h1), ("h2", h2), ("lt", lt)]:
        ours.admit(name, _port_csr(a))
        ref.admit(name, a)
    assert ours.placements() == {"h1": 1, "h2": 1, "lt": 0}

    b512, b64 = _b(512), _b(64)
    inputs = [("h1", h1, b512), ("h2", h2, b512), ("lt", lt, b64)]
    for name, _, b in inputs:
        ours.submit(name, b)
        ref.submit(name, b)
    served, r_served = ours.serve(), ref.serve()
    cold = {name: _cold(a, 4, FLEET_CFG)(b) for name, a, b in inputs}
    for name in cold:
        _check_c(served[name][0], cold[name], r_served[name][0])

    # both heavies share group 1: modeled imbalance crosses the
    # threshold and one migration rebalances the fleet — with NO MWVC
    # re-run (the staged rung reuses the session's plan)
    assert ours.imbalance() == ref.imbalance() > ours.threshold
    n0 = plan_build_count()
    moves = ours.rebalance()
    assert moves == ref.rebalance()
    assert len(moves) == 1 and ours.migrations == 1
    assert plan_build_count() == n0
    assert sorted(ours.placements().values()) == [0, 0, 1]
    assert ours.imbalance() <= ours.threshold
    _same_state(ours, ref)

    # waves keep flowing after the migration, still bit-identical
    for name, _, b in inputs:
        ours.submit(name, b)
        ref.submit(name, b)
    served2, r_served2 = ours.serve(), ref.serve()
    for name in cold:
        _check_c(served2[name][0], cold[name], r_served2[name][0])

    # the migrated tenant's pattern drifts: off-path replan, warm swap
    migrated = moves[0][0]
    a_new = power_law_sparse(512, 512, 16000, 1.2, seed=91)
    drift, swapped = ours.maybe_replan(migrated, _port_csr(a_new))
    assert (drift, swapped) == ref.maybe_replan(migrated, a_new)
    assert swapped and drift > \
        ours.tenants[migrated].session.config.drift_threshold
    ours.submit(migrated, b512)
    ref.submit(migrated, b512)
    served3, r_served3 = ours.serve(), ref.serve()
    _check_c(served3[migrated][0], _cold(a_new, 4, FLEET_CFG)(b512),
             r_served3[migrated][0])

    _same_state(ours, ref)
    stats = ours.stats()
    assert stats["migrations"] == 1
    for name, t in stats["tenants"].items():
        assert t["server"]["dropped_waves"] == 0, name


def test_fleet_migrate_fault_rolls_back():
    """An injected ``fleet_migrate_fail`` between stage and commit leaves
    the tenant serving from its source group, drops no wave, and counts
    as a failed migration — as in the reference."""
    h1, h2, lt = (_heavy(HEAVY_SEEDS[0]), _heavy(HEAVY_SEEDS[1]),
                  _light(LIGHT_SEED))
    ours, ref = _fleets((4, 4), config=FLEET_CFG)
    for name, a in [("h1", h1), ("h2", h2), ("lt", lt)]:
        ours.admit(name, _port_csr(a))
        ref.admit(name, a)
    before = ours.placements()

    with inject([Fault(kind="wave_error",
                       site="fleet_migrate_fail")]) as plan:
        moves = ours.rebalance()
    with r_inject([RFault(kind="wave_error",
                          site="fleet_migrate_fail")]) as r_plan:
        assert ref.rebalance() == moves
    assert plan.fired("wave_error") == r_plan.fired("wave_error") == 1
    assert moves == [] and ours.migrations == 0
    assert ours.failed_migrations == 1
    assert ours.placements() == before
    assert any(e["action"] == "migrate_rollback" for e in ours.events)
    _same_state(ours, ref)

    # the source group never stopped serving
    b512 = _b(512)
    ours.submit("h1", b512)
    ref.submit("h1", b512)
    served, r_served = ours.serve(), ref.serve()
    _check_c(served["h1"][0], _cold(h1, 4, FLEET_CFG)(b512),
             r_served["h1"][0])
    assert ours.stats()["tenants"]["h1"]["server"]["dropped_waves"] == 0

    # the fault is gone: the same rebalance now commits
    assert len(ours.rebalance()) == 1 and ours.migrations == 1
    assert len(ref.rebalance()) == 1
    _same_state(ours, ref)


def test_fleet_cross_size_migration_reshards_resident_slabs():
    """Migrating between different-size groups exercises real
    ReshardSpec routes: the resident B/C slabs move rows across ranks
    (on one card, device copies), and serving at the new P stays
    bit-identical."""
    a = _light(LIGHT_SEED)
    ours, ref = _fleets((4, 2))
    ours.admit("t", _port_csr(a), p_ladder=(2, 4))
    ref.admit("t", a, p_ladder=(2, 4))
    src = ours.placements()["t"]
    dst = 1 - src
    b = _b(64)
    ours.submit("t", b)
    ref.submit("t", b)
    ours.serve()
    ref.serve()
    tenant = ours.tenants["t"]
    assert tenant.resident_b is not None
    old_P = tenant.session.current_P

    assert ours.migrate("t", dst) and ref.migrate("t", dst)
    assert ours.placements()["t"] == dst
    move = [e for e in ours.events if e["action"] == "migrate"][-1]
    assert move["b_rows"] > 0 and move["c_rows"] > 0  # real routes
    assert move == [e for e in ref.events if e["action"] == "migrate"][-1]
    # resharded slabs reassemble to the arrays the OLD group served — a
    # reshard moves rows, it never recomputes them
    np.testing.assert_array_equal(np.concatenate(tenant.resident_b), b)
    assert torch.equal(torch.cat(tenant.resident_c), _cold(a, old_P)(b))
    new_P = tenant.session.current_P
    assert new_P != old_P and new_P == ref.tenants["t"].session.current_P
    assert (tenant.session.topology.P, tenant.session.topology.group) == \
        (ours.groups[dst].P, ours.groups[dst].group)

    ours.submit("t", b)
    ref.submit("t", b)
    served, r_served = ours.serve(), ref.serve()
    _check_c(served["t"][0], _cold(a, new_P)(b), r_served["t"][0])
    assert tenant.server.stats.dropped_waves == 0
    _same_state(ours, ref)


# ---------------------------------------------------------------------------
# session migration primitive + grouped grow guard
# ---------------------------------------------------------------------------


def test_session_stage_commit_topology(power_law_matrix):
    a = _port_csr(power_law_matrix())
    g0, g1 = Topology.local(8, "cpu").split((4, 4))
    session = SpmmSession.build(a, g0)
    b = _b(64)
    before = session.handle()(b)

    n0 = plan_build_count()
    staged = session.stage_topology(g1)
    # staging reuses the plan (no MWVC) and never mutates the session
    assert plan_build_count() == n0
    assert session.topology is g0 and session.topology.group == (0, 4)
    assert staged.rung.handle.comm.P == 4  # the group's width
    handle = session.commit_topology(staged)
    assert session.topology.group == (4, 8)
    assert torch.equal(handle(b), before)
    assert session.swaps == 1


def test_grouped_session_cannot_escape_its_group(power_law_matrix):
    a = _port_csr(power_law_matrix())
    g0 = Topology.local(8, "cpu").split((4, 4))[0]
    session = SpmmSession.build(a, g0, p_ladder=(4, 8))
    n0 = plan_build_count()
    with pytest.raises(TopologyError, match="sub-topology group"):
        session.on_resize(8)
    assert plan_build_count() == n0
    # an ungrouped session on the same ranks still grows a local topology
    free = SpmmSession.build(a, 4, p_ladder=(4, 8), device="cpu")
    assert free.on_resize(8).P == 8


def test_fleet_example_serves_every_tenant(capsys):
    """``examples/torch_fleet_serving.py --device cpu`` migrates, replans
    and prints a ``dropped_waves=0`` line per tenant, as the reference's
    example does."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "torch_fleet_serving.py"
    spec = importlib.util.spec_from_file_location("torch_fleet_serving", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("heavy-a", "heavy-b", "light"):
        assert f"tenant={name} " in out
    assert out.count("dropped_waves=0") == 3 and "fleet ok" in out
