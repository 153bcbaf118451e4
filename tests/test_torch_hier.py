"""The port's hierarchical tier against ``repro``'s (CPU, plain versions).

Host side, for (G, L) ∈ {(2, 4), (4, 2), (2, 2)} on the three matrix
families of ``tests/test_dist_spmm.py``: ``build_hier_plan``,
``hier_piece_csrs``, ``group_shift_slot_demands``,
``build_hier_comm_schedule`` / ``hier_schedule_layout`` (K ∈ {1, 2, 4}),
the ``modeled_time_hier*`` functions, ``choose_hier_schedule`` /
``choose_hier_fused_schedule``, ``inter_group_rows`` and
``build_group_aware_plan`` give exactly the reference's arrays and values.

Executor: ``hier_spmm``'s C matches the reference's ``hier_spmm`` (jitted,
its bsr in Pallas interpret mode) within 2e-4 for {single, K = 1, K = 4}
× {coo, bsr}, also when the port runs the reference's own exec arrays
through ``hier_exec_from_numpy``; overlapped C equals staged C under
``torch.equal``; the group-axis log carries exactly
``volume_rows_padded`` rows for both backends, and staged and overlapped
carry the same group ppermutes and no all_to_all (as
``tests/test_overlap.py`` pins on HLO).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import comm_model as r_model  # noqa: E402
from repro.core import comm_schedule as r_sched  # noqa: E402
from repro.core import dist_spmm as r_dist  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import planner as r_plan  # noqa: E402
from repro.core.sparse import (  # noqa: E402
    hub_sparse, power_law_sparse, random_sparse,
)
from repro.launch.mesh import make_spmm_mesh  # noqa: E402
from repro_torch.core import comm_model as t_model  # noqa: E402
from repro_torch.core import comm_schedule as t_sched  # noqa: E402
from repro_torch.core import dist_spmm as t_dist  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import planner as t_plan  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.distributed.comm import LocalComm  # noqa: E402

BACKENDS = ("coo", "bsr")
GRIDS = [(2, 4), (4, 2), (2, 2)]
# each grid's executor case on one family; the host cases run all three
FAMILY = {(2, 4): "powerlaw", (4, 2): "hub", (2, 2): "uniform"}


def _matrix(name):
    return {
        "uniform": lambda: random_sparse(64, 64, 0.05, 1),
        "powerlaw": lambda: power_law_sparse(64, 64, 400, 1.2, 2),
        "hub": lambda: hub_sparse(64, 64, 2, 2, 0.3, 3),
    }[name]()


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _same_csrs(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), what
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f"{what}.{f}")


def _same_plan(got, want, what):
    for f in ("P", "shape", "strategy", "max_b", "max_c"):
        assert getattr(got, f) == getattr(want, f), f"{what}.{f}"
    for f in ("bounds", "b_send_idx", "c_send_rows"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{what}.{f}")
    for f in ("a_diag", "a_colpart", "a_rowpart"):
        _same_csrs(getattr(got, f), getattr(want, f), f"{what}.{f}")


def _same_hier(got, want, what):
    assert (got.G, got.L, got.max_bg, got.max_cg) == \
        (want.G, want.L, want.max_bg, want.max_cg), what
    for f in ("b_group_send_idx", "c_group_rows", "c_slot_of_pair"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{what}.{f}")
    for g, w in zip(got.colpart_flat_cols, want.colpart_flat_cols):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.colpart")
    assert got.inter_group_rows() == want.inter_group_rows(), what
    assert got.inter_group_rows_flat() == want.inter_group_rows_flat(), what


def _sched_dict(s):
    return dataclasses.asdict(s)


def _hier_pair(a, G, L):
    rp = r_plan.build_plan(a, G * L, "joint")
    tp = t_plan.build_plan(_port_csr(a), G * L, "joint")
    return r_hier.build_hier_plan(rp, G, L), t_hier.build_hier_plan(tp, G, L)


@pytest.mark.parametrize("G,L", GRIDS)
def test_host_plans_schedules_models_equal_reference(G, L):
    net = r_model.TSUBAME_LIKE
    for name in ("uniform", "powerlaw", "hub"):
        what = f"{name}/{G}x{L}"
        rh, th = _hier_pair(_matrix(name), G, L)
        _same_hier(th, rh, what)
        rp, tp = r_hier.hier_piece_csrs(rh), t_hier.hier_piece_csrs(th)
        for piece in ("diag", "colp", "rowp"):
            _same_csrs(tp[piece], rp[piece], f"{what}/{piece}")
        for got, want in zip(t_sched.group_shift_slot_demands(th),
                             r_sched.group_shift_slot_demands(rh)):
            np.testing.assert_array_equal(got, want, err_msg=what)
        assert _sched_dict(t_sched.single_round_hier_schedule(th)) == \
            _sched_dict(r_sched.single_round_hier_schedule(rh))
        scheds = []
        for K in (1, 2, 4):
            rs = r_sched.build_hier_comm_schedule(rh, K=K)
            ts = t_sched.build_hier_comm_schedule(th, K=K)
            assert _sched_dict(ts) == _sched_dict(rs), f"{what}/K={K}"
            assert ts.volume_rows_padded() == rs.volume_rows_padded()
            rl = r_sched.hier_schedule_layout(rh, rs)
            tl = t_sched.hier_schedule_layout(th, ts)
            assert (tl.off_bg, tl.off_cg, tl.R_bg, tl.R_cg) == \
                (rl.off_bg, rl.off_cg, rl.R_bg, rl.R_cg), f"{what}/K={K}"
            for f in ("b_send_idx", "c_recv_rows"):
                np.testing.assert_array_equal(getattr(tl, f), getattr(rl, f),
                                              err_msg=f"{what}/K={K}/{f}")
            _same_csrs(tl.colp, rl.colp, f"{what}/K={K}/colp")
            _same_csrs(tl.rowp, rl.rowp, f"{what}/K={K}/rowp")
            scheds.append((rs, ts))
        single = (r_sched.single_round_hier_schedule(rh),
                  t_sched.single_round_hier_schedule(th))
        for n in (16, 64):
            assert t_model.modeled_time_hier(th, n, net) == \
                r_model.modeled_time_hier(rh, n, net)
            for rs, ts in scheds + [single]:
                assert t_model.modeled_time_hier_schedule(ts, n, net) == \
                    r_model.modeled_time_hier_schedule(rs, n, net)
                assert t_model.modeled_time_hier_staged(th, ts, n, net) == \
                    r_model.modeled_time_hier_staged(rh, rs, n, net)
                assert t_model.modeled_time_hier_overlap(th, ts, n, net) == \
                    r_model.modeled_time_hier_overlap(rh, rs, n, net)
                assert t_model.modeled_time_hier_fused_schedule(
                    ts, 8, n, net) == \
                    r_model.modeled_time_hier_fused_schedule(rs, 8, n, net)
            for overlap in (False, "auto", True):
                got = t_model.choose_hier_schedule(th, n, net, k_max=4,
                                                   overlap=overlap)
                want = r_model.choose_hier_schedule(rh, n, net, k_max=4,
                                                    overlap=overlap)
                assert _sched_dict(got[0]) == _sched_dict(want[0])
                assert got[1:] == want[1:], f"{what}/{overlap}"
            got = t_model.choose_hier_fused_schedule(th, 8, n, net)
            want = r_model.choose_hier_fused_schedule(rh, 8, n, net)
            assert _sched_dict(got[0]) == _sched_dict(want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("G,L", GRIDS)
def test_group_aware_plan_equals_reference(G, L):
    for name in ("uniform", "powerlaw", "hub"):
        a = _matrix(name)
        r_base, r_h, r_changed = r_hier.build_group_aware_plan(a, G * L, G,
                                                               L)
        t_base, t_h, t_changed = t_hier.build_group_aware_plan(
            _port_csr(a), G * L, G, L)
        assert t_changed == r_changed, name
        _same_plan(t_base, r_base, name)
        _same_hier(t_h, r_h, name)
        assert sum(t_h.inter_group_rows()) <= sum(t_hier.build_hier_plan(
            t_plan.build_plan(_port_csr(a), G * L), G, L).inter_group_rows()
        ), name


def _fields(ex):
    """The reference hier exec plan as plain numpy arrays + its metadata."""
    def arr(x):
        return np.asarray(x)

    return {
        "pieces": {be: {name: {k: arr(v) for k, v in piece.items()}
                        for name, piece in pieces.items()}
                   for be, pieces in ex.pieces.items()},
        "b_group_send_idx": arr(ex.b_group_send_idx),
        "c_recv_rows": arr(ex.c_recv_rows),
        "agg_perm": arr(ex.agg_perm),
        "agg_meta": arr(ex.agg_meta),
        "seg_agg": {k: arr(v) for k, v in ex.seg_agg.items()},
        "meta": dict(ex.meta),
    }


def _exec_pair(a, G, L, K):
    rh, th = _hier_pair(a, G, L)
    rs = None if K is None else r_sched.build_hier_comm_schedule(rh, K=K)
    ts = None if K is None else t_sched.build_hier_comm_schedule(th, K=K)
    r_ex = r_dist.hier_exec_arrays(rh, backends=BACKENDS, schedule=rs)
    t_ex = t_dist.hier_exec_arrays(th, backends=BACKENDS, schedule=ts)
    rows = (ts or t_sched.single_round_hier_schedule(th)).volume_rows_padded()
    return r_ex, t_ex, rows


def _run(ex, b, backend, overlap=False):
    comm = LocalComm(ex.P, ex.G)
    c = t_dist.hier_spmm(ex, torch.from_numpy(b), comm, backend=backend,
                         overlap=overlap)
    return c, comm


@pytest.mark.parametrize("G,L", GRIDS)
@pytest.mark.parametrize("K", [None, 1, 4], ids=["single", "K1", "K4"])
def test_hier_spmm_matches_reference(G, L, K):
    name = FAMILY[(G, L)]
    a = _matrix(name)
    P = G * L
    b = np.random.default_rng(P * 10 + (K or 0)).standard_normal(
        (64, 8)).astype(np.float32)
    r_ex, t_ex, want_rows = _exec_pair(a, G, L, K)
    from_ref = t_dist.hier_exec_from_numpy(_fields(r_ex))
    mesh = make_spmm_mesh(P, groups=G)
    ref_fn = jax.jit(lambda v: [r_dist.hier_spmm(r_ex, v, mesh, backend=be)
                                for be in BACKENDS])
    wants = [np.asarray(c) for c in ref_fn(jnp.asarray(b))]
    logs = []
    for be, want in zip(BACKENDS, wants):
        what = f"{name}/{G}x{L}/K={K}/{be}"
        got, comm = _run(t_ex, b, be)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=what)
        np.testing.assert_allclose(got.numpy(), a.to_dense() @ b, rtol=2e-4,
                                   atol=2e-4, err_msg=what + "/dense")
        got_ref_ex, comm_ref_ex = _run(from_ref, b, be)
        np.testing.assert_allclose(got_ref_ex.numpy(), want, rtol=2e-4,
                                   atol=2e-4, err_msg=what + "/from_ref")
        assert comm_ref_ex.log == comm.log, what
        assert comm.rows("g") == want_rows, what
        assert comm.rows("x") == 0, what
        assert comm.rows() == comm.rows("g") + comm.rows("l"), what
        logs.append(comm.log)
        if K is not None:
            over, comm_over = _run(t_ex, b, be, overlap=True)
            assert torch.equal(over, got), what + "/overlap"
            assert comm_over.rows("g") == want_rows, what
    assert logs[0] == logs[1], f"{name}: collectives depend on backend"


@pytest.mark.parametrize("K", [1, 4])
def test_overlap_same_group_permutes(power_law_matrix, K):
    """Staged and overlapped run the same group-axis ppermutes (pairs and
    rows) and no all_to_all; only the local-axis collectives split per
    round."""
    a = power_law_matrix()
    _, t_ex, want_rows = _exec_pair(a, 2, 4, K)
    b = np.random.default_rng(5).standard_normal((64, 8)).astype(np.float32)
    for be in BACKENDS:
        _, st = _run(t_ex, b, be)
        _, ov = _run(t_ex, b, be, overlap=True)
        grp = lambda c: sorted(e for e in c.log if e[0].endswith("@g"))  # noqa: E731,E501
        assert grp(st) == grp(ov) and grp(st)
        assert {op for op, _, _ in grp(st)} == {"ppermute@g"}
        assert not any(op.startswith("all_to_all") for op, _, _ in
                       st.log + ov.log)
        assert st.rows("g") == ov.rows("g") == want_rows
        # one reduce-scatter per consumed C shift when overlapped
        n_c = len(t_ex.meta["cg_all"])
        assert [op for op, _, _ in ov.log].count("psum_scatter@l") == n_c
        assert [op for op, _, _ in st.log].count("psum_scatter@l") == 1


def test_hier_exec_errors(power_law_matrix):
    a = _port_csr(power_law_matrix())
    th = t_hier.build_hier_plan(t_plan.build_plan(a, 8), 2, 4)
    ex = t_dist.hier_exec_arrays(
        th, schedule=t_sched.build_hier_comm_schedule(th, K=2),
        overlap_layouts=False)
    b = torch.zeros((64, 4))
    with pytest.raises(ValueError, match="overlap_layouts"):
        t_dist.hier_spmm(ex, b, overlap=True)
    with pytest.raises(ValueError, match="the plan needs"):
        t_dist.hier_spmm(ex, b, LocalComm(8))
    with pytest.raises(ValueError, match="not divisible"):
        t_dist.hier_spmm(ex, torch.zeros((63, 4)))
    with pytest.raises(ValueError, match="G\\*L"):
        t_hier.build_hier_plan(t_plan.build_plan(a, 8), 2, 3)
