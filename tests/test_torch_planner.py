"""The port's host-side planner equals the JAX package's, array for array.

``repro_torch.core.{sparse,mwvc,planner,comm_schedule,comm_model}`` are
copies; this holds them to the reference on the executor test families
(``tests/test_dist_spmm.py``) and the ``power_law_matrix`` fixture.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import comm_model as r_model  # noqa: E402
from repro.core import comm_schedule as r_sched  # noqa: E402
from repro.core import planner as r_plan  # noqa: E402
from repro.core import sparse as r_sparse  # noqa: E402
from repro.kernels.scatter_add_rows import (  # noqa: E402
    prepare_sorted_scatter as r_prepare,
)
from repro_torch.core import comm_model as t_model  # noqa: E402
from repro_torch.core import comm_schedule as t_sched  # noqa: E402
from repro_torch.core import planner as t_plan  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.kernels.scatter_add_rows import (  # noqa: E402
    prepare_sorted_scatter as t_prepare,
)

STRATEGIES = ["block", "col", "row", "joint"]


def _families(mod):
    return [
        ("uniform", mod.random_sparse(64, 64, 0.05, 1)),
        ("powerlaw", mod.power_law_sparse(64, 64, 400, 1.2, 2)),
        ("hub", mod.hub_sparse(64, 64, 2, 2, 0.3, 3)),
    ]


def _port_csr(a):
    """The same matrix as the port's CSRMatrix (identical arrays)."""
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _csr_equal(x, y, what):
    assert tuple(x.shape) == tuple(y.shape), what
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f),
                                      err_msg=f"{what}.{f}")


def _schedule_tuple(s):
    """The flat schedule's fields (the port's CommSchedule has no hier
    fields) with its rounds as plain tuples."""
    d = {f.name: getattr(s, f.name)
         for f in dataclasses.fields(t_sched.CommSchedule)}
    d["rounds"] = tuple(tuple(sorted(dataclasses.asdict(r).items()))
                        for r in s.rounds)
    return tuple(sorted(d.items()))


# a network whose fast tier spans every rank, next to TSUBAME_LIKE (whose
# group of 4 puts P = 8 on the slow tier)
_WIDE = dict(name="wide", bw_intra=50e9, bw_inter=6.25e9, group_size=256)


def _plans(power_law_matrix):
    fams = list(zip(_families(r_sparse), _families(t_sparse)))
    fams.append((("fixture", power_law_matrix()),
                 ("fixture", t_sparse.power_law_sparse(64, 64, 400, 1.2, 2))))
    return fams


def test_generators_and_ell_equal(power_law_matrix):
    for (name, ra), (_, ta) in _plans(power_law_matrix):
        _csr_equal(ra, ta, name)
        for block in [(8, 8), (4, 16)]:
            for rx, tx in zip(r_sparse.ell_from_csr(ra, block),
                              t_sparse.ell_from_csr(ta, block)):
                np.testing.assert_array_equal(rx, tx, err_msg=name)
        assert (r_sparse.pattern_snapshot(ra).fingerprint
                == t_sparse.pattern_snapshot(ta).fingerprint)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("P", [4, 8])
def test_build_plan_fields_equal(strategy, P, power_law_matrix):
    for (name, ra), _ in _plans(power_law_matrix):
        rp = r_plan.build_plan(ra, P, strategy)
        tp = t_plan.build_plan(_port_csr(ra), P, strategy)
        what = f"{name}/{strategy}/P={P}"
        assert (rp.P, tuple(rp.shape), rp.strategy, tuple(rp.bounds),
                rp.max_b, rp.max_c) == (tp.P, tuple(tp.shape), tp.strategy,
                                        tuple(tp.bounds), tp.max_b, tp.max_c)
        np.testing.assert_array_equal(rp.b_send_idx, tp.b_send_idx)
        np.testing.assert_array_equal(rp.c_send_rows, tp.c_send_rows)
        assert rp.pair_plans.keys() == tp.pair_plans.keys()
        for key, pp in rp.pair_plans.items():
            np.testing.assert_array_equal(pp.col_ids,
                                          tp.pair_plans[key].col_ids)
            np.testing.assert_array_equal(pp.row_ids,
                                          tp.pair_plans[key].row_ids)
        for piece in ("a_diag", "a_colpart", "a_rowpart"):
            for i, (x, y) in enumerate(zip(getattr(rp, piece),
                                           getattr(tp, piece))):
                _csr_equal(x, y, f"{what}/{piece}[{i}]")
        assert rp.volume_rows() == tp.volume_rows()
        assert rp.volume_rows_padded() == tp.volume_rows_padded()
        for K in (1, 2, 4):
            rs = r_sched.build_comm_schedule(rp, K=K)
            ts = t_sched.build_comm_schedule(tp, K=K)
            assert _schedule_tuple(rs) == _schedule_tuple(ts), what
            assert rp.volume_rows_padded(rs) == tp.volume_rows_padded(ts)
            rl = r_sched.flat_schedule_layout(rp, rs)
            tl = t_sched.flat_schedule_layout(tp, ts)
            assert (rl.off_b, rl.off_c, rl.R_b, rl.R_c) == \
                (tl.off_b, tl.off_c, tl.R_b, tl.R_c)
            np.testing.assert_array_equal(rl.b_send_idx, tl.b_send_idx)
            np.testing.assert_array_equal(rl.c_recv_rows, tl.c_recv_rows)
            for i, (x, y) in enumerate(zip(rl.colp + rl.rowp,
                                           tl.colp + tl.rowp)):
                _csr_equal(x, y, f"{what}/K={K}/layout[{i}]")


@pytest.mark.parametrize("P", [4, 8])
def test_model_decisions_equal(P, power_law_matrix):
    for (name, ra), _ in _plans(power_law_matrix):
        ta = _port_csr(ra)
        assert r_model.strategy_volumes(ra, P, 16) == \
            t_model.strategy_volumes(ta, P, 16), name
        rp, tp = r_plan.build_plan(ra, P), t_plan.build_plan(ta, P)
        assert dataclasses.asdict(r_model.TSUBAME_LIKE) == \
            dataclasses.asdict(t_model.TSUBAME_LIKE)
        for net, rn, tn in [
                ("TSUBAME_LIKE", r_model.TSUBAME_LIKE, t_model.TSUBAME_LIKE),
                ("wide", r_model.NetworkSpec(**_WIDE),
                 t_model.NetworkSpec(**_WIDE))]:
            assert r_model.modeled_time(rp, 64, rn) == \
                t_model.modeled_time(tp, 64, tn)
            for overlap in (False, "auto", True):
                rc = r_model.choose_schedule(rp, 64, rn, k_max=4,
                                             overlap=overlap)
                tc = t_model.choose_schedule(tp, 64, tn, k_max=4,
                                             overlap=overlap)
                assert _schedule_tuple(rc[0]) == _schedule_tuple(tc[0])
                assert rc[1:] == tc[1:], f"{name}/{net}/{overlap}"
                for fn in ("modeled_time_schedule", "modeled_time_staged",
                           "modeled_time_overlap"):
                    assert getattr(r_model, fn)(rp, rc[0], 64, rn) == \
                        getattr(t_model, fn)(tp, tc[0], 64, tn)


def test_prepare_sorted_scatter_equal():
    rng = np.random.default_rng(3)
    for S in (1, 7, 64):
        tgt = rng.integers(-1, 16, size=S).astype(np.int32)
        for rx, tx in zip(r_prepare(tgt), t_prepare(tgt)):
            np.testing.assert_array_equal(rx, tx)
    for rx, tx in zip(r_prepare(np.full(5, -1, np.int32)),
                      t_prepare(np.full(5, -1, np.int32))):
        np.testing.assert_array_equal(rx, tx)


def test_plan_build_count_counts_port_builds():
    before = t_plan.plan_build_count()
    t_plan.build_plan(t_sparse.random_sparse(32, 32, 0.1, 0), 4)
    assert t_plan.plan_build_count() == before + 1
