"""The port's flat executor against ``repro.flat_spmm`` (CPU, plain versions).

For 4 strategies × P ∈ {4, 8} × {single round, bucketed K=4}, each
strategy on one of the executor families of ``tests/test_dist_spmm.py``
(every family is covered; the reference runs jitted, with its bsr
backend in Pallas interpret mode): the port's C matches
the reference's C for coo and bsr (to the executor tolerance 2e-4), also
when the port runs the reference's own exec arrays through
``flat_exec_from_numpy``; overlapped C is bit-identical to staged C; the
collective log is the same for every backend and carries exactly
``volume_rows_padded`` rows.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import comm_schedule as r_sched  # noqa: E402
from repro.core import dist_spmm as r_dist  # noqa: E402
from repro.core import planner as r_plan  # noqa: E402
from repro.core.sparse import (  # noqa: E402
    hub_sparse, power_law_sparse, random_sparse,
)
from repro.launch.mesh import make_spmm_mesh  # noqa: E402
from repro_torch.core import comm_schedule as t_sched  # noqa: E402
from repro_torch.core import dist_spmm as t_dist  # noqa: E402
from repro_torch.core import planner as t_plan  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.distributed.comm import LocalComm  # noqa: E402

BACKENDS = ("coo", "bsr")


FAMILY = {"block": "uniform", "col": "hub", "row": "uniform",
          "joint": "powerlaw"}


def _matrix(name):
    return {
        "uniform": lambda: random_sparse(64, 64, 0.05, 1),
        "powerlaw": lambda: power_law_sparse(64, 64, 400, 1.2, 2),
        "hub": lambda: hub_sparse(64, 64, 2, 2, 0.3, 3),
    }[name]()


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _fields(ex):
    """The reference exec plan as plain numpy arrays + its metadata."""
    def arr(x):
        return np.asarray(x)

    return {
        "pieces": {be: {name: {k: arr(v) for k, v in piece.items()}
                        for name, piece in pieces.items()}
                   for be, pieces in ex.pieces.items()},
        "b_send_idx": arr(ex.b_send_idx),
        "c_recv_rows": arr(ex.c_recv_rows),
        "agg_perm": arr(ex.agg_perm),
        "agg_meta": arr(ex.agg_meta),
        "seg_agg": {k: arr(v) for k, v in ex.seg_agg.items()},
        "meta": dict(ex.meta),
    }


def _run(ex, b, backend, overlap=False):
    comm = LocalComm(ex.P)
    c = t_dist.flat_spmm(ex, torch.from_numpy(b), comm, backend=backend,
                         overlap=overlap)
    return c, comm.log


@pytest.mark.parametrize("strategy", ["block", "col", "row", "joint"])
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("K", [None, 4])
def test_flat_spmm_matches_reference(strategy, P, K):
    name = FAMILY[strategy]
    a = _matrix(name)
    b = np.random.default_rng(P * 10 + (K or 0)).standard_normal(
        (64, 8)).astype(np.float32)
    rp = r_plan.build_plan(a, P, strategy)
    tp = t_plan.build_plan(_port_csr(a), P, strategy)
    rs = None if K is None else r_sched.build_comm_schedule(rp, K=K)
    ts = None if K is None else t_sched.build_comm_schedule(tp, K=K)
    r_ex = r_dist.flat_exec_arrays(rp, backends=BACKENDS, schedule=rs)
    t_ex = t_dist.flat_exec_arrays(tp, backends=BACKENDS, schedule=ts)
    from_ref = t_dist.flat_exec_from_numpy(_fields(r_ex))
    want_rows = tp.volume_rows_padded(ts)
    mesh = make_spmm_mesh(P)
    ref_fn = jax.jit(lambda v: [r_dist.flat_spmm(r_ex, v, mesh, backend=be)
                                for be in BACKENDS])
    wants = [np.asarray(c) for c in ref_fn(jnp.asarray(b))]
    logs = []
    for be, want in zip(BACKENDS, wants):
        what = f"{name}/{strategy}/P={P}/K={K}/{be}"
        got, log = _run(t_ex, b, be)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=what)
        got_ref_ex, log_ref_ex = _run(from_ref, b, be)
        np.testing.assert_allclose(got_ref_ex.numpy(), want, rtol=2e-4,
                                   atol=2e-4, err_msg=what + "/from_ref")
        assert log_ref_ex == log, what
        assert sum(r for _, _, r in log) == want_rows, what
        logs.append(log)
        if K is not None:
            over, log_over = _run(t_ex, b, be, overlap=True)
            assert torch.equal(over, got), what + "/overlap"
            assert sorted(log_over) == sorted(log), what
    assert logs[0] == logs[1], f"{name}: collectives depend on backend"


def test_overlap_needs_overlap_layouts():
    a = _port_csr(power_law_sparse(64, 64, 400, 1.2, 2))
    plan = t_plan.build_plan(a, 4)
    ex = t_dist.flat_exec_arrays(plan, schedule=t_sched.build_comm_schedule(
        plan, K=2), overlap_layouts=False)
    b = torch.zeros((64, 4))
    with pytest.raises(ValueError, match="overlap_layouts"):
        t_dist.flat_spmm(ex, b, overlap=True)
    with pytest.raises(ValueError, match="no prepared pieces"):
        t_dist.flat_spmm(ex, b, backend="bsr")
    with pytest.raises(ValueError, match="not divisible"):
        t_dist.flat_spmm(ex, torch.zeros((63, 4)))


@pytest.mark.parametrize("K", [None, 4])
def test_coo_pieces_carry_row_maps(K):
    """Every coo piece (diag, colp, rowp and the overlapped body's
    colp@i / rowp@i) carries the sorted-scatter maps of its row array,
    pads at -1; entries are in CSR order, so each row's fold runs in
    ascending column order."""
    a = _port_csr(power_law_sparse(64, 64, 400, 1.2, 2))
    plan = t_plan.build_plan(a, 8)
    sched = None if K is None else t_sched.build_comm_schedule(plan, K=K)
    ex = t_dist.flat_exec_arrays(plan, schedule=sched)
    names = set(ex.pieces["coo"])
    assert {"diag", "colp", "rowp"} <= names
    if K is not None:
        assert any(n.startswith("colp@") for n in names)
    for name, piece in ex.pieces["coo"].items():
        row, col, val = (piece[k].numpy() for k in ("row", "col", "val"))
        for p in range(row.shape[0]):
            nnz = int(piece["meta"][p, -1])
            tgt = np.where(np.arange(row.shape[1]) < nnz, row[p], -1)
            perm, meta = t_dist.prepare_sorted_scatter(tgt)
            np.testing.assert_array_equal(piece["perm"][p].numpy(), perm,
                                          err_msg=name)
            np.testing.assert_array_equal(piece["meta"][p].numpy(), meta,
                                          err_msg=name)
            assert not val[p, nnz:].any(), name
            key = row[p, :nnz].astype(np.int64) * 64 + col[p, :nnz]
            assert (np.diff(key) > 0).all(), name


def test_coo_piece_with_maps_folds_every_stored_entry():
    """Arrays made elsewhere say nothing of padding, so every entry joins
    its row, as in the reference's scatter-add; a stored explicit zero at
    (0, 0) that is last in its rank stays in the fold."""
    from repro_torch.core.local_backend import coo_piece_with_maps

    row = np.array([[1, 2, 0], [0, 3, 0]], np.int32)
    col = np.array([[4, 1, 0], [2, 2, 0]], np.int32)
    val = np.array([[1.0, 2.0, 0.0], [3.0, 4.0, 0.0]], np.float32)
    piece = coo_piece_with_maps({k: torch.from_numpy(v) for k, v in
                                 (("row", row), ("col", col), ("val", val))})
    for p in range(2):
        perm, meta = t_dist.prepare_sorted_scatter(row[p])
        np.testing.assert_array_equal(piece["perm"][p].numpy(), perm)
        np.testing.assert_array_equal(piece["meta"][p].numpy(), meta)
        assert int(piece["meta"][p, -1]) == 3
    assert coo_piece_with_maps(piece) is piece


def test_coo_overlapped_bit_identical_through_k1_k2_plain():
    """The coo fold goes through the K1/K2 plain versions on the CPU, and
    overlapped C stays bit-identical to staged C (and run to run)."""
    from repro_torch.kernels import gather_rows, scatter_add_rows

    a = _port_csr(power_law_sparse(64, 64, 400, 1.2, 2))
    plan = t_plan.build_plan(a, 8)
    ex = t_dist.flat_exec_arrays(plan, schedule=t_sched.build_comm_schedule(
        plan, K=4))
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (64, 8)).astype(np.float32))
    calls = {"gather": 0, "scatter": 0}
    orig_g, orig_s = (gather_rows.gather_rows_plain,
                      scatter_add_rows.scatter_add_rows_plain)

    def count(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    gather_rows.gather_rows_plain = count("gather", orig_g)
    scatter_add_rows.scatter_add_rows_plain = count("scatter", orig_s)
    try:
        staged = t_dist.flat_spmm(ex, b, backend="coo")
        n_staged = dict(calls)
        over = t_dist.flat_spmm(ex, b, backend="coo", overlap=True)
    finally:
        gather_rows.gather_rows_plain = orig_g
        scatter_add_rows.scatter_add_rows_plain = orig_s
    # staged: the B pack + 3 piece gathers; 3 piece folds + the aggregation
    assert n_staged == {"gather": 4, "scatter": 4}
    assert torch.equal(over, staged)
    assert torch.equal(t_dist.flat_spmm(ex, b, backend="coo"), staged)
    np.testing.assert_allclose(staged.numpy(), a.to_dense() @ b.numpy(),
                               rtol=2e-4, atol=2e-4)
