"""The port's replicated (1.5D) tier against ``repro``'s (CPU, plain versions).

Host side, for c ∈ {2, 4} lanes at P = 8 on the matrix families of
``tests/test_dist_spmm.py``: ``replicate_plan``'s lane shifts, the
schedule's rounds, the layout arrays (``b_send_idx``, ``c_recv_rows``, the
diag / colp / rowp CSRs), ``modeled_time_replicated`` and
``replicated_device_bytes`` are equal to the reference's, and so are
``_plan_and_tune``'s decisions under ``replicate="auto"``, a forced c,
``hier="auto"`` beside ``"auto"`` and a ``memory_budget`` that filters
every candidate.

Executor: ``replicated_spmm``'s C is within 2e-4 of the reference's
``replicated_spmm`` (jitted on its (c, s) mesh, bsr in Pallas interpret
mode) and within the reference's 1e-4 of dense, for coo and bsr; the
lane-axis rows of the log equal ``volume_rows_padded``. ``replicate=1``
and ``"auto"`` at P = 4 are held to the flat handle by C's bits and an
equal collective log (never HLO text). The front door's validation,
save / load and the sibling kernels' refusal follow
``tests/test_replicate.py``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import api as r_api  # noqa: E402
from repro.core import comm_model as r_model  # noqa: E402
from repro.core import comm_schedule as r_sched  # noqa: E402
from repro.core import dist_spmm as r_dist  # noqa: E402
from repro.core import planner as r_plan  # noqa: E402
from repro.core.sparse import (  # noqa: E402
    CSRMatrix, hub_sparse, power_law_sparse, random_sparse,
)
from repro.distributed.topology import Topology as RTopology  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import comm_model as t_model  # noqa: E402
from repro_torch.core import comm_schedule as t_sched  # noqa: E402
from repro_torch.core import dist_spmm as t_dist  # noqa: E402
from repro_torch.core import planner as t_plan  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.distributed.comm import LocalComm  # noqa: E402

P = 8
BACKENDS = ("coo", "bsr")
FAMILIES = ("uniform", "powerlaw", "hub", "blockdiag", "offdiag")


def _block_matrix(keep, seed):
    """64 × 64 with nonzeros only in the 16 × 16 blocks (i, j) that
    ``keep(i, j)`` selects: block-diagonal A gives every rank an empty
    colp / rowp piece, an off-diagonal one an empty diagonal."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((64, 64), np.float32)
    for i in range(4):
        for j in range(4):
            if keep(i, j):
                blk = rng.standard_normal((16, 16)).astype(np.float32)
                dense[16 * i:16 * i + 16, 16 * j:16 * j + 16] = np.where(
                    rng.random((16, 16)) < 0.15, blk, 0.0)
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(65, np.int32)
    np.cumsum(np.bincount(rows, minlength=64), out=indptr[1:])
    return CSRMatrix((64, 64), indptr, cols.astype(np.int32),
                     dense[rows, cols])


def _matrix(name):
    return {
        "uniform": lambda: random_sparse(64, 64, 0.05, 1),
        "powerlaw": lambda: power_law_sparse(64, 64, 400, 1.2, 2),
        "hub": lambda: hub_sparse(64, 64, 2, 2, 0.3, 3),
        "blockdiag": lambda: _block_matrix(lambda i, j: i == j, 4),
        "offdiag": lambda: _block_matrix(lambda i, j: i != j, 5),
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


def _rounds(sched):
    return dataclasses.asdict(dataclasses.replace(sched, rplan=None))


def _repl_pair(a, c):
    """The reference's and the port's (plan, schedule) at s = P / c."""
    rp = r_plan.replicate_plan(r_plan.build_plan(a, P // c, "joint"), c)
    tp = t_plan.replicate_plan(t_plan.build_plan(_port_csr(a), P // c,
                                                 "joint"), c)
    return (rp, r_sched.build_replicated_schedule(rp)), \
        (tp, t_sched.build_replicated_schedule(tp))


@pytest.mark.parametrize("c", [2, 4])
def test_host_plan_schedule_layout_models_equal_reference(c):
    net = r_model.TSUBAME_LIKE
    for name in FAMILIES:
        what = f"{name}/c={c}"
        (rp, rs), (tp, ts) = _repl_pair(_matrix(name), c)
        assert tp.lane_shifts == rp.lane_shifts, what
        assert (tp.c, tp.s, tp.P) == (rp.c, rp.s, rp.P), what
        assert tp.volume_rows() == rp.volume_rows(), what
        assert _rounds(ts) == _rounds(rs), what
        assert (ts.P, ts.K, ts.R_b, ts.R_c, ts.volume_rows_padded()) == \
            (rs.P, rs.K, rs.R_b, rs.R_c, rs.volume_rows_padded()), what
        rl = r_sched.replicated_schedule_layout(rp, rs)
        tl = t_sched.replicated_schedule_layout(tp, ts)
        assert (tl.R_b, tl.R_c) == (rl.R_b, rl.R_c), what
        for f in ("b_send_idx", "c_recv_rows"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(rl, f),
                                          err_msg=f"{what}/{f}")
        for piece in ("diag", "colp", "rowp"):
            _same_csrs(getattr(tl, piece), getattr(rl, piece),
                       f"{what}/{piece}")
        # lanes > 0 hold no diagonal: the reduce-scatter must not
        # count it twice
        assert all(d.nnz == 0 for d in tl.diag[tp.s:]), what
        for n in (16, 64):
            assert t_model.modeled_time_replicated(tp, ts, n, net) == \
                r_model.modeled_time_replicated(rp, rs, n, net), what
            assert t_model.replicated_device_bytes(tp, ts, n) == \
                r_model.replicated_device_bytes(rp, rs, n), what


@pytest.mark.parametrize("P_,fields", [
    (8, dict(replicate="auto")),
    (8, dict(replicate=2)),
    (8, dict(replicate=4, n_dense_hint=16)),
    (8, dict(replicate="auto", hier="auto")),
    (8, dict(replicate="auto", n_dense_hint=16, memory_budget=1)),
    (8, dict(replicate="auto", memory_budget=200_000)),
    (4, dict(replicate="auto")),
    (8, dict(replicate="auto", schedule="single")),
], ids=lambda v: ",".join(f"{k}={x}" for k, x in v.items())
    if isinstance(v, dict) else f"P={v}")
def test_plan_and_tune_decisions_equal_reference(P_, fields,
                                                 power_law_matrix):
    """The whole decision record, the chosen tier and its schedule equal
    the reference's; a budget no candidate fits comes back flat."""
    for a in (power_law_matrix(), _matrix("uniform")):
        plan, hier, sched, dec = r_api._plan_and_tune(
            a, P_, r_api.SpmmConfig(**fields), RTopology.resolve(P_))
        tplan, thier, tsched, tdec = t_api._plan_and_tune(
            _port_csr(a), P_, t_api.SpmmConfig(**fields),
            T.Topology.local(P_, "cpu"))
        assert tdec == dec
        assert tsched.kind == sched.kind and tplan.P == plan.P
        assert (thier is None) == (hier is None)
        if sched.kind == "replicated":
            assert _rounds(tsched) == _rounds(sched)
            assert tsched.rplan.lane_shifts == sched.rplan.lane_shifts
        else:
            assert dataclasses.asdict(tsched) == dataclasses.asdict(sched)
    if fields.get("memory_budget") == 1:
        assert tdec["replicate"] == 1 and tsched.kind != "replicated"
    if P_ == 4:  # inside one fast group: "auto" keeps c = 1
        assert tdec["replicate"] == 1


def _run(ex, b, backend):
    comm = LocalComm(ex.P, replicas=ex.c)
    c = t_dist.replicated_spmm(ex, torch.from_numpy(b), comm,
                               backend=backend)
    return c, comm


@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("name", ["powerlaw", "hub", "blockdiag",
                                  "offdiag"])
def test_replicated_spmm_matches_reference(c, name):
    """C within 2e-4 of the reference's C (the executor tolerance) and
    within the reference's 1e-4 of dense, on coo and bsr; the lane log
    carries exactly
    ``volume_rows_padded`` rows and does not depend on the backend."""
    a = _matrix(name)
    b = np.random.default_rng(c).standard_normal((64, 8)).astype(np.float32)
    (rp, rs), (tp, ts) = _repl_pair(a, c)
    r_ex = r_dist.replicated_exec_arrays(rp, backends=BACKENDS, schedule=rs)
    t_ex = t_dist.replicated_exec_arrays(tp, backends=BACKENDS, schedule=ts)
    mesh, ra, ax = RTopology.resolve(P).replicated_mesh(c, P // c)
    ref_fn = jax.jit(lambda v: [r_dist.replicated_spmm(
        r_ex, v, mesh, replica_axis=ra, axis=ax, backend=be)
        for be in BACKENDS])
    wants = [np.asarray(w) for w in ref_fn(jnp.asarray(b))]
    dense = a.to_dense() @ b
    logs = []
    for be, want in zip(BACKENDS, wants):
        what = f"{name}/c={c}/{be}"
        got, comm = _run(t_ex, b, be)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=what)
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-4,
                                   err_msg=what + "/dense")
        assert comm.rows("s") == ts.volume_rows_padded(), what
        rs_rows = sum(r for op, _, r in comm.log if op == "psum_scatter@r")
        assert rs_rows == P * 64 // (P // c), what  # c·s ranks × m_local
        assert comm.rows("x") == comm.rows("g") == comm.rows("l") == 0
        logs.append(comm.log)
    assert logs[0] == logs[1], f"{name}: collectives depend on backend"


def _b(seed=0, n=8):
    return np.random.default_rng(seed).standard_normal((64, n)).astype(
        np.float32)


@pytest.mark.parametrize("c", [2, 4])
def test_forced_replication_front_door(c, power_law_matrix):
    a = _port_csr(power_law_matrix())
    h = T.compile_spmm(a, P, T.SpmmConfig(replicate=c,
                                          backends=("coo", "bsr")),
                       device="cpu")
    st = h.stats()
    assert h.strategy == "replicated" and h.P == P
    assert (st["P"], st["replicate"], st["replica_shards"]) == (P, c, P // c)
    assert st["overlap"] is False and st["schedule_kind"] == "replicated"
    assert st["schedule_K"] == h.schedule.K
    assert st["volume_rows_padded"] == h.schedule.volume_rows_padded()
    assert f"replicated(c={c},s={P // c})" in repr(h) and "P=8" in repr(h)
    b = _b(1)
    dense = a.to_dense() @ b
    coo, bsr = h(b), h(b, backend="bsr")
    for got in (coo, bsr):
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-4)
    assert h.comm.rows("s") == h.schedule.volume_rows_padded()
    # call == call bit for bit, coo vs bsr within the executor tolerance
    assert torch.equal(h(b), coo)
    np.testing.assert_allclose(coo.numpy(), bsr.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert h.cache_info()["lowerings"] == 2 and h.cache_info()["hits"] == 1


@pytest.mark.parametrize("P_,fields", [
    (8, dict(replicate=1)), (4, dict(replicate="auto")),
], ids=["replicate=1", "auto-P4"])
def test_replicate_one_is_flat_bit_for_bit(P_, fields, power_law_matrix):
    """``replicate=1`` (and "auto" inside one fast group) is the flat
    handle: the same decisions, C's bits and the same collective log."""
    a = _port_csr(power_law_matrix())
    h0 = T.compile_spmm(a, P_, device="cpu")
    h1 = T.compile_spmm(a, P_, T.SpmmConfig(**fields), device="cpu")
    assert h1.stats()["replicate"] == 1 and h1.strategy == h0.strategy
    assert h1.schedule == h0.schedule
    b = _b(2)
    c0, c1 = h0(b), h1(b)
    assert torch.equal(c0, c1)
    assert h0.comm.log == h1.comm.log and h1.comm.rows("s") == 0


def test_replicated_handle_save_load_roundtrip(power_law_matrix, tmp_path):
    a = _port_csr(power_law_matrix())
    h = T.compile_spmm(a, P, replicate=2, backends=("coo", "bsr"),
                       device="cpu")
    path = str(tmp_path / "rep.shiro-torch")
    h.save(path)
    h2 = T.DistSpmm.load(path, device="cpu")
    assert h2.strategy == "replicated" and h2.P == P
    assert h2.stats()["replicate"] == 2
    b = _b(3)
    for be in ("coo", "bsr"):
        assert torch.equal(h(b, backend=be), h2(b, backend=be))
    assert h.comm.log == h2.comm.log
    with pytest.raises(ValueError, match="P=8"):
        T.DistSpmm.load(path, 4, device="cpu")


def test_replicate_config_validation():
    for bad in (0, -1, True, "bogus", 2.5):
        with pytest.raises((ValueError, TypeError)):
            T.SpmmConfig(replicate=bad)
    with pytest.raises(ValueError, match="spmm"):
        T.SpmmConfig(replicate=2, kernel="sddmm")
    with pytest.raises(ValueError, match="spmm"):
        T.SpmmConfig(replicate="auto", kernel="fused")
    # c = 1 composes with every kernel (it is the do-nothing default)
    T.SpmmConfig(replicate=1, kernel="sddmm")
    for bad in (0, -5):
        with pytest.raises(ValueError, match="memory_budget"):
            T.SpmmConfig(memory_budget=bad)
    assert T.SpmmConfig(memory_budget=1 << 20).memory_budget == 1 << 20


def test_infeasible_forced_replicate_raises(power_law_matrix):
    a = _port_csr(power_law_matrix())
    with pytest.raises(ValueError, match="replicate=3"):
        T.compile_spmm(a, P, replicate=3, device="cpu")
    # s = P / c must be at least 2
    with pytest.raises(ValueError, match="replicate=8"):
        T.compile_spmm(a, P, replicate=8, device="cpu")


def test_replicated_handle_rejects_sibling_kernels(power_law_matrix):
    a = _port_csr(power_law_matrix())
    h = T.compile_spmm(a, P, replicate=2, device="cpu")
    x = np.ones((64, 4), np.float32)
    with pytest.raises(ValueError, match="replicated"):
        h(x, x, kernel="sddmm")
    with pytest.raises(ValueError, match="replicated"):
        h(x, x, x, kernel="fused")


def test_replicated_exec_errors(power_law_matrix):
    a = _port_csr(power_law_matrix())
    tp = t_plan.replicate_plan(t_plan.build_plan(a, 4), 2)
    ex = t_dist.replicated_exec_arrays(tp)
    b = torch.zeros((64, 4))
    with pytest.raises(ValueError, match="staged-only"):
        t_dist.replicated_spmm(ex, b, overlap=True)
    with pytest.raises(ValueError, match="the plan needs"):
        t_dist.replicated_spmm(ex, b, LocalComm(8))
    with pytest.raises(ValueError, match="not divisible"):
        t_dist.replicated_spmm(ex, torch.zeros((62, 4)))
    # m_local = 16 rows a shard: c = 32 lanes cannot split it
    with pytest.raises(ValueError, match="c \\| m_local"):
        t_dist.replicated_exec_arrays(t_plan.replicate_plan(
            t_plan.build_plan(a, 4), 32))
    with pytest.raises(T.TopologyError, match="c\\*s"):
        T.Topology.local(8, "cpu").replicated_mesh(3, 2)
