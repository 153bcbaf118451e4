"""The port's SDDMM / FusedMM family against ``repro``'s (CPU, plain versions).

Executor level: ``flat_sddmm``, ``flat_spmm_values`` and ``flat_fused``
give the reference's values and C (2e-4, ``tests/test_sddmm.py``'s
tolerance) on 8 ranks, for coo and bsr, the single round and bucketed
K ∈ {1, 4}, with and without the ``leaky_relu`` edge; the reference's
bsr runs through its jnp oracle, and through Pallas in interpret mode in
one case. Handle level: ``compile_sddmm`` / ``compile_fused`` decisions
equal the reference's exactly, per-call ``kernel=`` / ``edge=``, arity
and guard errors, tagged memo keys, ``stats()``, ``save`` / ``load``.
Collective level: the fused call's log has the spmm call's shift pairs
and ``len(c_segments)`` more exchanges (no second gather round).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import dist_sddmm as r_sddmm  # noqa: E402
from repro.core import dist_spmm as r_dist  # noqa: E402
from repro.core.local_backend import BsrBackend as RBsr  # noqa: E402
from repro.launch.mesh import make_spmm_mesh  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import comm_schedule as t_sched  # noqa: E402
from repro_torch.core import dist_sddmm as t_sddmm  # noqa: E402
from repro_torch.core import dist_spmm as t_dist  # noqa: E402
from repro_torch.core import planner as t_plan  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.distributed.comm import LocalComm  # noqa: E402
from repro_torch.kernels.ops import prepare_sorted_scatter  # noqa: E402
from repro_torch.robustness.guards import NumericalFault  # noqa: E402

P = 8
F, N = 8, 16
TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's bsr through its jnp oracle (fast); Pallas interpret mode
# runs in one case below
R_BSR = RBsr(block=(8, 8), bn=16, impl="ref")
DECISION_KEYS = ("kernel", "edge", "schedule_kind", "schedule_K", "overlap",
                 "volume_rows", "volume_rows_padded",
                 "volume_rows_padded_single", "decision_source")


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _problem(power_law_matrix, seed=7):
    a = power_law_matrix()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((a.shape[0], F)).astype(np.float32)
    y = rng.standard_normal((a.shape[1], F)).astype(np.float32)
    b = rng.standard_normal((a.shape[1], N)).astype(np.float32)
    return a, x, y, b


def _oracle(a, x, y, b, edge=None):
    s = a.to_dense().astype(np.float64) * (x.astype(np.float64) @ y.T)
    if edge == "leaky_relu":
        s = np.where(s > 0, s, 0.2 * s)
    return s @ b


def _plans(a, K, r_bsr=R_BSR):
    rp = R.build_plan(a, P, "joint")
    tp = t_plan.build_plan(_port_csr(a), P, "joint")
    rs = None if K is None else R.build_comm_schedule(rp, K=K)
    ts = None if K is None else t_sched.build_comm_schedule(tp, K=K)
    r_ex = r_dist.flat_exec_arrays(rp, backends=("coo", r_bsr), schedule=rs)
    t_ex = t_dist.flat_exec_arrays(tp, backends=("coo", "bsr"), schedule=ts)
    return r_ex, t_ex


@pytest.mark.parametrize("edge", [None, "leaky_relu"])
@pytest.mark.parametrize("K", [None, 1, 4], ids=["single", "K1", "K4"])
@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_flat_sddmm_values_fused_match_reference(power_law_matrix, backend,
                                                 K, edge):
    a, x, y, b = _problem(power_law_matrix)
    r_ex, t_ex = _plans(a, K)
    mesh = make_spmm_mesh(P)

    @jax.jit
    def reference(x, y, b):
        vals = r_sddmm.flat_sddmm(r_ex, x, y, mesh, backend=backend,
                                  edge=edge)
        return (vals,
                r_sddmm.flat_spmm_values(r_ex, vals, b, mesh,
                                         backend=backend),
                r_sddmm.flat_fused(r_ex, x, y, b, mesh, backend=backend,
                                   edge=edge))

    want_vals, want_comp, want_fused = reference(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(b))
    xt, yt, bt = (torch.from_numpy(v) for v in (x, y, b))
    vals = t_sddmm.flat_sddmm(t_ex, xt, yt, backend=backend, edge=edge)
    assert sorted(vals) == ["colp", "diag", "rowp"]
    for piece, v in vals.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_vals[piece]),
                                   err_msg=piece, **TOL)
    comp = t_sddmm.flat_spmm_values(t_ex, vals, bt, backend=backend)
    fused = t_sddmm.flat_fused(t_ex, xt, yt, bt, backend=backend, edge=edge)
    np.testing.assert_allclose(comp.numpy(), np.asarray(want_comp), **TOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want_fused), **TOL)
    np.testing.assert_allclose(fused.numpy(), _oracle(a, x, y, b, edge),
                               **TOL)


def test_flat_fused_bsr_matches_reference_pallas_interpret(power_law_matrix):
    """One case against the reference's Pallas kernels in interpret mode."""
    a, x, y, b = _problem(power_law_matrix, seed=11)
    r_ex, t_ex = _plans(a, 4, r_bsr=RBsr(block=(8, 8), bn=16))
    mesh = make_spmm_mesh(P)
    want = jax.jit(lambda x, y, b: r_sddmm.flat_fused(
        r_ex, x, y, b, mesh, backend="bsr", edge="leaky_relu"))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(b))
    got = t_sddmm.flat_fused(t_ex, *(torch.from_numpy(v) for v in (x, y, b)),
                             backend="bsr", edge="leaky_relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_runs_reference_exec_arrays(power_law_matrix):
    """The reference's own exec arrays, carried over as numpy, serve the
    port's fused executor (coo pieces gain their row maps on the way:
    every entry joins its row, as in the reference's scatter-add, so a
    pad adds an exact zero where the port's own pieces skip it)."""
    from test_torch_flat_spmm import _fields

    a, x, y, b = _problem(power_law_matrix, seed=5)
    r_ex, t_ex = _plans(a, 4)
    from_ref = t_dist.flat_exec_from_numpy(_fields(r_ex))
    for piece in ("diag", "colp", "rowp"):
        got = from_ref.pieces["coo"][piece]
        row = got["row"].numpy()
        assert torch.equal(got["row"], t_ex.pieces["coo"][piece]["row"])
        for p in range(row.shape[0]):
            perm, meta = prepare_sorted_scatter(row[p])
            np.testing.assert_array_equal(got["perm"][p].numpy(), perm)
            np.testing.assert_array_equal(got["meta"][p].numpy(), meta)
    args = [torch.from_numpy(v) for v in (x, y, b)]
    for be in ("coo", "bsr"):
        assert torch.equal(t_sddmm.flat_fused(from_ref, *args, backend=be),
                           t_sddmm.flat_fused(t_ex, *args, backend=be))


def test_fused_log_same_shift_pairs_as_spmm(power_law_matrix):
    """The acceptance pin of ``test_sddmm.py``, on the collective log: the
    fused call's ppermute pairs equal the plain SpMM call's on one
    (pattern, bucketed schedule), and it makes exactly len(c_segments)
    more exchanges — the reversed X rounds, no second gather round."""
    a, x, y, b = _problem(power_law_matrix)
    ap = _port_csr(a)
    h_spmm = T.compile_spmm(ap, P, schedule=4, overlap=False, device="cpu")
    h_fused = T.compile_fused(ap, P, schedule=4, device="cpu")
    meta = h_spmm.ex.meta
    b_shifts = {d for d, _, _ in meta["b_segments"]}
    c_shifts = {d for d, _, _ in meta["c_segments"]}
    assert {(P - d) % P for d in c_shifts} <= (b_shifts | c_shifts)
    h_spmm(b)
    spmm_log = list(h_spmm.comm.log)
    h_fused(x, y, b)
    fused_log = list(h_fused.comm.log)
    pairs = lambda log: {p for _, ps, _ in log for p in ps}  # noqa: E731
    assert pairs(fused_log) == pairs(spmm_log)
    assert {op for op, _, _ in fused_log} == {"ppermute"}
    assert len(fused_log) == len(spmm_log) + len(meta["c_segments"])
    # single round: the X exchange is one more all_to_all
    h1 = T.compile_fused(ap, P, schedule="single", device="cpu")
    h1(x, y, b)
    assert [op for op, _, _ in h1.comm.log] == ["all_to_all"] * 3


@pytest.mark.parametrize("cfg", [
    dict(kernel="fused", edge="leaky_relu", backends=("coo", "bsr")),
    dict(kernel="fused", schedule="single"),
    dict(kernel="fused", schedule=2, n_dense_hint=128),
    dict(kernel="sddmm"),
    dict(kernel="sddmm", strategy="col", k_max=2),
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_decisions_equal_reference(cfg, power_law_matrix):
    for a, p in [(power_law_matrix(), 8),
                 (R.random_sparse(64, 64, 0.05, 1), 4)]:
        ref = R.compile_spmm(a, p, R.SpmmConfig(**cfg))
        h = T.compile_spmm(_port_csr(a), p, T.SpmmConfig(**cfg),
                           device="cpu")
        assert h.decisions == ref.decisions
        want, got = ref.stats(), h.stats()
        assert {k: got[k] for k in DECISION_KEYS} == \
            {k: want[k] for k in DECISION_KEYS}
        if cfg["kernel"] == "fused":
            assert "modeled_time_fused" in got


def test_compile_wrappers_and_per_call_kernel(power_law_matrix):
    a, x, y, b = _problem(power_law_matrix)
    ap = _port_csr(a)
    s_ref = a.to_dense() * (x @ y.T)
    hs = T.compile_sddmm(ap, P, device="cpu")
    ref_hs = R.compile_sddmm(a, P)
    vals = hs(x, y)
    want = ref_hs(x, y)
    assert sorted(vals) == ["colp", "diag", "rowp"]
    for piece in vals:
        np.testing.assert_allclose(vals[piece].numpy(),
                                   np.asarray(want[piece]), **TOL)
    st = hs.stats()
    assert (st["kernel"], st["edge"], st["overlap"]) == ("sddmm", None, False)
    composed = hs(x, y, b, kernel="fused")
    np.testing.assert_allclose(composed.numpy(), s_ref @ b, **TOL)
    # a plain spmm handle serves the siblings per call too
    h0 = T.compile_spmm(ap, P, device="cpu")
    assert h0.stats()["kernel"] == "spmm" and h0.stats()["edge"] is None
    np.testing.assert_allclose(
        h0(x, y, b, kernel="fused", edge="leaky_relu").numpy(),
        _oracle(a, x, y, b, edge="leaky_relu"), **TOL)
    np.testing.assert_allclose(h0(b).numpy(), a.to_dense() @ b, **TOL)
    # a fused handle's default edge, overridden per call
    hf = T.compile_fused(ap, P, edge="leaky_relu", device="cpu")
    np.testing.assert_allclose(hf(x, y, b, edge=None).numpy(),
                               s_ref @ b, **TOL)
    assert "kernel=fused" in repr(hf) and "kernel=" not in repr(h0)


def test_config_kernel_validation():
    with pytest.raises(ValueError, match="kernel"):
        T.SpmmConfig(kernel="spgemm")
    with pytest.raises(ValueError, match="edge"):
        T.SpmmConfig(kernel="fused", edge="softmax")
    with pytest.raises(ValueError, match="edge"):
        T.SpmmConfig(kernel="spmm", edge="leaky_relu")
    assert T.SpmmConfig(kernel="fused", edge="leaky_relu").edge == \
        "leaky_relu"


def test_kernel_arity_and_guard_errors(power_law_matrix):
    a, x, y, b = _problem(power_law_matrix)
    h = T.compile_spmm(_port_csr(a), P, device="cpu")
    with pytest.raises(TypeError, match=r"kernel='spmm' takes 1"):
        h(x, y)
    with pytest.raises(TypeError, match=r"kernel='sddmm' takes 2"):
        h(x, kernel="sddmm")
    with pytest.raises(TypeError, match=r"kernel='fused' takes 3"):
        h(x, y, kernel="fused")
    with pytest.raises(TypeError, match="edge"):
        h(b, edge="leaky_relu")
    with pytest.raises(ValueError, match="edge must be"):
        h(x, y, kernel="sddmm", edge="softmax")
    # operand validation names the offending operand before any kernel
    with pytest.raises(ValueError, match="X has 32 rows"):
        h(np.ones((32, F), np.float32), y, kernel="sddmm")
    with pytest.raises(ValueError, match="Y has 32 rows"):
        h(x, np.ones((32, F), np.float32), kernel="sddmm")
    with pytest.raises(ValueError, match="X has F=8 .* Y has F=4"):
        h(x, np.ones((64, 4), np.float32), kernel="sddmm")
    with pytest.raises(ValueError, match="B has 32 rows"):
        h(x, y, np.ones((32, N), np.float32), kernel="fused")
    # a coo fused call differentiates (the autograd slice lifted the
    # refusal); a bsr SpMM phase has no gradient, as in the reference
    xg = torch.from_numpy(x).requires_grad_()
    assert h(xg, y, b, kernel="fused").grad_fn is not None
    hb = T.compile_spmm(_port_csr(a), P, backends=("bsr",), device="cpu")
    with pytest.raises(NotImplementedError, match="no JVP"):
        hb(xg, y, b, kernel="fused")
    # a poisoned operand trips the sampled sweep of the sampled values
    bad = x.copy()
    bad[:, 0] = np.nan
    with pytest.raises(NumericalFault, match="output leaf"):
        h(bad, y, kernel="sddmm")
    assert h.stats()["numerical_faults"] == 1


def test_memo_keys_stats_and_save_load(tmp_path, power_law_matrix):
    a, x, y, b = _problem(power_law_matrix)
    h = T.compile_fused(_port_csr(a), P, backends=("coo", "bsr"),
                        edge="leaky_relu", device="cpu")
    c = h(x, y, b)
    c_bsr = h(x, y, b, backend="bsr")
    assert torch.equal(h(x, y, b), c)  # a hit, the same bits
    vals = h(x, y, kernel="sddmm")
    info = h.cache_info()
    assert info["keys"] == (
        ("fused", F, N, "float32", "float32", "float32", "coo",
         "leaky_relu"),
        ("fused", F, N, "float32", "float32", "float32", "bsr",
         "leaky_relu"),
        ("sddmm", F, "float32", "float32", "coo", "leaky_relu"))
    assert (info["lowerings"], info["hits"]) == (3, 1)
    st = h.stats()
    assert (st["kernel"], st["edge"], st["calls"]) == ("fused", "leaky_relu",
                                                       4)
    path = tmp_path / "fused.shiro"
    h.save(str(path))
    h2 = T.DistSpmm.load(str(path), device="cpu")
    assert (h2.kernel, h2.edge) == ("fused", "leaky_relu")
    assert h2.decisions == h.decisions
    assert torch.equal(h2(x, y, b), c)
    assert torch.equal(h2(x, y, b, backend="bsr"), c_bsr)
    vals2 = h2(x, y, kernel="sddmm")
    assert all(torch.equal(vals2[k], vals[k]) for k in vals)


def test_sddmm_log_matches_comm_volume(power_law_matrix):
    """SDDMM moves the spmm call's rows: Y over the gather rounds and X
    over the reversed C rounds."""
    a, x, y, b = _problem(power_law_matrix)
    h = T.compile_sddmm(_port_csr(a), P, schedule=4, device="cpu")
    h(x, y)
    assert h.comm.rows() == h.plan.volume_rows_padded(h.schedule)
    comm = LocalComm(P)
    t_sddmm.flat_sddmm(h.ex, torch.from_numpy(x), torch.from_numpy(y), comm)
    assert comm.log == h.comm.log
