"""The port's hier SDDMM / FusedMM family against ``repro``'s (CPU, plain
versions).

``hier_sddmm``, ``hier_spmm_values`` and ``hier_fused`` give the
reference's sampled values and C (2e-4, ``tests/test_sddmm.py``'s
tolerance) on a (2, 4) grid of 8 ranks, for coo and bsr, the single round
and bucketed K ∈ {1, 4}, with and without the ``leaky_relu`` edge — the
reference's bsr through its jnp oracle, and through Pallas in interpret
mode in one case; the fused handle's group-axis log has the spmm call's
group pairs plus the reversed X rounds (no second gather round).
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
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import planner as t_plan  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402

G, L = 2, 4
P = G * L
F, N = 8, 16
TOL = dict(rtol=2e-4, atol=2e-4)
R_BSR = RBsr(block=(8, 8), bn=16, impl="ref")


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
    rh = R.build_hier_plan(R.build_plan(a, P, "joint"), G, L)
    th = t_hier.build_hier_plan(t_plan.build_plan(_port_csr(a), P, "joint"),
                                G, L)
    rs = None if K is None else R.build_hier_comm_schedule(rh, K=K)
    ts = None if K is None else t_sched.build_hier_comm_schedule(th, K=K)
    r_ex = r_dist.hier_exec_arrays(rh, backends=("coo", r_bsr), schedule=rs)
    t_ex = t_dist.hier_exec_arrays(th, backends=("coo", "bsr"), schedule=ts)
    return r_ex, t_ex


@pytest.mark.parametrize("edge", [None, "leaky_relu"])
@pytest.mark.parametrize("K", [None, 1, 4], ids=["single", "K1", "K4"])
@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_hier_sddmm_values_fused_match_reference(power_law_matrix, backend,
                                                 K, edge):
    a, x, y, b = _problem(power_law_matrix)
    r_ex, t_ex = _plans(a, K)
    mesh = make_spmm_mesh(P, groups=G)

    @jax.jit
    def reference(x, y, b):
        vals = r_sddmm.hier_sddmm(r_ex, x, y, mesh, backend=backend,
                                  edge=edge)
        return (vals,
                r_sddmm.hier_spmm_values(r_ex, vals, b, mesh,
                                         backend=backend),
                r_sddmm.hier_fused(r_ex, x, y, b, mesh, backend=backend,
                                   edge=edge))

    want_vals, want_comp, want_fused = reference(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(b))
    xt, yt, bt = (torch.from_numpy(v) for v in (x, y, b))
    vals = t_sddmm.hier_sddmm(t_ex, xt, yt, backend=backend, edge=edge)
    assert sorted(vals) == ["colp", "diag", "rowp"]
    for piece, v in vals.items():
        want = np.asarray(want_vals[piece])
        want = want.reshape((P,) + want.shape[2:])  # [G, L, ...] -> [P, ...]
        if backend == "bsr":  # the reference pads F for the TPU's lanes
            want = want[..., :v.shape[-1]]
        np.testing.assert_allclose(v.numpy(), want, err_msg=piece, **TOL)
    comp = t_sddmm.hier_spmm_values(t_ex, vals, bt, backend=backend)
    fused = t_sddmm.fused_sddmm_spmm(t_ex, xt, yt, bt, backend=backend,
                                     edge=edge)
    np.testing.assert_allclose(comp.numpy(), np.asarray(want_comp), **TOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want_fused), **TOL)
    np.testing.assert_allclose(fused.numpy(), _oracle(a, x, y, b, edge),
                               **TOL)
    assert torch.equal(fused, t_sddmm.hier_fused(t_ex, xt, yt, bt,
                                                 backend=backend, edge=edge))


def test_hier_fused_bsr_matches_reference_pallas_interpret(power_law_matrix):
    """One case against the reference's Pallas kernels in interpret mode."""
    a, x, y, b = _problem(power_law_matrix, seed=11)
    r_ex, t_ex = _plans(a, 4, r_bsr=RBsr(block=(8, 8), bn=16))
    mesh = make_spmm_mesh(P, groups=G)
    want = jax.jit(lambda x, y, b: r_sddmm.hier_fused(
        r_ex, x, y, b, mesh, backend="bsr", edge="leaky_relu"))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(b))
    got = t_sddmm.hier_fused(t_ex, *(torch.from_numpy(v) for v in (x, y, b)),
                             backend="bsr", edge="leaky_relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hier_fused_log_same_group_pairs_as_spmm(power_law_matrix):
    """The fused call's group-axis ppermute pairs equal the plain SpMM
    call's on one (pattern, bucketed hier schedule), with exactly
    len(cg_segments) more group exchanges (the reversed X rounds) and one
    more local all_gather (the X rows); the single round adds one group
    all_to_all."""
    a, x, y, b = _problem(power_law_matrix)
    ap = _port_csr(a)
    h_spmm = T.compile_spmm(ap, P, hier=(G, L), schedule=4, overlap=False,
                            device="cpu")
    h_fused = T.compile_fused(ap, P, hier=(G, L), schedule=4, device="cpu")
    h_spmm(b)
    spmm_log = list(h_spmm.comm.log)
    h_fused(x, y, b)
    fused_log = list(h_fused.comm.log)
    grp = lambda log: [e for e in log if e[0].endswith("@g")]  # noqa: E731
    pairs = lambda log: {p for _, ps, _ in grp(log) for p in ps}  # noqa: E731
    ops = lambda log: [op for op, _, _ in log]  # noqa: E731
    assert pairs(fused_log) == pairs(spmm_log)
    n_c = len(h_spmm.ex.meta["cg_segments"])
    assert len(grp(fused_log)) == len(grp(spmm_log)) + n_c
    assert ops(fused_log).count("all_gather@l") == \
        ops(spmm_log).count("all_gather@l") + 1
    h1 = T.compile_fused(ap, P, hier=(G, L), schedule="single", device="cpu")
    h1(x, y, b)
    assert ops(h1.comm.log).count("all_to_all@g") == 3
