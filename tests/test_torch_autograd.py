"""Gradients through the port's kernel ops and SpMM executors (CPU, plain versions).

Each op's backward is held against the explicit transpose of its linear
map, built densely in float64 (1e-5: a float32 fold against float64):
pack (K1), aggregation (K2), coo accumulation (K1 scaled + K2, with the
values' gradient), the coo SDDMM and K5. On the CPU the backward walks the
kernels' plain versions in the composition the card runs (counted here).

Through the executors, at P = 8 on ``power_law_matrix``: ``dB`` of
``½‖h(b)‖²`` from the port's ``backward()`` equals the reference's
``jax.grad`` of the same loss within its own tolerances (1e-4 for a
handle, ``tests/test_api.py``; 5e-3 for an overlapped one,
``tests/test_overlap.py``) and ``Aᵀ(A b)`` in float64, for flat (single,
bucketed staged, bucketed overlapped), hier and replicated handles. Two
runs give the same bits, overlapped grads stay within 5e-3 of staged
ones, the backward's collectives carry the forward's rows axis by axis,
a bsr SpMM under grad raises, and a call without grad builds no graph
and no backward map.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import dist_spmm as t_dist  # noqa: E402
from repro_torch.core import local_backend as t_lb  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.kernels import bsr_spmm as K34  # noqa: E402
from repro_torch.kernels import gather_rows as K1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import scatter_add_rows as K2  # noqa: E402
from repro_torch.kernels import sddmm as K5  # noqa: E402

P, N = 8, 16
OP_TOL = dict(rtol=1e-5, atol=1e-5)
HANDLE_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_api.py:297
OVERLAP_TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_overlap.py:207


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _b(seed=0, k=64, n=N):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# each op's backward against the explicit transpose
# ---------------------------------------------------------------------------


def _select(idx, k):
    """The [S, k] 0/1 matrix of out[s] = b[idx[s]] (-1 pads: zero rows)."""
    m = np.zeros((idx.size, k))
    ok = idx >= 0
    m[np.flatnonzero(ok), idx[ok]] = 1.0
    return m


def test_pack_backward_is_the_transposed_gather():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((3, 10, 5)).astype(np.float32)
    idx = rng.integers(-1, 10, size=(3, 2, 7)).astype(np.int32)  # dups, pads
    g = rng.standard_normal((3, 2, 7, 5))
    bt = _t(b, grad=True)
    out = ops.pack_rows_op(bt, torch.from_numpy(idx))
    assert out.shape == (3, 2, 7, 5) and out.grad_fn is not None
    out.backward(torch.from_numpy(g).float())
    for p in range(3):
        want = _select(idx[p].reshape(-1), 10).T @ g[p].reshape(-1, 5)
        np.testing.assert_allclose(bt.grad[p].numpy(), want, **OP_TOL)


def test_aggregate_backward_passes_c_and_packs_partials():
    rng = np.random.default_rng(1)
    tgt = rng.integers(-1, 6, size=(2, 9)).astype(np.int32)
    perm, meta = map(torch.from_numpy, ops.stack_sorted_scatter(tgt))
    c0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    parts = rng.standard_normal((2, 9, 4)).astype(np.float32)
    g = rng.standard_normal((2, 6, 4)).astype(np.float32)
    ct, pt = _t(c0, grad=True), _t(parts, grad=True)
    c = ct * 1.0  # a non-leaf, as the executors' accumulators are
    out = ops.scatter_add_rows_exec_op(c, pt, perm, meta)
    assert out is c and out.grad_fn is not None
    for p in range(2):
        want = c0[p] + _select(tgt[p], 6).T @ parts[p]
        np.testing.assert_allclose(out[p].detach().numpy(), want, **OP_TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ct.grad.numpy(), g)
    for p in range(2):
        np.testing.assert_allclose(pt.grad[p].numpy(),
                                   _select(tgt[p], 6) @ g[p], **OP_TOL)
    np.testing.assert_array_equal(
        ops.slot_targets(perm, meta).numpy(), np.where(tgt >= 0, tgt, -1))


def _coo_piece(seed, shape=(12, 10)):
    rng = np.random.default_rng(seed)
    csrs = [_port_csr(R.random_sparse(*shape, d, seed=seed + p))
            for p, d in enumerate((0.3, 0.1, 0.2))]
    return t_lb.CooBackend().prepare(csrs), csrs, rng


@pytest.mark.parametrize("with_maps", [False, True],
                         ids=["prepared", "reference_arrays"])
def test_coo_accumulate_backward_db_and_dval(with_maps):
    """db = Aᵀ g over the piece's transposed maps; dval[e] = g[row]·b[col]
    for the entries that join a row (pads of a prepared piece join none;
    those of a piece made from the reference's arrays join row 0)."""
    piece, csrs, rng = _coo_piece(3)
    if with_maps:
        piece = t_lb.coo_piece_with_maps(
            {k: piece[k] for k in ("row", "col", "val")})
    b = rng.standard_normal((3, 10, 4)).astype(np.float32)
    g = rng.standard_normal((3, 12, 4)).astype(np.float32)
    bt = _t(b, grad=True)
    val = piece["val"].clone().requires_grad_()
    acc = torch.zeros((3, 12, 4))
    out = ops.coo_accumulate_rows_op(acc, piece["col"], val, piece["perm"],
                                     piece["meta"], bt)
    out.backward(torch.from_numpy(g))
    row, col = piece["row"].numpy(), piece["col"].numpy()
    for p, csr in enumerate(csrs):
        a = csr.to_dense().astype(np.float64)
        np.testing.assert_allclose(out[p].detach().numpy(), a @ b[p],
                                   **OP_TOL)
        np.testing.assert_allclose(bt.grad[p].numpy(), a.T @ g[p], **OP_TOL)
        joins = np.arange(row.shape[1]) < (row.shape[1] if with_maps
                                           else csr.nnz)
        want = np.where(joins, np.einsum("ef,ef->e", g[p][row[p]],
                                         b[p][col[p]]), 0.0)
        np.testing.assert_allclose(val.grad[p].numpy(), want, **OP_TOL)


def test_coo_sddmm_backward_against_dense():
    piece, csrs, rng = _coo_piece(5)
    x = rng.standard_normal((3, 12, 6)).astype(np.float32)
    y = rng.standard_normal((3, 10, 6)).astype(np.float32)
    xt, yt = _t(x, grad=True), _t(y, grad=True)
    val = piece["val"].clone().requires_grad_()
    vals = t_lb.coo_sddmm_op(dict(piece, val=val), xt, yt)
    g = rng.standard_normal(tuple(vals.shape)).astype(np.float32)
    vals.backward(torch.from_numpy(g))
    row, col = piece["row"].numpy(), piece["col"].numpy()
    for p, csr in enumerate(csrs):
        nnz = csr.nnz
        gd = np.zeros((12, 10))
        np.add.at(gd, (row[p, :nnz], col[p, :nnz]), g[p, :nnz])
        w = csr.to_dense() * gd  # d loss / d (x_i · y_j) per stored entry
        np.testing.assert_allclose(xt.grad[p].numpy(), w @ y[p], **OP_TOL)
        np.testing.assert_allclose(yt.grad[p].numpy(), w.T @ x[p], **OP_TOL)
        dots = np.einsum("ef,ef->e", x[p][row[p]], y[p][col[p]])
        np.testing.assert_allclose(val.grad[p].numpy(), g[p] * dots,
                                   **OP_TOL)


def _ell(rng, P_=2, mb=4, t=3, kb=5, bm=8, bk=8):
    """ELL pieces with distinct block columns per block-row and pads."""
    cols = np.full((P_, mb, t), -1, np.int32)
    for p in range(P_):
        for i in range(mb):
            n = rng.integers(0, t + 1)
            cols[p, i, :n] = rng.permutation(kb)[:n]
    blocks = rng.standard_normal((P_, mb, t, bm, bk)).astype(np.float32)
    blocks *= rng.random((P_, mb, t, bm, bk)) < 0.5  # stored zeros
    blocks[cols < 0] = 0.0
    return cols, blocks


def _dense_blocks(cols, blocks, kb):
    P_, mb, t, bm, bk = blocks.shape
    out = np.zeros((P_, mb * bm, kb * bk))
    for p, i, s in zip(*np.nonzero(cols >= 0)):
        c = cols[p, i, s]
        out[p, i * bm:(i + 1) * bm, c * bk:(c + 1) * bk] += blocks[p, i, s]
    return out


def test_bsr_sddmm_backward_against_dense():
    """dX = (A⊙G) Y and dY = (A⊙G)ᵀ X through K3 on the piece and on its
    transposed ELL layout; dblocks = G ⊙ (X Yᵀ) through K5."""
    rng = np.random.default_rng(7)
    kb, f = 5, 6
    cols, blocks = _ell(rng, kb=kb)
    x3 = rng.standard_normal((2, 4, 8, f)).astype(np.float32)
    y3 = rng.standard_normal((2, kb, 8, f)).astype(np.float32)
    bt, xt, yt = _t(blocks, True), _t(x3, True), _t(y3, True)
    out = ops.bsr_sddmm_op(torch.from_numpy(cols), bt, xt, yt)
    g = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    gd = _dense_blocks(cols, g, kb)
    ad = _dense_blocks(cols, blocks, kb)
    for p in range(2):
        x, y = x3[p].reshape(-1, f), y3[p].reshape(-1, f)
        w = ad[p] * gd[p]
        np.testing.assert_allclose(xt.grad[p].reshape(-1, f).numpy(), w @ y,
                                   **OP_TOL)
        np.testing.assert_allclose(yt.grad[p].reshape(-1, f).numpy(),
                                   w.T @ x, **OP_TOL)
    prods = np.einsum("pimf,ptkf->pimtk", x3, y3)  # block-row × block-col
    want = np.zeros_like(g)
    for p, i, s in zip(*np.nonzero(cols >= 0)):
        want[p, i, s] = g[p, i, s] * prods[p, i, :, cols[p, i, s]]
    np.testing.assert_allclose(bt.grad.numpy(), want, **OP_TOL)


def test_transpose_ell_lists_each_block_once_in_row_order():
    rng = np.random.default_rng(2)
    cols, _ = _ell(rng, P_=3, mb=6, t=4, kb=5)
    cols[0, 1, 0] = 9  # past kb: reads nothing
    cols_t, slot = K5.transpose_ell(cols, 5)
    for p in range(3):
        seen = sorted(int(s) for s in slot[p][slot[p] >= 0])
        ok = (cols[p] >= 0) & (cols[p] < 5)
        assert seen == sorted(np.flatnonzero(ok.reshape(-1)).tolist())
        for c in range(5):
            live = slot[p, c] >= 0
            assert (cols.reshape(3, -1)[p, slot[p, c, live]] == c).all()
            assert (cols_t[p, c, live] == slot[p, c, live] // 4).all()
            assert (np.diff(cols_t[p, c, live]) >= 0).all()


def test_backward_compositions_run_the_plain_kernels(monkeypatch):
    """On the CPU every backward composition goes through the kernels'
    plain versions (the card takes the kernels in the same places):
    pack → K2; aggregation → K1 pack; coo → K1 scaled + K2; K5 → K3 on
    both layouts (+ K5 for dblocks)."""
    calls = []

    def count(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: (
            calls.append(name), fn(*a, **k))[1])

    for mod, name in ((K1, "gather_rows_plain"),
                      (K1, "gather_rows_scaled_plain"),
                      (K2, "scatter_add_rows_plain"),
                      (K34, "bsr_spmm_plain"), (K5, "bsr_sddmm_plain")):
        count(mod, name)
    rng = np.random.default_rng(4)
    b = _t(rng.standard_normal((2, 6, 3)).astype(np.float32), True)
    idx = torch.from_numpy(rng.integers(-1, 6, (2, 5)).astype(np.int32))
    out = ops.pack_rows_op(b, idx)
    calls.clear()
    out.sum().backward()
    assert calls == ["scatter_add_rows_plain"]

    piece, _, _ = _coo_piece(1)
    bt = _t(rng.standard_normal((3, 10, 4)).astype(np.float32), True)
    out = ops.coo_accumulate_rows_op(torch.zeros((3, 12, 4)), piece["col"],
                                     piece["val"], piece["perm"],
                                     piece["meta"], bt)
    parts = _t(rng.standard_normal((3, 7, 4)).astype(np.float32), True)
    tgt = rng.integers(-1, 12, (3, 7)).astype(np.int32)
    perm, meta = map(torch.from_numpy, ops.stack_sorted_scatter(tgt))
    out = ops.scatter_add_rows_exec_op(out, parts, perm, meta)
    calls.clear()
    out.sum().backward()
    assert calls == ["gather_rows_plain", "gather_rows_scaled_plain",
                     "scatter_add_rows_plain"]

    cols, blocks = _ell(rng)
    out = ops.bsr_sddmm_op(torch.from_numpy(cols), _t(blocks, True),
                           _t(rng.standard_normal((2, 4, 8, 3)), True).float(),
                           _t(rng.standard_normal((2, 5, 8, 3)), True).float())
    calls.clear()
    out.sum().backward()
    assert calls == ["bsr_sddmm_plain", "bsr_spmm_plain", "bsr_spmm_plain"]


def test_bsr_spmm_under_grad_raises():
    rng = np.random.default_rng(6)
    cols, blocks = _ell(rng)
    b = _t(rng.standard_normal((2, 40, 3)).astype(np.float32), True)
    cols_t = torch.from_numpy(cols)
    with pytest.raises(NotImplementedError, match="no JVP"):
        ops.bsr_spmm_op(cols_t, torch.from_numpy(blocks), b, 32)
    with pytest.raises(NotImplementedError, match="no JVP"):
        ops.bsr_spmm_acc_op(cols_t, torch.from_numpy(blocks), b,
                            torch.zeros((2, 32, 3)))
    with torch.no_grad():  # inference on the same operands
        ops.bsr_spmm_op(cols_t, torch.from_numpy(blocks), b, 32)


# ---------------------------------------------------------------------------
# through the executors
# ---------------------------------------------------------------------------

CONFIGS = {
    "flat_single": dict(schedule="single"),
    "flat_staged": dict(schedule=2, overlap=False),
    "flat_overlapped": dict(schedule=2, overlap=True),
    "hier_single": dict(hier=(2, 4), schedule="single"),
    "hier_overlapped": dict(hier=(2, 4), schedule=1, overlap=True),
    "replicated": dict(replicate=2),
}


def _port_grad(h, b):
    x = torch.from_numpy(b).requires_grad_()
    c = h(x)
    assert c.grad_fn is not None
    c.backward(c.detach())  # d ½‖c‖² / dc = c
    assert x.grad is not None
    return x.grad.numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_handle_grad_matches_reference_jax_grad(name, power_law_matrix):
    a = power_law_matrix()
    cfg = CONFIGS[name]
    b = _b()
    ref = R.compile_spmm(a, P, R.SpmmConfig(**cfg))
    loss = jax.grad(lambda x: 0.5 * jnp.sum(ref(x) ** 2))
    want = np.asarray(jax.jit(loss)(jnp.asarray(b)))
    h = T.compile_spmm(_port_csr(a), P, T.SpmmConfig(**cfg), device="cpu")
    assert h.decisions == ref.decisions
    got = _port_grad(h, b)
    tol = OVERLAP_TOL if h.overlap else HANDLE_TOL
    np.testing.assert_allclose(got, want, **tol)
    dense = a.to_dense().astype(np.float64)
    np.testing.assert_allclose(got, dense.T @ (dense @ b), **tol)


AXES = {"flat": ("x",), "hier": ("g", "l"), "replicated": ("s", "r")}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_backward_moves_the_forward_rows_and_repeats(name,
                                                     power_law_matrix):
    """Per axis, the backward's collectives carry exactly the forward's
    rows (the transposed collective volume), in reversed pairs; a second
    run gives the same bits (K2 has no atomics)."""
    h = T.compile_spmm(_port_csr(power_law_matrix()), P,
                       T.SpmmConfig(**CONFIGS[name]), device="cpu")
    b = _b(1)
    g1 = _port_grad(h, b)
    for axis in AXES[h.strategy]:
        assert h.comm.rows(axis) > 0
        assert h.comm.rows(axis, "bwd") == h.comm.rows(axis)
    fwd = [(op, pairs) for op, pairs, _ in h.comm.log
           if not op.startswith("bwd:")]
    bwd = [(op[4:], tuple((d, s) for s, d in pairs))
           for op, pairs, _ in h.comm.log if op.startswith("bwd:")]
    assert sorted(bwd) == sorted(fwd)
    assert np.array_equal(_port_grad(h, b), g1)
    with pytest.raises(ValueError, match="direction"):
        h.comm.rows(None, "both")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_under_grad_keeps_c_and_the_log(name, power_law_matrix):
    """Under grad the forward runs the same kernels in the same order: C
    equals the call without grad bit for bit, and so does the collective
    log."""
    h = T.compile_spmm(_port_csr(power_law_matrix()), P,
                       T.SpmmConfig(**CONFIGS[name]), device="cpu")
    b = torch.from_numpy(_b(6))
    c = h(b)
    log = list(h.comm.log)
    c_grad = h(b.clone().requires_grad_())
    assert c_grad.grad_fn is not None
    assert torch.equal(c_grad.detach(), c) and h.comm.log == log


def test_overlapped_grads_within_5e3_of_staged(power_law_matrix):
    a = _port_csr(power_law_matrix())
    b = _b(2)
    g = {ov: _port_grad(T.compile_spmm(a, P, schedule=3, overlap=ov,
                                       device="cpu"), b)
         for ov in (False, True)}
    np.testing.assert_allclose(g[True], g[False], **OVERLAP_TOL)


def test_bsr_handle_under_grad_raises(power_law_matrix):
    h = T.compile_spmm(_port_csr(power_law_matrix()), P,
                       backends=("coo", "bsr"), device="cpu")
    x = torch.from_numpy(_b()).requires_grad_()
    with pytest.raises(NotImplementedError, match="no JVP"):
        h(x, backend="bsr")
    c = h(x)  # coo differentiates
    with torch.no_grad():
        np.testing.assert_allclose(h(x, backend="bsr").numpy(),
                                   c.detach().numpy(), rtol=2e-4, atol=2e-4)


def _own_map_keys(h):
    """The ids of ``h``'s plan tensors that key an entry of ``ops._MAPS``.
    Only these: the cache is process-wide, and an earlier handle's entries
    go whenever the cyclic collector frees its plan, which may happen
    during any call of this test."""
    def tensors(o):
        if isinstance(o, torch.Tensor):
            yield o
        elif isinstance(o, dict):
            for v in o.values():
                yield from tensors(v)
    return {id(t) for f in dataclasses.fields(h.ex) if f.name != "meta"
            for t in tensors(getattr(h.ex, f.name)) if t in ops._MAPS}


def test_inference_builds_no_graph_and_no_maps(power_law_matrix):
    h = T.compile_spmm(_port_csr(power_law_matrix()), P, schedule=2,
                       overlap=True, device="cpu")
    assert _own_map_keys(h) == set()
    c = h(torch.from_numpy(_b()))
    assert c.grad_fn is None and _own_map_keys(h) == set()
    _port_grad(h, _b())  # the first gradient builds the plan's maps
    built = _own_map_keys(h)
    assert built
    _port_grad(h, _b(3))  # and the next reuses them
    assert _own_map_keys(h) == built


@pytest.mark.parametrize("name", ["flat_staged", "hier_single", "replicated"])
def test_make_spmm_fn_over_handles_and_plans(name, power_law_matrix):
    a = _port_csr(power_law_matrix())
    h = T.compile_spmm(a, P, T.SpmmConfig(**CONFIGS[name]), device="cpu")
    b = _b(4)
    want = _port_grad(h, b)
    for fn in (T.core.make_spmm_fn(h), T.core.make_spmm_fn(h.ex)):
        x = torch.from_numpy(b).requires_grad_()
        c = fn(x)
        c.backward(c.detach())
        np.testing.assert_array_equal(x.grad.numpy(), want)
    with pytest.raises(TypeError, match="owns its comm"):
        T.core.make_spmm_fn(h, comm=h.comm)
    with pytest.raises(TypeError, match="exec plan"):
        T.core.make_spmm_fn(object())


def test_flat_exec_from_reference_arrays_differentiates(power_law_matrix):
    """A plan carried over from the reference's exec arrays (coo pieces
    whose pads join rows) gives the same grads as the port's own plan."""
    from test_torch_flat_spmm import _fields

    a = power_law_matrix()
    r_ex = R.dist_spmm.flat_exec_arrays(R.build_plan(a, P, "joint"))
    t_ex = t_dist.flat_exec_from_numpy(_fields(r_ex))
    own = t_dist.flat_exec_arrays(
        T.core.build_plan(_port_csr(a), P, "joint"))
    b = _b(5)
    grads = []
    for ex in (t_ex, own):
        x = torch.from_numpy(b).requires_grad_()
        c = t_dist.flat_spmm(ex, x)
        c.backward(c.detach())
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], **HANDLE_TOL)
