"""Non-finite operands: where the port's C stays finite and the reference's is NaN.

The port's kernels skip what holds no product: K3/K4 read only the B rows
of a block's nonzero A columns (per 8-row slice of the block) and skip pad
slots, K5 writes +0.0 for stored zeros and pads without forming their dot,
and the coo backend's pads join no row. The reference forms dense block
products (``bsr_spmm_pallas``, ``bsr_sddmm_pallas``) and adds its coo pads
as ``0.0 · b[0]``, so an inf or a NaN in a B / Y row that reaches an entry
only through a zero gives NaN there, and a finite value in the port. These
tests put the same numpy operands with infs and NaNs through both
packages (the reference's Pallas kernels in interpret mode, the port's
plain versions on the CPU), pin exactly those entries from the operands'
structure, and hold every other entry to agree: the same entries are
non-finite, and the finite ones agree within float32 1e-5.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import local_backend as r_lb  # noqa: E402
from repro.core import sparse as r_sparse  # noqa: E402
from repro.kernels.bsr_spmm import (  # noqa: E402
    bsr_spmm_acc_pallas, bsr_spmm_pallas,
)
from repro.kernels.sddmm import bsr_sddmm_pallas  # noqa: E402
from repro_torch.core import local_backend as t_lb  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.kernels import bsr_spmm as K34  # noqa: E402
from repro_torch.kernels import sddmm as K5  # noqa: E402


def _sparse_blocks(bm, bk, seed, mb=4, t=5, kb=5):
    """ELL pieces with 1-3 nonzeros per stored block, pad slots (which the
    reference reads as block column 0) and one block of stored zeros."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, kb, size=(mb, t)).astype(np.int32)
    cols[:, 1] = -1
    cols[0, 3] = 0
    blocks = np.zeros((mb, t, bm, bk), np.float32)
    for i, s in zip(*np.nonzero(cols >= 0)):
        for _ in range(rng.integers(1, 4)):
            blocks[i, s, rng.integers(bm), rng.integers(bk)] = \
                rng.standard_normal()
    blocks[0, 3] = 0.0  # stored zeros in block column 0
    return cols, blocks, rng


def _non_finite_b(rng, kb, bk, n):
    """B [kb·bk, n] with an inf, a -inf and a NaN in each of three block
    columns, at rows whose A column is zero in some stored blocks and
    nonzero in others."""
    b = rng.standard_normal((kb * bk, n)).astype(np.float32)
    for c, v in ((0, np.inf), (1, -np.inf), (2, np.nan)):
        rows = c * bk + rng.permutation(bk)[:3]
        b[rows, rng.integers(n, size=3)] = v
    return b


def _bsr_bad(cols, blocks, b):
    """Entries of A @ B reached by a non-finite B value: through any column
    of a dense block product (the reference; pads read block column 0), and
    through the nonzero A columns of each 8-row slice (the port)."""
    mb, t, bm, bk = blocks.shape
    bad_b = ~np.isfinite(b)
    ref = np.zeros((mb * bm, b.shape[1]), bool)
    port = np.zeros_like(ref)
    for i in range(mb):
        for s in range(t):
            c = cols[i, s]
            tile = bad_b[max(c, 0) * bk:(max(c, 0) + 1) * bk]
            ref[i * bm:(i + 1) * bm] |= tile.any(0)
            if c < 0:
                continue
            for r0 in range(0, bm, 8):
                used = (blocks[i, s, r0:r0 + 8] != 0).any(0)
                port[i * bm + r0:i * bm + min(r0 + 8, bm)] |= \
                    tile[used].any(0)
    return ref, port


def _check_pins(got, want, pinned, what):
    """``got`` (port) finite and ``want`` (reference) NaN exactly on
    ``pinned``; elsewhere the same entries non-finite and the finite ones
    within 1e-5."""
    assert pinned.any(), f"{what}: the operands pin no entry"
    assert np.isfinite(got[pinned]).all(), what
    assert np.isnan(want[pinned]).all(), what
    rest = ~pinned
    np.testing.assert_array_equal(np.isfinite(got[rest]),
                                  np.isfinite(want[rest]), err_msg=what)
    fin = rest & np.isfinite(want)
    assert (~np.isfinite(want[rest])).any(), f"{what}: no inf reached C"
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("block", [(8, 8), (16, 8)], ids=str)
@pytest.mark.parametrize("acc_form", [False, True], ids=["K3", "K4"])
def test_bsr_non_finite_b_pins_where_zero_columns_skip(block, acc_form):
    bm, bk = block
    cols, blocks, rng = _sparse_blocks(bm, bk, bm + bk)
    mb, t = cols.shape
    n = 16
    b = _non_finite_b(rng, 5, bk, n)
    acc = rng.standard_normal((mb * bm, n)).astype(np.float32)
    cols_j, blocks_j, b_j = (jnp.asarray(cols), jnp.asarray(blocks),
                             jnp.asarray(b))
    cols_t, blocks_t, b_t = (torch.from_numpy(x)[None]
                             for x in (cols, blocks, b))
    if acc_form:
        want = np.asarray(bsr_spmm_acc_pallas(
            cols_j, blocks_j, b_j, jnp.asarray(acc), bn=n, interpret=True))
        got = K34.bsr_spmm_acc_plain(cols_t, blocks_t, b_t,
                                     torch.from_numpy(acc)[None].clone())
    else:
        want = np.asarray(bsr_spmm_pallas(cols_j, blocks_j, b_j, bn=n,
                                          interpret=True))
        got = K34.bsr_spmm_plain(cols_t, blocks_t, b_t, mb * bm)
    got = got[0].numpy()
    ref_bad, port_bad = _bsr_bad(cols, blocks, b)
    np.testing.assert_array_equal(~np.isfinite(want), ref_bad)
    np.testing.assert_array_equal(~np.isfinite(got), port_bad)
    _check_pins(got, want, ref_bad & ~port_bad, f"bsr {block}")


@pytest.mark.parametrize("block", [(8, 8), (16, 8)], ids=str)
def test_sddmm_stored_zeros_and_pads_stay_zero_on_non_finite_y(block):
    """K5: a stored zero or a pad gives +0.0 in the port; the reference's
    ``0 · (x · y)`` gives NaN where the dot is non-finite."""
    bm, bk = block
    cols, blocks, rng = _sparse_blocks(bm, bk, 3 * bm + bk)
    mb, t = cols.shape
    f = 16
    x3 = rng.standard_normal((mb, bm, f)).astype(np.float32)
    y3 = rng.standard_normal((5, bk, f)).astype(np.float32)
    y3[0, 2, 5] = np.inf  # block column 0: the pads' in the reference
    y3[3, 1, 0] = np.nan
    cols[1, 2] = 3
    blocks[1, 2, 0, 1] = 2.0  # a nonzero that reads the NaN row
    want = np.asarray(bsr_sddmm_pallas(
        jnp.asarray(cols), jnp.asarray(blocks), jnp.asarray(x3),
        jnp.asarray(y3), interpret=True))
    got = K5.bsr_sddmm_plain(*(torch.from_numpy(v)[None]
                               for v in (cols, blocks, x3, y3)))[0].numpy()
    y_bad = ~np.isfinite(y3).all(-1)  # [kb, bk]
    dot_bad = np.broadcast_to(y_bad[np.maximum(cols, 0)][:, :, None, :],
                              blocks.shape)
    pinned = dot_bad & (blocks == 0)
    zero = blocks == 0
    assert np.array_equal(got[zero], np.zeros(int(zero.sum()), np.float32))
    assert not np.signbit(got[zero]).any()
    _check_pins(got, want, pinned, f"sddmm {block}")


def test_coo_pads_join_no_row_on_non_finite_b():
    """coo: the reference's pads (row 0, col 0, val 0) add 0 · b[0] to row
    0, so an inf in b[0] that no real entry reads gives NaN there; the
    port's pads join no row."""
    m = k = 6
    n = 4
    rng = np.random.default_rng(5)
    pieces = []
    for nnz, seed in ((9, 1), (2, 2)):
        r = np.random.default_rng(seed)
        dense = np.zeros((m, k), np.float32)
        rows_, cols_ = r.integers(1, m, nnz), r.integers(1, k, nnz)
        dense[rows_, cols_] = r.standard_normal(nnz)  # no entry reads b[0]
        dense[0, 2] = 1.5  # row 0 holds a real entry
        pieces.append(dense)
    b = rng.standard_normal((2, k, n)).astype(np.float32)
    b[:, 0, 1] = np.inf  # read by the reference's pads only
    b[:, 2, 3] = -np.inf  # read by row 0's real entry: -inf in both
    want, got = [], []
    r_csrs = [r_sparse.csr_from_dense(d) for d in pieces]
    assert r_csrs[1].nnz < r_csrs[0].nnz  # rank 1 carries pads
    t_csrs = [t_sparse.CSRMatrix(c.shape, c.indptr.copy(), c.indices.copy(),
                                 c.data.copy()) for c in r_csrs]
    r_piece = r_lb.CooBackend().prepare(r_csrs)
    for p in range(2):
        want.append(np.asarray(r_lb.coo_spmm_local(
            r_piece["row"][p], r_piece["col"][p], r_piece["val"][p],
            jnp.asarray(b[p]), m)))
    got = t_lb.coo_spmm_local(t_lb.CooBackend().prepare(t_csrs),
                              torch.from_numpy(b), m).numpy()
    want = np.stack(want)
    pinned = np.zeros(want.shape, bool)
    pinned[1, 0, 1] = True
    _check_pins(got, want, pinned, "coo pads")
