"""Sparse matrix containers used throughout SHIRO.

A copy of ``repro.core.sparse`` (NumPy only): the port keeps its own
host-side code so that it never imports the JAX package.

These are *host-side* (NumPy) containers: the communication plan is computed
offline from the sparsity pattern (paper §5.1 steps 1-2), exactly mirroring
SHIRO's preprocessing phase. Device-side execution converts the relevant
pieces to torch tensors (see core.dist_spmm and kernels/).

All containers are immutable dataclasses with canonicalized (sorted,
deduplicated) structure so that plans are deterministic.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "BSRMatrix",
    "PatternSnapshot",
    "pattern_snapshot",
    "coo_from_arrays",
    "csr_from_coo",
    "csr_from_dense",
    "bsr_from_csr",
    "ell_from_csr",
    "random_sparse",
    "power_law_sparse",
    "hub_sparse",
    "block_rows",
]


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate-format sparse matrix (host side)."""

    shape: Tuple[int, int]
    row: np.ndarray  # int32 [nnz]
    col: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float32 [nnz]

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.val.dtype)
        np.add.at(out, (self.row, self.col), self.val)
        return out


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse row matrix (host side)."""

    shape: Tuple[int, int]
    indptr: np.ndarray  # int32 [m+1]
    indices: np.ndarray  # int32 [nnz], column ids, sorted within each row
    data: np.ndarray  # float32 [nnz]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_slice(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def to_coo(self) -> COOMatrix:
        m = self.nrows
        counts = np.diff(self.indptr)
        rows = np.repeat(np.arange(m, dtype=np.int32), counts)
        return COOMatrix(self.shape, rows, self.indices.copy(), self.data.copy())

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def nonzero_rows(self) -> np.ndarray:
        """Unique row indices holding at least one nonzero (paper Rows(A))."""
        return np.nonzero(np.diff(self.indptr) > 0)[0].astype(np.int32)

    def nonzero_cols(self) -> np.ndarray:
        """Unique column indices holding at least one nonzero (paper Cols(A))."""
        return np.unique(self.indices).astype(np.int32)

    def col_block(self, lo: int, hi: int) -> "CSRMatrix":
        """Extract the column range [lo, hi) as a CSR matrix with local cols."""
        m = self.nrows
        mask = (self.indices >= lo) & (self.indices < hi)
        counts = np.zeros(m, dtype=np.int64)
        row_ids = np.repeat(np.arange(m), np.diff(self.indptr))
        np.add.at(counts, row_ids[mask], 1)
        indptr = np.zeros(m + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSRMatrix(
            (m, hi - lo),
            indptr,
            (self.indices[mask] - lo).astype(np.int32),
            self.data[mask].copy(),
        )

    def row_block(self, lo: int, hi: int) -> "CSRMatrix":
        """Extract the row range [lo, hi) as a CSR matrix (cols unchanged)."""
        indptr = (self.indptr[lo : hi + 1] - self.indptr[lo]).astype(np.int32)
        s, e = int(self.indptr[lo]), int(self.indptr[hi])
        return CSRMatrix(
            (hi - lo, self.ncols), indptr, self.indices[s:e].copy(), self.data[s:e].copy()
        )

    def select_nonzeros(self, keep_mask: np.ndarray) -> "CSRMatrix":
        """Keep a subset of nonzeros (mask over nnz, CSR order preserved)."""
        m = self.nrows
        row_ids = np.repeat(np.arange(m), np.diff(self.indptr))
        counts = np.zeros(m, dtype=np.int64)
        np.add.at(counts, row_ids[keep_mask], 1)
        indptr = np.zeros(m + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSRMatrix(
            self.shape, indptr, self.indices[keep_mask].copy(), self.data[keep_mask].copy()
        )

    def transpose(self) -> "CSRMatrix":
        coo = self.to_coo()
        return csr_from_coo(
            COOMatrix((self.shape[1], self.shape[0]), coo.col, coo.row, coo.val)
        )


@dataclasses.dataclass(frozen=True)
class PatternSnapshot:
    """The sparsity pattern a plan was built against, frozen.

    Drift detection compares a live operand against this snapshot: the
    plan (MWVC cover, schedule, exec layouts) depends only on WHERE the
    nonzeros sit, so ``drift()`` is a pure set distance over nonzero
    coordinates — 0.0 for the planned pattern, 1.0 for a disjoint one
    (Jaccard distance). Values never enter; a weight update is drift 0.

    Host-side NumPy only: snapshots ride inside saved plans/sessions and
    their ``fingerprint`` stamps stats/BENCH records.

    ``values_digest`` additionally fingerprints the nonzero VALUES (it
    never enters ``drift``): an unchanged ``fingerprint`` with a changed
    ``values_digest`` is a values-only update — the plan still matches,
    only the exec arrays need refreshing (``SpmmSession.maybe_replan``
    reuses the compiled executables on exactly this signal). ``None`` on
    snapshots saved before the field existed.
    """

    shape: Tuple[int, int]
    keys: np.ndarray  # int64 [nnz], sorted row * ncols + col
    fingerprint: str  # sha1 hex of shape + keys
    values_digest: Optional[str] = None  # sha1 hex of nonzero values

    @property
    def nnz(self) -> int:
        return int(self.keys.size)

    def drift(self, other: Union["PatternSnapshot", "CSRMatrix",
                                 "COOMatrix"]) -> float:
        """Jaccard distance between nonzero-coordinate sets in [0, 1]."""
        snap = (other if isinstance(other, PatternSnapshot)
                else pattern_snapshot(other))
        if snap.shape != self.shape:
            return 1.0
        inter = np.intersect1d(self.keys, snap.keys,
                               assume_unique=True).size
        union = self.nnz + snap.nnz - inter
        if union == 0:
            return 0.0
        return 1.0 - inter / union


def pattern_snapshot(a: Union[CSRMatrix, COOMatrix]) -> PatternSnapshot:
    """Snapshot a matrix's sparsity pattern for later drift checks."""
    coo = a if isinstance(a, COOMatrix) else a.to_coo()
    keys = np.unique(coo.row.astype(np.int64) * a.shape[1] + coo.col)
    h = hashlib.sha1()
    h.update(np.asarray(a.shape, np.int64).tobytes())
    h.update(keys.tobytes())
    hv = hashlib.sha1()
    hv.update(np.ascontiguousarray(coo.val, np.float32).tobytes())
    return PatternSnapshot(tuple(a.shape), keys, h.hexdigest(),
                           hv.hexdigest())


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-sparse row matrix with dense (bm, bk) blocks.

    ``block_cols[r]`` is the block column of the r-th stored block and
    ``block_indptr`` delimits the block rows. The port's bsr backend runs
    the ELL form of it (``ell_from_csr``, K3 / K4); this is the
    reference's host type, for code that builds blocks itself.
    """

    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    block_indptr: np.ndarray  # int32 [mb+1]
    block_cols: np.ndarray  # int32 [nblocks]
    blocks: np.ndarray  # float32 [nblocks, bm, bk]

    @property
    def nblocks(self) -> int:
        return int(self.block_cols.shape[0])

    def to_dense(self) -> np.ndarray:
        bm, bk = self.block_shape
        out = np.zeros(self.shape, dtype=self.blocks.dtype)
        mb = len(self.block_indptr) - 1
        for br in range(mb):
            for r in range(int(self.block_indptr[br]),
                           int(self.block_indptr[br + 1])):
                bc = int(self.block_cols[r])
                out[br * bm:(br + 1) * bm, bc * bk:(bc + 1) * bk] = \
                    self.blocks[r]
        return out


def coo_from_arrays(shape, row, col, val=None) -> COOMatrix:
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    if val is None:
        val = np.ones(row.shape[0], dtype=np.float32)
    val = np.asarray(val, dtype=np.float32)
    # canonical order + duplicate coalescing
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    if row.size:
        key = row.astype(np.int64) * shape[1] + col
        uniq, inv = np.unique(key, return_inverse=True)
        merged = np.zeros(uniq.shape[0], dtype=np.float64)
        np.add.at(merged, inv, val.astype(np.float64))
        row = (uniq // shape[1]).astype(np.int32)
        col = (uniq % shape[1]).astype(np.int32)
        val = merged.astype(np.float32)
    return COOMatrix(tuple(shape), row, col, val)


def csr_from_coo(coo: COOMatrix) -> CSRMatrix:
    m = coo.shape[0]
    order = np.lexsort((coo.col, coo.row))
    row, col, val = coo.row[order], coo.col[order], coo.val[order]
    counts = np.zeros(m, dtype=np.int64)
    np.add.at(counts, row, 1)
    indptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSRMatrix(coo.shape, indptr, col.astype(np.int32), val.astype(np.float32))


def csr_from_dense(a: np.ndarray) -> CSRMatrix:
    row, col = np.nonzero(a)
    return csr_from_coo(COOMatrix(
        a.shape, row.astype(np.int32), col.astype(np.int32),
        a[row, col].astype(np.float32)))


def bsr_from_csr(a: CSRMatrix, block_shape: Tuple[int, int]) -> BSRMatrix:
    """Convert CSR → BSR with zero-padded edge blocks."""
    bm, bk = block_shape
    m, k = a.shape
    mb = (m + bm - 1) // bm
    kb = (k + bk - 1) // bk
    dense = a.to_dense()
    padded = np.zeros((mb * bm, kb * bk), dtype=dense.dtype)
    padded[:m, :k] = dense
    block_indptr = [0]
    block_cols = []
    blocks = []
    for br in range(mb):
        tile_rows = padded[br * bm:(br + 1) * bm]
        for bc in range(kb):
            tile = tile_rows[:, bc * bk:(bc + 1) * bk]
            if np.any(tile != 0):
                block_cols.append(bc)
                blocks.append(tile.copy())
        block_indptr.append(len(block_cols))
    blocks_arr = (np.stack(blocks) if blocks
                  else np.zeros((0, bm, bk), dtype=np.float32))
    return BSRMatrix(
        (m, k),
        (bm, bk),
        np.asarray(block_indptr, dtype=np.int32),
        np.asarray(block_cols, dtype=np.int32),
        blocks_arr.astype(np.float32),
    )


def ell_from_csr(a: CSRMatrix, block_shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """CSR → ELL block layout for the BSR kernel (kernels.bsr_spmm).

    Returns ``(block_cols [mb, t], blocks [mb, t, bm, bk])``: every
    block-row stores exactly ``t`` (bm × bk) dense blocks, ``-1`` in
    ``block_cols`` marking all-zero padding slots. Edge blocks are
    zero-padded; ``t ≥ 1`` so shapes never degenerate. Built directly from
    coordinates (never densifies), so it scales to the planner's wide
    flat-buffer pieces (m × P·max_b).
    """
    bm, bk = block_shape
    m, k = a.shape
    mb = (m + bm - 1) // bm
    kb = (k + bk - 1) // bk
    coo = a.to_coo()
    if coo.nnz == 0:
        return (np.full((mb, 1), -1, np.int32),
                np.zeros((mb, 1, bm, bk), np.float32))
    br = coo.row.astype(np.int64) // bm
    bc = coo.col.astype(np.int64) // bk
    key = br * kb + bc
    uniq = np.unique(key)  # sorted ⇒ grouped by block-row
    ubr, ubc = uniq // kb, uniq % kb
    counts = np.bincount(ubr, minlength=mb)
    t = max(1, int(counts.max()))
    starts = np.zeros(mb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(uniq.size) - starts[ubr]
    block_cols = np.full((mb, t), -1, np.int32)
    block_cols[ubr, slot] = ubc.astype(np.int32)
    blocks = np.zeros((mb, t, bm, bk), np.float32)
    blk_of_nz = np.searchsorted(uniq, key)
    np.add.at(blocks,
              (ubr[blk_of_nz], slot[blk_of_nz], coo.row % bm, coo.col % bk),
              coo.val)
    return block_cols, blocks


# ---------------------------------------------------------------------------
# Synthetic generators (mirror the dataset families in paper Tab. 2)
# ---------------------------------------------------------------------------

def random_sparse(m: int, k: int, density: float, seed: int = 0) -> CSRMatrix:
    """Uniform Erdos-Renyi sparsity (paper Pattern 3: uniform)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(round(m * k * density)))
    row = rng.integers(0, m, size=nnz)
    col = rng.integers(0, k, size=nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    return csr_from_coo(coo_from_arrays((m, k), row, col, val))


def power_law_sparse(m: int, k: int, nnz: int, alpha: float = 1.5, seed: int = 0) -> CSRMatrix:
    """Power-law degree distribution on BOTH rows and columns.

    High-degree vertices on both bipartite sides — the paper's
    high-reduction regime (§5.4.2, Pattern 4 / social & web graphs).
    """
    rng = np.random.default_rng(seed)
    pr = (np.arange(1, m + 1, dtype=np.float64)) ** (-alpha)
    pc = (np.arange(1, k + 1, dtype=np.float64)) ** (-alpha)
    pr /= pr.sum()
    pc /= pc.sum()
    row = rng.choice(m, size=nnz, p=pr)
    col = rng.choice(k, size=nnz, p=pc)
    val = rng.standard_normal(nnz).astype(np.float32)
    return csr_from_coo(coo_from_arrays((m, k), row, col, val))


def hub_sparse(m: int, k: int, n_hub_rows: int, n_hub_cols: int, fill: float, seed: int = 0) -> CSRMatrix:
    """Hub-structured matrix (mawi-like traffic pattern: few hubs touch all).

    A few dense hub rows and hub columns cover nearly all nonzeros, so
    mu ~= n_hub_rows + n_hub_cols << min(|Rows|,|Cols|) and the joint
    strategy achieves the paper's ~96% reduction regime.
    """
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    hub_rows = rng.choice(m, size=n_hub_rows, replace=False)
    hub_cols = rng.choice(k, size=n_hub_cols, replace=False)
    for hr in hub_rows:
        cs = rng.choice(k, size=max(1, int(fill * k)), replace=False)
        rows.append(np.full(cs.shape, hr))
        cols.append(cs)
    for hc in hub_cols:
        rs = rng.choice(m, size=max(1, int(fill * m)), replace=False)
        rows.append(rs)
        cols.append(np.full(rs.shape, hc))
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    return csr_from_coo(coo_from_arrays((m, k), row, col))


def block_rows(total_rows: int, nparts: int) -> Sequence[Tuple[int, int]]:
    """1-D row partition boundaries: nparts contiguous [lo, hi) ranges."""
    base = total_rows // nparts
    rem = total_rows % nparts
    bounds = []
    lo = 0
    for p in range(nparts):
        hi = lo + base + (1 if p < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds
