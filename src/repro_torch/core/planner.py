"""SHIRO communication planner (paper §5.1 workflow, stages 1-2).

A copy of ``repro.core.planner`` (NumPy only): the port keeps its own
host-side code so that it never imports the JAX package.

Offline preprocessing: analyze the sparsity of every off-diagonal block
A^(p,q), decide per-nonzero between row-based and column-based communication
(via exact minimum vertex cover, core.mwvc), and emit:

* per-pair ``PairPlan`` — which B rows move q→p (column part) and which
  partial C rows are computed at q and moved q→p (row part), plus the two
  complementary sub-matrices of A^(p,q);
* a global ``SpmmPlan`` with the padded static buffer layout needed for
  a static all_to_all (see core.dist_spmm).

The two-tier plan derived from this one is ``core.hierarchy``'s; the
replicated (1.5D) plan, ``replicate_plan``, partitions a flat plan's
shifts across ``c`` lanes.

Everything here is NumPy / pure Python and runs once per sparsity pattern;
the paper amortizes this exactly the same way (§5.3.2, §7.6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mwvc import cover_is_valid, min_vertex_cover_unweighted, min_vertex_cover_weighted
from .sparse import CSRMatrix, block_rows, csr_from_coo, COOMatrix

__all__ = [
    "Strategy",
    "PairPlan",
    "SpmmPlan",
    "build_pair_plan",
    "build_plan",
    "pair_volume_rows",
    "local_piece_csrs",
    "plan_build_count",
    "ReplicatedPlan",
    "replicate_plan",
]

# Monotone counter of MWVC plan constructions, the expensive offline
# stage. The session/elastic machinery promises "a ladder-rung resize
# never re-plans"; tests pin that promise by diffing this counter, the
# same way register_lowering_hook pins executable-cache behavior.
_PLAN_BUILDS = 0


def plan_build_count() -> int:
    """Number of ``build_plan`` calls (MWVC runs) in this process."""
    return _PLAN_BUILDS

Strategy = str  # 'block' | 'col' | 'row' | 'joint'
_STRATEGIES = ("block", "col", "row", "joint")


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """Communication plan for the ordered pair q -> p (data flowing to p).

    ``a_col``/``a_row`` partition the nonzeros of A^(p,q): a_col holds the
    column-covered nonzeros (computed at p with fetched B rows), a_row the
    row-covered ones (computed at q, partial C shipped to p). Row indices of
    both are LOCAL to p's row block; column indices are LOCAL to q's block.
    """

    p: int
    q: int
    col_ids: np.ndarray  # local (to q) B-row indices fetched by p        [n_col]
    row_ids: np.ndarray  # local (to p) C-row indices computed at q       [n_row]
    a_col: CSRMatrix  # (m_p x k_q), nonzeros covered by columns
    a_row: CSRMatrix  # (m_p x k_q), nonzeros covered by rows
    n_rows_total: int  # |Rows(A^(p,q))| — for Eq. 3
    n_cols_total: int  # |Cols(A^(p,q))| — for Eq. 2

    @property
    def mu(self) -> int:
        """Cover size: number of communicated rows (paper Eq. 9)."""
        return int(self.col_ids.size + self.row_ids.size)


def _compact(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    uniq, inv = np.unique(ids, return_inverse=True)
    return uniq.astype(np.int64), inv.astype(np.int64)


def build_pair_plan(
    a_block: CSRMatrix,
    p: int,
    q: int,
    strategy: Strategy = "joint",
    w_row: Optional[np.ndarray] = None,
    w_col: Optional[np.ndarray] = None,
) -> PairPlan:
    """Plan communication for off-diagonal block A^(p,q) (local indices).

    ``strategy``:
      * 'col'   — paper Eq. 2: fetch B rows for every unique nonzero column.
      * 'row'   — paper Eq. 3: ship partial C rows for every unique row.
      * 'joint' — paper Eq. 9: exact minimum (weighted) vertex cover.
      * 'block' — handled at the SpmmPlan level (full B block, Eq. 1);
                  per-pair it degrades to 'col' over all k_q columns.
    ``w_row[i]`` / ``w_col[j]`` optionally weight vertices (local indices)
    for the weighted cover (e.g. hierarchy-aware costs, §6 extension).
    """
    coo = a_block.to_coo()
    m_p, k_q = a_block.shape
    if coo.nnz == 0:
        empty = csr_from_coo(COOMatrix((m_p, k_q), np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32)))
        return PairPlan(p, q, np.empty(0, np.int64), np.empty(0, np.int64), empty, empty, 0, 0)

    rows_u, row_inv = _compact(coo.row)
    cols_u, col_inv = _compact(coo.col)
    n_l, n_r = rows_u.size, cols_u.size

    if strategy in ("col", "block"):
        cover_l = np.zeros(n_l, bool)
        cover_r = np.ones(n_r, bool)
    elif strategy == "row":
        cover_l = np.ones(n_l, bool)
        cover_r = np.zeros(n_r, bool)
    elif strategy == "joint":
        if w_row is None and w_col is None:
            cover_l, cover_r = min_vertex_cover_unweighted(n_l, n_r, row_inv, col_inv)
        else:
            wl = None if w_row is None else np.asarray(w_row, float)[rows_u]
            wr = None if w_col is None else np.asarray(w_col, float)[cols_u]
            cover_l, cover_r = min_vertex_cover_weighted(n_l, n_r, row_inv, col_inv, wl, wr)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    assert cover_is_valid(row_inv, col_inv, cover_l, cover_r)

    # Per-nonzero assignment: row-covered nonzeros go to the row part;
    # everything else is column-covered (cover validity guarantees it).
    # A nonzero with BOTH endpoints covered goes to the row part —
    # arbitrary but fixed; either choice preserves correctness and volume.
    nz_row_covered = cover_l[row_inv]
    a_row = a_block.select_nonzeros(nz_row_covered)
    a_col = a_block.select_nonzeros(~nz_row_covered)

    row_ids = rows_u[cover_l]
    # Only columns that still have column-assigned nonzeros need B rows:
    col_ids = np.unique(coo.col[~nz_row_covered]).astype(np.int64)
    if strategy in ("col", "block"):
        col_ids = cols_u.copy()
    return PairPlan(p, q, col_ids, row_ids, a_col, a_row, n_l, n_r)


def pair_volume_rows(plan: PairPlan) -> int:
    """Rows communicated for this pair (multiply by N*sz for bytes)."""
    return plan.mu


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """Global SHIRO plan for a 1-D row-partitioned SpMM over P processes.

    Padded buffer layout (static shapes → jit-compatible):

    column part (B rows move src→dst):
      b_send_idx [P_src, P_dst, max_b] — local B-row index at src, -1 pad
      (receiver side positions are implied: slot order is preserved by
      all_to_all, so dst addresses fetched row (src q, slot s) at flat
      offset q*max_b + s).

    row part (partial C rows move src→dst):
      c_send_rows [P_src, P_dst, max_c] — DEST-local C row index, -1 pad.
      Source q computes partials into slot s for dest p; receiver p
      scatter-adds slot (q, s) into local row c_send_rows[q, p, s].

    Per-process A pieces (src-indexed):
      a_diag[p]              — diagonal block (local rows × local cols)
      a_colpart[p]           — column-covered off-diag nonzeros at p, with
                               column space remapped to the flat receive
                               buffer offset (P*max_b columns)
      a_rowpart[q]           — row-covered nonzeros whose OWNER is some
                               other p but which are computed at q; rows
                               remapped to (dest p, slot) flat send-buffer
                               offset (P*max_c rows), cols local to q.
    """

    P: int
    shape: Tuple[int, int]
    strategy: Strategy
    bounds: Sequence[Tuple[int, int]]
    pair_plans: Dict[Tuple[int, int], PairPlan]
    max_b: int
    max_c: int
    b_send_idx: np.ndarray  # [P, P, max_b] int32
    c_send_rows: np.ndarray  # [P, P, max_c] int32
    a_diag: List[CSRMatrix]
    a_colpart: List[CSRMatrix]  # shape (m_p, P*max_b)
    a_rowpart: List[CSRMatrix]  # shape (P*max_c, k_q)

    # ----- analytics (paper Eqs. 1-3, 9) -------------------------------
    def volume_rows(self) -> int:
        """Total communicated rows under this plan (ideal, unpadded)."""
        return sum(pp.mu for pp in self.pair_plans.values())

    def volume_rows_padded(self, schedule=None) -> int:
        """Rows placed in collective operands by the ACTIVE schedule.

        ``schedule``: a ``core.comm_schedule.CommSchedule`` (bucketed or
        single); ``None`` means the default single max-padded all_to_all
        round. The count matches what HLO analysis measures on the
        lowered program — for the single round that is ``P² (max_b +
        max_c)`` rows: the dense all_to_all operand carries P slots per
        process *including the always-empty self slot*, which is exactly
        the padding waste the bucketed schedules eliminate.
        """
        from .comm_schedule import single_round_schedule

        if schedule is None:
            schedule = single_round_schedule(self)
        return schedule.volume_rows_padded()

    def pair_matrix(self) -> np.ndarray:
        """[P,P] rows moved src->dst (for Fig. 9-style balance analysis)."""
        m = np.zeros((self.P, self.P), np.int64)
        for (p, q), pp in self.pair_plans.items():
            m[q, p] = pp.mu
        return m


def local_piece_csrs(plan: SpmmPlan) -> Dict[str, List[CSRMatrix]]:
    """Per-piece local layouts consumed by ``LocalSpmmBackend.prepare``.

    The flat executor multiplies three sparse pieces per process, each
    against a different dense operand (see core.dist_spmm):

      diag — (m_p × k_p) against the local B block;
      colp — (m_p × P·max_b) against the flat all_to_all receive buffer;
      rowp — (P·max_c × k_q) against the local B block, producing the
             partial-C send buffer.

    Backends re-layout these CSRs into their native compute format
    (padded COO, ELL blocks, ...) without touching the communication
    schedule — the flat index spaces above ARE the schedule.
    """
    return {
        "diag": list(plan.a_diag),
        "colp": list(plan.a_colpart),
        "rowp": list(plan.a_rowpart),
    }


def build_plan(
    a: CSRMatrix,
    P: int,
    strategy: Strategy = "joint",
    bounds: Optional[Sequence[Tuple[int, int]]] = None,
    w_row: Optional[np.ndarray] = None,
    w_col: Optional[np.ndarray] = None,
    pad_to: int = 1,
) -> SpmmPlan:
    """Build the full SHIRO plan for ``C = A @ B`` row-partitioned over P.

    ``a`` is the GLOBAL sparse matrix (square or rectangular, K rows of B
    partitioned with the same bounds as A's columns). ``pad_to`` rounds the
    padded slot counts up (bucket rounding keeps recompilation away when
    patterns change slightly; 1 = exact max).
    """
    if strategy not in _STRATEGIES:
        raise ValueError(f"strategy must be one of {_STRATEGIES}")
    global _PLAN_BUILDS
    _PLAN_BUILDS += 1
    m, k = a.shape
    row_bounds = bounds or block_rows(m, P)
    col_bounds = bounds or block_rows(k, P)

    pair_plans: Dict[Tuple[int, int], PairPlan] = {}
    a_diag: List[CSRMatrix] = []
    for p in range(P):
        rlo, rhi = row_bounds[p]
        a_p = a.row_block(rlo, rhi)
        for q in range(P):
            clo, chi = col_bounds[q]
            blk = a_p.col_block(clo, chi)
            if q == p:
                a_diag.append(blk)
                continue
            wr = None if w_row is None else w_row[rlo:rhi]
            wc = None if w_col is None else w_col[clo:chi]
            pair_plans[(p, q)] = build_pair_plan(blk, p, q, strategy, wr, wc)

    if strategy == "block":
        # sparsity-oblivious: every remote block of B moves in full (Eq. 1)
        pair_plans = {
            (p, q): dataclasses.replace(
                pp,
                col_ids=np.arange(col_bounds[q][1] - col_bounds[q][0], dtype=np.int64),
            )
            for (p, q), pp in pair_plans.items()
        }

    def _round(v: int) -> int:
        return ((v + pad_to - 1) // pad_to) * pad_to if v else 0

    max_b = _round(max((pp.col_ids.size for pp in pair_plans.values()), default=0))
    max_c = _round(max((pp.row_ids.size for pp in pair_plans.values()), default=0))
    max_b = max(max_b, 1)  # keep shapes non-degenerate
    max_c = max(max_c, 1)

    b_send_idx = np.full((P, P, max_b), -1, np.int32)
    c_send_rows = np.full((P, P, max_c), -1, np.int32)
    for (p, q), pp in pair_plans.items():
        # column part: q sends B rows listed in col_ids; slot order is
        # preserved by all_to_all so fetched row (src q, slot s) lands at
        # flat receive offset q*max_b + s on the destination.
        b_send_idx[q, p, : pp.col_ids.size] = pp.col_ids
        # row part: q computes partial C rows listed in row_ids into slot
        # (dest p, s); receiver p scatter-adds slot (q, s) into this row.
        c_send_rows[q, p, : pp.row_ids.size] = pp.row_ids

    # Build the remapped CSR pieces (flat buffer index spaces).
    a_colpart: List[CSRMatrix] = []
    a_rowpart: List[CSRMatrix] = []
    for p in range(P):
        rlo, rhi = row_bounds[p]
        m_p = rhi - rlo
        rows_l, cols_l, vals_l = [], [], []
        for q in range(P):
            if q == p or (p, q) not in pair_plans:
                continue
            pp = pair_plans[(p, q)]
            coo = pp.a_col.to_coo()
            if coo.nnz:
                slot_of_col = np.full(pp.a_col.shape[1], -1, np.int64)
                slot_of_col[pp.col_ids] = np.arange(pp.col_ids.size)
                rows_l.append(coo.row.astype(np.int64))
                cols_l.append(q * max_b + slot_of_col[coo.col])
                vals_l.append(coo.val)
        if rows_l:
            a_colpart.append(
                csr_from_coo(
                    COOMatrix(
                        (m_p, P * max_b),
                        np.concatenate(rows_l).astype(np.int32),
                        np.concatenate(cols_l).astype(np.int32),
                        np.concatenate(vals_l),
                    )
                )
            )
        else:
            a_colpart.append(
                CSRMatrix((m_p, P * max_b), np.zeros(m_p + 1, np.int32), np.empty(0, np.int32), np.empty(0, np.float32))
            )

    for q in range(P):
        clo, chi = col_bounds[q]
        k_q = chi - clo
        rows_l, cols_l, vals_l = [], [], []
        for p in range(P):
            if p == q or (p, q) not in pair_plans:
                continue
            pp = pair_plans[(p, q)]
            roo = pp.a_row.to_coo()
            if roo.nnz:
                slot_of_row = np.full(pp.a_row.shape[0], -1, np.int64)
                slot_of_row[pp.row_ids] = np.arange(pp.row_ids.size)
                rows_l.append(p * max_c + slot_of_row[roo.row])
                cols_l.append(roo.col.astype(np.int64))
                vals_l.append(roo.val)
        if rows_l:
            a_rowpart.append(
                csr_from_coo(
                    COOMatrix(
                        (P * max_c, k_q),
                        np.concatenate(rows_l).astype(np.int32),
                        np.concatenate(cols_l).astype(np.int32),
                        np.concatenate(vals_l),
                    )
                )
            )
        else:
            a_rowpart.append(
                CSRMatrix((P * max_c, k_q), np.zeros(P * max_c + 1, np.int32), np.empty(0, np.int32), np.empty(0, np.float32))
            )

    return SpmmPlan(
        P=P,
        shape=a.shape,
        strategy=strategy,
        bounds=tuple(row_bounds),
        pair_plans=pair_plans,
        max_b=max_b,
        max_c=max_c,
        b_send_idx=b_send_idx,
        c_send_rows=c_send_rows,
        a_diag=a_diag,
        a_colpart=a_colpart,
        a_rowpart=a_rowpart,
    )


# ---------------------------------------------------------------------------
# replication (the 1.5D axis): c lanes over a flat plan at s = P/c shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicatedPlan:
    """A 1.5D replicated plan: ``c`` lanes over a flat plan at ``s = P/c``.

    B is replicated ``c``-fold (every lane holds the full s-way B shard
    of its shard index), and the flat plan's nonzero shifts d in 1..s-1
    are partitioned across the lanes (``lane_shifts``): lane r executes
    only its shifts' exchanges + compute, then the lanes' partial C
    blocks are summed and scattered over the replica axis. Memory for
    bandwidth: each lane's exchange spans only the s contiguous ranks of
    the lane — the fast tier once s <= NetworkSpec.group_size — while
    the flat plan at P = c*s pays inter-group prices.

    Lane 0 additionally owns the diagonal block (replicating it would
    double-count rows through the reduce-scatter).
    """

    base: SpmmPlan  # flat plan over s shards (base.P == s)
    c: int
    lane_shifts: Tuple[Tuple[int, ...], ...]  # per-lane shift lists, len c

    @property
    def s(self) -> int:
        return self.base.P

    @property
    def P(self) -> int:
        return self.c * self.base.P

    def volume_rows(self) -> int:
        """Lane-exchanged rows (ideal); the reduce-scatter moves dense C
        blocks and is modeled separately (comm_model)."""
        return self.base.volume_rows()


def replicate_plan(base: SpmmPlan, c: int) -> ReplicatedPlan:
    """Partition the flat plan's shifts across ``c`` lanes (greedy LPT).

    Shift demand is the padded per-shift slot count the bucketed layout
    would pay (B slots + C slots); heaviest shifts are assigned first to
    the least-loaded lane, and each lane keeps its shifts in descending
    demand order so round j of every lane pairs big with big (round
    padding is the max over participating lanes).
    """
    from .comm_schedule import shift_slot_demands

    c = int(c)
    if c < 1:
        raise ValueError(f"replication factor must be >= 1, got {c}")
    s = base.P
    sb, sc = shift_slot_demands(base)
    demands = [(int(sb[d - 1] + sc[d - 1]), d) for d in range(1, s)]
    demands = [(w, d) for w, d in demands if w > 0]
    demands.sort(key=lambda t: (-t[0], t[1]))
    loads = [0] * c
    lanes: List[List[int]] = [[] for _ in range(c)]
    for w, d in demands:
        r = min(range(c), key=lambda i: (loads[i], i))
        loads[r] += w
        lanes[r].append(d)  # assignment order IS descending demand
    return ReplicatedPlan(base=base, c=c,
                          lane_shifts=tuple(tuple(l) for l in lanes))
