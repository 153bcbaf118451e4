"""Hierarchical (two-tier) extension of the SHIRO plan (paper §6).

A copy of ``repro.core.hierarchy`` (NumPy only), so that the port never
imports the JAX package. The reference's per-nonzero and per-row Python
loops are vectorised with ``searchsorted`` over the same sorted unions;
every array comes out equal to the reference's.

Processes form a G × L grid: G groups ("pods" over the slow tier) of L
local members each (fast tier). Process id = g * L + l.

Column part (B rows), paper §6.1.2 "column-based redundancy elimination":
  stage I.①  inter-group: source q sends, ONCE per destination group, the
             de-duplicated union of B rows any member of that group needs;
  stage II.② intra-group: rows are redistributed inside the dest group.

Row part (partial C rows), "row-based redundancy elimination":
  stage I.①  intra-group: members of a source group pre-aggregate partials
             that target the same destination C row;
  stage II.② inter-group: aggregated partials cross the slow tier once.

SPMD realization: the paper's "group representative" becomes same-local-
rank pairing — the all_to_all over the group axis pairs (g, l) with
(g', l), and the reduce-scatter over the local axis assigns each
destination process's traffic to the member sharing its local rank.
Inter-group byte counts match the paper exactly; there is no
single-representative bottleneck.

Buffer layouts (static):
  b_group_send_idx [P_src, G_dst, max_bg]   local B row at src, -1 pad
  colpart_flat_cols maps each process's column-part flat column space
     (see planner.SpmmPlan) onto the group receive space
     [L_src, G_src, max_bg] flattened — so after the intra-group
     all_gather each process gathers exactly the rows it needs.
  c_group_rows [G_src, P_dst, max_cg]       DEST-local C row index, -1 pad
  c_slot_of_pair [P_src, P_dst, max_c] -> slot in the (src-group, dst)
     union list, used by sources to write partials into the group layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .planner import SpmmPlan
from .sparse import COOMatrix, CSRMatrix, csr_from_coo

__all__ = ["HierPlan", "build_hier_plan", "build_group_aware_plan",
           "hier_piece_csrs"]


@dataclasses.dataclass(frozen=True)
class HierPlan:
    """Two-tier buffer layout derived from a flat SpmmPlan."""

    base: SpmmPlan
    G: int
    L: int
    max_bg: int
    max_cg: int
    # column part
    b_group_send_idx: np.ndarray  # [P, G, max_bg] int32, local B row at src
    colpart_flat_cols: List[np.ndarray]  # per dest p: new flat col for each
    #   nonzero of base.a_colpart[p] (indexes [L, G, max_bg] space), int32
    # row part
    c_group_rows: np.ndarray  # [G, P, max_cg] int32, dest-local C row
    c_slot_of_pair: np.ndarray  # [P, P, max_c] int32, slot into group list

    # ---- analytics ----------------------------------------------------
    def inter_group_rows(self) -> Tuple[int, int]:
        """(B rows, C rows) crossing the slow tier under the hier plan."""
        P, G, L = self.base.P, self.G, self.L
        b_counts = (self.b_group_send_idx >= 0).sum(axis=2)  # [P, G]
        c_counts = (self.c_group_rows >= 0).sum(axis=2)  # [G, P]
        own = np.arange(P) // L
        b = int(b_counts.sum() - b_counts[np.arange(P), own].sum())
        cross = own[None, :] != np.arange(G)[:, None]  # [G(src), P(dst)]
        return b, int(c_counts[cross].sum())

    def inter_group_rows_flat(self) -> Tuple[int, int]:
        """Slow-tier rows if the flat plan were used directly (baseline)."""
        L = self.L
        b = c = 0
        for (p, q), pp in self.base.pair_plans.items():
            if p // L != q // L:
                b += pp.col_ids.size
                c += pp.row_ids.size
        return b, c


def _unions(pairs: Dict[Tuple[int, int], List[np.ndarray]]
            ) -> Dict[Tuple[int, int], np.ndarray]:
    """Sorted de-duplicated union per key (the reference's sorted sets)."""
    return {key: np.unique(np.concatenate(parts).astype(np.int64))
            for key, parts in pairs.items()}


def build_hier_plan(base: SpmmPlan, G: int, L: int, pad_to: int = 1) -> HierPlan:
    """Derive the two-tier layout from a flat SHIRO plan.

    Group dedup (B): for destination group gd and source q, the union of
    col_ids over all members p ∈ gd. Pre-aggregation (C): for source group
    gs and destination p, the union of row_ids over all members q ∈ gs.
    """
    P = base.P
    if G * L != P:
        raise ValueError(f"G*L={G * L} != P={P}")

    def _round(v: int) -> int:
        v = ((v + pad_to - 1) // pad_to) * pad_to if v else 0
        return max(v, 1)

    # ---------------- column part: (src q, dest group) dedup -----------
    b_parts: Dict[Tuple[int, int], List[np.ndarray]] = {}
    for (p, q), pp in base.pair_plans.items():
        b_parts.setdefault((q, p // L), []).append(pp.col_ids)
    b_union = _unions(b_parts)
    max_bg = _round(max((v.size for v in b_union.values()), default=0))
    b_group_send_idx = np.full((P, G, max_bg), -1, np.int32)
    for (q, gd), rows in b_union.items():
        b_group_send_idx[q, gd, : rows.size] = rows

    # Remap each dest's column-part flat columns from the flat receive
    # space (q*max_b + slot) to the hierarchical gathered space.
    # After stage I.① a2a over groups + stage II.② all_gather over locals,
    # dest p holds a buffer indexed [l_src, g_src, max_bg]: entry
    # (ls, gs, s) = B row b_group_send_idx[gs*L+ls, gd, s] of source
    # process gs*L+ls (gd = p's group).
    colpart_flat_cols: List[np.ndarray] = []
    for p in range(P):
        gd = p // L
        flat = base.a_colpart[p].indices.astype(np.int64)
        qs = flat // base.max_b
        local_rows = base.b_send_idx[qs, p, flat % base.max_b].astype(
            np.int64)
        s = np.empty(flat.size, np.int64)
        for q in np.unique(qs):
            at = qs == q
            union = b_union[(int(q), gd)]
            s[at] = np.searchsorted(union, local_rows[at])
            assert np.array_equal(union[s[at]], local_rows[at])
        new_cols = ((qs % L) * G + qs // L) * max_bg + s
        colpart_flat_cols.append(new_cols.astype(np.int32))

    # ---------------- row part: (src group, dest p) union --------------
    c_parts: Dict[Tuple[int, int], List[np.ndarray]] = {}
    for (p, q), pp in base.pair_plans.items():
        c_parts.setdefault((q // L, p), []).append(pp.row_ids)
    c_union = _unions(c_parts)
    max_cg = _round(max((v.size for v in c_union.values()), default=0))
    c_group_rows = np.full((G, P, max_cg), -1, np.int32)
    for (gs, p), rows in c_union.items():
        c_group_rows[gs, p, : rows.size] = rows

    c_slot_of_pair = np.full((P, P, base.max_c), -1, np.int32)
    for (p, q), pp in base.pair_plans.items():
        union = c_union[(q // L, p)]
        c_slot_of_pair[q, p, : pp.row_ids.size] = np.searchsorted(
            union, pp.row_ids)

    return HierPlan(
        base=base,
        G=G,
        L=L,
        max_bg=max_bg,
        max_cg=max_cg,
        b_group_send_idx=b_group_send_idx,
        colpart_flat_cols=colpart_flat_cols,
        c_group_rows=c_group_rows,
        c_slot_of_pair=c_slot_of_pair,
    )


def hier_piece_csrs(hier: HierPlan) -> dict:
    """Per-piece local layouts for the hierarchical executor's backends.

    Same three pieces as ``planner.local_piece_csrs`` but with the flat
    off-diagonal index spaces remapped onto the two-tier buffers:

      colp — columns move from the flat receive space (q·max_b + slot) to
             the gathered group space ((l_src·G + g_src)·max_bg + slot);
      rowp — rows move from (dest·max_c + slot) to the pre-aggregation
             layout (dest·max_cg + group_slot) fed to psum_scatter.
    """
    base = hier.base
    P = base.P
    gathered_cols = hier.L * hier.G * hier.max_bg
    colp: List[CSRMatrix] = []
    for p in range(P):
        coo = base.a_colpart[p].to_coo()
        colp.append(csr_from_coo(COOMatrix(
            (base.a_colpart[p].shape[0], gathered_cols),
            coo.row, hier.colpart_flat_cols[p].astype(np.int32), coo.val)))

    group_rows = P * hier.max_cg
    rowp: List[CSRMatrix] = []
    for q in range(P):
        coo = base.a_rowpart[q].to_coo()
        flat = coo.row.astype(np.int64)
        ps, slots = flat // base.max_c, flat % base.max_c
        gslot = hier.c_slot_of_pair[q, ps, slots]
        assert np.all(gslot >= 0)
        rowp.append(csr_from_coo(COOMatrix(
            (group_rows, base.a_rowpart[q].shape[1]),
            (ps * hier.max_cg + gslot).astype(np.int32), coo.col, coo.val)))

    return {"diag": list(base.a_diag), "colp": colp, "rowp": rowp}


def build_group_aware_plan(a, P: int, G: int, L: int, pad_to: int = 1):
    """Beyond-paper: WEIGHTED covers that anticipate group dedup (§5.2 hook).

    The paper solves each off-diagonal block's cover with uniform weights
    and only afterwards de-duplicates B rows at group granularity (§6.1).
    But the two decisions interact: a B row needed by k members of the
    destination group crosses the slow tier ONCE under dedup, so its
    *marginal* inter-group cost is 1/k — choosing it over a C row is
    cheaper than the uniform cover believes.

    Two-pass scheme: pass 1 counts, for every (source q, dest group gd),
    how many group members' blocks touch each B row; pass 2 re-solves each
    inter-group pair's cover via the weighted min-cut (Dinic) with
    w_col[j] = 1/shared_count, w_row = 1. Intra-group pairs keep uniform
    weights. Returns (SpmmPlan, HierPlan, changed) built from the
    re-weighted covers — drop-in for the executors.
    """
    from .planner import build_pair_plan, build_plan
    from .sparse import block_rows

    m, k = a.shape
    bounds = block_rows(m, P)
    cbounds = block_rows(k, P)

    # pass 1: shared-fetch counts per (source q, dest group, local B row)
    share = {}
    blocks = {}
    for p in range(P):
        rlo, rhi = bounds[p]
        a_p = a.row_block(rlo, rhi)
        for q in range(P):
            if q == p:
                continue
            clo, chi = cbounds[q]
            blk = a_p.col_block(clo, chi)
            blocks[(p, q)] = blk
            gd = p // L
            cnt = share.setdefault((q, gd), np.zeros(chi - clo, np.int64))
            cols = blk.nonzero_cols()
            cnt[cols] += 1

    # pass 2: build the full plan, re-weighting inter-group pairs
    base = build_plan(a, P, "joint", pad_to=pad_to)
    pair_plans = dict(base.pair_plans)
    changed = 0
    for (p, q), blk in blocks.items():
        if p // L == q // L:
            continue  # intra-group: uniform cover already optimal
        gd = p // L
        cnt = share[(q, gd)]
        w_col = 1.0 / np.maximum(cnt, 1).astype(np.float64)
        w_row = np.ones(blk.shape[0], np.float64)
        new = build_pair_plan(blk, p, q, "joint", w_row=w_row, w_col=w_col)
        if new.mu != pair_plans[(p, q)].mu or \
                new.col_ids.size != pair_plans[(p, q)].col_ids.size:
            changed += 1
        pair_plans[(p, q)] = new

    rebuilt = _rebuild_from_pairs(a, P, pair_plans, bounds, cbounds, pad_to)
    hier = build_hier_plan(rebuilt, G, L, pad_to=pad_to)
    return rebuilt, hier, changed


def _rebuild_from_pairs(a, P, pair_plans, bounds, cbounds, pad_to):
    """Re-pack a SpmmPlan from externally (re-)computed PairPlans."""
    a_diag = []
    for p in range(P):
        rlo, rhi = bounds[p]
        clo, chi = cbounds[p]
        a_diag.append(a.row_block(rlo, rhi).col_block(clo, chi))

    def _round(v):
        v = ((v + pad_to - 1) // pad_to) * pad_to if v else 0
        return max(v, 1)

    max_b = _round(max((pp.col_ids.size for pp in pair_plans.values()), default=0))
    max_c = _round(max((pp.row_ids.size for pp in pair_plans.values()), default=0))
    b_send_idx = np.full((P, P, max_b), -1, np.int32)
    c_send_rows = np.full((P, P, max_c), -1, np.int32)
    for (p, q), pp in pair_plans.items():
        b_send_idx[q, p, : pp.col_ids.size] = pp.col_ids
        c_send_rows[q, p, : pp.row_ids.size] = pp.row_ids

    a_colpart, a_rowpart = [], []
    for p in range(P):
        m_p = bounds[p][1] - bounds[p][0]
        rows_l, cols_l, vals_l = [], [], []
        for q in range(P):
            if q == p or (p, q) not in pair_plans:
                continue
            pp = pair_plans[(p, q)]
            coo = pp.a_col.to_coo()
            if coo.nnz:
                slot = np.full(pp.a_col.shape[1], -1, np.int64)
                slot[pp.col_ids] = np.arange(pp.col_ids.size)
                rows_l.append(coo.row.astype(np.int64))
                cols_l.append(q * max_b + slot[coo.col])
                vals_l.append(coo.val)
        if rows_l:
            a_colpart.append(csr_from_coo(COOMatrix(
                (m_p, P * max_b), np.concatenate(rows_l).astype(np.int32),
                np.concatenate(cols_l).astype(np.int32),
                np.concatenate(vals_l))))
        else:
            a_colpart.append(CSRMatrix((m_p, P * max_b),
                                       np.zeros(m_p + 1, np.int32),
                                       np.empty(0, np.int32),
                                       np.empty(0, np.float32)))
    for q in range(P):
        k_q = cbounds[q][1] - cbounds[q][0]
        rows_l, cols_l, vals_l = [], [], []
        for p in range(P):
            if p == q or (p, q) not in pair_plans:
                continue
            pp = pair_plans[(p, q)]
            roo = pp.a_row.to_coo()
            if roo.nnz:
                slot = np.full(pp.a_row.shape[0], -1, np.int64)
                slot[pp.row_ids] = np.arange(pp.row_ids.size)
                rows_l.append(p * max_c + slot[roo.row])
                cols_l.append(roo.col.astype(np.int64))
                vals_l.append(roo.val)
        if rows_l:
            a_rowpart.append(csr_from_coo(COOMatrix(
                (P * max_c, k_q), np.concatenate(rows_l).astype(np.int32),
                np.concatenate(cols_l).astype(np.int32),
                np.concatenate(vals_l))))
        else:
            a_rowpart.append(CSRMatrix((P * max_c, k_q),
                                       np.zeros(P * max_c + 1, np.int32),
                                       np.empty(0, np.int32),
                                       np.empty(0, np.float32)))
    return SpmmPlan(
        P=P, shape=a.shape, strategy="joint-groupaware",
        bounds=tuple(bounds), pair_plans=pair_plans,
        max_b=max_b, max_c=max_c, b_send_idx=b_send_idx,
        c_send_rows=c_send_rows, a_diag=a_diag,
        a_colpart=a_colpart, a_rowpart=a_rowpart)
