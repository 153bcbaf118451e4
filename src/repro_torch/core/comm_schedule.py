"""Skew-aware bucketed communication schedules (beyond-paper §5 extension).

A copy of ``repro.core.comm_schedule`` (NumPy only) — the flat,
hierarchical and replicated (1.5D) schedules and layouts — so that the
port never imports the JAX package.

The offline planner (core.planner) pads every (src, dst) pair to the
GLOBAL slot maxima ``max_b`` / ``max_c`` so a single ``all_to_all`` stays
static. On skewed patterns (power-law / hub matrices) that wastes an
order of magnitude on the wire: the dense all_to_all operand carries
``P · (max_b + max_c)`` rows per process while the analytic SHIRO volume
(paper Eq. 9) is ``Σ μ``.

This module replaces the one max-padded round with a **multi-round
schedule** that is still fully static:

* the complete (src, dst) exchange graph decomposes into its P-1
  *shift* classes — shift ``d`` pairs every source ``q`` with destination
  ``(q + d) % P``, a perfect matching realized by one ppermute
  (``LocalComm.shift`` in the port);
* each shift only needs its OWN slot maximum (the largest pair it
  carries), not the global one, so executed padded rows drop from
  ``P·(P-1)·max`` toward ``P·Σ_d max_d``;
* shifts are then binned into ``K`` rounds of similar slot demand
  (optimal 1-D partition, not just geometric guesses); every shift in a
  round shares the round's slot ceiling. ``K`` trades residual padding
  (smaller with more rounds) against launch latency (one α term per
  round) — ``comm_model.choose_schedule`` picks it from the α-β model.
* empty shifts (no communicated rows) vanish from the schedule entirely —
  the dense all_to_all could never skip them.

The executor (core.dist_spmm) unrolls the rounds statically, so shapes
never depend on data. ``CommSchedule`` is a hashable pure-int structure
and rides in the exec plan's metadata.

The same treatment applies to the hierarchical inter-group collectives
(``build_hier_comm_schedule``): group-shift 0 — data for the process's
OWN group, which the dense all_to_all shipped through the network — is
served by a local slice instead of a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .hierarchy import HierPlan
from .planner import SpmmPlan

__all__ = [
    "CommRound",
    "CommSchedule",
    "shift_slot_demands",
    "group_shift_slot_demands",
    "partition_slots",
    "build_comm_schedule",
    "build_hier_comm_schedule",
    "single_round_schedule",
    "single_round_hier_schedule",
    "flat_schedule_layout",
    "hier_schedule_layout",
    "ordered_spans",
    "span_cuts",
    "ReplRound",
    "ReplicatedSchedule",
    "build_replicated_schedule",
    "ReplicatedScheduleLayout",
    "replicated_schedule_layout",
]

# ---------------------------------------------------------------------------
# schedule structure (hashable: rides in jit-static exec-plan metadata)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommRound:
    """One statically-unrolled communication round.

    ``shifts`` lists the shift classes served this round (shift ``d``
    moves src ``q`` → dst ``(q + d) % P`` — a perfect matching, one
    ppermute). ``slot_b`` / ``slot_c`` are the round's shared slot
    ceilings: every listed shift's B / C segment is padded to them,
    except that a shift with zero demand on one part keeps slot 0 there
    (no segment at all — see ``CommSchedule.slots_b`` / ``slots_c`` for
    the per-shift truth).
    """

    shifts: Tuple[int, ...]
    slot_b: int
    slot_c: int


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Static multi-round schedule for one executor tier.

    ``kind``:
      * ``"single"``  — the legacy one-round max-padded all_to_all pair;
        ``rounds`` is empty and ``max_b`` / ``max_c`` carry the layout.
      * ``"bucketed"`` — K ppermute rounds; shift ``d``'s slot sizes are
        ``slots_b[d-1]`` / ``slots_c[d-1]`` (0 = shift not scheduled).

    ``P`` is the number of ranks on the scheduled axis (the group count
    G for hierarchical inter-group schedules, where shift 0 data is
    served locally and therefore never appears in ``rounds``).
    ``procs`` is the number of PROCESSES placing operands — equal to
    ``P`` for flat schedules, ``G·L`` for hierarchical ones (every group
    member runs the group-axis collectives); 0 means "same as P".
    """

    kind: str
    P: int
    max_b: int
    max_c: int
    slots_b: Tuple[int, ...] = ()
    slots_c: Tuple[int, ...] = ()
    rounds: Tuple[CommRound, ...] = ()
    local_slot_b: int = 0  # hier only: shift-0 (own group) slot width
    local_slot_c: int = 0
    procs: int = 0

    @property
    def K(self) -> int:
        return len(self.rounds) if self.kind == "bucketed" else 1

    # ----- padded-volume accounting (operand rows, matches the HLO) ----
    def rows_per_process(self) -> int:
        """Rows each process places into collective operands.

        ``single``: the all_to_all operand is [P, max, N] — including the
        always-empty self slot the dense collective cannot drop.
        ``bucketed``: one [slot_d, N] ppermute operand per scheduled
        shift; local (shift-0) slices never hit the wire.
        """
        if self.kind == "single":
            return self.P * (self.max_b + self.max_c)
        return int(sum(self.slots_b) + sum(self.slots_c))

    def volume_rows_padded(self) -> int:
        """Total rows in collective operands across all processes."""
        return (self.procs or self.P) * self.rows_per_process()


# ---------------------------------------------------------------------------
# per-shift slot demands
# ---------------------------------------------------------------------------


def shift_slot_demands(plan: SpmmPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shift slot maxima (sb[d-1], sc[d-1]) for d = 1..P-1.

    Shift ``d`` carries every pair (dst=(q+d)%P, src=q); its slot demand
    is the largest per-pair row count among them — the only padding a
    shift-structured round ever needs.
    """
    P = plan.P
    nb = np.zeros((P, P), np.int64)
    nc = np.zeros((P, P), np.int64)
    for (p, q), pp in plan.pair_plans.items():
        nb[q, p] = pp.col_ids.size
        nc[q, p] = pp.row_ids.size
    sb = np.zeros(P - 1, np.int64)
    sc = np.zeros(P - 1, np.int64)
    for d in range(1, P):
        dsts = (np.arange(P) + d) % P
        sb[d - 1] = nb[np.arange(P), dsts].max()
        sc[d - 1] = nc[np.arange(P), dsts].max()
    return sb, sc


def group_shift_slot_demands(hier: HierPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group-shift slot maxima for the hier inter-group collectives.

    Returns ``(sbg, scg)`` of length G, index = group shift ``dg``
    (0 = own group, served locally by the bucketed executor).
    """
    G, L = hier.G, hier.L
    P = hier.base.P
    b_counts = (hier.b_group_send_idx >= 0).sum(axis=2)  # [P(src), G(dst)]
    c_counts = (hier.c_group_rows >= 0).sum(axis=2)  # [G(src), P(dst)]
    sbg = np.zeros(G, np.int64)
    scg = np.zeros(G, np.int64)
    gs = np.arange(P) // L
    # b: source q's group gs, dest group gd -> shift (gd - gs) % G
    np.maximum.at(sbg, (np.arange(G)[None, :] - gs[:, None]) % G, b_counts)
    # c: source group gs, dest p's group -> shift (p // L - gs) % G
    np.maximum.at(scg, (gs[None, :] - np.arange(G)[:, None]) % G, c_counts)
    return sbg, scg


# ---------------------------------------------------------------------------
# bucketing: optimal K-way partition of sorted slot demands
# ---------------------------------------------------------------------------


def partition_slots(demands_b: np.ndarray, demands_c: np.ndarray,
                    K: int) -> List[Tuple[Tuple[int, ...], int, int]]:
    """Bin shifts into ≤K rounds minimizing total padded slots.

    Returns ``[(shift_indices, slot_b_ceiling, slot_c_ceiling), ...]``
    with AT MOST K entries — one α term per entry, which is the contract
    ``modeled_time_schedule`` charges for. Shifts with no demand on
    either part are dropped (they need no round at all). Shifts are
    sorted by combined demand and split into ≤K contiguous classes by a
    tiny DP minimizing the executed padded rows over this ordering —
    each member shift pays its class ceiling only on parts where it has
    demand (zero-demand parts emit no segment, see ``_make_rounds``);
    better than fixed geometric ceilings on real skew.
    """
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    idx = [i for i in range(len(demands_b))
           if demands_b[i] > 0 or demands_c[i] > 0]
    if not idx:
        return []
    order = sorted(idx, key=lambda i: (int(demands_b[i]) + int(demands_c[i]),
                                       int(demands_b[i])))
    n = len(order)
    K = min(K, n)

    def cls_cost(i: int, j: int) -> int:  # class = order[i:j]
        mb = max(int(demands_b[t]) for t in order[i:j])
        mc = max(int(demands_c[t]) for t in order[i:j])
        return sum((mb if demands_b[t] > 0 else 0)
                   + (mc if demands_c[t] > 0 else 0)
                   for t in order[i:j])

    INF = float("inf")
    dp = [[INF] * (K + 1) for _ in range(n + 1)]
    cut = [[0] * (K + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for j in range(1, n + 1):
        for k in range(1, K + 1):
            for i in range(j):
                if dp[i][k - 1] == INF:
                    continue
                cost = dp[i][k - 1] + cls_cost(i, j)
                if cost < dp[j][k]:
                    dp[j][k] = cost
                    cut[j][k] = i
    best_k = min(range(1, K + 1), key=lambda k: dp[n][k])
    bounds = []
    j = n
    for k in range(best_k, 0, -1):
        i = cut[j][k]
        bounds.append((i, j))
        j = i
    out = []
    for (i, j) in sorted(bounds):
        members = tuple(sorted(order[i:j]))
        mb = max(int(demands_b[t]) for t in members)
        mc = max(int(demands_c[t]) for t in members)
        out.append((members, mb, mc))
    return out


def _make_rounds(demands_b: np.ndarray, demands_c: np.ndarray,
                 K: int) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                  Tuple[CommRound, ...]]:
    """≤K rounds over the scheduled shifts, plus per-shift slot tables.

    A shift's B (C) segment is padded to its round's slot_b (slot_c) —
    except that a part with ZERO demand on that shift keeps slot 0: no
    segment, no wire bytes, whatever its round ceiling says.
    """
    parts = partition_slots(demands_b, demands_c, K)
    sb_final = [0] * len(demands_b)
    sc_final = [0] * len(demands_c)
    rounds = []
    for members, mb, mc in parts:
        for i in members:
            sb_final[i] = mb if demands_b[i] > 0 else 0
            sc_final[i] = mc if demands_c[i] > 0 else 0
        rounds.append(CommRound(shifts=tuple(d + 1 for d in members),
                                slot_b=mb, slot_c=mc))
    return tuple(sb_final), tuple(sc_final), tuple(rounds)


def build_comm_schedule(plan: SpmmPlan, K: int = 4) -> CommSchedule:
    """Bucketed K-round schedule for the flat executor.

    ``K`` bounds the number of distinct slot classes per part; rounds
    merge shifts whose (slot_b, slot_c) ceilings coincide. ``K`` large
    enough (≥ the number of distinct demands) yields exact per-shift
    slots; ``K=1`` pads every scheduled shift to the global maximum —
    still ahead of the all_to_all, which additionally carries the self
    slot and empty shifts.
    """
    sb, sc = shift_slot_demands(plan)
    slots_b, slots_c, rounds = _make_rounds(sb, sc, K)
    return CommSchedule(
        kind="bucketed", P=plan.P, max_b=plan.max_b, max_c=plan.max_c,
        slots_b=slots_b, slots_c=slots_c, rounds=rounds,
    )


def single_round_schedule(plan: SpmmPlan) -> CommSchedule:
    """The legacy max-padded all_to_all as a CommSchedule (for accounting)."""
    return CommSchedule(kind="single", P=plan.P,
                        max_b=plan.max_b, max_c=plan.max_c)


def build_hier_comm_schedule(hier: HierPlan, K: int = 4) -> CommSchedule:
    """Bucketed schedule for the hierarchical INTER-GROUP collectives.

    Scheduled shifts run over the group axis (1..G-1); group-shift 0 —
    traffic whose source and destination share a group — becomes a local
    slice with its own slot width (``local_slot_*``) instead of a wire
    round.
    """
    sbg, scg = group_shift_slot_demands(hier)
    slots_b, slots_c, rounds = _make_rounds(sbg[1:], scg[1:], K)
    return CommSchedule(
        kind="bucketed", P=hier.G, max_b=hier.max_bg, max_c=hier.max_cg,
        slots_b=slots_b, slots_c=slots_c, rounds=rounds,
        local_slot_b=int(sbg[0]), local_slot_c=int(scg[0]),
        procs=hier.base.P,
    )


def single_round_hier_schedule(hier: HierPlan) -> CommSchedule:
    """The hier max-padded group all_to_all pair as a CommSchedule."""
    return CommSchedule(kind="single", P=hier.G,
                        max_b=hier.max_bg, max_c=hier.max_cg,
                        procs=hier.base.P)

# ---------------------------------------------------------------------------
# buffer layouts: flat index spaces for the bucketed executors
# ---------------------------------------------------------------------------


def ordered_spans(off: Dict[int, Tuple[int, int]]
                  ) -> Tuple[Tuple[int, int, int], ...]:
    """``((shift, offset, slot), ...)`` sorted by offset.

    The order every consumer must agree on: the executors exchange and
    consume segments in ascending-offset order, the per-segment
    backend layouts are cut at the same boundaries, and the staged
    paths' flat receive spaces concatenate segments the same way — so
    round-pipelined (overlapped) execution accumulates partial C in
    exactly the order the staged compute does.
    """
    return tuple(sorted(((d, o, s) for d, (o, s) in off.items()),
                        key=lambda t: t[1]))


def span_cuts(spans: Sequence[Tuple[int, int, int]]) -> Tuple[int, ...]:
    """Cumulative end offsets of ``ordered_spans`` output (one per span).

    ``cuts[i]`` is the first index NOT covered after consuming spans
    0..i — the column cut points handed to
    ``LocalSpmmBackend.prepare_segments``.
    """
    return tuple(o + s for _, o, s in spans)


def _segment_offsets(slots: Sequence[int], lead: int = 0
                     ) -> Tuple[Dict[int, Tuple[int, int]], int]:
    """{shift: (offset, slot)} over the concatenated per-shift segments.

    ``lead`` reserves a leading local segment (hier shift 0).
    """
    out: Dict[int, Tuple[int, int]] = {}
    off = lead
    for i, s in enumerate(slots):
        if s > 0:
            out[i + 1] = (off, int(s))
            off += int(s)
    return out, off


@dataclasses.dataclass(frozen=True)
class FlatScheduleLayout:
    """Host-side arrays realizing a bucketed CommSchedule for flat_spmm.

    Index spaces (R_b = Σ slots_b, R_c = Σ slots_c, both ≥ 1):

      b_send_idx [P, R_b]  — local B row packed into send segment
                             (shift d at offset off_b[d]), -1 pad;
      c_recv_rows [P, R_c] — dest-local C row for each receive slot
                             (segment d arrives from src (p-d)%P), -1 pad;
      colp / rowp          — the planner's off-diagonal pieces with
                             columns / rows remapped into the bucketed
                             receive / send spaces.
    """

    schedule: CommSchedule
    off_b: Dict[int, Tuple[int, int]]
    off_c: Dict[int, Tuple[int, int]]
    R_b: int
    R_c: int
    b_send_idx: np.ndarray
    c_recv_rows: np.ndarray
    colp: list
    rowp: list


def flat_schedule_layout(plan: SpmmPlan, sched: CommSchedule
                         ) -> FlatScheduleLayout:
    """Materialize send maps + remapped pieces for a bucketed flat plan."""
    from .sparse import COOMatrix, csr_from_coo

    if sched.kind != "bucketed":
        raise ValueError("flat_schedule_layout needs a bucketed schedule")
    P = plan.P
    off_b, R_b = _segment_offsets(sched.slots_b)
    off_c, R_c = _segment_offsets(sched.slots_c)
    R_b = max(R_b, 1)
    R_c = max(R_c, 1)

    # dense offset tables indexed by shift (-1 = shift not scheduled)
    boff = np.full(P, -1, np.int64)
    coff = np.full(P, -1, np.int64)
    for d, (off, _) in off_b.items():
        boff[d] = off
    for d, (off, _) in off_c.items():
        coff[d] = off

    b_send_idx = np.full((P, R_b), -1, np.int32)
    c_recv_rows = np.full((P, R_c), -1, np.int32)
    for (p, q), pp in plan.pair_plans.items():
        d = (p - q) % P
        if pp.col_ids.size:
            off, slot = off_b[d]
            assert pp.col_ids.size <= slot
            b_send_idx[q, off:off + pp.col_ids.size] = pp.col_ids
        if pp.row_ids.size:
            off, slot = off_c[d]
            assert pp.row_ids.size <= slot
            c_recv_rows[p, off:off + pp.row_ids.size] = pp.row_ids

    # colp: flat col (q·max_b + slot) -> off_b[(p-q)%P] + slot
    colp: List = []
    for p in range(P):
        csr = plan.a_colpart[p]
        coo = csr.to_coo()
        flat = coo.col.astype(np.int64)
        qs = flat // plan.max_b
        slots = flat % plan.max_b
        new_cols = boff[(p - qs) % P] + slots
        assert csr.nnz == 0 or new_cols.min() >= 0
        colp.append(csr_from_coo(COOMatrix(
            (csr.shape[0], R_b), coo.row,
            new_cols.astype(np.int32), coo.val)))

    # rowp: flat row (p·max_c + slot) -> off_c[(p-q)%P] + slot at source q
    rowp: List = []
    for q in range(P):
        csr = plan.a_rowpart[q]
        coo = csr.to_coo()
        flat = coo.row.astype(np.int64)
        ps = flat // plan.max_c
        slots = flat % plan.max_c
        new_rows = coff[(ps - q) % P] + slots
        assert csr.nnz == 0 or new_rows.min() >= 0
        rowp.append(csr_from_coo(COOMatrix(
            (R_c, csr.shape[1]), new_rows.astype(np.int32),
            coo.col, coo.val)))

    return FlatScheduleLayout(
        schedule=sched, off_b=off_b, off_c=off_c, R_b=R_b, R_c=R_c,
        b_send_idx=b_send_idx, c_recv_rows=c_recv_rows,
        colp=colp, rowp=rowp,
    )


@dataclasses.dataclass(frozen=True)
class HierScheduleLayout:
    """Bucketed layout for the hierarchical inter-group collectives.

    R_bg / R_cg include the leading shift-0 (own-group) segment, which
    the executor serves with a local slice instead of a ppermute.

      b_send_idx [P, R_bg]      — local B row per send slot (group-shift
                                  segments, -1 pad);
      c_recv_rows [P, R_cg]     — dest-local C row per receive slot;
      colp                      — columns remapped to the SEGMENT-MAJOR
                                  post-all_gather space: group shift dg
                                  owns the contiguous range
                                  [L·off_bg[dg], L·(off_bg[dg]+slot_dg))
                                  at inner index l_src·slot_dg + slot, so
                                  each gathered segment is consumable the
                                  moment it lands — the overlapped
                                  executor accumulates per segment and
                                  the staged executor concatenates the
                                  same ranges in the same order;
      rowp                      — the intra-group psum_scatter keeps its
                                  uniform max_cg slot layout, but rows
                                  are re-keyed SHIFT-major,
                                  (dg·L + l_dst)·max_cg + group_slot, so
                                  the aggregated tile for group shift dg
                                  lands at agg[dg] on every source —
                                  ready for a static per-shift ppermute
                                  without consulting the group index.
    """

    schedule: CommSchedule
    off_bg: Dict[int, Tuple[int, int]]
    off_cg: Dict[int, Tuple[int, int]]
    R_bg: int
    R_cg: int
    b_send_idx: np.ndarray
    c_recv_rows: np.ndarray
    colp: list
    rowp: list


def hier_schedule_layout(hier: HierPlan, sched: CommSchedule
                         ) -> HierScheduleLayout:
    """Materialize the bucketed inter-group layout for hier_spmm."""
    from .hierarchy import hier_piece_csrs
    from .sparse import COOMatrix, csr_from_coo

    if sched.kind != "bucketed":
        raise ValueError("hier_schedule_layout needs a bucketed schedule")
    base = hier.base
    P, G, L = base.P, hier.G, hier.L
    off_bg, R_bg = _segment_offsets(sched.slots_b, lead=sched.local_slot_b)
    off_cg, R_cg = _segment_offsets(sched.slots_c, lead=sched.local_slot_c)
    if sched.local_slot_b:
        off_bg[0] = (0, sched.local_slot_b)
    if sched.local_slot_c:
        off_cg[0] = (0, sched.local_slot_c)
    R_bg = max(R_bg, 1)
    R_cg = max(R_cg, 1)

    b_counts = (hier.b_group_send_idx >= 0).sum(axis=2)
    b_send_idx = np.full((P, R_bg), -1, np.int32)
    for q in range(P):
        gs = q // L
        for gd in range(G):
            cnt = int(b_counts[q, gd])
            if not cnt:
                continue
            off, slot = off_bg[(gd - gs) % G]
            assert cnt <= slot
            b_send_idx[q, off:off + cnt] = hier.b_group_send_idx[q, gd, :cnt]

    c_counts = (hier.c_group_rows >= 0).sum(axis=2)
    c_recv_rows = np.full((P, R_cg), -1, np.int32)
    for dst in range(P):
        gd = dst // L
        for gs in range(G):
            cnt = int(c_counts[gs, dst])
            if not cnt:
                continue
            off, slot = off_cg[(gd - gs) % G]
            assert cnt <= slot
            c_recv_rows[dst, off:off + cnt] = hier.c_group_rows[gs, dst, :cnt]

    pieces = hier_piece_csrs(hier)

    # colp: hier gathered col ((ls·G + gs)·max_bg + slot) -> segment-major
    #       L·off_bg[dg] + ls·slot_dg + slot, with dg = (gd_dest - gs) % G
    goff = np.full(G, -1, np.int64)
    gwidth = np.zeros(G, np.int64)
    for dg, (off, sl) in off_bg.items():
        goff[dg] = off
        gwidth[dg] = sl
    colp: List = []
    for p in range(P):
        gd = p // L
        csr = pieces["colp"][p]
        coo = csr.to_coo()
        flat = coo.col.astype(np.int64)
        lg = flat // hier.max_bg
        slots = flat % hier.max_bg
        ls, gs = lg // G, lg % G
        dg = (gd - gs) % G
        new_cols = L * goff[dg] + ls * gwidth[dg] + slots
        assert csr.nnz == 0 or new_cols.min() >= 0
        colp.append(csr_from_coo(COOMatrix(
            (csr.shape[0], L * R_bg), coo.row,
            new_cols.astype(np.int32), coo.val)))

    # rowp: dest-major row (dst·max_cg + gslot) -> shift-major
    #       ((dg·L + l_dst)·max_cg + gslot), dg = dest group shift from q
    rowp: List = []
    for q in range(P):
        gs = q // L
        csr = pieces["rowp"][q]
        coo = csr.to_coo()
        flat = coo.row.astype(np.int64)
        dst = flat // hier.max_cg
        gslot = flat % hier.max_cg
        dg = (dst // L - gs) % G
        new_rows = (dg * L + dst % L) * hier.max_cg + gslot
        rowp.append(csr_from_coo(COOMatrix(
            (csr.shape[0], csr.shape[1]), new_rows.astype(np.int32),
            coo.col, coo.val)))

    return HierScheduleLayout(
        schedule=sched, off_bg=off_bg, off_cg=off_cg, R_bg=R_bg, R_cg=R_cg,
        b_send_idx=b_send_idx, c_recv_rows=c_recv_rows,
        colp=colp, rowp=rowp,
    )


# ---------------------------------------------------------------------------
# replicated (1.5D) schedules: c lanes execute disjoint shift subsets
# ---------------------------------------------------------------------------


def _empty_csr(rows: int, cols: int):
    """An all-zero CSR of the given shape (piece placeholder)."""
    from .sparse import CSRMatrix

    return CSRMatrix((rows, cols), np.zeros(rows + 1, np.int32),
                     np.empty(0, np.int32), np.empty(0, np.float32))


@dataclasses.dataclass(frozen=True)
class ReplRound:
    """One replicated round: every lane runs ITS OWN shift concurrently.

    ``shifts[r]`` is lane r's shift this round (0 = lane idle). The
    round's B / C segments share one ceiling and one offset across all
    lanes (``slot_b`` at ``off_b``, ``slot_c`` at ``off_c``) so a single
    slice serves every rank; ``b_lanes`` / ``c_lanes`` list the lanes
    whose shift actually has demand on that part — lanes outside the
    permutation receive zeros, and their pieces carry no nonzeros in the
    segment. ``off_b`` / ``off_c`` are -1 when no lane participates.
    """

    shifts: Tuple[int, ...]
    slot_b: int
    slot_c: int
    off_b: int
    off_c: int
    b_lanes: Tuple[int, ...]
    c_lanes: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ReplicatedSchedule:
    """Static schedule for the replicated (1.5D) executor tier.

    ``c`` lanes over ``s``-shard lane exchanges (P = c·s ranks), plus
    the final reduce-scatter over the replica axis. Hash/equality
    intentionally exclude ``rplan`` (the host-side ``ReplicatedPlan``
    with its numpy pieces), as in the reference, so two schedules
    compare by their rounds alone.
    """

    kind: str  # always "replicated"
    c: int
    s: int
    rounds: Tuple[ReplRound, ...]
    rplan: object = dataclasses.field(compare=False, default=None)

    @property
    def P(self) -> int:
        return self.c * self.s

    @property
    def K(self) -> int:
        return max(len(self.rounds), 1)

    @property
    def R_b(self) -> int:
        """Width of the per-rank B receive space (>= 1)."""
        return max(sum(r.slot_b for r in self.rounds if r.b_lanes), 1)

    @property
    def R_c(self) -> int:
        """Width of the per-rank partial-C send space (>= 1)."""
        return max(sum(r.slot_c for r in self.rounds if r.c_lanes), 1)

    def volume_rows_padded(self) -> int:
        """Rows placed in LANE collective operands across all ranks
        (the reduce-scatter's dense C traffic is modeled separately)."""
        return self.s * sum(len(r.b_lanes) * r.slot_b
                            + len(r.c_lanes) * r.slot_c
                            for r in self.rounds)


def build_replicated_schedule(rp) -> ReplicatedSchedule:
    """Rounds for a ``planner.ReplicatedPlan``: round j runs shift
    ``lane_shifts[r][j]`` on lane r (lanes keep their shifts in
    descending demand order, so round ceilings pair big with big)."""
    base = rp.base
    sb, sc = shift_slot_demands(base)
    n_rounds = max((len(l) for l in rp.lane_shifts), default=0)
    rounds = []
    off_b = off_c = 0
    for j in range(n_rounds):
        shifts = tuple(l[j] if j < len(l) else 0 for l in rp.lane_shifts)
        b_lanes = tuple(r for r, d in enumerate(shifts)
                        if d and sb[d - 1] > 0)
        c_lanes = tuple(r for r, d in enumerate(shifts)
                        if d and sc[d - 1] > 0)
        slot_b = max((int(sb[shifts[r] - 1]) for r in b_lanes), default=0)
        slot_c = max((int(sc[shifts[r] - 1]) for r in c_lanes), default=0)
        rounds.append(ReplRound(
            shifts=shifts, slot_b=slot_b, slot_c=slot_c,
            off_b=off_b if b_lanes else -1,
            off_c=off_c if c_lanes else -1,
            b_lanes=b_lanes, c_lanes=c_lanes))
        off_b += slot_b
        off_c += slot_c
    return ReplicatedSchedule(kind="replicated", c=rp.c, s=base.P,
                              rounds=tuple(rounds), rplan=rp)


@dataclasses.dataclass(frozen=True)
class ReplicatedScheduleLayout:
    """Host-side arrays realizing a ReplicatedSchedule (lane-major).

    Rank (r, g) = lane r, shard g, linear index r·s + g:

      b_send_idx [c, s, R_b]  — local B row per lane-send slot, -1 pad;
      c_recv_rows [c, s, R_c] — dest-local C row per receive slot;
      diag / colp / rowp      — c·s piece CSRs in lane-major order; lane
                                0 owns the diagonal (empty on lanes > 0:
                                the replica-axis reduce must not
                                double-count it), colp columns live in
                                the lane receive space (m_g × R_b), rowp
                                rows in the lane send space (R_c × k_g).
    """

    schedule: ReplicatedSchedule
    R_b: int
    R_c: int
    b_send_idx: np.ndarray
    c_recv_rows: np.ndarray
    diag: list
    colp: list
    rowp: list


def replicated_schedule_layout(rp, sched: ReplicatedSchedule
                               ) -> ReplicatedScheduleLayout:
    """Materialize send maps + lane-remapped pieces for replicated_spmm."""
    from .sparse import COOMatrix, csr_from_coo

    base = rp.base
    c, s = rp.c, base.P
    R_b, R_c = sched.R_b, sched.R_c

    # per (lane, shift) segment offsets
    boff: Dict[Tuple[int, int], int] = {}
    coff: Dict[Tuple[int, int], int] = {}
    for rnd in sched.rounds:
        for r in rnd.b_lanes:
            boff[(r, rnd.shifts[r])] = rnd.off_b
        for r in rnd.c_lanes:
            coff[(r, rnd.shifts[r])] = rnd.off_c

    b_send_idx = np.full((c, s, R_b), -1, np.int32)
    c_recv_rows = np.full((c, s, R_c), -1, np.int32)
    diag: List = []
    colp: List = []
    rowp: List = []
    for r in range(c):
        for g in range(s):
            m_g, k_g = base.a_diag[g].shape
            # send maps: lane r's shift d pairs src g with dst (g+d)%s
            for d in rp.lane_shifts[r]:
                pp = base.pair_plans.get(((g + d) % s, g))
                if pp is not None and pp.col_ids.size:
                    off = boff[(r, d)]
                    b_send_idx[r, g, off:off + pp.col_ids.size] = pp.col_ids
                pp = base.pair_plans.get((g, (g - d) % s))
                if pp is not None and pp.row_ids.size:
                    off = coff[(r, d)]
                    c_recv_rows[r, g, off:off + pp.row_ids.size] = pp.row_ids
            diag.append(base.a_diag[g] if r == 0 else _empty_csr(m_g, k_g))
            # colp: dest-side pairs (g, q) whose shift lane r owns
            rows_l, cols_l, vals_l = [], [], []
            for d in rp.lane_shifts[r]:
                pp = base.pair_plans.get((g, (g - d) % s))
                if pp is None:
                    continue
                coo = pp.a_col.to_coo()
                if not coo.nnz:
                    continue
                slot_of_col = np.full(pp.a_col.shape[1], -1, np.int64)
                slot_of_col[pp.col_ids] = np.arange(pp.col_ids.size)
                rows_l.append(coo.row.astype(np.int64))
                cols_l.append(boff[(r, d)] + slot_of_col[coo.col])
                vals_l.append(coo.val)
            if rows_l:
                colp.append(csr_from_coo(COOMatrix(
                    (m_g, R_b),
                    np.concatenate(rows_l).astype(np.int32),
                    np.concatenate(cols_l).astype(np.int32),
                    np.concatenate(vals_l))))
            else:
                colp.append(_empty_csr(m_g, R_b))
            # rowp: source-side pairs (p, g) whose shift lane r owns
            rows_l, cols_l, vals_l = [], [], []
            for d in rp.lane_shifts[r]:
                pp = base.pair_plans.get(((g + d) % s, g))
                if pp is None:
                    continue
                roo = pp.a_row.to_coo()
                if not roo.nnz:
                    continue
                slot_of_row = np.full(pp.a_row.shape[0], -1, np.int64)
                slot_of_row[pp.row_ids] = np.arange(pp.row_ids.size)
                rows_l.append(coff[(r, d)] + slot_of_row[roo.row])
                cols_l.append(roo.col.astype(np.int64))
                vals_l.append(roo.val)
            if rows_l:
                rowp.append(csr_from_coo(COOMatrix(
                    (R_c, k_g),
                    np.concatenate(rows_l).astype(np.int32),
                    np.concatenate(cols_l).astype(np.int32),
                    np.concatenate(vals_l))))
            else:
                rowp.append(_empty_csr(R_c, k_g))

    return ReplicatedScheduleLayout(
        schedule=sched, R_b=R_b, R_c=R_c,
        b_send_idx=b_send_idx, c_recv_rows=c_recv_rows,
        diag=diag, colp=colp, rowp=rowp,
    )
