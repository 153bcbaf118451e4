"""Skew-aware bucketed communication schedules (beyond-paper §5 extension).

The flat-executor part of ``repro.core.comm_schedule`` (NumPy only),
copied so that the port never imports the JAX package. The hierarchical
and replicated schedules come with the slices that port their executors
(ROADMAP items 7 and 10).

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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .planner import SpmmPlan

__all__ = [
    "CommRound",
    "CommSchedule",
    "shift_slot_demands",
    "partition_slots",
    "build_comm_schedule",
    "single_round_schedule",
    "flat_schedule_layout",
    "ordered_spans",
    "span_cuts",
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

    ``P`` is the number of ranks on the scheduled axis. The reference's
    hierarchical fields (``local_slot_*``, ``procs``) come with the hier
    slice.
    """

    kind: str
    P: int
    max_b: int
    max_c: int
    slots_b: Tuple[int, ...] = ()
    slots_c: Tuple[int, ...] = ()
    rounds: Tuple[CommRound, ...] = ()

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
        return self.P * self.rows_per_process()


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


def _segment_offsets(slots: Sequence[int]
                     ) -> Tuple[Dict[int, Tuple[int, int]], int]:
    """{shift: (offset, slot)} over the concatenated per-shift segments."""
    out: Dict[int, Tuple[int, int]] = {}
    off = 0
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
