"""Analytic communication volumes and a two-tier α-β time model.

The flat, hierarchical and replicated parts of ``repro.core.comm_model``
(NumPy only), copied so that the port never imports the JAX package:
paper Eqs. 1-3 and 9, the flat and hier schedules' α-β times,
``choose_schedule`` / ``choose_hier_schedule``, the FusedMM scoring of
both tiers (``modeled_time_fused_schedule``,
``modeled_time_hier_fused_schedule``, ``choose_fused_schedule``,
``choose_hier_fused_schedule``), and the replicated (1.5D) tier's
``modeled_time_replicated`` / ``replicated_device_bytes``.

Bandwidth defaults mirror the paper's TSUBAME4.0 numbers (450 GB/s NVLink
intra-group, 25 GB/s IB inter-group).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np

from .comm_schedule import (
    CommSchedule, build_comm_schedule, build_hier_comm_schedule,
    single_round_hier_schedule, single_round_schedule,
)
from .hierarchy import HierPlan
from .planner import SpmmPlan, build_plan
from .sparse import CSRMatrix, block_rows

__all__ = [
    "NetworkSpec",
    "TSUBAME_LIKE",
    "TPU_POD",
    "AURORA_LIKE",
    "strategy_volumes",
    "balance_stats",
    "modeled_time",
    "modeled_time_hier",
    "modeled_time_schedule",
    "modeled_time_staged",
    "modeled_time_overlap",
    "choose_schedule",
    "modeled_time_hier_schedule",
    "modeled_time_hier_staged",
    "modeled_time_hier_overlap",
    "choose_hier_schedule",
    "modeled_time_fused_schedule",
    "modeled_time_hier_fused_schedule",
    "choose_fused_schedule",
    "choose_hier_fused_schedule",
    "modeled_time_replicated",
    "replicated_device_bytes",
]


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Two-tier network: per-process bandwidths in bytes/sec + latencies."""

    name: str
    bw_intra: float  # fast tier (NVLink / ICI), B/s per process
    bw_inter: float  # slow tier (IB / DCN), B/s per process
    lat_intra: float = 2e-6
    lat_inter: float = 10e-6
    group_size: int = 4


TSUBAME_LIKE = NetworkSpec("tsubame4", 450e9, 6.25e9, group_size=4)  # 25GB/s NIC / 4 GPUs
# the reference's other named networks of the α-β model: constants of the
# model, not measurements of any device (the port runs none of them)
TPU_POD = NetworkSpec("tpu-v5e", 50e9, 6.25e9, group_size=256)
# balanced tiers (§7.7)
AURORA_LIKE = NetworkSpec("aurora", 15e9, 17e9, group_size=12)


def strategy_volumes(
    a: CSRMatrix, P: int, n_dense: int, sz_dt: int = 4,
) -> Dict[str, int]:
    """Total bytes moved under each strategy (paper Eqs. 1, 2, 3, 9)."""
    out: Dict[str, int] = {}
    bounds = block_rows(a.shape[0], P)
    cbounds = block_rows(a.shape[1], P)
    v_block = v_col = v_row = 0
    for p in range(P):
        rlo, rhi = bounds[p]
        a_p = a.row_block(rlo, rhi)
        for q in range(P):
            if q == p:
                continue
            clo, chi = cbounds[q]
            blk = a_p.col_block(clo, chi)
            v_block += (chi - clo)  # Eq. 1: full K_q rows regardless
            v_col += blk.nonzero_cols().size  # Eq. 2
            v_row += blk.nonzero_rows().size  # Eq. 3
    joint = build_plan(a, P, "joint")
    out["block"] = v_block * n_dense * sz_dt
    out["col"] = v_col * n_dense * sz_dt
    out["row"] = v_row * n_dense * sz_dt
    out["joint"] = joint.volume_rows() * n_dense * sz_dt  # Eq. 9: mu·N·sz
    out["joint_padded"] = joint.volume_rows_padded() * n_dense * sz_dt
    bucketed = build_comm_schedule(joint, K=4)
    out["joint_padded_bucketed"] = (
        joint.volume_rows_padded(bucketed) * n_dense * sz_dt)
    return out


def modeled_time(
    plan: SpmmPlan,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
    flop_rate: float = 1e12,
) -> float:
    """Flat-schedule execution time under an α-β model.

    Comm: the busiest process bounds the all_to_all (bytes in + out over its
    tier link). Compute: local nnz·2·N flops. Max(comm, compute) assumes the
    overlap the paper's pipelines (and XLA latency hiding) provide.
    """
    P = plan.P
    pm = plan.pair_matrix().astype(np.float64) * n_dense * sz_dt
    L = net.group_size
    t_comm = 0.0
    for proc in range(P):
        g = proc // L
        intra = inter = 0.0
        for other in range(P):
            if other == proc:
                continue
            v = pm[proc, other] + pm[other, proc]
            if other // L == g:
                intra += v
            else:
                inter += v
        t = intra / net.bw_intra + inter / net.bw_inter
        t += (P - 1) * (net.lat_intra if P <= L else net.lat_inter)
        t_comm = max(t_comm, t)
    nnz_local = max(
        (blk.nnz + plan.a_colpart[p].nnz + plan.a_rowpart[p].nnz)
        for p, blk in enumerate(plan.a_diag)
    )
    t_comp = nnz_local * 2.0 * n_dense / flop_rate
    return max(t_comm, t_comp) + 0.25 * min(t_comm, t_comp)


def modeled_time_hier(
    hier: HierPlan,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
    flop_rate: float = 1e12,
) -> float:
    """Two-stage hierarchical schedule time (paper Alg. 1 / Fig. 6(f)).

    Stage I: inter-group B fetch ∥ intra-group C pre-aggregation.
    Stage II: inter-group C transfer ∥ intra-group B distribution.
    Each stage costs max of its two overlapped halves (complementary links).
    """
    P, L = hier.base.P, hier.L
    unit = n_dense * sz_dt
    b_inter, c_inter = hier.inter_group_rows()
    # per-process slow-tier bytes (uniform split across P processes)
    b_inter_pp = b_inter * unit / P
    c_inter_pp = c_inter * unit / P
    # intra volumes: C pre-aggregation moves every partial once intra-group;
    # B distribution moves every de-duplicated row to its L group members.
    c_intra = sum(pp.row_ids.size for pp in hier.base.pair_plans.values())
    b_intra = int((hier.b_group_send_idx >= 0).sum()) * (L - 1)
    c_intra_pp = c_intra * unit / P
    b_intra_pp = b_intra * unit / P

    stage1 = max(b_inter_pp / net.bw_inter, c_intra_pp / net.bw_intra) + net.lat_inter
    stage2 = max(c_inter_pp / net.bw_inter, b_intra_pp / net.bw_intra) + net.lat_inter
    nnz_local = max(
        (blk.nnz + hier.base.a_colpart[p].nnz + hier.base.a_rowpart[p].nnz)
        for p, blk in enumerate(hier.base.a_diag)
    )
    t_comp = nnz_local * 2.0 * n_dense / flop_rate
    t_comm = stage1 + stage2
    return max(t_comm, t_comp) + 0.25 * min(t_comm, t_comp)

def _tier(net: NetworkSpec, P: int) -> Tuple[float, float]:
    """(bandwidth, latency) of the tier a P-process exchange runs on."""
    if P <= net.group_size:
        return net.bw_intra, net.lat_intra
    return net.bw_inter, net.lat_inter


def _round_comm_times(sched: CommSchedule, unit: float, bw: float,
                      lat: float) -> list:
    """Per-round α-β comm seconds, one entry per ``sched.rounds``.

    Each round is charged one α per PART it carries traffic on (the B
    exchange and the C exchange are separate program phases; a round's
    shift permutes within one phase are disjoint matchings and overlap),
    plus the round's padded per-process bytes. The SINGLE source of the
    per-round comm term: the staged sum and the overlap per-round max
    must charge identically or ``overlap ≤ staged`` (and the autotuner's
    mode decision) silently breaks.
    """
    out = []
    for rnd in sched.rounds:
        rows = sum(sched.slots_b[d - 1] + sched.slots_c[d - 1]
                   for d in rnd.shifts)
        phases = (any(sched.slots_b[d - 1] > 0 for d in rnd.shifts)
                  + any(sched.slots_c[d - 1] > 0 for d in rnd.shifts))
        out.append(phases * lat + rows * unit / bw)
    return out


def _schedule_alpha_beta_time(sched: CommSchedule, unit: float, bw: float,
                              lat: float) -> float:
    """α-β time of one schedule realization on a fixed (bw, lat) tier.

    ``single``: two max-padded all_to_alls — the per-process operand rows
    behind 2 α terms (one per part). ``bucketed``: the serialized sum of
    the per-round terms (``_round_comm_times``).
    """
    if sched.kind == "single":
        return 2 * lat + sched.rows_per_process() * unit / bw
    return sum(_round_comm_times(sched, unit, bw, lat))


# ---------------------------------------------------------------------------
# per-round segment compute (the work an overlapped round hides wire behind)
# ---------------------------------------------------------------------------


def _shift_compute_nnz(plan: SpmmPlan) -> np.ndarray:
    """[P, P-1] nonzeros each process computes for shift d = 1..P-1.

    Shift ``d``'s segment compute at process ``p`` is the column-covered
    nonzeros it multiplies against the received B segment (pair
    ``(p, (p-d)%P)``'s a_col) plus the row-covered nonzeros it computes
    into the partial-C send segment (pair ``((p+d)%P, p)``'s a_row).
    """
    P = plan.P
    nnz = np.zeros((P, P - 1), np.int64)
    for (p, q), pp in plan.pair_plans.items():
        d = (p - q) % P
        nnz[p, d - 1] += pp.a_col.nnz
        nnz[q, d - 1] += pp.a_row.nnz
    return nnz


def _round_flops(nnz: np.ndarray, sched: CommSchedule,
                 n_dense: int) -> List[float]:
    """Per-round segment flops (critical path: max over processes)."""
    if sched.kind == "single":
        return [float(nnz.sum(axis=1).max()) * 2.0 * n_dense]
    out = []
    for rnd in sched.rounds:
        per_proc = nnz[:, [d - 1 for d in rnd.shifts]].sum(axis=1)
        out.append(float(per_proc.max()) * 2.0 * n_dense)
    return out


def _group_shift_compute_nnz(hier: HierPlan) -> np.ndarray:
    """[P, G] nonzeros each process computes per group shift (0 = own)."""
    base, G, L = hier.base, hier.G, hier.L
    P = base.P
    nnz = np.zeros((P, G), np.int64)
    for (p, q), pp in base.pair_plans.items():
        dg = (p // L - q // L) % G
        nnz[p, dg] += pp.a_col.nnz
        nnz[q, dg] += pp.a_row.nnz
    return nnz


def _hier_round_flops(nnz: np.ndarray, sched: CommSchedule,
                      n_dense: int) -> Tuple[float, List[float]]:
    """(own-group flops, per-round flops) for a hier inter-group schedule."""
    local = float(nnz[:, 0].max()) * 2.0 * n_dense
    if sched.kind == "single":
        return local, [float(nnz[:, 1:].sum(axis=1).max()) * 2.0 * n_dense]
    rounds = []
    for rnd in sched.rounds:
        per_proc = nnz[:, list(rnd.shifts)].sum(axis=1)
        rounds.append(float(per_proc.max()) * 2.0 * n_dense)
    return local, rounds


def modeled_time_schedule(
    plan: SpmmPlan,
    sched: CommSchedule,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
) -> float:
    """α-β communication time of one flat schedule realization.

    More rounds → finer slot classes → fewer padded bytes but more α
    terms; this is the trade ``choose_schedule`` optimizes over K, with
    latency accounted consistently across both schedule kinds (see
    ``_schedule_alpha_beta_time``). The tier follows the exchange span
    (``_tier``): intra for P within one group, inter beyond.
    """
    bw, lat = _tier(net, plan.P)
    return _schedule_alpha_beta_time(sched, n_dense * sz_dt, bw, lat)


def modeled_time_staged(
    plan: SpmmPlan,
    sched: CommSchedule,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
    flop_rate: float = 1e12,
) -> float:
    """Serialized rounds: every round's wire, THEN every segment compute.

    The comm+comp SUM the staged executor realizes (diagonal-block
    compute is common to both execution modes and excluded from both, so
    staged-vs-overlap comparisons are offset-free).
    """
    comp = sum(_round_flops(_shift_compute_nnz(plan), sched, n_dense))
    return (modeled_time_schedule(plan, sched, n_dense, net, sz_dt)
            + comp / flop_rate)


def modeled_time_overlap(
    plan: SpmmPlan,
    sched: CommSchedule,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
    flop_rate: float = 1e12,
) -> float:
    """Round-pipelined time: ``Σ_k max(α_k + bytes_k/β, γ·flops_k)``.

    Each bucketed round's wire hides behind (or is hidden by) its own
    segment compute instead of serializing — the dataflow the
    ``overlap=True`` executors expose to XLA's async collective
    scheduler. Never worse than ``modeled_time_staged`` of the same
    schedule (``max ≤ sum`` per round); the single round degenerates to
    ``max(comm, comp)`` — the whole-program overlap ``modeled_time``
    already assumed.
    """
    unit = n_dense * sz_dt
    bw, lat = _tier(net, plan.P)
    flops = _round_flops(_shift_compute_nnz(plan), sched, n_dense)
    if sched.kind == "single":
        comm = 2 * lat + sched.rows_per_process() * unit / bw
        return max(comm, flops[0] / flop_rate)
    return sum(max(comm, f / flop_rate)
               for comm, f in zip(_round_comm_times(sched, unit, bw, lat),
                                  flops))


def choose_schedule(
    plan: SpmmPlan,
    n_dense: int,
    net: NetworkSpec,
    k_max: int = 4,
    sz_dt: int = 4,
    overlap: Union[bool, str] = False,
    flop_rate: float = 1e12,
):
    """Pick the fastest schedule realization under the α-β model.

    Candidates: the single max-padded all_to_all round and bucketed
    schedules for K = 1..k_max slot classes. On balanced patterns the
    single round usually wins (fewer α terms, no padding to shave); on
    skewed patterns a small K already removes most padded bytes —
    mirroring the paper's flat-vs-hier discussion (§7.7) one level down.

    ``overlap`` grows the sweep's execution-mode axis:

    * ``False`` (default) — communication-only scoring, returns
      ``(schedule, modeled_seconds)`` exactly as before.
    * ``"auto"`` — every candidate is scored at BOTH execution modes
      (``modeled_time_staged`` vs ``modeled_time_overlap``; the single
      round has no rounds to pipeline and is staged-only). Returns
      ``(schedule, modeled_seconds, use_overlap)``.
    * ``True`` — bucketed candidates are scored overlapped only (the
      caller forces overlap); same 3-tuple return.

    Overlap changes which K wins: pipelining hides padded bytes behind
    segment compute, so compute-rich problems tolerate finer (larger-K)
    bucketing than a comm-only model would pick.
    """
    single = single_round_schedule(plan)
    if overlap is False:
        best: Tuple[CommSchedule, float] = (
            single, modeled_time_schedule(plan, single, n_dense, net, sz_dt))
        seen = set()
        for K in range(1, max(1, k_max) + 1):
            sched = build_comm_schedule(plan, K=K)
            key = (sched.slots_b, sched.slots_c)
            if key in seen:
                continue
            seen.add(key)
            t = modeled_time_schedule(plan, sched, n_dense, net, sz_dt)
            if t < best[1]:
                best = (sched, t)
        return best

    best3 = (single, modeled_time_staged(plan, single, n_dense, net, sz_dt,
                                         flop_rate), False)
    seen = set()
    for K in range(1, max(1, k_max) + 1):
        sched = build_comm_schedule(plan, K=K)
        key = (sched.slots_b, sched.slots_c)
        if key in seen:
            continue
        seen.add(key)
        t_ovl = modeled_time_overlap(plan, sched, n_dense, net, sz_dt,
                                     flop_rate)
        cands = [(t_ovl, True)]
        if overlap is not True:  # "auto" also admits staged execution
            cands.append((modeled_time_staged(plan, sched, n_dense, net,
                                              sz_dt, flop_rate), False))
        for t, use in cands:
            if t < best3[1]:
                best3 = (sched, t, use)
    return best3


def modeled_time_hier_schedule(
    sched: CommSchedule,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
) -> float:
    """α-β time of a hierarchical INTER-GROUP schedule realization.

    The inter-group collectives always run on the slow tier, so the tier
    choice is fixed (unlike ``modeled_time_schedule``). The single round's
    per-process operand rows include the own-group slots the dense
    collective cannot drop; bucketed rounds serve own-group traffic with
    a wire-free local slice (``rows_per_process`` already excludes it).
    """
    return _schedule_alpha_beta_time(sched, n_dense * sz_dt,
                                     net.bw_inter, net.lat_inter)


def modeled_time_hier_staged(
    hier: HierPlan,
    sched: CommSchedule,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
    flop_rate: float = 1e12,
) -> float:
    """Serialized inter-group rounds + every off-diagonal segment compute."""
    local, rounds = _hier_round_flops(_group_shift_compute_nnz(hier),
                                      sched, n_dense)
    return (modeled_time_hier_schedule(sched, n_dense, net, sz_dt)
            + (local + sum(rounds)) / flop_rate)


def modeled_time_hier_overlap(
    hier: HierPlan,
    sched: CommSchedule,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
    flop_rate: float = 1e12,
) -> float:
    """Round-pipelined hier time: own-group compute + Σ_k max(comm, comp).

    The shift-0 (own group) segment never touches the inter-group wire;
    its compute overlaps the first in-flight round in the executor but is
    charged additively here so overlapped and staged share accounting
    (the same term appears in ``modeled_time_hier_staged``, keeping
    ``overlap ≤ staged`` exact).
    """
    unit = n_dense * sz_dt
    bw, lat = net.bw_inter, net.lat_inter
    local, flops = _hier_round_flops(_group_shift_compute_nnz(hier),
                                     sched, n_dense)
    if sched.kind == "single":
        comm = 2 * lat + sched.rows_per_process() * unit / bw
        return local / flop_rate + max(comm, flops[0] / flop_rate)
    return local / flop_rate + sum(
        max(comm, f / flop_rate)
        for comm, f in zip(_round_comm_times(sched, unit, bw, lat), flops))


def _hier_candidates(hier: HierPlan, k_max: int):
    """The hier schedule sweep's bucketed candidates, K = 1..k_max, each
    distinct slot layout once (in K order)."""
    seen = set()
    for K in range(1, max(1, k_max) + 1):
        sched = build_hier_comm_schedule(hier, K=K)
        key = (sched.slots_b, sched.slots_c,
               sched.local_slot_b, sched.local_slot_c)
        if key not in seen:
            seen.add(key)
            yield sched


def choose_hier_schedule(
    hier: HierPlan,
    n_dense: int,
    net: NetworkSpec,
    k_max: int = 4,
    sz_dt: int = 4,
    overlap: Union[bool, str] = False,
    flop_rate: float = 1e12,
):
    """Pick the fastest hierarchical inter-group schedule realization.

    Mirrors ``choose_schedule`` one tier up: candidates are the single
    max-padded all_to_all pair and bucketed group-shift schedules for
    K = 1..k_max. ``overlap`` grows the same execution-mode axis as
    ``choose_schedule`` — ``False`` keeps the comm-only 2-tuple return,
    ``"auto"``/``True`` score staged-vs-overlapped totals and return
    ``(schedule, modeled_seconds, use_overlap)``.
    """
    single = single_round_hier_schedule(hier)
    if overlap is False:
        best: Tuple[CommSchedule, float] = (
            single, modeled_time_hier_schedule(single, n_dense, net, sz_dt))
        for sched in _hier_candidates(hier, k_max):
            t = modeled_time_hier_schedule(sched, n_dense, net, sz_dt)
            if t < best[1]:
                best = (sched, t)
        return best

    best3 = (single, modeled_time_hier_staged(hier, single, n_dense, net,
                                              sz_dt, flop_rate), False)
    for sched in _hier_candidates(hier, k_max):
        t_ovl = modeled_time_hier_overlap(hier, sched, n_dense, net, sz_dt,
                                          flop_rate)
        cands = [(t_ovl, True)]
        if overlap is not True:
            cands.append((modeled_time_hier_staged(hier, sched, n_dense, net,
                                                   sz_dt, flop_rate), False))
        for t, use in cands:
            if t < best3[1]:
                best3 = (sched, t, use)
    return best3


# ---------------------------------------------------------------------------
# FusedMM (SDDMM → SpMM in one communication phase) scoring
# ---------------------------------------------------------------------------
#
# The fused executor's bytes per schedule are fixed by the SAME row
# counts as SpMM: the joint [Y | B] gather moves every B-phase row at
# width F+N, and the C-phase rows are crossed twice — X dest→source at
# width F, aggregated partials source→dest at width N — F+N per row
# again. So fused and the unfused SDDMM→SpMM composition move IDENTICAL
# bytes; what fusion buys is α: per bucketed round the unfused pair pays
# (b>0)+(c>0) latencies TWICE (once per phase-separated kernel launch),
# the fused round pays (b>0) + 2·(c>0) — one B-phase α saved per round
# with B traffic, and one α total in the single-round case (3 a2a vs
# 2+2). SDDMM alone needs no new scorer: its rows match SpMM's with both
# parts at width F, i.e. ``modeled_time_schedule(plan, sched, F, net)``.


def _fused_alpha_beta_time(sched: CommSchedule, unit: float, bw: float,
                           lat: float) -> float:
    """α-β time of one FUSED schedule realization on a fixed tier.

    ``unit`` is the per-row byte width (F+N)·sz — joint gather rows and
    the X+C row pair both carry it (see the module comment above).
    """
    if sched.kind == "single":
        return 3 * lat + sched.rows_per_process() * unit / bw
    out = 0.0
    for rnd in sched.rounds:
        rows_b = sum(sched.slots_b[d - 1] for d in rnd.shifts)
        rows_c = sum(sched.slots_c[d - 1] for d in rnd.shifts)
        phases = (1 if rows_b else 0) + (2 if rows_c else 0)
        out += phases * lat + (rows_b + rows_c) * unit / bw
    return out


def modeled_time_fused_schedule(
    plan: SpmmPlan,
    sched: CommSchedule,
    n_feat: int,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
) -> float:
    """α-β time of one flat FusedMM schedule realization.

    ``n_feat`` is the sampled feature width F (X/Y columns), ``n_dense``
    the SpMM operand width N; every scheduled row crosses the wire once
    at width F+N.
    """
    bw, lat = _tier(net, plan.P)
    return _fused_alpha_beta_time(sched, (n_feat + n_dense) * sz_dt, bw, lat)


def choose_fused_schedule(
    plan: SpmmPlan,
    n_feat: int,
    n_dense: int,
    net: NetworkSpec,
    k_max: int = 4,
    sz_dt: int = 4,
) -> Tuple[CommSchedule, float]:
    """Pick the fastest schedule for the fused kernel (comm-only — the
    fused executors are staged by construction, no overlap axis)."""
    single = single_round_schedule(plan)
    best = (single,
            modeled_time_fused_schedule(plan, single, n_feat, n_dense, net,
                                        sz_dt))
    seen = set()
    for K in range(1, max(1, k_max) + 1):
        sched = build_comm_schedule(plan, K=K)
        key = (sched.slots_b, sched.slots_c)
        if key in seen:
            continue
        seen.add(key)
        t = modeled_time_fused_schedule(plan, sched, n_feat, n_dense, net,
                                        sz_dt)
        if t < best[1]:
            best = (sched, t)
    return best


def modeled_time_hier_fused_schedule(
    sched: CommSchedule,
    n_feat: int,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
) -> float:
    """α-β time of a hier INTER-GROUP FusedMM schedule realization (the
    inter-group collectives are tier-fixed, as in
    ``modeled_time_hier_schedule``)."""
    return _fused_alpha_beta_time(sched, (n_feat + n_dense) * sz_dt,
                                  net.bw_inter, net.lat_inter)


def choose_hier_fused_schedule(
    hier: HierPlan,
    n_feat: int,
    n_dense: int,
    net: NetworkSpec,
    k_max: int = 4,
    sz_dt: int = 4,
) -> Tuple[CommSchedule, float]:
    """``choose_fused_schedule`` one tier up (inter-group candidates)."""
    single = single_round_hier_schedule(hier)
    best = (single,
            modeled_time_hier_fused_schedule(single, n_feat, n_dense, net,
                                             sz_dt))
    for sched in _hier_candidates(hier, k_max):
        t = modeled_time_hier_fused_schedule(sched, n_feat, n_dense, net,
                                             sz_dt)
        if t < best[1]:
            best = (sched, t)
    return best


# ---------------------------------------------------------------------------
# replicated (1.5D) scoring: lane exchanges + replica-axis reduce-scatter
# ---------------------------------------------------------------------------


def modeled_time_replicated(
    rp,
    sched,
    n_dense: int,
    net: NetworkSpec,
    sz_dt: int = 4,
    flop_rate: float = 1e12,
) -> float:
    """Staged time of a ``ReplicatedSchedule`` (``c`` lanes over ``s``).

    Lane exchanges span only the ``s`` contiguous ranks of a lane, so
    they are priced at ``_tier(net, s)`` — the fast tier once
    ``s <= group_size``, which is where replication beats the flat plan
    whose ``_tier(net, c·s)`` exchange pays inter-group prices. The
    replica-axis reduce-scatter moves ``(c-1)/c`` of the dense local C
    block across lane boundaries (stride-s rank pairs: the slow tier
    whenever P exceeds one group). Compute is the busiest rank's lane
    nonzeros — INCLUDING the diagonal block, which replication
    concentrates on lane 0 (flat comparisons must add their diagonal
    term; see ``api._plan_and_tune``).
    """
    base = rp.base
    c, s = rp.c, rp.s
    unit = n_dense * sz_dt
    bw_x, lat_x = _tier(net, s)
    t_comm = 0.0
    for rnd in sched.rounds:
        phases = (1 if rnd.b_lanes else 0) + (1 if rnd.c_lanes else 0)
        rows = ((rnd.slot_b if rnd.b_lanes else 0)
                + (rnd.slot_c if rnd.c_lanes else 0))
        t_comm += phases * lat_x + rows * unit / bw_x
    # reduce-scatter over the replica axis (stride-s pairs span groups
    # whenever P > group_size — price it at the full-P tier)
    m_local = -(-base.shape[0] // s)
    bw_r, lat_r = _tier(net, c * s)
    t_rs = lat_r + (c - 1) / c * m_local * unit / bw_r if c > 1 else 0.0
    # busiest rank: lane-assigned off-diagonal nnz + lane 0's diagonal
    nnz_shift = _shift_compute_nnz(base)  # [s, s-1]
    lane_nnz = np.zeros((c, s), np.int64)
    for r, shifts in enumerate(rp.lane_shifts):
        for d in shifts:
            lane_nnz[r] += nnz_shift[:, d - 1]
    lane_nnz[0] += np.array([blk.nnz for blk in base.a_diag], np.int64)
    t_comp = float(lane_nnz.max()) * 2.0 * n_dense / flop_rate
    return t_comm + t_rs + t_comp


def replicated_device_bytes(rp, sched, n_dense: int, sz_dt: int = 4) -> int:
    """Coarse per-rank allocation estimate for a replicated candidate.

    The reference's estimate, with the replica memory made explicit:
    every rank holds a FULL s-way B shard (the c-fold replication —
    c·P/s bytes in all where flat holds P/P), the C accumulator +
    scattered output, the lane send/recv slabs (R_b + R_c rows each
    way), and the plan's covered row slots.
    """
    n = int(n_dense)
    s = rp.s
    m, k = rp.base.shape

    def per(rows: int) -> int:
        return -(-int(rows) // s)

    rows = (per(k)                        # replicated B shard (s-way)
            + 2 * per(m)                  # C accumulator + scattered output
            + 2 * (sched.R_b + sched.R_c) # lane send + recv slabs
            + per(rp.base.volume_rows())) # gathered partials
    return rows * n * sz_dt + per(rp.base.volume_rows()) * 12


def balance_stats(plan: SpmmPlan) -> Dict[str, float]:
    """Fig. 9-style balance metrics on the pair-volume matrix."""
    pm = plan.pair_matrix().astype(np.float64)
    off = pm[~np.eye(plan.P, dtype=bool)]
    if off.size == 0 or off.max() == 0:
        return {"max": 0.0, "mean": 0.0, "imbalance": 1.0, "symmetry": 1.0}
    sym = 1.0 - np.abs(pm - pm.T).sum() / max(pm.sum() * 2.0, 1.0)
    return {
        "max": float(off.max()),
        "mean": float(off.mean()),
        "imbalance": float(off.max() / max(off.mean(), 1e-12)),
        "symmetry": float(sym),
    }
