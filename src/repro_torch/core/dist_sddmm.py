"""Distributed SDDMM + FusedMM over the SHIRO SpMM plans (both tiers).

Port of ``repro/core/dist_sddmm.py``. SDDMM —
``vals(i,j) = a(i,j) · (x_i · y_j)`` per stored nonzero — is
communication-equivalent to SpMM over the same sparsity pattern: the
nonzeros that force rank p to FETCH row j of B for SpMM are exactly the
ones that make it need row j of Y, and the nonzeros whose partial C rows
p SHIPS to q are the ones whose sampled values live at q's X rows. So the
executors here reuse the SAME exec plans (``FlatExecPlan`` /
``HierExecPlan``), schedules and piece layouts as ``dist_spmm`` with the
dataflow reversed:

* column-covered nonzeros (colp): Y rows travel dest-ward over the
  UNCHANGED B-gather rounds (same ``b_send_idx``, same shifts).
* row-covered nonzeros (rowp): the SpMM phase consumes their values at
  the SOURCE, so X rows travel dest → source over the C-transfer segment
  layout with every shift REVERSED (d → P−d); the received segments line
  up with the rowp row space at the same offsets.
* diagonal nonzeros sample local X against local Y — no wire.

The P ranks run in one process over stacked ``[P, ...]`` tensors, and
every collective goes through a ``LocalComm``, which logs it — or, on a
fleet of processes, each process runs its span of the ranks on the
plan's ``span`` and its ``ProcessComm`` (``x`` / ``y`` / ``b`` then hold
the span's rows, as the results do).

``flat_sddmm`` / ``hier_sddmm`` return the sampled values in the
backend's native piece layout ({"diag", "colp", "rowp"});
``flat_spmm_values`` / ``hier_spmm_values`` run the SpMM of those values
(the unfused second phase). ``flat_fused`` / ``hier_fused`` (FusedMM) chain
both phases through ONE set of collectives: the B gather carries
``[Y | B]`` so the SDDMM operand rides the same rounds as the SpMM
operand, the sampled values drop into the SpMM pieces via
``with_values`` without leaving the device, and the C transfer runs
unchanged. The fused collective log therefore has the plain SpMM's shift
set whenever the demanded C shifts are closed under reversal, plus one
reversed X round per C segment. On the hier tier the X rows travel the
same way over the group axis (reversed group shifts), and an
intra-group all_gather hands every local rank its rows. The fused and
SDDMM executors always run staged.

Edge nonlinearities (the ``edge=`` axis, e.g. graph attention's
leaky_relu) apply to the sampled values between the phases. They MUST be
zero-preserving (``f(0) = 0``): padding slots carry stored value 0,
sample to 0, and stay silent only if the nonlinearity keeps them there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..distributed.comm import LocalComm
from ..kernels.ops import pack_rows_op, scatter_add_rows_exec_op
from .dist_spmm import (
    BackendSpec, FlatExecPlan, HierExecPlan, Segments, _exchange_segments,
    _hier_gathered, _rank_blocks, _slice_fetch, flat_spmm, hier_spmm,
)
from .local_backend import LocalSpmmBackend, backend_sddmm, backend_with_values

__all__ = [
    "EDGE_FNS",
    "resolve_edge",
    "SddmmValues",
    "flat_sddmm",
    "hier_sddmm",
    "with_values_exec",
    "flat_spmm_values",
    "hier_spmm_values",
    "flat_fused",
    "hier_fused",
    "fused_sddmm_spmm",
]

# sampled values per piece, backend-native layout, leading [P, ...] axis
# (the rank axis of either tier)
SddmmValues = Dict[str, torch.Tensor]

EdgeSpec = Union[None, str, Callable[[torch.Tensor], torch.Tensor]]

# Named edge nonlinearities for the sampled values. Every entry MUST be
# zero-preserving (f(0) == 0) so padding slots stay silent — that is the
# whole registry contract, not a stylistic preference.
EDGE_FNS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.2),
    "relu": torch.relu,
}


def resolve_edge(edge: EdgeSpec) -> Optional[Callable]:
    """None → None (identity); name → registry lookup; callable → itself."""
    if edge is None or callable(edge):
        return edge
    try:
        return EDGE_FNS[edge]
    except KeyError:
        raise ValueError(
            f"unknown edge nonlinearity {edge!r}; named options: "
            f"{tuple(EDGE_FNS)} (or pass any zero-preserving callable)"
        ) from None


def _apply_edge(vals: SddmmValues, fn: Optional[Callable]) -> SddmmValues:
    return {k: fn(v) for k, v in vals.items()} if fn is not None else vals


def _reverse_segments(segments: Segments, P_: int) -> Segments:
    """The C-transfer segments with every shift inverted — offsets and
    slots unchanged, so send and receive keep one layout."""
    return tuple(((P_ - d) % P_, off, slot) for d, off, slot in segments)


# ---------------------------------------------------------------------------
# exchanges on the stacked [P, ...] layout
# ---------------------------------------------------------------------------


def _flat_gather_single(rows_loc: torch.Tensor, plan: FlatExecPlan,
                        comm: LocalComm) -> torch.Tensor:
    """Dense rows [P, K/P, W] → the [P, P·max_b, W] column-gather space
    (one all_to_all)."""
    P_, _, w = rows_loc.shape
    send = pack_rows_op(rows_loc, plan.b_send_idx)  # [P, P, max_b, W]
    return comm.all_to_all(send).reshape(P_, plan.P * plan.max_b, w)


def _flat_gather_bucketed(rows_loc: torch.Tensor, plan: FlatExecPlan,
                          comm: LocalComm) -> torch.Tensor:
    """Dense rows → the bucketed [P, R_b, W] receive space (one ppermute
    per scheduled B shift)."""
    send = pack_rows_op(rows_loc, plan.b_send_idx)  # [P, R_b, W]
    return _exchange_segments(plan.meta["b_segments"], comm.shift,
                              plan.meta["R_b"], _slice_fetch(send), send)


def _flat_x_single(x_loc: torch.Tensor, plan: FlatExecPlan,
                   comm: LocalComm) -> torch.Tensor:
    """X rows dest → source over the single-round C layout.

    Each dest packs its X rows by ``c_recv_rows`` [P(src), max_c]; the
    all_to_all is self-inverse in this layout, so source q receives
    exactly its rowp row space [P(dst)·max_c, F] — slot j of tile p holds
    the X row the partial C row q computes for p at slot j lands on.
    """
    P_, _, f = x_loc.shape
    xs = pack_rows_op(x_loc, plan.c_recv_rows)  # [P, P, max_c, F]
    return comm.all_to_all(xs).reshape(P_, plan.P * plan.max_c, f)


def _flat_x_bucketed(x_loc: torch.Tensor, plan: FlatExecPlan,
                     comm: LocalComm) -> torch.Tensor:
    """X rows dest → source over the bucketed C layout, shifts reversed.

    The per-shift slot maps are schedule-global, so the segment arriving
    under reversed shift P−d sits at the SAME (offset, slot) its rowp
    rows occupy in the send space — no relayout on arrival.
    """
    xs = pack_rows_op(x_loc, plan.c_recv_rows)  # [P, R_c, F]
    return _exchange_segments(
        _reverse_segments(plan.meta["c_segments"], plan.P), comm.shift,
        plan.meta["R_c"], _slice_fetch(xs), xs)


def _hier_gather_single(rows_loc: torch.Tensor, plan: HierExecPlan,
                        comm: LocalComm) -> torch.Tensor:
    """Dense rows → the hier [P, L·G·max_bg, W] gathered space
    (inter-group all_to_all, then intra-group all_gather) — Stage I/II
    of ``hier_spmm``."""
    P_, _, w = rows_loc.shape
    send = pack_rows_op(rows_loc, plan.b_group_send_idx)  # [P, G, max_bg, W]
    allg = comm.local_all_gather(comm.group_all_to_all(send))
    return allg.reshape(P_, -1, w)


def _hier_gather_bucketed(rows_loc: torch.Tensor, plan: HierExecPlan,
                          comm: LocalComm) -> torch.Tensor:
    """Dense rows → the SEGMENT-major hier gathered space [P, L·R_bg, W]."""
    send = pack_rows_op(rows_loc, plan.b_group_send_idx)  # [P, R_bg, W]
    recv = _exchange_segments(plan.meta["bg_segments"], comm.group_shift,
                              plan.meta["R_bg"], _slice_fetch(send), send,
                              local=plan.meta["local_b"])
    return _hier_gathered(comm.local_all_gather(recv), plan.meta["bg_all"],
                          plan.meta["R_bg"])


def _hier_x_single(x_loc: torch.Tensor, plan: HierExecPlan,
                   comm: LocalComm) -> torch.Tensor:
    """X rows dest → source over the single-round hier C layout.

    Dest (gd, l) packs by ``c_recv_rows`` [G(src), max_cg]; the group
    all_to_all hands source (gs, l) the X rows of every dest group at ITS
    local rank, and the intra-group all_gather fills in the other local
    ranks. Transposing to (dst-group, local, slot) order reproduces the
    rowp row space (gd·L + ld)·max_cg + slot exactly.
    """
    P_, _, f = x_loc.shape
    xs = pack_rows_op(x_loc, plan.c_recv_rows)  # [P, G, max_cg, F]
    recv = comm.group_all_to_all(xs)  # [P, G(dst), max_cg, F]
    allx = comm.local_all_gather(recv)  # [P, L, G, max_cg, F]
    return allx.transpose(1, 2).reshape(P_, -1, f)


def _hier_x_bucketed(x_loc: torch.Tensor, plan: HierExecPlan,
                     comm: LocalComm) -> torch.Tensor:
    """X rows dest → source over the bucketed hier C layout.

    Reversed group shifts land each dest group's X pack at its source
    group (shift 0 is the wire-free own-group slice); the intra-group
    all_gather recovers every destination local rank. The rowp row space
    is SHIFT-major, (dg·L + ld)·max_cg + slot, with every shift padded to
    max_cg — so each received segment is re-padded slot → max_cg and laid
    out in ascending-shift order, zeros for unscheduled shifts (their
    rowp rows store no nonzeros, so zero X rows sample nothing).
    """
    P_, _, f = x_loc.shape
    G, L, max_cg = plan.G, plan.L, plan.max_cg
    local_c = plan.meta["local_c"]
    cg_segments = plan.meta["cg_segments"]
    xs = pack_rows_op(x_loc, plan.c_recv_rows)  # [P, R_cg, F]
    recv = _exchange_segments(_reverse_segments(cg_segments, G),
                              comm.group_shift, plan.meta["R_cg"],
                              _slice_fetch(xs), xs, local=local_c)
    allx = comm.local_all_gather(recv)  # [P, L, R_cg, F]
    off_map = dict({0: local_c} if local_c is not None else {})
    off_map.update({d: (off, slot) for d, off, slot in cg_segments})
    out = allx.new_zeros((P_, G, L, max_cg, f))
    for dg, (off, slot) in off_map.items():
        out[:, dg, :, :slot] = allx[:, :, off:off + slot]
    return out.reshape(P_, G * L * max_cg, f)


def _exchanges(plan, comm: LocalComm, rows_loc: torch.Tensor,
               x_loc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column gather of ``rows_loc`` and the reversed X rounds, on
    the plan's tier."""
    single = plan.schedule.kind == "single"
    if isinstance(plan, HierExecPlan):
        if single:
            return (_hier_gather_single(rows_loc, plan, comm),
                    _hier_x_single(x_loc, plan, comm))
        return (_hier_gather_bucketed(rows_loc, plan, comm),
                _hier_x_bucketed(x_loc, plan, comm))
    if single:
        return (_flat_gather_single(rows_loc, plan, comm),
                _flat_x_single(x_loc, plan, comm))
    return (_flat_gather_bucketed(rows_loc, plan, comm),
            _flat_x_bucketed(x_loc, plan, comm))


def _sample(be: LocalSpmmBackend, pieces, x_loc, y_loc, x_rows, y_gathered,
            fn_edge) -> SddmmValues:
    """The three per-piece SDDMM computes every executor shares."""
    vals = {
        "diag": backend_sddmm(be, pieces["diag"], x_loc, y_loc),
        "colp": backend_sddmm(be, pieces["colp"], x_loc, y_gathered),
        "rowp": backend_sddmm(be, pieces["rowp"], x_rows, y_loc),
    }
    return _apply_edge(vals, fn_edge)


def _groups(plan) -> int:
    return plan.G if isinstance(plan, HierExecPlan) else 1


def _setup(plan, comm: Optional[LocalComm], x: torch.Tensor,
           y: torch.Tensor) -> Tuple[LocalComm, torch.Tensor, torch.Tensor]:
    """The comm (on the plan's grid) and the stacked local blocks of
    X [M, F] and Y [K, F]."""
    comm, x_loc = _rank_blocks(plan, comm, x, _groups(plan), "X")
    _, y_loc = _rank_blocks(plan, comm, y, _groups(plan), "Y")
    return comm, x_loc, y_loc


# ---------------------------------------------------------------------------
# SDDMM executors
# ---------------------------------------------------------------------------


def _sddmm(plan, x: torch.Tensor, y: torch.Tensor, comm: Optional[LocalComm],
           backend: Optional[BackendSpec], edge: EdgeSpec) -> SddmmValues:
    be, pieces = plan.resolve_backend(backend)
    fn_edge = resolve_edge(edge)
    comm, x_loc, y_loc = _setup(plan, comm, x, y)
    y_g, x_r = _exchanges(plan, comm, y_loc, x_loc)
    return _sample(be, pieces, x_loc, y_loc, x_r, y_g, fn_edge)


def flat_sddmm(plan: FlatExecPlan, x: torch.Tensor, y: torch.Tensor,
               comm: Optional[LocalComm] = None,
               backend: Optional[BackendSpec] = None,
               edge: EdgeSpec = None) -> SddmmValues:
    """Sampled values ``a ⊙ (X · Yᵀ)`` with the flat SHIRO schedule.

    ``x``: [M, F] row-partitioned like C; ``y``: [K, F] row-partitioned
    like B. Returns the values in the backend's native piece layout,
    leading axis P — feed ``flat_spmm_values`` for the unfused
    composition.
    """
    return _sddmm(plan, x, y, comm, backend, edge)


def hier_sddmm(plan: HierExecPlan, x: torch.Tensor, y: torch.Tensor,
               comm: Optional[LocalComm] = None,
               backend: Optional[BackendSpec] = None,
               edge: EdgeSpec = None) -> SddmmValues:
    """Sampled values with the two-tier schedule (``comm`` on the plan's
    (G, L) grid); the same layout as ``flat_sddmm``'s, leading axis P —
    feed ``hier_spmm_values`` for the unfused composition."""
    return _sddmm(plan, x, y, comm, backend, edge)


# ---------------------------------------------------------------------------
# SpMM over swapped values (the unfused second phase)
# ---------------------------------------------------------------------------


def with_values_exec(plan, values: SddmmValues,
                     backend: Optional[BackendSpec] = None):
    """An exec plan (flat or hier) whose stored values are replaced by
    ``values``.

    Only the selected backend's diag/colp/rowp values change. The
    per-round overlap consumables (``colp@i`` / ``rowp@i``) keep the
    ORIGINAL values; run the result with ``overlap=False`` (the wrapper
    below always does).
    """
    be, _ = plan.resolve_backend(backend)
    swapped = dict(plan.pieces[be.name])
    for name in ("diag", "colp", "rowp"):
        swapped[name] = backend_with_values(be, swapped[name], values[name])
    pieces = dict(plan.pieces)
    pieces[be.name] = swapped
    return dataclasses.replace(plan, pieces=pieces)


def flat_spmm_values(plan: FlatExecPlan, values: SddmmValues,
                     b: torch.Tensor, comm: Optional[LocalComm] = None,
                     backend: Optional[BackendSpec] = None) -> torch.Tensor:
    """``C = (A with values) @ B`` — the unfused SDDMM→SpMM second phase."""
    return flat_spmm(with_values_exec(plan, values, backend), b, comm,
                     backend=backend, overlap=False)


def hier_spmm_values(plan: HierExecPlan, values: SddmmValues,
                     b: torch.Tensor, comm: Optional[LocalComm] = None,
                     backend: Optional[BackendSpec] = None) -> torch.Tensor:
    """``hier_spmm`` over swapped values (staged)."""
    return hier_spmm(with_values_exec(plan, values, backend), b, comm,
                     backend=backend, overlap=False)


# ---------------------------------------------------------------------------
# FusedMM: SDDMM → SpMM through one communication phase
# ---------------------------------------------------------------------------


def _concat_dense(y_loc: torch.Tensor, b_loc: torch.Tensor):
    dt = torch.promote_types(y_loc.dtype, b_loc.dtype)
    yb = torch.cat([y_loc.to(dt), b_loc.to(dt)], dim=2)
    return yb, y_loc.shape[2], dt


def _fused(plan, x: torch.Tensor, y: torch.Tensor, b: torch.Tensor,
           comm: Optional[LocalComm], backend: Optional[BackendSpec],
           edge: EdgeSpec) -> torch.Tensor:
    """FusedMM on either tier: ① ONE gather round set for both phases
    ([Y | B] jointly) and ② X rows over the reversed C layout, ③ sample
    and swap the values into the SpMM pieces, ④ the SpMM phase as the
    staged executor runs it."""
    m_local = plan.meta["m_local"]
    P_ = plan.P
    be, pieces = plan.resolve_backend(backend)
    fn_edge = resolve_edge(edge)
    comm, x_loc, y_loc = _setup(plan, comm, x, y)
    K, n = b.shape
    if K != y.shape[0]:
        raise ValueError(f"B has {K} rows, Y has {y.shape[0]}")
    w = y_loc.shape[0]  # the ranks on hand: P, or a process's span
    b_loc = b.reshape(w, K // w, n)

    # ① + ②
    yb, f, dt = _concat_dense(y_loc, b_loc)
    recv, x_r = _exchanges(plan, comm, yb, x_loc)
    y_g, b_g = recv[..., :f], recv[..., f:]

    # ③
    vals = _sample(be, pieces, x_loc, y_loc, x_r, y_g, fn_edge)
    pc = {k: backend_with_values(be, pieces[k], vals[k])
          for k in ("diag", "colp", "rowp")}

    # ④
    b_loc = b_loc.to(dt)
    if isinstance(plan, HierExecPlan):
        G, L, max_cg = plan.G, plan.L, plan.max_cg
        partials = be.compute(pc["rowp"], b_loc, G * L * max_cg)
        agg = comm.local_psum_scatter(
            partials.reshape(w, G, L * max_cg, n), dim=1)
        if plan.schedule.kind == "single":
            recv_c = comm.group_all_to_all(agg).reshape(w, G * max_cg, n)
        else:
            recv_c = _exchange_segments(
                plan.meta["cg_segments"], comm.group_shift,
                plan.meta["R_cg"], lambda dg, off, slot: agg[:, dg, :slot],
                agg, local=plan.meta["local_c"])
    elif plan.schedule.kind == "single":
        partials = be.compute(pc["rowp"], b_loc, P_ * plan.max_c)
        recv_c = comm.all_to_all(partials.reshape(w, P_, plan.max_c, n))
        recv_c = recv_c.reshape(w, P_ * plan.max_c, n)
    else:
        partials = be.compute(pc["rowp"], b_loc, plan.meta["R_c"])
        recv_c = _exchange_segments(plan.meta["c_segments"], comm.shift,
                                    plan.meta["R_c"], _slice_fetch(partials),
                                    partials)
    c = be.compute(pc["diag"], b_loc, m_local)
    c = c + be.compute(pc["colp"], b_g, m_local)
    c = scatter_add_rows_exec_op(c, recv_c, plan.agg_perm, plan.agg_meta)
    return c.reshape(w * m_local, n)


def flat_fused(plan: FlatExecPlan, x: torch.Tensor, y: torch.Tensor,
               b: torch.Tensor, comm: Optional[LocalComm] = None,
               backend: Optional[BackendSpec] = None,
               edge: EdgeSpec = None) -> torch.Tensor:
    """``C = (edge(A ⊙ (X·Yᵀ))) @ B`` in one communication phase.

    The B-gather rounds carry ``[Y | B]`` jointly (width F+N, same
    exchanges as plain SpMM), the sampled values feed the SpMM pieces via
    ``with_values`` on the device, and the C transfer is unchanged.
    Returns C [M, N].
    """
    return _fused(plan, x, y, b, comm, backend, edge)


def hier_fused(plan: HierExecPlan, x: torch.Tensor, y: torch.Tensor,
               b: torch.Tensor, comm: Optional[LocalComm] = None,
               backend: Optional[BackendSpec] = None,
               edge: EdgeSpec = None) -> torch.Tensor:
    """FusedMM on the two-tier schedule — joint [Y | B] inter-group fetch,
    reversed inter-group X rounds, unchanged C transfer. Returns C [M, N].
    """
    return _fused(plan, x, y, b, comm, backend, edge)


def fused_sddmm_spmm(plan, x: torch.Tensor, y: torch.Tensor, b: torch.Tensor,
                     comm: Optional[LocalComm] = None,
                     backend: Optional[BackendSpec] = None,
                     edge: EdgeSpec = None) -> torch.Tensor:
    """FusedMM on the plan's tier (flat or hierarchical)."""
    return _fused(plan, x, y, b, comm, backend, edge)
