"""Distributed SDDMM + FusedMM over the SHIRO SpMM plans (flat executor).

Port of the flat half of ``repro/core/dist_sddmm.py``. SDDMM —
``vals(i,j) = a(i,j) · (x_i · y_j)`` per stored nonzero — is
communication-equivalent to SpMM over the same sparsity pattern: the
nonzeros that force rank p to FETCH row j of B for SpMM are exactly the
ones that make it need row j of Y, and the nonzeros whose partial C rows
p SHIPS to q are the ones whose sampled values live at q's X rows. So the
executors here reuse the SAME ``FlatExecPlan``, schedule and piece
layouts as ``dist_spmm`` with the dataflow reversed:

* column-covered nonzeros (colp): Y rows travel dest-ward over the
  UNCHANGED B-gather rounds (same ``b_send_idx``, same shifts).
* row-covered nonzeros (rowp): the SpMM phase consumes their values at
  the SOURCE, so X rows travel dest → source over the C-transfer segment
  layout with every shift REVERSED (d → P−d); the received segments line
  up with the rowp row space at the same offsets.
* diagonal nonzeros sample local X against local Y — no wire.

The P ranks run in one process over stacked ``[P, ...]`` tensors, and
every collective goes through a ``LocalComm``, which logs it.

``flat_sddmm`` returns the sampled values in the backend's native piece
layout ({"diag", "colp", "rowp"}); ``flat_spmm_values`` runs the SpMM of
those values (the unfused second phase). ``flat_fused`` (FusedMM) chains
both phases through ONE set of collectives: the B gather carries
``[Y | B]`` so the SDDMM operand rides the same rounds as the SpMM
operand, the sampled values drop into the SpMM pieces via
``with_values`` without leaving the device, and the C transfer runs
unchanged. The fused collective log therefore has the plain SpMM's shift
set whenever the demanded C shifts are closed under reversal, plus one
reversed X round per C segment. The fused and SDDMM executors always run
staged. The hierarchical executors come with ROADMAP item 7.

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
    BackendSpec, FlatExecPlan, Segments, _exchange_segments, flat_spmm,
)
from .local_backend import LocalSpmmBackend, backend_sddmm, backend_with_values

__all__ = [
    "EDGE_FNS",
    "resolve_edge",
    "SddmmValues",
    "flat_sddmm",
    "with_values_exec",
    "flat_spmm_values",
    "flat_fused",
    "fused_sddmm_spmm",
]

# sampled values per piece, backend-native layout, leading [P, ...] axis
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
    return comm.all_to_all(send).reshape(P_, P_ * plan.max_b, w)


def _flat_gather_bucketed(rows_loc: torch.Tensor, plan: FlatExecPlan,
                          comm: LocalComm) -> torch.Tensor:
    """Dense rows → the bucketed [P, R_b, W] receive space (one ppermute
    per scheduled B shift)."""
    send = pack_rows_op(rows_loc, plan.b_send_idx)  # [P, R_b, W]
    return _exchange_segments(plan.meta["b_segments"], comm,
                              plan.meta["R_b"], send)


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
    return comm.all_to_all(xs).reshape(P_, P_ * plan.max_c, f)


def _flat_x_bucketed(x_loc: torch.Tensor, plan: FlatExecPlan,
                     comm: LocalComm) -> torch.Tensor:
    """X rows dest → source over the bucketed C layout, shifts reversed.

    The per-shift slot maps are schedule-global, so the segment arriving
    under reversed shift P−d sits at the SAME (offset, slot) its rowp
    rows occupy in the send space — no relayout on arrival.
    """
    xs = pack_rows_op(x_loc, plan.c_recv_rows)  # [P, R_c, F]
    return _exchange_segments(
        _reverse_segments(plan.meta["c_segments"], plan.P), comm,
        plan.meta["R_c"], xs)


def _exchanges(plan: FlatExecPlan, comm: LocalComm, rows_loc: torch.Tensor,
               x_loc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column gather of ``rows_loc`` and the reversed X rounds."""
    if plan.schedule.kind == "single":
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


def _setup(plan: FlatExecPlan, comm: Optional[LocalComm], x: torch.Tensor,
           y: torch.Tensor) -> Tuple[LocalComm, torch.Tensor, torch.Tensor]:
    """The comm and the stacked local blocks of X [M, F] and Y [K, F]."""
    P_ = plan.P
    comm = comm if comm is not None else LocalComm(P_)
    if comm.P != P_:
        raise ValueError(f"comm has P={comm.P}, plan has P={P_}")
    for name, t in (("X", x), ("Y", y)):
        if t.shape[0] % P_:
            raise ValueError(f"{name} has {t.shape[0]} rows, not divisible "
                             f"over P={P_} ranks")
    return (comm, x.reshape(P_, x.shape[0] // P_, x.shape[1]),
            y.reshape(P_, y.shape[0] // P_, y.shape[1]))


# ---------------------------------------------------------------------------
# SDDMM executor
# ---------------------------------------------------------------------------


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
    be, pieces = plan.resolve_backend(backend)
    fn_edge = resolve_edge(edge)
    comm, x_loc, y_loc = _setup(plan, comm, x, y)
    y_g, x_r = _exchanges(plan, comm, y_loc, x_loc)
    return _sample(be, pieces, x_loc, y_loc, x_r, y_g, fn_edge)


# ---------------------------------------------------------------------------
# SpMM over swapped values (the unfused second phase)
# ---------------------------------------------------------------------------


def with_values_exec(plan: FlatExecPlan, values: SddmmValues,
                     backend: Optional[BackendSpec] = None) -> FlatExecPlan:
    """An exec plan whose stored values are replaced by ``values``.

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


# ---------------------------------------------------------------------------
# FusedMM: SDDMM → SpMM through one communication phase
# ---------------------------------------------------------------------------


def _concat_dense(y_loc: torch.Tensor, b_loc: torch.Tensor):
    dt = torch.promote_types(y_loc.dtype, b_loc.dtype)
    yb = torch.cat([y_loc.to(dt), b_loc.to(dt)], dim=2)
    return yb, y_loc.shape[2], dt


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
    m_local = plan.meta["m_local"]
    P_ = plan.P
    be, pieces = plan.resolve_backend(backend)
    fn_edge = resolve_edge(edge)
    comm, x_loc, y_loc = _setup(plan, comm, x, y)
    K, n = b.shape
    if K != y.shape[0]:
        raise ValueError(f"B has {K} rows, Y has {y.shape[0]}")
    b_loc = b.reshape(P_, K // P_, n)

    # ① ONE gather round set for both phases: [Y | B] jointly; ② X rows
    #   ride the reversed C layout to the rowp sources
    yb, f, dt = _concat_dense(y_loc, b_loc)
    recv, x_r = _exchanges(plan, comm, yb, x_loc)
    y_g, b_g = recv[..., :f], recv[..., f:]

    # ③ sample, then swap the values into the SpMM pieces
    vals = _sample(be, pieces, x_loc, y_loc, x_r, y_g, fn_edge)
    pc = {k: backend_with_values(be, pieces[k], vals[k])
          for k in ("diag", "colp", "rowp")}

    # ④ the SpMM phase, as the staged executor runs it
    b_loc = b_loc.to(dt)
    if plan.schedule.kind == "single":
        partials = be.compute(pc["rowp"], b_loc, P_ * plan.max_c)
        recv_c = comm.all_to_all(partials.reshape(P_, P_, plan.max_c, n))
        recv_c = recv_c.reshape(P_, P_ * plan.max_c, n)
    else:
        partials = be.compute(pc["rowp"], b_loc, plan.meta["R_c"])
        recv_c = _exchange_segments(plan.meta["c_segments"], comm,
                                    plan.meta["R_c"], partials)
    c = be.compute(pc["diag"], b_loc, m_local)
    c = c + be.compute(pc["colp"], b_g, m_local)
    c = scatter_add_rows_exec_op(c, recv_c, plan.agg_perm, plan.agg_meta)
    return c.reshape(P_ * m_local, n)


def fused_sddmm_spmm(plan, x: torch.Tensor, y: torch.Tensor, b: torch.Tensor,
                     comm: Optional[LocalComm] = None,
                     backend: Optional[BackendSpec] = None,
                     edge: EdgeSpec = None) -> torch.Tensor:
    """FusedMM on the plan's tier (only the flat tier is ported)."""
    if not isinstance(plan, FlatExecPlan):
        raise NotImplementedError(
            f"fused_sddmm_spmm on a {type(plan).__name__} is not ported to "
            f"repro_torch yet (ROADMAP.md, open item 7: the hierarchical "
            f"executors); use the JAX package (repro) for it meanwhile")
    return flat_fused(plan, x, y, b, comm, backend=backend, edge=edge)
