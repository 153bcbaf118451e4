"""The flat SHIRO executor over P ranks emulated on one device (paper §5).

Port of ``repro/core/dist_spmm.py``'s flat half. The reference runs
``flat_spmm`` as a ``shard_map`` body on every mesh device; here all P
ranks run in one process over the same stacked ``[P, ...]`` exec layouts,
every per-rank operation is a tensor operation on the rank axis (one
kernel launch covers all ranks), and every collective goes through a
``distributed.comm.LocalComm``, which logs it.

The three bodies of the reference are all here: the single max-padded
all_to_all round, the bucketed ppermute rounds run staged, and the same
rounds round-pipelined (``overlap=True``: each round's received slab is
consumed as it lands, bit-identical C). Each runs four steps: ① pack B
rows (K1) and exchange them; ② partial C rows for other ranks, exchanged;
③ diagonal + column-covered local compute; ④ sorted scatter-add of the
received partials (K2).

``flat_exec_arrays`` builds the exec plan from an ``SpmmPlan``;
``flat_exec_from_numpy`` builds it from plain arrays named like the
reference's ``FlatExecPlan`` fields — the form that carries exec state
from the JAX package (or a file) into the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..distributed.comm import LocalComm
from ..kernels.ops import (
    pack_rows_op, prepare_sorted_scatter, scatter_add_rows_exec_op,
)
from .comm_schedule import (
    CommRound, CommSchedule, flat_schedule_layout, ordered_spans,
    single_round_schedule, span_cuts,
)
from .local_backend import (
    BsrBackend, LocalSpmmBackend, backend_compute_segment,
    backend_prepare_segments, get_backend,
)
from .planner import SpmmPlan, local_piece_csrs

__all__ = [
    "BackendSpec",
    "FlatExecPlan",
    "flat_exec_arrays",
    "flat_exec_from_numpy",
    "flat_spmm",
]

BackendSpec = Union[str, LocalSpmmBackend]

# piece name -> backend-native tensors, all leading with the rank axis [P, ...]
Pieces = Dict[str, Dict[str, torch.Tensor]]

# static per-shift segment descriptors: ((shift, offset, slot), ...)
Segments = Tuple[Tuple[int, int, int], ...]


def _map_tensors(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def _prepare_pieces(
    piece_csrs: Dict[str, list],
    backends: Sequence[BackendSpec],
) -> Tuple[Dict[str, Pieces], Dict[str, LocalSpmmBackend]]:
    """Run every requested backend's host-side prepare over the pieces."""
    prepared: Dict[str, Pieces] = {}
    resolved: Dict[str, LocalSpmmBackend] = {}
    for spec in backends:
        be = get_backend(spec)
        if be.name in resolved:
            raise ValueError(f"duplicate backend {be.name!r}")
        resolved[be.name] = be
        prepared[be.name] = {k: be.prepare(v) for k, v in piece_csrs.items()}
    if not resolved:
        raise ValueError("at least one backend is required")
    return prepared, resolved


def _stack_sorted_scatter(tgt_rows: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-rank sorted-scatter prep, stacked on the leading axis.

    ``tgt_rows`` is [P, S] (-1 pads). Returns (perm [P, S] int32,
    meta [P, S+1] int32) for ``scatter_add_rows_exec_op``.
    """
    perms, metas = [], []
    for p in range(tgt_rows.shape[0]):
        perm, meta = prepare_sorted_scatter(tgt_rows[p])
        perms.append(perm)
        metas.append(meta)
    return np.stack(perms), np.stack(metas)


@dataclasses.dataclass(frozen=True)
class FlatExecPlan:
    """Stacked per-rank tensors for the flat executor.

    ``pieces[backend][piece]`` holds the backend-native tensors for the
    three local-compute pieces ('diag', 'colp', 'rowp'), leading axis P.
    ``b_send_idx`` / ``c_recv_rows`` follow the active schedule's layout:
    [P, P, max_b] / [P, P, max_c] for the single all_to_all round,
    [P, R_b] / [P, R_c] flat segment spaces for a bucketed schedule.
    ``agg_perm`` / ``agg_meta`` are the host-prepared sorted-scatter maps
    the aggregation kernel consumes. Bucketed plans additionally carry
    per-round consumables: ``pieces[backend]["colp@i"]`` /
    ``["rowp@i"]`` (segment layouts for round-pipelined compute) and
    ``seg_agg`` (``perm@i`` / ``meta@i`` per-round sorted-scatter maps).
    ``meta`` holds the static layout description (P, slot maxima, the
    schedule, segment descriptors, the backend instances).
    """

    pieces: Dict[str, Pieces]
    b_send_idx: torch.Tensor  # int32, -1 pad
    c_recv_rows: torch.Tensor  # int32, -1 pad
    agg_perm: torch.Tensor  # [P, S] int32
    agg_meta: torch.Tensor  # [P, S+1] int32
    seg_agg: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def P(self) -> int:
        return self.meta["P"]

    @property
    def max_b(self) -> int:
        return self.meta["max_b"]

    @property
    def max_c(self) -> int:
        return self.meta["max_c"]

    @property
    def backends(self) -> Tuple[str, ...]:
        return tuple(self.pieces)

    @property
    def schedule(self) -> CommSchedule:
        return self.meta["schedule"]

    def to(self, device) -> "FlatExecPlan":
        """The same plan with every tensor on ``device``."""
        move = lambda t: t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, pieces=_map_tensors(self.pieces, move),
            b_send_idx=move(self.b_send_idx),
            c_recv_rows=move(self.c_recv_rows),
            agg_perm=move(self.agg_perm), agg_meta=move(self.agg_meta),
            seg_agg=_map_tensors(self.seg_agg, move))

    def resolve_backend(self, backend: Optional[BackendSpec]
                        ) -> Tuple[LocalSpmmBackend, Pieces]:
        if backend is None:
            be = self.meta["backends"][self.meta["default_backend"]]
        elif isinstance(backend, str):
            # the plan's own instances win over the global registry
            be = self.meta["backends"].get(backend) or get_backend(backend)
        else:
            be = backend
        if be.name not in self.pieces:
            raise ValueError(
                f"backend {be.name!r} has no prepared pieces in this plan; "
                f"rebuild with flat_exec_arrays(plan, backends=(..., "
                f"{be.name!r}))")
        return be, self.pieces[be.name]


# ---------------------------------------------------------------------------
# host-side array builders
# ---------------------------------------------------------------------------


def _uniform_m_local(bounds) -> int:
    m_locals = {b[1] - b[0] for b in bounds}
    if len(m_locals) != 1:
        raise ValueError("row blocks must be equal-sized; pad M to P|M first")
    return int(next(iter(m_locals)))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def flat_exec_arrays(plan: SpmmPlan,
                     backends: Sequence[BackendSpec] = ("coo",),
                     schedule: Optional[CommSchedule] = None,
                     overlap_layouts: bool = True
                     ) -> FlatExecPlan:
    """Convert an offline SpmmPlan into stacked tensors (on the CPU).

    ``backends`` selects which local-compute layouts to prepare; the
    executor picks among them per call (``flat_spmm(..., backend=...)``).
    ``schedule``: ``None`` (or a ``kind="single"`` CommSchedule) keeps the
    one max-padded all_to_all per part; a bucketed CommSchedule switches to
    per-shift ppermute rounds and re-lays the colp/rowp pieces into the
    bucketed index spaces. ``overlap_layouts=False`` skips the per-round
    consumables when execution stays staged. Move the result to the card
    with ``.to(device)``.
    """
    m_local = _uniform_m_local(plan.bounds)
    if schedule is None or schedule.kind == "single":
        sched = schedule or single_round_schedule(plan)
        pieces, resolved = _prepare_pieces(local_piece_csrs(plan), backends)
        c_recv = plan.c_send_rows.transpose(1, 0, 2)  # [P(dst), P(src), max_c]
        perm, meta_arr = _stack_sorted_scatter(c_recv.reshape(plan.P, -1))
        return FlatExecPlan(
            pieces=pieces,
            b_send_idx=_t(plan.b_send_idx),
            c_recv_rows=_t(c_recv),
            agg_perm=_t(perm),
            agg_meta=_t(meta_arr),
            meta=dict(P=plan.P, max_b=plan.max_b, max_c=plan.max_c,
                      m_local=m_local, backends=resolved,
                      default_backend=next(iter(resolved)),
                      schedule=sched),
        )

    layout = flat_schedule_layout(plan, schedule)
    piece_csrs = {"diag": list(plan.a_diag), "colp": layout.colp,
                  "rowp": layout.rowp}
    pieces, resolved = _prepare_pieces(piece_csrs, backends)
    perm, meta_arr = _stack_sorted_scatter(layout.c_recv_rows)

    # per-round consumables for the overlapped executor: segment colp
    # layouts over the cumulative receive prefix, per-round rowp row
    # slices, and per-round aggregation maps
    b_spans = ordered_spans(layout.off_b)
    c_spans = ordered_spans(layout.off_c)
    seg_agg: Dict[str, torch.Tensor] = {}
    if overlap_layouts:
        for name, be in resolved.items():
            for i, seg in enumerate(
                    backend_prepare_segments(be, layout.colp,
                                             span_cuts(b_spans))):
                pieces[name][f"colp@{i}"] = seg
            for i, (_, off, slot) in enumerate(c_spans):
                pieces[name][f"rowp@{i}"] = be.prepare(
                    [csr.row_block(off, off + slot) for csr in layout.rowp])
        for i, (_, off, slot) in enumerate(c_spans):
            sp, sm = _stack_sorted_scatter(
                layout.c_recv_rows[:, off:off + slot])
            seg_agg[f"perm@{i}"] = _t(sp)
            seg_agg[f"meta@{i}"] = _t(sm)

    return FlatExecPlan(
        pieces=pieces,
        b_send_idx=_t(layout.b_send_idx),
        c_recv_rows=_t(layout.c_recv_rows),
        agg_perm=_t(perm),
        agg_meta=_t(meta_arr),
        seg_agg=seg_agg,
        meta=dict(P=plan.P, max_b=plan.max_b, max_c=plan.max_c,
                  m_local=m_local, backends=resolved,
                  default_backend=next(iter(resolved)),
                  schedule=schedule,
                  b_segments=b_spans,
                  c_segments=c_spans,
                  overlap_ready=overlap_layouts,
                  R_b=layout.R_b, R_c=layout.R_c),
    )


def _as_schedule(s: Any) -> CommSchedule:
    """The port's CommSchedule from any object with its field names."""
    if isinstance(s, CommSchedule):
        return s
    rounds = tuple(CommRound(shifts=tuple(int(d) for d in r.shifts),
                             slot_b=int(r.slot_b), slot_c=int(r.slot_c))
                   for r in s.rounds)
    return CommSchedule(
        kind=str(s.kind), P=int(s.P), max_b=int(s.max_b), max_c=int(s.max_c),
        slots_b=tuple(int(v) for v in s.slots_b),
        slots_c=tuple(int(v) for v in s.slots_c), rounds=rounds)


def _as_backend(spec: Any) -> LocalSpmmBackend:
    """The port's backend for a name or a backend-like object."""
    if isinstance(spec, str):
        return get_backend(spec)
    if spec.name == "bsr":
        return BsrBackend(block=tuple(int(v) for v in spec.block),
                          bn=int(spec.bn))
    return get_backend(spec.name)


def flat_exec_from_numpy(fields: Dict[str, Any]) -> FlatExecPlan:
    """A FlatExecPlan from plain arrays named like the reference's fields.

    ``fields`` holds ``pieces`` ({backend: {piece: {array name: array}}}),
    ``b_send_idx``, ``c_recv_rows``, ``agg_perm``, ``agg_meta``, optionally
    ``seg_agg`` ({"perm@i"/"meta@i": array}), and ``meta``: ``P``,
    ``max_b``, ``max_c``, ``m_local``, ``schedule`` (a CommSchedule, or any
    object with its field names), ``backends`` (names, or objects
    with a ``name``, in prepare order; optional, default: the pieces'
    keys), ``default_backend`` and, for bucketed schedules,
    ``b_segments``, ``c_segments``, ``overlap_ready``, ``R_b``, ``R_c``.
    Arrays may be numpy arrays or anything ``np.asarray`` accepts; the
    result lives on the CPU.
    """
    src_meta = dict(fields["meta"])
    specs = src_meta.get("backends") or tuple(fields["pieces"])
    if isinstance(specs, dict):
        specs = tuple(specs.values())
    resolved = {be.name: be for be in map(_as_backend, specs)}
    meta = dict(P=int(src_meta["P"]), max_b=int(src_meta["max_b"]),
                max_c=int(src_meta["max_c"]),
                m_local=int(src_meta["m_local"]), backends=resolved,
                default_backend=src_meta.get("default_backend")
                or next(iter(resolved)),
                schedule=_as_schedule(src_meta["schedule"]))
    if meta["schedule"].kind == "bucketed":
        for key in ("b_segments", "c_segments"):
            meta[key] = tuple(tuple(int(v) for v in seg)
                              for seg in src_meta[key])
        meta["overlap_ready"] = bool(src_meta.get("overlap_ready", False))
        meta["R_b"] = int(src_meta["R_b"])
        meta["R_c"] = int(src_meta["R_c"])

    def arr(a):
        return torch.from_numpy(np.array(a))  # a private, writable copy

    pieces = {be: {name: {k: arr(v) for k, v in piece.items()}
                   for name, piece in by_piece.items()}
              for be, by_piece in fields["pieces"].items()}
    return FlatExecPlan(
        pieces=pieces,
        b_send_idx=arr(fields["b_send_idx"]),
        c_recv_rows=arr(fields["c_recv_rows"]),
        agg_perm=arr(fields["agg_perm"]),
        agg_meta=arr(fields["agg_meta"]),
        seg_agg={k: arr(v) for k, v in fields.get("seg_agg", {}).items()},
        meta=meta,
    )


# ---------------------------------------------------------------------------
# bucketed round execution
# ---------------------------------------------------------------------------


def _exchange_segments(segments: Segments, comm: LocalComm, total: int,
                       send: torch.Tensor) -> torch.Tensor:
    """One ppermute per segment, rebuilding the flat receive space.

    Segment (d, off, slot) of the [P, total, N] send space goes to rank
    ``(q + d) % P`` and comes back at the same offset, so send and
    receive share one layout. Degenerate empty schedules yield the
    all-padding zeros.
    """
    parts: List[Tuple[int, torch.Tensor]] = [
        (off, comm.shift(send[:, off:off + slot], d))
        for d, off, slot in segments]
    P, _, n = send.shape
    if not parts:
        return torch.zeros((P, total, n), dtype=send.dtype,
                           device=send.device)
    parts.sort(key=lambda t: t[0])
    out = torch.cat([seg for _, seg in parts], dim=1)
    if out.shape[1] < total:  # trailing dummy slot (degenerate empty plan)
        out = torch.cat([out, out.new_zeros((P, total - out.shape[1], n))],
                        dim=1)
    return out


# ---------------------------------------------------------------------------
# flat executor (paper §5 / Fig. 1)
# ---------------------------------------------------------------------------


def flat_spmm(plan: FlatExecPlan, b_global: torch.Tensor,
              comm: Optional[LocalComm] = None,
              backend: Optional[BackendSpec] = None,
              overlap: bool = False) -> torch.Tensor:
    """Execute ``C = A @ B`` with the flat SHIRO schedule over P ranks.

    ``b_global``: [K, N] dense matrix on the plan's device, row-partitioned
    into P equal blocks (rank p holds rows [p·K/P, (p+1)·K/P)).
    ``comm`` logs the collectives (a fresh ``LocalComm`` when None).
    ``backend`` selects the local-compute substrate among the layouts the
    plan was built with (default: the plan's first backend).
    ``overlap=True`` switches a bucketed plan to the round-pipelined body:
    identical collectives, bit-identical C (single-round plans have no
    rounds to pipeline and run staged). Returns C [M, N].
    """
    m_local = plan.meta["m_local"]
    P_ = plan.P
    be, pieces = plan.resolve_backend(backend)
    sched = plan.schedule
    comm = comm if comm is not None else LocalComm(P_)
    if comm.P != P_:
        raise ValueError(f"comm has P={comm.P}, plan has P={P_}")
    K, n = b_global.shape
    if K % P_:
        raise ValueError(f"B has {K} rows, not divisible over P={P_} ranks")
    b_loc = b_global.reshape(P_, K // P_, n)

    if sched.kind == "single":
        # ① pack + exchange B rows (column-based comm, Fig. 1(b))
        send_b = pack_rows_op(b_loc, plan.b_send_idx)  # [P, P, max_b, N]
        recv_b = comm.all_to_all(send_b)

        # ② remote computation (row-based, Fig. 1(c)): partial C rows for
        #    every other rank, against the LOCAL B block
        partials = be.compute(pieces["rowp"], b_loc, P_ * plan.max_c)
        recv_c = comm.all_to_all(partials.reshape(P_, P_, plan.max_c, n))

        # ③ local compute: diagonal + column-covered remote nonzeros
        c = be.compute(pieces["diag"], b_loc, m_local)
        c = c + be.compute(pieces["colp"],
                           recv_b.reshape(P_, P_ * plan.max_b, n), m_local)

        # ④ result aggregation: scatter received partial C rows
        c = scatter_add_rows_exec_op(
            c, recv_c.reshape(P_, P_ * plan.max_c, n),
            plan.agg_perm, plan.agg_meta)
    elif not overlap:
        b_segments: Segments = plan.meta["b_segments"]
        c_segments: Segments = plan.meta["c_segments"]

        # ① pack once, then one ppermute per scheduled shift — each padded
        #   only to its round's slot ceiling
        send_b = pack_rows_op(b_loc, plan.b_send_idx)  # [P, R_b, N]
        recv_b = _exchange_segments(b_segments, comm, plan.meta["R_b"],
                                    send_b)

        # ② partial C rows, computed straight into the bucketed send
        #   space, then exchanged shift by shift
        partials = be.compute(pieces["rowp"], b_loc, plan.meta["R_c"])
        recv_c = _exchange_segments(c_segments, comm, plan.meta["R_c"],
                                    partials)

        # ③ local compute against the bucketed receive space
        c = be.compute(pieces["diag"], b_loc, m_local)
        c = c + be.compute(pieces["colp"], recv_b, m_local)

        # ④ aggregation of received partials
        c = scatter_add_rows_exec_op(c, recv_c, plan.agg_perm, plan.agg_meta)
    else:
        if not plan.meta.get("overlap_ready"):
            raise ValueError(
                "overlap=True needs the per-round consumable layouts; "
                "rebuild with flat_exec_arrays(..., overlap_layouts=True)")
        b_segments = plan.meta["b_segments"]
        c_segments = plan.meta["c_segments"]

        # ① pack once; every B round is issued up front
        send_b = pack_rows_op(b_loc, plan.b_send_idx)  # [P, R_b, N]
        recv_b = [comm.shift(send_b[:, off:off + slot], d)
                  for d, off, slot in b_segments]

        # ② per-round partial-C compute feeding its own round: round i
        #   departs after only ITS rowp slice ran
        recv_c = [comm.shift(be.compute(pieces[f"rowp@{i}"], b_loc, slot), d)
                  for i, (d, off, slot) in enumerate(c_segments)]

        # ③ diagonal block
        c = be.compute(pieces["diag"], b_loc, m_local)

        # ④ consume B rounds in order: cumulative receive prefix +
        #   segment-accumulating compute (bit-identical to staged)
        colp_acc = torch.zeros((P_, m_local, n), dtype=b_loc.dtype,
                               device=b_loc.device)
        prefix = None
        for i, seg in enumerate(recv_b):
            prefix = seg if prefix is None else torch.cat([prefix, seg], 1)
            colp_acc = backend_compute_segment(
                be, pieces[f"colp@{i}"], prefix, colp_acc)
        c = c + colp_acc

        # ⑤ per-round aggregation of received partials
        for i in range(len(c_segments)):
            c = scatter_add_rows_exec_op(c, recv_c[i],
                                         plan.seg_agg[f"perm@{i}"],
                                         plan.seg_agg[f"meta@{i}"])
    return c.reshape(P_ * m_local, n)
