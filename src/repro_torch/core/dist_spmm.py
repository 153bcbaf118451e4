"""The SHIRO executors over P ranks emulated on one device (paper §5-§6).

Port of ``repro/core/dist_spmm.py``'s flat and hierarchical halves. The
reference runs ``flat_spmm`` / ``hier_spmm`` as ``shard_map`` bodies on
every mesh device; here all P ranks run in one process over the same
stacked ``[P, ...]`` exec layouts, every per-rank operation is a tensor
operation on the rank axis (one kernel launch covers all ranks), and
every collective goes through a ``distributed.comm.LocalComm``, which
logs it.

``flat_spmm`` runs the three bodies of the reference: the single
max-padded all_to_all round, the bucketed ppermute rounds run staged,
and the same rounds round-pipelined (``overlap=True``: each round's
received slab is consumed as it lands, bit-identical C). Each runs four
steps: ① pack B rows (K1) and exchange them; ② partial C rows for other
ranks, exchanged; ③ diagonal + column-covered local compute; ④ sorted
scatter-add of the received partials (K2).

``hier_spmm`` runs the two-tier schedule (paper Alg. 1) on the ranks laid
out as a (G, L) grid, rank p = (p // L, p % L): Stage I, the inter-group
B fetch (group axis) and the intra-group pre-aggregation of partial C
rows (a reduce-scatter over the local axis); Stage II, the inter-group
C transfer and the intra-group B distribution (an all_gather over the
local axis). It has the same three bodies, the bucketed ones serving the
own-group (shift-0) traffic with a local slice instead of a collective.

``replicated_spmm`` runs the 1.5D tier on the ranks laid out as a (c, s)
replica × shard grid, rank p = r·s + g: B's s-way shards copied to every
lane, each lane exchanging only its own subset of the shifts (every lane
on its own shift in one round), and the lanes' C blocks summed and split
back over the replica axis in one reduce-scatter. Staged only, as in the
reference.

Across processes (``Topology.multiprocess``) each process runs the same
executors on its contiguous span of the ranks: the exec plan cut to the
span (``span(lo, hi)``; every index in it is rank-local, so a span needs
no rebasing), B's rows of the span, and a ``distributed.comm.
ProcessComm`` that moves the rows between processes. The executors take
the count of ranks on hand from B's blocks; the global P stays the axis
of destinations. Each returns the span's C rows.

``flat_exec_arrays`` / ``hier_exec_arrays`` / ``replicated_exec_arrays``
build the exec plans from the host plans; ``flat_exec_from_numpy`` /
``hier_exec_from_numpy`` build them from plain arrays named like the
reference's ``FlatExecPlan`` / ``HierExecPlan`` fields — the form that
carries exec state from the JAX package (or a file) into the port.
"""
from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from ..distributed.comm import LocalComm
from ..kernels.ops import (
    pack_rows_op, scatter_add_rows_exec_op, stack_sorted_scatter,
)
from .comm_schedule import (
    CommRound, CommSchedule, ReplicatedSchedule, build_replicated_schedule,
    flat_schedule_layout, hier_schedule_layout, ordered_spans,
    replicated_schedule_layout, single_round_hier_schedule,
    single_round_schedule, span_cuts,
)
from .hierarchy import HierPlan, hier_piece_csrs
from .local_backend import (
    BsrBackend, LocalSpmmBackend, backend_compute_segment,
    backend_prepare_segments, coo_piece_with_maps, get_backend,
)
from .planner import ReplicatedPlan, SpmmPlan, local_piece_csrs

__all__ = [
    "BackendSpec",
    "FlatExecPlan",
    "HierExecPlan",
    "ReplicatedExecPlan",
    "flat_exec_arrays",
    "flat_exec_from_numpy",
    "hier_exec_arrays",
    "hier_exec_from_numpy",
    "replicated_exec_arrays",
    "flat_spmm",
    "hier_spmm",
    "replicated_spmm",
]

BackendSpec = Union[str, LocalSpmmBackend]

# piece name -> backend-native tensors, all leading with the rank axis [P, ...]
Pieces = Dict[str, Dict[str, torch.Tensor]]

# static per-shift segment descriptors: ((shift, offset, slot), ...)
Segments = Tuple[Tuple[int, int, int], ...]

# static replicated round descriptors: ((per-lane shifts, slot, offset,
# participating lanes), ...)
LaneRounds = Tuple[Tuple[Tuple[int, ...], int, int, Tuple[int, ...]], ...]


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


@dataclasses.dataclass(frozen=True)
class _ExecPlanBase:
    """What both exec plans share: the prepared pieces, the backend
    lookup, the schedule and the move to a device."""

    @property
    def backends(self) -> Tuple[str, ...]:
        return tuple(self.pieces)

    @property
    def schedule(self) -> CommSchedule:
        return self.meta["schedule"]

    def to(self, device):
        """The same plan with every tensor on ``device``."""
        move = lambda t: t.to(device)  # noqa: E731
        return dataclasses.replace(self, **{
            f.name: _map_tensors(getattr(self, f.name), move)
            for f in dataclasses.fields(self) if f.name != "meta"})

    @property
    def rank_span(self) -> Tuple[int, int]:
        """The (start, stop) ranks whose tensors the plan holds: all P,
        or the span ``span`` cut."""
        return self.meta.get("rank_span", (0, self.P))

    def span(self, lo: int, hi: int):
        """The plan of the ranks [lo, hi) only: every tensor (they all
        lead with the rank axis) cut to its rows lo..hi−1 and copied, so
        the whole plan's storage is not kept. Every index in an exec
        plan is rank-local (a row of the rank's own B block, receive
        space or C block), so nothing is rebased; the metadata keeps the
        global P, the axis of destinations. An empty span (lo == hi, a
        process that holds no rank of a narrowed fleet) keeps every
        tensor with its rank axis 0 long."""
        lo, hi = int(lo), int(hi)
        if (lo, hi) == self.rank_span:
            return self
        if self.rank_span != (0, self.P) or not 0 <= lo <= hi <= self.P:
            raise ValueError(f"cannot cut ranks [{lo}, {hi}) from a plan of "
                             f"ranks {self.rank_span}")
        cut = lambda t: t[lo:hi].clone()  # noqa: E731
        return dataclasses.replace(self, meta=dict(self.meta,
                                                   rank_span=(lo, hi)), **{
            f.name: _map_tensors(getattr(self, f.name), cut)
            for f in dataclasses.fields(self) if f.name != "meta"})

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
                f"rebuild its exec arrays with backends=(..., "
                f"{be.name!r})")
        return be, self.pieces[be.name]


@dataclasses.dataclass(frozen=True)
class FlatExecPlan(_ExecPlanBase):
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


@dataclasses.dataclass(frozen=True)
class HierExecPlan(_ExecPlanBase):
    """Stacked per-rank tensors for the hierarchical executor.

    Every tensor leads with the rank axis P = G·L (rank p is (g, l) =
    (p // L, p % L), the reference's [G, L, ...] leading axes merged).
    Layouts follow the active inter-group schedule as in
    ``FlatExecPlan``: ``b_group_send_idx`` / ``c_recv_rows`` are
    [P, G, max_bg] / [P, G, max_cg] for the single group all_to_all pair,
    [P, R_bg] / [P, R_cg] segment spaces (own-group segment first) for a
    bucketed schedule.
    """

    pieces: Dict[str, Pieces]
    b_group_send_idx: torch.Tensor  # int32, -1 pad
    c_recv_rows: torch.Tensor  # int32, -1 pad
    agg_perm: torch.Tensor
    agg_meta: torch.Tensor
    seg_agg: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def P(self) -> int:
        return self.meta["G"] * self.meta["L"]

    @property
    def G(self) -> int:
        return self.meta["G"]

    @property
    def L(self) -> int:
        return self.meta["L"]

    @property
    def max_bg(self) -> int:
        return self.meta["max_bg"]

    @property
    def max_cg(self) -> int:
        return self.meta["max_cg"]


@dataclasses.dataclass(frozen=True)
class ReplicatedExecPlan(_ExecPlanBase):
    """Stacked per-rank tensors for the replicated (1.5D) executor.

    Every tensor leads with the rank axis P = c·s, lane-major (rank p is
    (r, g) = (p // s, p % s), the reference's [c, s, ...] leading axes
    merged). ``b_send_idx`` [P, R_b] / ``c_recv_rows`` [P, R_c] are the
    lane send and receive spaces; the metadata carries the round
    descriptors (``b_rounds`` / ``c_rounds``): per round the per-lane
    shifts, the shared slot ceiling, its offset and the participating
    lanes.
    """

    pieces: Dict[str, Pieces]
    b_send_idx: torch.Tensor  # [P, R_b] int32, -1 pad
    c_recv_rows: torch.Tensor  # [P, R_c] int32, -1 pad
    agg_perm: torch.Tensor  # [P, R_c] int32
    agg_meta: torch.Tensor  # [P, R_c+1] int32
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def P(self) -> int:
        return self.meta["c"] * self.meta["s"]

    @property
    def c(self) -> int:
        return self.meta["c"]

    @property
    def s(self) -> int:
        return self.meta["s"]


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
    k_local = plan.shape[1] // plan.P  # B rows a rank holds
    if schedule is None or schedule.kind == "single":
        sched = schedule or single_round_schedule(plan)
        pieces, resolved = _prepare_pieces(local_piece_csrs(plan), backends)
        c_recv = plan.c_send_rows.transpose(1, 0, 2)  # [P(dst), P(src), max_c]
        perm, meta_arr = stack_sorted_scatter(c_recv.reshape(plan.P, -1))
        return FlatExecPlan(
            pieces=pieces,
            b_send_idx=_t(plan.b_send_idx),
            c_recv_rows=_t(c_recv),
            agg_perm=_t(perm),
            agg_meta=_t(meta_arr),
            meta=dict(P=plan.P, max_b=plan.max_b, max_c=plan.max_c,
                      m_local=m_local, k_local=k_local, backends=resolved,
                      default_backend=next(iter(resolved)),
                      schedule=sched),
        )

    layout = flat_schedule_layout(plan, schedule)
    piece_csrs = {"diag": list(plan.a_diag), "colp": layout.colp,
                  "rowp": layout.rowp}
    pieces, resolved = _prepare_pieces(piece_csrs, backends)
    perm, meta_arr = stack_sorted_scatter(layout.c_recv_rows)

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
        seg_agg = _seg_agg(layout.c_recv_rows, c_spans)

    return FlatExecPlan(
        pieces=pieces,
        b_send_idx=_t(layout.b_send_idx),
        c_recv_rows=_t(layout.c_recv_rows),
        agg_perm=_t(perm),
        agg_meta=_t(meta_arr),
        seg_agg=seg_agg,
        meta=dict(P=plan.P, max_b=plan.max_b, max_c=plan.max_c,
                  m_local=m_local, k_local=k_local, backends=resolved,
                  default_backend=next(iter(resolved)),
                  schedule=schedule,
                  b_segments=b_spans,
                  c_segments=c_spans,
                  overlap_ready=overlap_layouts,
                  R_b=layout.R_b, R_c=layout.R_c),
    )


def _seg_agg(c_recv_rows: np.ndarray, spans: Segments
             ) -> Dict[str, torch.Tensor]:
    """Per-round sorted-scatter maps over each receive segment."""
    out: Dict[str, torch.Tensor] = {}
    for i, (_, off, slot) in enumerate(spans):
        sp, sm = stack_sorted_scatter(c_recv_rows[:, off:off + slot])
        out[f"perm@{i}"] = _t(sp)
        out[f"meta@{i}"] = _t(sm)
    return out


def hier_exec_arrays(hier: HierPlan,
                     backends: Sequence[BackendSpec] = ("coo",),
                     schedule: Optional[CommSchedule] = None,
                     overlap_layouts: bool = True
                     ) -> HierExecPlan:
    """Convert a HierPlan into stacked tensors (on the CPU).

    ``schedule`` buckets the INTER-GROUP collectives (see
    ``comm_schedule.build_hier_comm_schedule``); the intra-group
    reduce-scatter / all_gather keep their uniform layouts either way.
    ``backends`` and ``overlap_layouts`` as in ``flat_exec_arrays``.
    """
    base = hier.base
    G, L, P = hier.G, hier.L, hier.base.P
    m_local = _uniform_m_local(base.bounds)
    k_local = base.shape[1] // P

    if schedule is None or schedule.kind == "single":
        sched = schedule or single_round_hier_schedule(hier)
        pieces, resolved = _prepare_pieces(hier_piece_csrs(hier), backends)
        c_recv = hier.c_group_rows.transpose(1, 0, 2)  # [P(dst), G(src), max_cg]
        perm, meta_arr = stack_sorted_scatter(c_recv.reshape(P, -1))
        return HierExecPlan(
            pieces=pieces,
            b_group_send_idx=_t(hier.b_group_send_idx),
            c_recv_rows=_t(c_recv),
            agg_perm=_t(perm),
            agg_meta=_t(meta_arr),
            meta=dict(G=G, L=L, max_bg=hier.max_bg, max_cg=hier.max_cg,
                      m_local=m_local, k_local=k_local, backends=resolved,
                      default_backend=next(iter(resolved)),
                      schedule=sched),
        )

    layout = hier_schedule_layout(hier, schedule)
    piece_csrs = {"diag": list(base.a_diag), "colp": layout.colp,
                  "rowp": layout.rowp}
    pieces, resolved = _prepare_pieces(piece_csrs, backends)

    # per-round consumables over the SEGMENT-MAJOR gathered space (the
    # shift-0 own-group segment is ordinal 0 when present): colp segment
    # layouts cut at the gathered cumulative boundaries, and per-round
    # aggregation maps over the inter-group C receive segments
    bg_all = ordered_spans(layout.off_bg)
    cg_all = ordered_spans(layout.off_cg)
    seg_agg: Dict[str, torch.Tensor] = {}
    if overlap_layouts:
        gathered_cuts = tuple(L * (off + slot) for _, off, slot in bg_all)
        for name, be in resolved.items():
            for i, seg in enumerate(
                    backend_prepare_segments(be, layout.colp,
                                             gathered_cuts)):
                pieces[name][f"colp@{i}"] = seg
        seg_agg = _seg_agg(layout.c_recv_rows, cg_all)
    perm, meta_arr = stack_sorted_scatter(layout.c_recv_rows)
    return HierExecPlan(
        pieces=pieces,
        b_group_send_idx=_t(layout.b_send_idx),
        c_recv_rows=_t(layout.c_recv_rows),
        agg_perm=_t(perm),
        agg_meta=_t(meta_arr),
        seg_agg=seg_agg,
        meta=dict(G=G, L=L, max_bg=hier.max_bg, max_cg=hier.max_cg,
                  m_local=m_local, k_local=k_local, backends=resolved,
                  default_backend=next(iter(resolved)),
                  schedule=schedule,
                  bg_segments=tuple(t for t in bg_all if t[0] != 0),
                  cg_segments=tuple(t for t in cg_all if t[0] != 0),
                  bg_all=bg_all, cg_all=cg_all,
                  overlap_ready=overlap_layouts,
                  local_b=layout.off_bg.get(0), local_c=layout.off_cg.get(0),
                  R_bg=layout.R_bg, R_cg=layout.R_cg),
    )


def replicated_exec_arrays(rp: ReplicatedPlan,
                           backends: Sequence[BackendSpec] = ("coo",),
                           schedule: Optional[ReplicatedSchedule] = None
                           ) -> ReplicatedExecPlan:
    """Convert a ``planner.ReplicatedPlan`` into stacked tensors (on the
    CPU).

    ``schedule`` is a ``comm_schedule.ReplicatedSchedule`` (built from
    the plan when None). The replicated executor is staged only: the
    lane rounds are few by construction (ceil((s-1)/c) shifts a lane)
    and the reduce-scatter already serializes the tail, so there are no
    per-round consumables.
    """
    sched = schedule or build_replicated_schedule(rp)
    layout = replicated_schedule_layout(rp, sched)
    c, s = rp.c, rp.s
    m_local = _uniform_m_local(rp.base.bounds)
    k_local = rp.base.shape[1] // (c * s)  # B's P-way row blocks
    if m_local % c:
        raise ValueError(
            f"replicate={c} needs c | m_local for the tiled replica "
            f"reduce-scatter (m_local={m_local}); pad M or pick another c")
    pieces, resolved = _prepare_pieces(
        {"diag": layout.diag, "colp": layout.colp, "rowp": layout.rowp},
        backends)
    c_recv = layout.c_recv_rows.reshape(c * s, layout.R_c)
    perm, meta_arr = stack_sorted_scatter(c_recv)
    return ReplicatedExecPlan(
        pieces=pieces,
        b_send_idx=_t(layout.b_send_idx.reshape(c * s, layout.R_b)),
        c_recv_rows=_t(c_recv),
        agg_perm=_t(perm),
        agg_meta=_t(meta_arr),
        meta=dict(c=c, s=s, m_local=m_local, k_local=k_local,
                  backends=resolved,
                  default_backend=next(iter(resolved)), schedule=sched,
                  b_rounds=tuple((rnd.shifts, rnd.slot_b, rnd.off_b,
                                  rnd.b_lanes)
                                 for rnd in sched.rounds if rnd.b_lanes),
                  c_rounds=tuple((rnd.shifts, rnd.slot_c, rnd.off_c,
                                  rnd.c_lanes)
                                 for rnd in sched.rounds if rnd.c_lanes),
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
        slots_c=tuple(int(v) for v in s.slots_c), rounds=rounds,
        local_slot_b=int(getattr(s, "local_slot_b", 0)),
        local_slot_c=int(getattr(s, "local_slot_c", 0)),
        procs=int(getattr(s, "procs", 0)))


def _as_backend(spec: Any) -> LocalSpmmBackend:
    """The port's backend for a name or a backend-like object."""
    if isinstance(spec, str):
        return get_backend(spec)
    if spec.name == "bsr":
        return BsrBackend(block=tuple(int(v) for v in spec.block),
                          bn=int(spec.bn))
    return get_backend(spec.name)


def _segments(seq) -> Segments:
    return tuple(tuple(int(v) for v in seg) for seg in seq)


def _from_numpy(fields: Dict[str, Any], lead: int, sizes: Tuple[str, ...],
                bucketed_keys: Tuple[str, ...]
                ) -> Tuple[Dict[str, Any], Callable, Dict[str, Pieces]]:
    """What both ``*_exec_from_numpy`` share: the metadata (``sizes`` as
    ints, the schedule, the backends, and for a bucketed schedule the
    segment descriptors, widths and ``overlap_ready``), an array converter
    that merges the ``lead`` leading axes into the rank axis, and the
    pieces (coo ones with the row maps the port's fold needs)."""
    src_meta = dict(fields["meta"])
    specs = src_meta.get("backends") or tuple(fields["pieces"])
    if isinstance(specs, dict):
        specs = tuple(specs.values())
    resolved = {be.name: be for be in map(_as_backend, specs)}
    meta = {k: int(src_meta[k]) for k in sizes}
    meta.update(m_local=int(src_meta["m_local"]), backends=resolved,
                default_backend=src_meta.get("default_backend")
                or next(iter(resolved)),
                schedule=_as_schedule(src_meta["schedule"]))
    if meta["schedule"].kind == "bucketed":
        for key in bucketed_keys:
            v = src_meta[key]
            if key.startswith("local_"):
                meta[key] = None if v is None else tuple(int(x) for x in v)
            elif key.startswith("R_"):
                meta[key] = int(v)
            else:
                meta[key] = _segments(v)
        meta["overlap_ready"] = bool(src_meta.get("overlap_ready", False))

    def arr(a):
        a = np.array(a)  # a private, writable copy
        n = int(np.prod(a.shape[:lead]))
        return torch.from_numpy(a.reshape((n,) + a.shape[lead:]))

    pieces = {be: {name: {k: arr(v) for k, v in piece.items()}
                   for name, piece in by_piece.items()}
              for be, by_piece in fields["pieces"].items()}
    if "coo" in pieces:  # the port's coo fold needs each piece's row maps
        pieces["coo"] = {name: coo_piece_with_maps(piece)
                         for name, piece in pieces["coo"].items()}
    return meta, arr, pieces


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
    meta, arr, pieces = _from_numpy(
        fields, 1, ("P", "max_b", "max_c"),
        ("b_segments", "c_segments", "R_b", "R_c"))
    return FlatExecPlan(
        pieces=pieces,
        b_send_idx=arr(fields["b_send_idx"]),
        c_recv_rows=arr(fields["c_recv_rows"]),
        agg_perm=arr(fields["agg_perm"]),
        agg_meta=arr(fields["agg_meta"]),
        seg_agg={k: arr(v) for k, v in fields.get("seg_agg", {}).items()},
        meta=meta,
    )


def hier_exec_from_numpy(fields: Dict[str, Any]) -> HierExecPlan:
    """A HierExecPlan from plain arrays named like the reference's fields.

    The hier counterpart of ``flat_exec_from_numpy``: ``pieces``,
    ``b_group_send_idx``, ``c_recv_rows``, ``agg_perm``, ``agg_meta``,
    optionally ``seg_agg``, every array leading with the reference's
    [G, L] axes (merged here into the rank axis), and ``meta``: ``G``,
    ``L``, ``max_bg``, ``max_cg``, ``m_local``, ``schedule``,
    ``backends``, ``default_backend`` and, for bucketed schedules,
    ``bg_segments``, ``cg_segments``, ``bg_all``, ``cg_all``,
    ``local_b``, ``local_c``, ``R_bg``, ``R_cg``, ``overlap_ready``.
    """
    meta, arr, pieces = _from_numpy(
        fields, 2, ("G", "L", "max_bg", "max_cg"),
        ("bg_segments", "cg_segments", "bg_all", "cg_all", "local_b",
         "local_c", "R_bg", "R_cg"))
    return HierExecPlan(
        pieces=pieces,
        b_group_send_idx=arr(fields["b_group_send_idx"]),
        c_recv_rows=arr(fields["c_recv_rows"]),
        agg_perm=arr(fields["agg_perm"]),
        agg_meta=arr(fields["agg_meta"]),
        seg_agg={k: arr(v) for k, v in fields.get("seg_agg", {}).items()},
        meta=meta,
    )


# ---------------------------------------------------------------------------
# bucketed round execution (shared by the executors)
# ---------------------------------------------------------------------------


def _slice_fetch(buf: torch.Tensor):
    """fetch() over a packed [P, total, N] send buffer sharing the
    receive layout."""
    return lambda d, off, slot: buf[:, off:off + slot]


def _exchange_segments(segments: Segments, shift: Callable, total: int,
                       fetch: Callable, like: torch.Tensor,
                       local: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """One ppermute per segment, rebuilding the flat receive space.

    ``fetch(d, off, slot)`` gives the [P, slot, N] send slab of shift
    ``d`` (a slice of the packed send space, or of the pre-aggregated
    hier tiles) and ``shift(x, d)`` is the collective (``comm.shift`` on
    the flat axis, ``comm.group_shift`` on the group axis). Segment
    (d, off, slot) comes back at the same offset, so send and receive
    share one layout. ``local`` is the hier shift-0 (own group) segment:
    fetched straight into the receive space, never a collective.
    Degenerate empty schedules yield the all-padding zeros (shaped
    [P, total, N] after ``like``).
    """
    parts: List[Tuple[int, torch.Tensor]] = []
    if local is not None:
        off, slot = local
        parts.append((off, fetch(0, off, slot)))
    parts += [(off, shift(fetch(d, off, slot), d))
              for d, off, slot in segments]
    P, n = like.shape[0], like.shape[-1]
    if not parts:
        return like.new_zeros((P, total, n))
    parts.sort(key=lambda t: t[0])
    out = torch.cat([seg for _, seg in parts], dim=1)
    if out.shape[1] < total:  # trailing dummy slot (degenerate empty plan)
        out = torch.cat([out, out.new_zeros((P, total - out.shape[1], n))],
                        dim=1)
    return out


def _operand(b_global) -> torch.Tensor:
    """The B tensor of an executor call. A one-element list hands the
    executor the only reference (donation, ``SpmmConfig.donate``): the
    list is emptied, and B's block returns to the allocator after the
    executor's last read of it, free for the partials and C. B is never
    written either way."""
    return b_global.pop() if isinstance(b_global, list) else b_global


def _rank_blocks(plan, comm, b: torch.Tensor, groups: int = 1,
                 name: str = "B", replicas: int = 1
                 ) -> Tuple[Any, torch.Tensor]:
    """The comm (a fresh ``LocalComm`` on the plan's layout when None) and
    the stacked row blocks [w, K/P, N] of the operand ``b`` (called
    ``name``) for the w ranks the plan holds: all P, or a process's span
    (``b`` then holds that span's rows and ``comm`` is its
    ``ProcessComm``). With ``replicas`` c > 1 every lane gets B's whole
    s = P/c shard split, [w, K/s, N] (``comm.replicate``)."""
    P_ = plan.P
    comm = comm if comm is not None else LocalComm(P_, groups, replicas)
    if comm.P != P_ or comm.G != groups or comm.C != replicas:
        raise ValueError(f"comm has P={comm.P}, G={comm.G}, c={comm.C}; "
                         f"the plan needs P={P_}, G={groups}, c={replicas}")
    if tuple(comm.span) != tuple(plan.rank_span):
        raise ValueError(f"comm runs ranks {comm.span}, the plan holds "
                         f"ranks {plan.rank_span}")
    K, n = b.shape
    if isinstance(comm, LocalComm):
        shards = P_ // replicas
        if K % shards:
            raise ValueError(f"{name} has {K} rows, not divisible over "
                             + (f"P={P_} ranks" if replicas == 1
                                else f"s={shards} shards"))
        if replicas == 1:
            return comm, b.reshape(P_, K // P_, n)
        return comm, comm.replicate(b.reshape(shards, K // shards, n))
    w = comm.span[1] - comm.span[0]
    if (K % w if w else K):
        raise ValueError(f"{name} has {K} rows, not divisible over this "
                         f"process's {w} ranks")
    # an empty span's blocks keep a rank's shape: the slabs every process
    # sends are alike (``ProcessComm.replicate`` sends B's blocks)
    blocks = b.reshape(w, K // w if w else plan.meta["k_local"], n)
    return comm, blocks if replicas == 1 else comm.replicate(blocks)


# ---------------------------------------------------------------------------
# flat executor (paper §5 / Fig. 1)
# ---------------------------------------------------------------------------


def flat_spmm(plan: FlatExecPlan, b_global: torch.Tensor,
              comm: Optional[LocalComm] = None,
              backend: Optional[BackendSpec] = None,
              overlap: bool = False) -> torch.Tensor:
    """Execute ``C = A @ B`` with the flat SHIRO schedule over P ranks.

    ``b_global``: [K, N] dense matrix on the plan's device, row-partitioned
    into P equal blocks (rank p holds rows [p·K/P, (p+1)·K/P)), or a
    one-element list holding it to donate it (``_operand``).
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
    donated = isinstance(b_global, list)
    comm, b_loc = _rank_blocks(plan, comm, _operand(b_global))
    del b_global  # from here on b_loc holds B; dropped after its last read
    w, n = b_loc.shape[0], b_loc.shape[2]  # w: the ranks on hand

    # Every read of B comes first: ②'s partial C rows (row-based, Fig.
    # 1(c): computed against the LOCAL B block), ①'s pack, and ③'s
    # diagonal last (``_diag``). The collectives keep their order (B rows
    # first), and each compute its addition chain.
    if sched.kind == "single":
        partials = be.compute(pieces["rowp"], b_loc, P_ * plan.max_c)
        send_b = pack_rows_op(b_loc, plan.b_send_idx)  # [P, P, max_b, N]
        c = _diag(be, pieces["diag"], b_loc, m_local, donated)
        del b_loc

        # ① exchange B rows (column-based comm, Fig. 1(b)); ② exchange
        #   the partials
        recv_b = comm.all_to_all(send_b)
        recv_c = comm.all_to_all(partials.reshape(w, P_, plan.max_c, n))

        # ③ local compute: column-covered remote nonzeros
        c = c + be.compute(pieces["colp"],
                           recv_b.reshape(w, P_ * plan.max_b, n), m_local)

        # ④ result aggregation: scatter received partial C rows
        c = scatter_add_rows_exec_op(
            c, recv_c.reshape(w, P_ * plan.max_c, n),
            plan.agg_perm, plan.agg_meta)
    elif not overlap:
        b_segments: Segments = plan.meta["b_segments"]
        c_segments: Segments = plan.meta["c_segments"]
        # partial C rows straight into the bucketed send space; B packed
        # once
        partials = be.compute(pieces["rowp"], b_loc, plan.meta["R_c"])
        send_b = pack_rows_op(b_loc, plan.b_send_idx)  # [P, R_b, N]
        c = _diag(be, pieces["diag"], b_loc, m_local, donated)
        del b_loc

        # ① one ppermute per scheduled shift — each padded only to its
        #   round's slot ceiling; ② the partials, shift by shift
        recv_b = _exchange_segments(b_segments, comm.shift, plan.meta["R_b"],
                                    _slice_fetch(send_b), send_b)
        recv_c = _exchange_segments(c_segments, comm.shift, plan.meta["R_c"],
                                    _slice_fetch(partials), partials)

        # ③ local compute against the bucketed receive space
        c = c + be.compute(pieces["colp"], recv_b, m_local)

        # ④ aggregation of received partials
        c = scatter_add_rows_exec_op(c, recv_c, plan.agg_perm, plan.agg_meta)
    else:
        _need_overlap_layouts(plan, "flat_exec_arrays")
        b_segments = plan.meta["b_segments"]
        c_segments = plan.meta["c_segments"]
        # ② per-round partial C rows, one rowp slice per round
        partials = [be.compute(pieces[f"rowp@{i}"], b_loc, slot)
                    for i, (_, _, slot) in enumerate(c_segments)]
        send_b = pack_rows_op(b_loc, plan.b_send_idx)  # [P, R_b, N]
        c = _diag(be, pieces["diag"], b_loc, m_local, donated)
        del b_loc
        acc = torch.zeros_like(c)

        # ① every B round is issued up front; ② each partial round
        #   departs on its own shift (and its unsent slice is released)
        recv_b = [comm.shift(send_b[:, off:off + slot], d)
                  for d, off, slot in b_segments]
        partials.reverse()
        recv_c = [comm.shift(partials.pop(), d) for d, _, _ in c_segments]

        # ④ consume B rounds in order: cumulative receive prefix +
        #   segment-accumulating compute (bit-identical to staged)
        c = c + _colp_rounds(be, pieces, recv_b, acc)

        # ⑤ per-round aggregation of received partials
        c = _aggregate_rounds(c, recv_c, plan.seg_agg)
    return c.reshape(w * m_local, n)


def _diag(be: LocalSpmmBackend, piece: Dict[str, torch.Tensor],
          b_loc: torch.Tensor, m_local: int, donated: bool) -> torch.Tensor:
    """③'s diagonal block, B's last read. With B donated (square A) and
    a backend that can (``compute_over``), C's accumulator takes B's own
    storage once the gather has read it, the counterpart of XLA's
    input/output alias: the call then never holds B and C at once."""
    over = getattr(be, "compute_over", None)
    if donated and over is not None and b_loc.shape[1] == m_local:
        return over(piece, b_loc)
    return be.compute(piece, b_loc, m_local)


def _need_overlap_layouts(plan, arrays_fn: str) -> None:
    if not plan.meta.get("overlap_ready"):
        raise ValueError(
            f"overlap=True needs the per-round consumable layouts; "
            f"rebuild with {arrays_fn}(..., overlap_layouts=True)")


def _colp_rounds(be: LocalSpmmBackend, pieces: Pieces,
                 segs: Iterable[torch.Tensor], acc: torch.Tensor
                 ) -> torch.Tensor:
    """The overlapped colp compute: each received segment joins the
    cumulative receive prefix, and segment i's piece ``colp@i``
    accumulates against it — the staged compute's addition chains.
    ``acc`` is the zero [P, m_local, N] accumulator, in B's dtype."""
    prefix = None
    for i, seg in enumerate(segs):
        prefix = seg if prefix is None else torch.cat([prefix, seg], 1)
        acc = backend_compute_segment(be, pieces[f"colp@{i}"], prefix, acc)
    return acc


def _aggregate_rounds(c: torch.Tensor, recv: List[torch.Tensor],
                      seg_agg: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-round sorted scatter-add of received partials (K2), in round
    order — the staged aggregation's slot-order chain."""
    for i, part in enumerate(recv):
        c = scatter_add_rows_exec_op(c, part, seg_agg[f"perm@{i}"],
                                     seg_agg[f"meta@{i}"])
    return c


# ---------------------------------------------------------------------------
# hierarchical executor (paper §6 / Alg. 1)
# ---------------------------------------------------------------------------


def _hier_gathered(all_bg: torch.Tensor, bg_all: Segments, R_bg: int
                   ) -> torch.Tensor:
    """The all_gathered B segments [P, L, R_bg, N] re-laid SEGMENT-major
    ([L·off, L·(off+slot)) per group shift) — the colp index space, and
    the order the overlapped body consumes segments in."""
    P_, L, _, n = all_bg.shape
    parts = [all_bg[:, :, off:off + slot].reshape(P_, L * slot, n)
             for _, off, slot in bg_all]
    return torch.cat(parts, dim=1) if parts else \
        all_bg.new_zeros((P_, L * R_bg, n))


def hier_spmm(plan: HierExecPlan, b_global: torch.Tensor,
              comm: Optional[LocalComm] = None,
              backend: Optional[BackendSpec] = None,
              overlap: bool = False) -> torch.Tensor:
    """Two-tier SHIRO schedule on the (G, L) grid of the P ranks.

    Program order follows paper Alg. 1; Stage I and Stage II each pair a
    group-axis collective with a local-axis one (``comm`` is a
    ``LocalComm(P, groups=G)``, a fresh one when None). ``backend``
    selects the local-compute substrate as in ``flat_spmm``; a bucketed
    schedule (fixed at ``hier_exec_arrays`` time) replaces the two
    inter-group all_to_alls with per-group-shift ppermute rounds and
    serves own-group traffic with a local slice. ``overlap=True``
    round-pipelines a bucketed plan: each group shift's C transfer
    departs straight out of its own intra-group reduce-scatter, and every
    received B slab is gathered and consumed as it lands — the same
    group-axis ppermutes, bit-identical C. Returns C [M, N].
    """
    m_local = plan.meta["m_local"]
    G, L, P_ = plan.G, plan.L, plan.P
    max_bg, max_cg = plan.max_bg, plan.max_cg
    be, pieces = plan.resolve_backend(backend)
    sched = plan.schedule
    donated = isinstance(b_global, list)
    comm, b_loc = _rank_blocks(plan, comm, _operand(b_global), groups=G)
    del b_global  # from here on b_loc holds B; dropped after its last read
    w, n = b_loc.shape[0], b_loc.shape[2]  # w: the ranks on hand

    # Every read of B comes first, as in ``flat_spmm``: the row-based
    # partials, the pack of de-duplicated B rows, and the diagonal last
    # (``_diag``); the collectives keep the order of Alg. 1.
    partials = be.compute(pieces["rowp"], b_loc, G * L * max_cg)
    send_bg = pack_rows_op(b_loc, plan.b_group_send_idx)
    c = _diag(be, pieces["diag"], b_loc, m_local, donated)
    del b_loc

    if sched.kind == "single":
        # Stage I.① (inter-group, column-based): ship de-duplicated B
        # rows once per destination group. Pairs (g, l) <-> (g', l).
        recv_bg = comm.group_all_to_all(send_bg)  # send [P, G, max_bg, N]

        # Stage I.① (intra-group, row-based): pre-aggregate the partials
        # within the source group via reduce-scatter; each member ends up
        # owning the aggregates for destinations that share its local
        # rank (the "representative" of Fig. 6(e)).
        agg = comm.local_psum_scatter(
            partials.reshape(w, G, L * max_cg, n), dim=1)  # [P, G, max_cg, N]

        # Stage II.② (inter-group, row-based): aggregated C rows cross the
        # slow tier once per source group.
        recv_cg = comm.group_all_to_all(agg)

        # Stage II.② (intra-group, column-based): distribute fetched B
        # rows inside the destination group: [P, L(src), G(src), max_bg, N]
        all_bg = comm.local_all_gather(recv_bg)

        c = c + be.compute(pieces["colp"],
                           all_bg.reshape(w, L * G * max_bg, n), m_local)
        c = scatter_add_rows_exec_op(
            c, recv_cg.reshape(w, G * max_cg, n),
            plan.agg_perm, plan.agg_meta)
    elif not overlap:
        R_bg, R_cg = plan.meta["R_bg"], plan.meta["R_cg"]

        # Stage I.① inter-group B fetch, one ppermute per group shift;
        # shift 0 (own group) is a wire-free local slice
        recv_bg = _exchange_segments(
            plan.meta["bg_segments"], comm.group_shift, R_bg,
            _slice_fetch(send_bg), send_bg, local=plan.meta["local_b"])

        # Stage I.① intra-group pre-aggregation: rowp rows are laid out
        # shift-major — (dg·L + ld)·max_cg + slot — so the aggregated
        # tile for group shift dg sits at agg[:, dg]
        agg = comm.local_psum_scatter(
            partials.reshape(w, G, L * max_cg, n), dim=1)  # [P, G, max_cg, N]

        # Stage II.② inter-group C transfer, bucketed per shift: the send
        # slab for shift dg is the pre-aggregated tile agg[:, dg]
        recv_cg = _exchange_segments(
            plan.meta["cg_segments"], comm.group_shift, R_cg,
            lambda dg, off, slot: agg[:, dg, :slot], agg,
            local=plan.meta["local_c"])

        # Stage II.② intra-group B distribution, re-laid segment-major
        all_bg = comm.local_all_gather(recv_bg)  # [P, L, R_bg, N]
        gathered = _hier_gathered(all_bg, plan.meta["bg_all"], R_bg)

        c = c + be.compute(pieces["colp"], gathered, m_local)
        c = scatter_add_rows_exec_op(c, recv_cg, plan.agg_perm,
                                     plan.agg_meta)
    else:
        _need_overlap_layouts(plan, "hier_exec_arrays")

        # Stage I.① inter-group B fetch, issued round by round; the
        # shift-0 own-group segment never touches the wire
        b_segs = []
        for dg, off, slot in plan.meta["bg_all"]:
            seg = send_bg[:, off:off + slot]
            b_segs.append(comm.group_shift(seg, dg) if dg else seg)

        # Stage I.① intra-group pre-aggregation, one reduce-scatter per
        # consumed group shift — round dg's inter-group C transfer
        # departs as soon as ITS tile is aggregated
        partials = partials.reshape(w, G, L * max_cg, n)
        c_segs = []
        for dg, off, slot in plan.meta["cg_all"]:
            seg = comm.local_psum_scatter(partials[:, dg], dim=0)[:, :slot]
            c_segs.append(comm.group_shift(seg, dg) if dg else seg)

        # Stage II: gather and consume each B slab as it lands
        gathered = (comm.local_all_gather(seg).flatten(1, 2)
                    for seg in b_segs)
        c = c + _colp_rounds(be, pieces, gathered, torch.zeros_like(c))

        # per-round aggregation of the inter-group partials
        c = _aggregate_rounds(c, c_segs, plan.seg_agg)
    return c.reshape(w * m_local, n)


# ---------------------------------------------------------------------------
# replicated executor (1.5D: c lanes + replica-axis reduce-scatter)
# ---------------------------------------------------------------------------


def _lane_exchange(comm: LocalComm, rounds: LaneRounds, buf: torch.Tensor,
                   total: int) -> torch.Tensor:
    """One lane exchange per round over the packed [P, total, N] send
    space; each round's segment comes back at its own offset."""
    segments = tuple((i, off, slot)
                     for i, (_, slot, off, _) in enumerate(rounds))
    return _exchange_segments(
        segments, lambda x, i: comm.lane_shift(x, rounds[i][0], rounds[i][3]),
        total, _slice_fetch(buf), buf)


def replicated_spmm(plan: ReplicatedExecPlan, b_global: torch.Tensor,
                    comm: Optional[LocalComm] = None,
                    backend: Optional[BackendSpec] = None,
                    overlap: bool = False) -> torch.Tensor:
    """Execute ``C = A @ B`` on the (c, s) replica × shard layout.

    ``b_global``: [K, N] dense matrix on the plan's device, split into s
    row blocks; every lane holds all s of them (the c-fold B copy).
    ``comm`` is a ``LocalComm(c·s, replicas=c)`` (a fresh one when None).
    Per round, every participating lane exchanges on ITS OWN shift in one
    lane exchange; lanes outside it receive zeros, and their pieces carry
    no nonzeros in the segment. After the lane-local compute and
    aggregation, the lanes' partial C blocks are summed and split over
    the replica axis (``replica_psum_scatter``). ``backend`` as in
    ``flat_spmm``. Returns C [M, N] in global row order; on a process's
    span, its ranks' C chunks in rank order (rank (r, g) holds rows
    g·m_local + r·m_local/c onward, ``ProcessComm.replica_psum_scatter``).
    """
    if overlap:
        raise ValueError(
            "the replicated executor is staged-only; overlap composes "
            "with replicate=1 tiers (flat/hier) instead")
    m_local = plan.meta["m_local"]
    R_b, R_c = plan.meta["R_b"], plan.meta["R_c"]
    be, pieces = plan.resolve_backend(backend)
    comm, b_loc = _rank_blocks(plan, comm, _operand(b_global),
                               replicas=plan.c)
    n = b_loc.shape[2]

    # ① pack + lane-exchange B rows, one lane exchange per round
    send_b = pack_rows_op(b_loc, plan.b_send_idx)  # [P, R_b, N]
    recv_b = _lane_exchange(comm, plan.meta["b_rounds"], send_b, R_b)

    # ② partial C rows for this lane's shifts, exchanged per round
    partials = be.compute(pieces["rowp"], b_loc, R_c)  # [P, R_c, N]
    recv_c = _lane_exchange(comm, plan.meta["c_rounds"], partials, R_c)

    # ③ lane-local compute: the diagonal (lane 0 only, by construction)
    #   + this lane's column-covered nonzeros
    c = be.compute(pieces["diag"], b_loc, m_local)
    c = c + be.compute(pieces["colp"], recv_b, m_local)

    # ④ aggregate received partials, then sum + split the lanes' C blocks
    #   over the replica axis: [s, c, m_local / c, N] in global row order
    c = scatter_add_rows_exec_op(c, recv_c, plan.agg_perm, plan.agg_meta)
    return comm.replica_psum_scatter(c).flatten(0, -2)
