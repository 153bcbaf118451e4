"""One front door: ``compile_spmm`` — a planned, autotuned DistSpmm handle.

Port of ``repro/core/api.py`` for the flat, hierarchical and replicated
executors:

    cfg = SpmmConfig(backends=("coo", "bsr"), hier="auto")
    h   = compile_spmm(a, 8, cfg)        # plan + autotune + prepare, once
    c   = h(b)                           # C = A @ B on the card
    h.stats()                            # what it decided, and why
    h.save("plan.shiro-torch")           # ship the host-side plan
    h2  = DistSpmm.load("plan.shiro-torch")   # no MWVC re-run

The same handle serves the SDDMM / FusedMM kernel family on the same
plan (``compile_sddmm`` / ``compile_fused``, or per call):

    vals = h(x, y, kernel="sddmm")       # A ⊙ (x yᵀ), per piece
    c    = h(x, y, b, kernel="fused", edge="leaky_relu")

The decision procedure is the reference's model-only path, on the same
host code (``core.planner`` / ``comm_schedule`` / ``comm_model`` are
copies), so the decisions are the reference's:

1. ``build_plan(a, P, strategy, pad_to)`` — the flat SHIRO plan (MWVC).
2. flat vs hierarchical: ``hier="auto"`` groups the P ranks as (G, L) by
   ``Topology.auto_grouping`` (one device has no tiers, so the largest
   L | P with 2 <= L <= ``net.group_size``) and keeps the two-tier
   executor iff ``modeled_time_hier`` beats ``modeled_time``; ``(G, L)``
   forces it.
3. schedule: ``"auto"`` sweeps K = 1..k_max bucketed ppermute schedules
   against the single max-padded all_to_all (``choose_schedule``, or
   ``choose_hier_schedule`` over the group axis on the hier tier),
   co-optimised with the execution mode; ``"single"`` keeps the one
   round; an int K forces that bucketing.
4. execution mode: ``overlap="auto"`` runs the round-pipelined body iff
   ``modeled_time_overlap`` beats the staged total (``kernel="spmm"``
   only: the SDDMM and fused executors always run staged, and the fused
   kernel picks its schedule with its own α-β model).
5. replication (``kernel="spmm"`` only): ``replicate="auto"`` sweeps
   c ∈ {2, 4, 8} lanes of s = P/c shards (under ``memory_budget``) and
   keeps the 1.5D tier iff ``modeled_time_replicated`` beats the chosen
   flat / hier time; an int c > 1 forces it (staged).
6. every backend in ``backends`` gets its layout prepared once and moved
   to the device; calls pick among them (``h(b, backend="bsr")``).

The P ranks are emulated on ONE device (``distributed.topology``): the
handle's tensors live on ``device`` (default ``"cuda"``; raises without a
card, ``device="cpu"`` runs the kernels' plain versions). On a
``Topology.multiprocess`` fleet every process plans the same handle (the
planner is deterministic host code), keeps only its span of the exec
arrays on its device, takes its rows of each operand
(``Topology.put_global``) and returns its rows of C, whose global row
ranges ``h.row_blocks()`` names; the collectives run through a
``ProcessComm``, and measured autotuning stays model-only there, as in
the reference. Calls are
differentiable where the reference's are (``kernels.ops``), on one
device and on a fleet alike (the crossing exchanges' backward runs in
reverse across the processes, ``ProcessComm``): coo SpMM on every tier,
coo and bsr SDDMM, coo FusedMM; a bsr SpMM or FusedMM call on an operand
that requires grad raises, as the reference has no JVP for its K3 / K4.
``make_spmm_fn`` closes a handle or an exec plan over model code.

``measure=True`` (or an autotune cache directory, ``REPRO_AUTOTUNE_CACHE``)
overlays timed profiling on the model's choice (``core.autotune``):
the model's top candidates run on the device and the fastest wins,
cached on disk per (pattern, topology, versions, config).
``compile_spmm`` is the one-rung form of ``core.session.SpmmSession``
(P ladders, drift-triggered replans with warm hot swaps, values-only
refreshes, bundle save / load).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..distributed.comm import LocalComm
from ..distributed.topology import Topology
from ..launch.memory import executable_memory
from ..robustness import faults, guards
from .comm_model import (
    NetworkSpec, choose_fused_schedule, choose_hier_fused_schedule,
    choose_hier_schedule, choose_schedule, modeled_time,
    modeled_time_fused_schedule, modeled_time_hier,
    modeled_time_hier_fused_schedule, modeled_time_hier_overlap,
    modeled_time_hier_schedule, modeled_time_hier_staged,
    modeled_time_overlap, modeled_time_replicated, modeled_time_schedule,
    modeled_time_staged, replicated_device_bytes,
)
from .comm_schedule import (
    CommSchedule, ReplicatedSchedule, build_comm_schedule,
    build_hier_comm_schedule, build_replicated_schedule,
    single_round_hier_schedule, single_round_schedule,
)
from .dist_sddmm import EDGE_FNS, flat_fused, flat_sddmm, hier_fused, hier_sddmm
from .dist_spmm import (
    BackendSpec, FlatExecPlan, HierExecPlan, ReplicatedExecPlan,
    flat_exec_arrays, flat_spmm, hier_exec_arrays, hier_spmm,
    replicated_exec_arrays, replicated_spmm,
)
from .hierarchy import HierPlan, build_hier_plan
from .local_backend import get_backend
from .planner import SpmmPlan, Strategy, build_plan, replicate_plan
from .sparse import CSRMatrix, PatternSnapshot

__all__ = ["SpmmConfig", "DistSpmm", "compile_spmm", "compile_sddmm",
           "compile_fused", "make_spmm_fn", "register_lowering_hook",
           "unregister_lowering_hook"]

_SCHEDULE_POLICIES = ("auto", "single")
_KERNELS = ("spmm", "sddmm", "fused")
_UNSET = object()
_SAVE_FORMAT = "repro_torch.DistSpmm"
_SAVE_VERSION = 1
_KNOWN_VERSIONS = (1,)

# hooks called as hook(handle, key) each time a handle makes a NEW memo
# entry — the port's counterpart of the reference's fresh lowering, and
# the same keys: (n_cols, dtype_name, backend) for spmm calls and
# "sddmm" / "fused"-tagged tuples for the sibling kernels
_LOWERING_HOOKS: List[Callable[["DistSpmm", Tuple[Any, ...]], None]] = []


def register_lowering_hook(fn: Callable) -> Callable:
    """Install a callback fired on every new memo entry of a handle."""
    _LOWERING_HOOKS.append(fn)
    return fn


def unregister_lowering_hook(fn: Callable) -> None:
    _LOWERING_HOOKS.remove(fn)


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    """Everything ``compile_spmm`` needs beyond the matrix and the ranks.

    ``strategy``       planner cover strategy ('block'|'col'|'row'|'joint').
    ``kernel``         which kernel family calls run by default:
                       ``"spmm"`` (C = A @ B), ``"sddmm"`` (sampled
                       dense-dense: values = A ⊙ (X Yᵀ) on A's pattern)
                       or ``"fused"`` (FusedMM: C = edge(A ⊙ (X Yᵀ)) @ B
                       through ONE communication phase). All three share
                       the plan and schedule; per-call selectable like
                       ``backend=``: ``h(x, y, b, kernel="fused")``.
                       Non-spmm kernels always execute staged.
    ``edge``           zero-preserving edge nonlinearity applied to the
                       sampled values of ``"sddmm"``/``"fused"`` calls, a
                       name from ``dist_sddmm.EDGE_FNS`` (``"leaky_relu"``,
                       ``"relu"``) or None.
    ``hier``           None = flat executor; ``(G, L)`` forces the
                       two-tier executor on a (G, L) grid of the ranks;
                       ``"auto"`` derives (G, L) from ``net.group_size``
                       and keeps it iff the α-β model says it wins.
    ``backends``       local-compute layouts to prepare (names or
                       LocalSpmmBackend instances); calls select per call.
    ``default_backend`` name used when ``h(b)`` gets no ``backend=``
                       (default: the first entry of ``backends``).
    ``schedule``       ``"auto"`` = model-picked (single vs bucketed
                       K=1..k_max); ``"single"`` = the max-padded
                       all_to_all; an int K forces a K-class schedule.
    ``overlap``        ``"auto"`` = round-pipelined execution iff the α-β
                       model says it beats staged; ``True`` forces it on
                       bucketed schedules; ``False`` keeps staged.
    ``net``            NetworkSpec the autotuner scores against;
                       ``"auto"`` takes the topology's (the TSUBAME-like
                       model network on a flat substrate).
    ``pad_to``         slot-count rounding forwarded to ``build_plan``.
    ``n_dense_hint``   dense column count the model evaluates at.
    ``k_max``          upper bound of the schedule-K sweep under "auto".
    ``drift_threshold`` sparsity-pattern Jaccard distance above which a
                       live operand no longer matches the planned
                       snapshot: ``SpmmSession.maybe_replan`` re-plans
                       past it, and ``h.stats()["drift"]`` reports the
                       last measured value either way.
    ``donate``         hand the handle's private copy of B (made when B
                       is a numpy array, lives on another device or is
                       not contiguous) to the executor, which releases
                       it after its last read so the allocator can give
                       its block to the partials or C (C bit-identical
                       either way; a caller's tensor is never written or
                       consumed). Applied on square operands of
                       ``kernel="spmm"`` handles that are not replicated,
                       and skipped for a B that requires grad.
    ``measure``        timed candidate profiling on top of the α-β model:
                       ``True`` times the model's top ``profile_topk``
                       candidates on the device, ``False`` stays
                       model-only, ``"auto"`` (default) measures iff an
                       autotune cache directory is configured (env
                       ``REPRO_AUTOTUNE_CACHE``); ``REPRO_MEASURE=0``/``1``
                       overrides either way. See ``core.autotune``.
    ``memory_budget``  per-rank byte budget (None = no limit); the
                       ``replicate="auto"`` sweep drops candidates whose
                       ``replicated_device_bytes`` exceed it, and
                       ``SpmmSession.build`` skips ladder rungs whose
                       estimated (or measured) allocation exceeds it.
    ``profile_topk``   how many model-ranked candidates to time.
    ``profile_iters``  timed runs per candidate (the median is kept).
    ``profile_warmup`` discarded warmup runs per candidate.
    ``check``          ``"auto"``: validate B before the kernels, validate
                       the sparse values at plan time, sampled isfinite
                       sweep of each C; ``"full"``/``True``: sweep every
                       row; ``False``: none of it.
    ``replicate``      1.5D replication factor ``c``: B is copied to
                       ``c`` lanes of ``s = P/c`` shards, each lane covers
                       a disjoint subset of the nonzero shifts, and the
                       partial C is reduce-scattered over the replica
                       axis. ``1`` (default) keeps the flat / hier
                       executors untouched; an int ``c > 1`` forces a
                       c-lane plan (raising if P, the row blocks or the
                       B partition don't divide); ``"auto"`` sweeps
                       feasible c ∈ {2, 4, 8} under ``memory_budget``
                       and keeps the winner iff
                       ``modeled_time_replicated`` beats the chosen flat
                       / hier time. Only ``kernel="spmm"``; c > 1 runs
                       staged (no ``overlap``).
    """

    strategy: Strategy = "joint"
    kernel: str = "spmm"
    edge: Optional[str] = None
    hier: Union[str, Tuple[int, int], None] = None
    backends: Tuple[BackendSpec, ...] = ("coo",)
    default_backend: Optional[str] = None
    schedule: Union[str, int] = "auto"
    overlap: Union[str, bool] = "auto"
    net: Union[str, NetworkSpec] = "auto"
    pad_to: int = 1
    n_dense_hint: int = 64
    k_max: int = 4
    drift_threshold: float = 0.1
    donate: bool = True
    measure: Union[str, bool] = "auto"
    memory_budget: Optional[int] = None
    profile_topk: int = 3
    profile_iters: int = 3
    profile_warmup: int = 1
    check: Union[str, bool] = "auto"
    replicate: Union[int, str] = 1

    def __post_init__(self) -> None:
        if self.kernel not in _KERNELS:
            raise ValueError(
                f"kernel must be one of {_KERNELS}; got {self.kernel!r}")
        if self.edge is not None:
            if self.edge not in EDGE_FNS:
                raise ValueError(
                    f"edge must be None or one of "
                    f"{tuple(sorted(EDGE_FNS))}; got {self.edge!r}")
            if self.kernel == "spmm":
                raise ValueError(
                    "edge= applies to the sampled values of "
                    "kernel='sddmm'/'fused'; kernel='spmm' has none")
        if not (self.hier is None or self.hier == "auto"
                or (isinstance(self.hier, tuple) and len(self.hier) == 2)):
            raise ValueError(f"hier must be None, 'auto' or a (G, L) tuple; "
                             f"got {self.hier!r}")
        if self.check not in ("auto", "full", True, False):
            raise ValueError(f"check must be 'auto', 'full', True or False; "
                             f"got {self.check!r}")
        if isinstance(self.schedule, bool) or not (
                self.schedule in _SCHEDULE_POLICIES
                or (isinstance(self.schedule, int) and self.schedule >= 1)):
            raise ValueError(f"schedule must be 'auto', 'single' or an int "
                             f"K >= 1; got {self.schedule!r}")
        if self.overlap not in ("auto", True, False):
            raise ValueError(f"overlap must be 'auto', True or False; "
                             f"got {self.overlap!r}")
        if not self.backends:
            raise ValueError("at least one backend is required")
        if not (self.net == "auto" or isinstance(self.net, NetworkSpec)):
            raise ValueError(f"net must be 'auto' or a NetworkSpec; "
                             f"got {self.net!r}")
        if not (0.0 <= float(self.drift_threshold) <= 1.0):
            raise ValueError(
                f"drift_threshold is a Jaccard distance in [0, 1]; "
                f"got {self.drift_threshold!r}")
        if self.measure not in ("auto", True, False):
            raise ValueError(f"measure must be 'auto', True or False; "
                             f"got {self.measure!r}")
        if self.memory_budget is not None and int(self.memory_budget) <= 0:
            raise ValueError(
                f"memory_budget is a per-rank byte count > 0 (or None); "
                f"got {self.memory_budget!r}")
        if isinstance(self.replicate, bool) or not (
                self.replicate == "auto"
                or (isinstance(self.replicate, int) and self.replicate >= 1)):
            raise ValueError(
                f"replicate must be 'auto' or an int c >= 1; "
                f"got {self.replicate!r}")
        if self.replicate != 1 and self.kernel != "spmm":
            raise ValueError(
                f"replicate= applies to kernel='spmm' only; the sddmm/"
                f"fused executors have no replicated tier yet "
                f"(got kernel={self.kernel!r}, "
                f"replicate={self.replicate!r})")
        if int(self.profile_topk) < 1 or int(self.profile_iters) < 1 \
                or int(self.profile_warmup) < 0:
            raise ValueError(
                f"profiling needs topk >= 1, iters >= 1, warmup >= 0; got "
                f"topk={self.profile_topk!r} iters={self.profile_iters!r} "
                f"warmup={self.profile_warmup!r}")

    def backend_names(self) -> Tuple[str, ...]:
        return tuple(get_backend(spec).name for spec in self.backends)

    def resolve_net(self, topology: Topology) -> NetworkSpec:
        """The NetworkSpec the autotuner scores against on ``topology``."""
        return topology.network() if self.net == "auto" else self.net


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------


class DistSpmm:
    """A prepared distributed-SpMM handle: ``C = A @ B`` behind one call.

    Built by ``compile_spmm`` / ``compile_sddmm`` / ``compile_fused`` (or
    ``DistSpmm.load``); owns the offline plan (and the ``HierPlan`` on the
    hierarchical tier; on the replicated tier the plan slot holds the
    s-shard base plan and the schedule spans all c·s ranks), the
    autotuned schedule and the prepared backend layouts on the device.
    PyTorch runs eagerly, so an "executable" here is the executor bound
    to one key —
    ``(n_cols, dtype, backend)`` for spmm, ``("sddmm", F, dx, dy, backend,
    edge)`` and ``("fused", F, N, dx, dy, db, backend, edge)`` for the
    siblings; the memo counts first uses (``lowerings``) and hits exactly
    as the reference's AOT cache does, and the first call of each key
    records its device memory (``launch.memory.executable_memory``). An
    executable reads the handle's exec arrays at call time, so a
    values-only ``refresh_values`` keeps every memo entry. ``comm.log``
    holds the last call's collectives.
    """

    def __init__(self, *, config: SpmmConfig, plan: SpmmPlan,
                 hier: Optional[HierPlan],
                 schedule: Union[CommSchedule, ReplicatedSchedule],
                 ex: Union[FlatExecPlan, HierExecPlan, ReplicatedExecPlan],
                 decisions: Dict[str, Any], topology: Topology,
                 snapshot: Optional[PatternSnapshot] = None):
        self.config = config
        self.plan = plan
        self.hier = hier
        self.schedule = schedule
        self.ex = ex
        self.topology = topology
        self.device = topology.device
        self.snapshot = snapshot
        self.last_drift: float = 0.0
        self.decisions = dict(decisions)
        self.kernel = config.kernel
        self.edge = config.edge
        self.overlap = bool(self.decisions.get("overlap", False))
        self.default_backend = (config.default_backend
                                or self.decisions.get("backend")
                                or config.backend_names()[0])
        if self.default_backend not in self.ex.backends:
            raise ValueError(
                f"default_backend {self.default_backend!r} not among "
                f"prepared backends {self.ex.backends}")
        # replicated rungs route by schedule kind: the plan slot holds the
        # s-shard base plan, the ranks are laid out (c, s)
        self.replicated = schedule.kind == "replicated"
        if self.replicated:
            self.comm = topology.replicated_mesh(schedule.c, schedule.s)
        else:
            self.comm = topology.comm(1 if hier is None else hier.G)
        self._executables: Dict[Tuple[Any, ...], Callable] = {}
        # same keys -> executable_memory() profile of the key's first call
        self._memory: Dict[Tuple[Any, ...], Dict[str, int]] = {}
        self.lowerings: List[Tuple[Any, ...]] = []
        self.cache_hits = 0
        self.values_refreshes = 0
        self._check = guards.check_mode(config)
        self.calls = 0
        self.numerical_faults = 0
        # B donation: only where C has B's exact geometry (square A), as
        # the reference's; the sibling kernels take three operands and
        # the replicated tier copies B to every lane, so neither donates
        self._donate = (bool(config.donate) and self.kernel == "spmm"
                        and not self.replicated
                        and plan.shape[0] == plan.shape[1])

    @property
    def strategy(self) -> str:
        """Chosen executor tier: 'flat', 'hier' or 'replicated'."""
        if self.replicated:
            return "replicated"
        return "flat" if self.hier is None else "hier"

    @property
    def P(self) -> int:
        """Ranks the handle spans (c·s on the replicated tier)."""
        return self.schedule.P if self.replicated else self.plan.P

    @property
    def backends(self) -> Tuple[str, ...]:
        return self.ex.backends

    def _memo(self, key: Tuple[Any, ...], make: Callable[[], Callable]
              ) -> Callable:
        fn = self._executables.get(key)
        if fn is not None:
            self.cache_hits += 1
            return fn
        fn = make()
        self._executables[key] = fn
        self.lowerings.append(key)
        for hook in list(_LOWERING_HOOKS):
            hook(self, key)
        return fn

    def _bound(self, fn: Callable, **kw) -> Callable:
        """``fn(self.ex, *operands, comm, **kw)`` with the exec arrays read
        at call time (a values refresh swaps them under the memo)."""
        return lambda *args: fn(self.ex, *args, **kw)

    def _executable(self, n_cols: int, dtype, backend: str) -> Callable:
        if self.replicated:
            fn = replicated_spmm
        else:
            fn = flat_spmm if self.hier is None else hier_spmm
        return self._memo(
            (int(n_cols), _dtype_name(dtype), backend),
            lambda: self._bound(fn, backend=backend, overlap=self.overlap))

    def _sddmm_executable(self, n_feat: int, dtype_x, dtype_y, backend: str,
                          edge: Optional[str]) -> Callable:
        return self._memo(
            ("sddmm", int(n_feat), _dtype_name(dtype_x),
             _dtype_name(dtype_y), backend, edge),
            lambda: self._bound(
                flat_sddmm if self.hier is None else hier_sddmm,
                backend=backend, edge=edge))

    def _fused_executable(self, n_feat: int, n_cols: int, dtype_x, dtype_y,
                          dtype_b, backend: str, edge: Optional[str]
                          ) -> Callable:
        return self._memo(
            ("fused", int(n_feat), int(n_cols), _dtype_name(dtype_x),
             _dtype_name(dtype_y), _dtype_name(dtype_b), backend, edge),
            lambda: self._bound(
                flat_fused if self.hier is None else hier_fused,
                backend=backend, edge=edge))

    def _as_operand(self, b, rows: int) -> torch.Tensor:
        """A dense operand of ``rows`` rows on the handle's substrate:
        whole on one device, this process's rows on a fleet."""
        return self.topology.put_global(b, rows)

    def _rows_for(self, x, rows: int) -> int:
        """The rows a dense operand must have: ``rows``, or, on a fleet,
        this process's share of them when ``x`` is a tensor of that
        share (one handle's output fed to the next): its span's ranks'
        rows, none on an empty span."""
        lo, hi = self.comm.span
        share = rows * (hi - lo) // self.P
        if self.topology.is_multiprocess and isinstance(x, torch.Tensor) \
                and x.dim() == 2 and x.shape[0] == share:
            return share
        return rows

    def row_blocks(self) -> List[Tuple[int, int]]:
        """The global (start, stop) C rows a call returns, in the order it
        returns them: [(0, M)] on one device; on a fleet this process's
        span of the row blocks — one run on the flat and hier tiers, and
        on the replicated tier each rank's chunk (rank (r, g) holds rows
        g·m_local + r·m_local/c onward); none on a process whose span of
        a narrowed fleet is empty."""
        lo, hi = self.comm.span
        M = self.plan.shape[0]
        if not self.topology.is_multiprocess:
            return [(0, M)]
        m_local = self.ex.meta["m_local"]
        if lo == hi:
            return []
        if not self.replicated:
            return [(lo * m_local, hi * m_local)]
        s, ch = self.schedule.s, m_local // self.schedule.c
        return [((p % s) * m_local + (p // s) * ch,
                 (p % s) * m_local + (p // s + 1) * ch)
                for p in range(lo, hi)]

    def _measured(self, key: Tuple[Any, ...], run: Callable[[], Any]):
        """``run()``, recording its device memory on the key's first call
        (operand copies included, as XLA's figure counts arguments)."""
        if key in self._memory:
            return run()
        out, self._memory[key] = executable_memory(run, self.device)
        return out

    def _resolve_call(self, kernel, edge) -> Tuple[str, Optional[str]]:
        """Per-call kernel/edge selection against the config defaults."""
        kern = self.kernel if kernel is None else kernel
        if kern not in _KERNELS:
            raise ValueError(
                f"kernel must be one of {_KERNELS}; got {kern!r}")
        if kern == "spmm":
            if edge is not _UNSET and edge is not None:
                raise TypeError(
                    "edge= applies to the sampled values of "
                    "kernel='sddmm'/'fused'; kernel='spmm' has none")
            return kern, None
        if self.replicated:
            raise ValueError(
                f"kernel={kern!r} has no replicated executor; this "
                f"handle was compiled with replicate="
                f"{self.decisions.get('replicate')} — recompile with "
                f"replicate=1 for sddmm/fused calls")
        edge_name = self.edge if edge is _UNSET else edge
        if edge_name is not None and edge_name not in EDGE_FNS:
            raise ValueError(
                f"edge must be None or one of {tuple(sorted(EDGE_FNS))}; "
                f"got {edge_name!r}")
        return kern, edge_name

    def __call__(self, *operands, backend: Optional[BackendSpec] = None,
                 kernel: Optional[str] = None, edge: Any = _UNSET):
        """One front door for the whole kernel family, memoized per shape.

        Arity follows the (per-call overridable) kernel:

          ``h(b)``          kernel="spmm"  -> C [M, N] = A @ b
          ``h(x, y)``       kernel="sddmm" -> {piece: values} = A ⊙ (x yᵀ)
          ``h(x, y, b)``    kernel="fused" -> C = edge(A ⊙ (x yᵀ)) @ b

        Operands are tensors on any device or numpy arrays: ``b`` is
        [K, N], ``x`` [M, F], ``y`` [K, F]. ``backend`` selects the
        local-compute layout (default: the config's). Under
        ``config.check`` every dense operand is validated first and the
        output gets the sampled isfinite sweep.
        """
        name = self.default_backend if backend is None else \
            get_backend(backend).name
        kern, edge_name = self._resolve_call(kernel, edge)
        arity = {"spmm": 1, "sddmm": 2, "fused": 3}[kern]
        operand_names = {"spmm": "(B)", "sddmm": "(X, Y)",
                         "fused": "(X, Y, B)"}[kern]
        if len(operands) != arity:
            raise TypeError(
                f"kernel={kern!r} takes {arity} operand(s) "
                f"{operand_names}; got {len(operands)}")
        if kern == "sddmm":
            return self._call_sddmm(*operands, name=name, edge=edge_name)
        if kern == "fused":
            return self._call_fused(*operands, name=name, edge=edge_name)
        return self._call_spmm(operands[0], name)

    def _guarded(self, out, check: Callable, what: str):
        """Count the call, then run the sampled isfinite sweep on ``out``."""
        self.calls += 1
        if self._check:
            try:
                with torch.no_grad():
                    check(out, mode=self._check, call_index=self.calls,
                          context=f"DistSpmm(P={self.P}) {what}")
            except guards.NumericalFault:
                self.numerical_faults += 1
                raise
        return out

    def plan_crossing_rows(self) -> int:
        """The padded rows one call's collectives send between processes
        on the handle's topology, B and C together — what
        ``ProcessComm.fleet_rows(crossing=True)`` counts (0 on one
        process): the plan's slow-tier traffic as it is really sent.
        Flat and hier tiers (a hier shift d moves every rank by d·L);
        each rank's process from the topology's span table. On a rung
        whose (G, L) groups straddle a process boundary (a narrowed or
        carved fleet) the local-axis reduce-scatter and all_gather cross
        too, with the slabs the executor's body sends."""
        if self.replicated:
            raise NotImplementedError(
                "plan_crossing_rows covers the flat and hier tiers")
        P, s = self.P, self.schedule
        spans = self.topology.spans or ((0, P),)
        owner = np.repeat(np.arange(len(spans)),
                          [hi - lo for lo, hi in spans])
        stride = 1 if self.hier is None else self.hier.L

        def crossing(d: int) -> int:  # ranks whose shift-d peer is remote
            return sum(int(owner[q] != owner[(q + d * stride) % P])
                       for q in range(P))

        if s.kind == "single":
            rows = (s.max_b + s.max_c) * sum(crossing(d) for d in range(s.P))
        else:
            rows = sum((s.slots_b[d - 1] + s.slots_c[d - 1]) * crossing(d)
                       for d in range(1, s.P))
        return rows + self._local_crossing_rows(owner)

    def _local_crossing_rows(self, owner: np.ndarray) -> int:
        """The hier local axis's rows between processes: (ordered pairs
        of a group's ranks on different processes) × the rows one pair's
        slabs hold in the body's reduce-scatter(s) and all_gather(s)."""
        if self.hier is None:
            return 0
        G, L, ex = self.hier.G, self.hier.L, self.ex
        pairs = sum(int(owner[g * L + a] != owner[g * L + b])
                    for g in range(G) for a in range(L) for b in range(L))
        if not pairs:
            return 0
        if self.schedule.kind == "single":
            per = G * (ex.max_cg + ex.max_bg)
        elif not self.overlap:
            per = G * ex.max_cg + ex.meta["R_bg"]
        else:  # a reduce-scatter per C round, an all_gather per B round
            per = (len(ex.meta["cg_all"]) * ex.max_cg
                   + sum(slot for _, _, slot in ex.meta["bg_all"]))
        return pairs * per

    def _finite_c(self, c, **kw) -> None:
        lo, hi = self.comm.span
        guards.sampled_finite_check(c, ranks=hi - lo, **kw)

    def _call_spmm(self, b, name: str) -> torch.Tensor:
        if self._check:
            guards.validate_dense_operand(
                b, k_expected=self._rows_for(b, self.plan.shape[1]),
                context=f"DistSpmm(P={self.P}) call")
        key = (_width(b), _dtype_name(_operand_dtype(b)), name)
        c = self._measured(key, lambda: self._run_spmm(b, name))
        # chaos hook: nan_poison at site "output" stands in for a broken
        # kernel — fires with or without check, as the real failure would
        c = faults.maybe_poison_array(c, site="output")
        return self._guarded(c, self._finite_c, f"backend={name!r}")

    def _run_spmm(self, b, name: str) -> torch.Tensor:
        b_dev = self._as_operand(b, self.plan.shape[1])
        fn = self._executable(b_dev.shape[1], b_dev.dtype, name)
        self.comm.reset()
        if (self._donate and not _callers_memory(b_dev, b)
                and not b_dev.requires_grad):
            # the handle's private copy: hand the executor the only
            # reference, so it can reuse B's storage after its last read
            held = [b_dev]
            del b_dev
            return fn(held, self.comm)
        return fn(b_dev, self.comm)

    def _call_sddmm(self, x, y, *, name: str, edge: Optional[str]
                    ) -> Dict[str, torch.Tensor]:
        if self._check:
            guards.validate_sddmm_operands(
                x, y, m_expected=self._rows_for(x, self.plan.shape[0]),
                k_expected=self._rows_for(y, self.plan.shape[1]),
                context=f"DistSpmm(P={self.P}) sddmm call")
        key = ("sddmm", _width(x), _dtype_name(_operand_dtype(x)),
               _dtype_name(_operand_dtype(y)), name, edge)

        def run():
            xd = self._as_operand(x, self.plan.shape[0])
            yd = self._as_operand(y, self.plan.shape[1])
            fn = self._sddmm_executable(xd.shape[1], xd.dtype, yd.dtype,
                                        name, edge)
            self.comm.reset()
            return fn(xd, yd, self.comm)

        vals = self._measured(key, run)
        vals = {k: faults.maybe_poison_array(v, site="output")
                for k, v in vals.items()}
        return self._guarded(vals, guards.sampled_finite_check_tree,
                             f"sddmm backend={name!r}")

    def _call_fused(self, x, y, b, *, name: str, edge: Optional[str]
                    ) -> torch.Tensor:
        if self._check:
            ctx = f"DistSpmm(P={self.P}) fused call"
            guards.validate_sddmm_operands(
                x, y, m_expected=self._rows_for(x, self.plan.shape[0]),
                k_expected=self._rows_for(y, self.plan.shape[1]),
                context=ctx)
            guards.validate_dense_operand(
                b, k_expected=self._rows_for(b, self.plan.shape[1]),
                context=ctx)
        key = ("fused", _width(x), _width(b),
               _dtype_name(_operand_dtype(x)), _dtype_name(_operand_dtype(y)),
               _dtype_name(_operand_dtype(b)), name, edge)

        def run():
            M, K = self.plan.shape
            xd, yd, bd = (self._as_operand(x, M), self._as_operand(y, K),
                          self._as_operand(b, K))
            fn = self._fused_executable(xd.shape[1], bd.shape[1], xd.dtype,
                                        yd.dtype, bd.dtype, name, edge)
            self.comm.reset()
            return fn(xd, yd, bd, self.comm)

        c = faults.maybe_poison_array(self._measured(key, run), site="output")
        return self._guarded(c, self._finite_c, f"fused backend={name!r}")

    # ----- lifecycle ---------------------------------------------------

    def warm_from(self, other: "DistSpmm") -> int:
        """Take on every executable ``other`` has served (the hot-swap
        contract of ``SpmmSession.replan``): the first post-swap call of
        each of those keys is a memo hit. Returns how many were warmed."""
        warmed = 0
        for key in list(other._executables):
            if key[0] == "sddmm":
                _, n_feat, dx, dy, backend, edge = key
                if backend not in self.ex.backends:
                    continue
                self._sddmm_executable(n_feat, dx, dy, backend, edge)
            elif key[0] == "fused":
                _, n_feat, n_cols, dx, dy, db, backend, edge = key
                if backend not in self.ex.backends:
                    continue
                self._fused_executable(n_feat, n_cols, dx, dy, db,
                                       backend, edge)
            else:
                n_cols, dtype_name, backend = key
                if backend not in self.ex.backends:
                    continue
                self._executable(n_cols, dtype_name, backend)
            warmed += 1
        return warmed

    def refresh_values(self, *, plan: SpmmPlan, hier: Optional[HierPlan],
                       schedule: Union[CommSchedule, ReplicatedSchedule],
                       decisions: Dict[str, Any],
                       snapshot: Optional[PatternSnapshot]) -> bool:
        """Swap in same-pattern exec arrays, keeping every memo entry.

        The values-only half of a replan: the sparsity pattern (and with
        it the plan structure, schedule and layouts) is unchanged, only
        the nonzero values moved. The new exec arrays are built from
        ``plan``, compared with the old ones field by field (shape and
        dtype), and moved onto the handle's device; the executables read
        them at call time, so nothing is re-memoized. Returns False
        without touching the handle when the geometry does not match
        (the caller falls back to a full replan).
        """
        overlap = bool(decisions.get("overlap", False))
        replicated = schedule.kind == "replicated"
        if (overlap != self.overlap or replicated != self.replicated
                or (hier is None) != (self.hier is None)):
            return False
        if replicated:
            new_ex = replicated_exec_arrays(schedule.rplan,
                                            backends=self.config.backends,
                                            schedule=schedule)
        elif hier is not None:
            new_ex = hier_exec_arrays(hier, backends=self.config.backends,
                                      schedule=schedule,
                                      overlap_layouts=overlap)
        else:
            new_ex = flat_exec_arrays(plan, backends=self.config.backends,
                                      schedule=schedule,
                                      overlap_layouts=overlap)
        new_ex = _place(new_ex, self.topology)
        old_leaves, new_leaves = _tensor_leaves(self.ex), _tensor_leaves(new_ex)
        if (new_ex.backends != self.ex.backends
                or [p for p, _ in old_leaves] != [p for p, _ in new_leaves]
                or any(o.shape != n.shape or o.dtype != n.dtype
                       for (_, o), (_, n) in zip(old_leaves, new_leaves))):
            return False
        self.plan, self.hier, self.schedule = plan, hier, schedule
        self.decisions = dict(decisions)
        self.ex = new_ex
        self.snapshot = snapshot
        self.last_drift = 0.0
        self.values_refreshes += 1
        return True

    def drift(self, a_new) -> float:
        """Pattern drift of ``a_new`` vs the planned snapshot (Jaccard
        distance in [0, 1]); recorded so ``stats()`` carries the last
        observed value."""
        if self.snapshot is None:
            raise ValueError(
                "this handle carries no pattern snapshot; recompile with "
                "compile_spmm to enable drift detection")
        self.last_drift = self.snapshot.drift(a_new)
        return self.last_drift

    # ----- introspection ----------------------------------------------

    def cache_info(self) -> Dict[str, Any]:
        return {"lowerings": len(self.lowerings),
                "hits": self.cache_hits,
                "keys": tuple(self.lowerings)}

    def stats(self) -> Dict[str, Any]:
        """Autotune decisions + analytic/padded volumes + cache state."""
        plan, sched = self.plan, self.schedule
        out: Dict[str, Any] = dict(self.decisions)
        out.update(
            kernel=self.kernel,
            edge=self.edge,
            strategy=self.strategy,
            plan_strategy=plan.strategy,
            P=plan.P,
            shape=plan.shape,
            backends=self.backends,
            default_backend=self.default_backend,
            schedule_kind=sched.kind,
            schedule_K=sched.K if sched.kind == "bucketed" else 1,
            overlap=self.overlap,
            volume_rows=plan.volume_rows(),
            volume_rows_padded=sched.volume_rows_padded(),
            cache=self.cache_info(),
            drift=self.last_drift,
            drift_threshold=self.config.drift_threshold,
            donated_buffers=("b",) if self._donate else (),
            values_refreshes=self.values_refreshes,
            check=self._check,
            calls=self.calls,
            numerical_faults=self.numerical_faults,
            topology=self.topology.describe(),
            device=str(self.device),
        )
        out.setdefault("decision_source", "model")
        out.setdefault("measured_time", None)
        out.setdefault("replicate", 1)
        if self.replicated:
            # plan.P is the lane width s; the handle spans c·s ranks
            out.update(P=sched.P, replicate=sched.c, replica_shards=sched.s,
                       schedule_K=sched.K)
        # what the first calls measured wins over a profiling-time record
        mem = [m["total_allocation_size"] for m in self._memory.values()
               if m.get("total_allocation_size")]
        out["total_allocation_size"] = (
            max(mem) if mem else self.decisions.get("total_allocation_size"))
        if self.snapshot is not None:
            out["pattern_nnz"] = self.snapshot.nnz
            out["pattern_fingerprint"] = self.snapshot.fingerprint[:12]
        if self.hier is not None:
            out.update(G=self.hier.G, L=self.hier.L,
                       volume_rows_padded_single=single_round_hier_schedule(
                           self.hier).volume_rows_padded())
        else:
            out["volume_rows_padded_single"] = plan.volume_rows_padded()
        return out

    def __repr__(self) -> str:
        sched = self.schedule
        if self.replicated:
            tier = f"replicated(c={sched.c},s={sched.s})"
        elif self.hier is not None:
            tier = f"hier(G={self.hier.G},L={self.hier.L})"
        else:
            tier = "flat"
        return (f"DistSpmm({self.plan.shape[0]}x{self.plan.shape[1]}, "
                f"P={self.P}, {tier}, schedule={sched.kind}"
                f"{f'/K={sched.K}' if sched.kind == 'bucketed' else ''}"
                f"{', overlapped' if self.overlap else ''}"
                f"{f', kernel={self.kernel}' if self.kernel != 'spmm' else ''}"
                f", backends={self.backends}, device={self.device})")

    # ----- serialization ----------------------------------------------

    def save(self, path: str) -> None:
        """Persist the host-side plan (no device state) as a pickle.

        ``load`` rebuilds the exec arrays deterministically, so C is
        bit-identical and MWVC never re-runs. TRUSTED INPUT ONLY:
        unpickling a file executes code from it.
        """
        with open(path, "wb") as f:
            pickle.dump(self.save_payload(), f)

    def save_payload(self) -> Dict[str, Any]:
        """The versioned host-side dict ``save`` pickles (also the
        per-rung unit ``SpmmSession.save`` bundles)."""
        return _payload(self.config, self.plan, self.hier, self.schedule,
                        self.decisions, self.snapshot)

    @classmethod
    def load(cls, path: str, where: Union[Topology, int, None] = None, *,
             device: Union[str, torch.device] = "cuda") -> "DistSpmm":
        """Rebuild a handle from ``save`` output (``where`` defaults to
        the plan's P on ``device``)."""
        if os.path.getsize(path) == 0:
            raise ValueError(f"{path!r} is empty (0 bytes); re-run "
                             f"compile_spmm(...).save()")
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
        except (EOFError, pickle.UnpicklingError) as e:
            raise ValueError(
                f"{path!r} is not a complete saved DistSpmm plan "
                f"({type(e).__name__}: {e}) — the file was truncated or "
                f"corrupted in transit; re-fetch it or re-run "
                f"compile_spmm(...).save().") from None
        if not isinstance(payload, dict) or \
                payload.get("format") != _SAVE_FORMAT:
            raise ValueError(f"{path!r} is not a saved repro_torch DistSpmm")
        return materialize_payload(payload, where, device=device,
                                   source=path)


def _payload(config: SpmmConfig, plan: SpmmPlan, hier: Optional[HierPlan],
             schedule, decisions: Dict[str, Any],
             snapshot: Optional[PatternSnapshot]) -> Dict[str, Any]:
    return {
        "format": _SAVE_FORMAT,
        "version": _SAVE_VERSION,
        "config": config,
        "plan": plan,
        "hier": hier,
        "schedule": schedule,
        "decisions": decisions,
        "snapshot": snapshot,
    }


def check_payload_version(payload: Dict[str, Any], source: str) -> None:
    """Reject plan payloads this library version cannot rebuild."""
    version = payload.get("version")
    if version not in _KNOWN_VERSIONS:
        raise ValueError(
            f"{source!r} carries format version {version!r}; this library "
            f"reads versions {_KNOWN_VERSIONS}. Re-run "
            f"compile_spmm(...).save() (or SpmmSession.save) with the "
            f"version that will load it; plans are cheap to regenerate "
            f"from the operand matrix.")


def materialize_payload(payload: Dict[str, Any],
                        where: Union[Topology, int, None], *,
                        device: Union[str, torch.device] = "cuda",
                        source: str = "<payload>") -> DistSpmm:
    """Version check + topology check + device prep for a saved plan."""
    check_payload_version(payload, source)
    plan: SpmmPlan = payload["plan"]
    schedule = payload["schedule"]
    # a replicated handle's plan slot holds the s-shard base plan; the
    # handle itself spans schedule.P = c·s ranks
    want_p = (schedule.P if schedule.kind == "replicated" else plan.P)
    topo = Topology.resolve(want_p if where is None else where, device,
                            expect_p=want_p)
    return _materialize(payload["config"], plan, payload.get("hier"),
                        schedule, payload["decisions"], topo,
                        snapshot=payload.get("snapshot"))


# ---------------------------------------------------------------------------
# compilation pipeline
# ---------------------------------------------------------------------------


def _materialize(config: SpmmConfig, plan: SpmmPlan,
                 hier: Optional[HierPlan],
                 schedule: Union[CommSchedule, ReplicatedSchedule],
                 decisions: Dict[str, Any], topo: Topology,
                 snapshot: Optional[PatternSnapshot] = None) -> DistSpmm:
    """Deterministic device-side prep: exec arrays on the device + handle."""
    # the per-round consumable layouts only when execution is overlapped
    overlap = bool(decisions.get("overlap", False))
    if schedule.kind == "replicated":
        ex = replicated_exec_arrays(schedule.rplan, backends=config.backends,
                                    schedule=schedule)
    elif hier is not None:
        ex = hier_exec_arrays(hier, backends=config.backends,
                              schedule=schedule, overlap_layouts=overlap)
    else:
        ex = flat_exec_arrays(plan, backends=config.backends,
                              schedule=schedule, overlap_layouts=overlap)
    return DistSpmm(config=config, plan=plan, hier=hier, schedule=schedule,
                    ex=_place(ex, topo), decisions=decisions,
                    topology=topo, snapshot=snapshot)


def _place(ex, topo: Topology):
    """An exec plan on ``topo``: on a fleet, only this process's span of
    it goes to the device (of a narrowed fleet's span table: shorter
    than its share, or empty)."""
    if topo.is_multiprocess:
        ex = ex.span(*topo.span)
    return ex.to(topo.device)


def _candidate_schedule(plan: SpmmPlan, hier: Optional[HierPlan],
                        kind: str, K: Optional[int]) -> CommSchedule:
    """Deterministically (re)build one candidate's schedule object.

    Shared between the model sweep and ``core.autotune``: a cached
    measured decision replays through here, so a cache hit reproduces
    the exact schedule the profiled run used.
    """
    if hier is not None:
        return (single_round_hier_schedule(hier) if kind == "single"
                else build_hier_comm_schedule(hier, K=int(K)))
    return (single_round_schedule(plan) if kind == "single"
            else build_comm_schedule(plan, K=int(K)))


def _schedule_fields(plan: SpmmPlan, hier: Optional[HierPlan],
                     schedule: CommSchedule, n_hint: int,
                     net: NetworkSpec) -> Dict[str, float]:
    """The three modeled-time decision fields for one candidate."""
    if hier is not None:
        return {
            "modeled_time_schedule": modeled_time_hier_schedule(
                schedule, n_hint, net),
            "modeled_time_staged": modeled_time_hier_staged(
                hier, schedule, n_hint, net),
            "modeled_time_overlap": modeled_time_hier_overlap(
                hier, schedule, n_hint, net),
        }
    return {
        "modeled_time_schedule": modeled_time_schedule(
            plan, schedule, n_hint, net),
        "modeled_time_staged": modeled_time_staged(
            plan, schedule, n_hint, net),
        "modeled_time_overlap": modeled_time_overlap(
            plan, schedule, n_hint, net),
    }


def _plan_and_tune(a: CSRMatrix, P: int, config: SpmmConfig, topo: Topology
                   ) -> Tuple[SpmmPlan, Optional[HierPlan],
                              Union[CommSchedule, ReplicatedSchedule],
                              Dict[str, Any]]:
    """The offline pipeline: MWVC plan + every autotune decision.

    Host-side work, apart from the measured overlay at the end, which
    times candidates on ``topo``'s device when measurement is enabled
    and the plan targets this substrate (``topo.P == P``): ladder rungs
    of another P stay model-only.
    """
    net, n_hint = config.resolve_net(topo), config.n_dense_hint
    kernel = config.kernel
    plan = build_plan(a, P, config.strategy, pad_to=config.pad_to)
    decisions: Dict[str, Any] = {
        "kernel": kernel,
        "net": net.name,
        "net_source": "topology" if config.net == "auto" else "config",
        "n_dense_hint": n_hint,
        "modeled_time_flat": modeled_time(plan, n_hint, net),
    }

    # ----- flat vs hierarchical ---------------------------------------
    hier: Optional[HierPlan] = None
    hier_cand: Optional[HierPlan] = None
    if config.hier is not None:
        if config.hier == "auto":
            gl = (topo.auto_grouping(net) if topo.P == P
                  else _ladder_grouping(P, net))
        else:
            gl = (int(config.hier[0]), int(config.hier[1]))
        if gl is not None:
            G, L = gl
            if G * L != P:
                raise ValueError(f"hier=({G},{L}) incompatible with P={P}")
            hier_cand = build_hier_plan(plan, G, L, pad_to=config.pad_to)
            t_hier = modeled_time_hier(hier_cand, n_hint, net)
            decisions["modeled_time_hier"] = t_hier
            decisions["hier_candidate"] = (G, L)
            if config.hier != "auto" or \
                    t_hier < decisions["modeled_time_flat"]:
                hier = hier_cand

    # ----- communication schedule + execution mode --------------------
    # The "auto" schedule sweep co-optimizes K with the execution mode.
    # Sibling kernels score differently: "fused" moves [Y|B] jointly
    # (width F+N) plus the reversed X rounds, so its own α-β function
    # picks K; "sddmm" moves the same rows as spmm at width F and always
    # executes staged, so the overlap-free sweep applies. n_dense_hint
    # stands in for both F and N.
    if hier is not None:
        if config.schedule == "single":
            schedule = single_round_hier_schedule(hier)
        elif isinstance(config.schedule, int):
            schedule = build_hier_comm_schedule(hier, K=config.schedule)
        elif kernel == "fused":
            schedule, _ = choose_hier_fused_schedule(hier, n_hint, n_hint,
                                                     net, k_max=config.k_max)
        elif kernel == "sddmm" or config.overlap is False:
            schedule, _ = choose_hier_schedule(hier, n_hint, net,
                                               k_max=config.k_max)
        else:
            schedule, _, _ = choose_hier_schedule(hier, n_hint, net,
                                                  k_max=config.k_max,
                                                  overlap=config.overlap)
    elif config.schedule == "single":
        schedule = single_round_schedule(plan)
    elif isinstance(config.schedule, int):
        schedule = build_comm_schedule(plan, K=config.schedule)
    elif kernel == "fused":
        schedule, _ = choose_fused_schedule(plan, n_hint, n_hint, net,
                                            k_max=config.k_max)
    elif kernel == "sddmm" or config.overlap is False:
        schedule, _ = choose_schedule(plan, n_hint, net, k_max=config.k_max)
    else:
        schedule, _, _ = choose_schedule(plan, n_hint, net,
                                         k_max=config.k_max,
                                         overlap=config.overlap)
    fields = _schedule_fields(plan, hier, schedule, n_hint, net)
    decisions.update(fields)
    if kernel == "fused":
        decisions["modeled_time_fused"] = (
            modeled_time_hier_fused_schedule(schedule, n_hint, n_hint, net)
            if hier is not None
            else modeled_time_fused_schedule(plan, schedule, n_hint,
                                             n_hint, net))
    use_overlap = False
    if schedule.kind == "bucketed" and kernel == "spmm":
        if config.overlap is True:
            use_overlap = True
        elif config.overlap == "auto":
            use_overlap = (fields["modeled_time_overlap"]
                           < fields["modeled_time_staged"])
    decisions["overlap"] = use_overlap
    decisions["decision_source"] = "model"

    # ----- replication (1.5D): c lanes of s = P/c shards --------------
    # The only strategy that changes the rank layout itself: B is copied
    # to c lanes, each lane exchanges only its subset of the s-shard
    # shifts over the FAST s-rank tier, and the partial C pays one
    # replica-axis reduce-scatter. Wins at high P where the flat / hier
    # exchange spans the slow tier but s <= group_size stays on the
    # fast one.
    decisions["replicate"] = 1
    replicate = config.replicate
    if kernel == "spmm" and replicate != 1:
        # modeled_time_replicated includes the diagonal-block compute
        # that the staged/overlap fields exclude (it is common to both
        # execution MODES) — add the same term to the unreplicated side
        # so the cross-tier comparison is offset-free
        diag = (max(blk.nnz for blk in plan.a_diag) * 2.0 * n_hint / 1e12
                if plan.a_diag else 0.0)
        t_base = (fields["modeled_time_overlap"] if use_overlap
                  else fields["modeled_time_staged"]) + diag
        budget = (int(config.memory_budget)
                  if config.memory_budget is not None else None)
        cands = (2, 4, 8) if replicate == "auto" else (int(replicate),)
        best: Optional[Tuple[float, int, ReplicatedSchedule]] = None
        infeasible: Dict[int, str] = {}
        for c in cands:
            if P % c or P // c < 2:
                infeasible[c] = f"needs c | P={P} with s = P/c >= 2"
                continue
            s = P // c
            base = build_plan(a, s, config.strategy, pad_to=config.pad_to)
            sizes = {hi - lo for lo, hi in base.bounds}
            m_local = sizes.pop() if len(sizes) == 1 else None
            if m_local is None or m_local % c or base.shape[1] % s:
                infeasible[c] = (
                    f"needs uniform s={s}-way row/col blocks with "
                    f"c={c} | m_local for the tiled replica "
                    f"reduce-scatter (pad M and K first)")
                continue
            rp = replicate_plan(base, c)
            rsched = build_replicated_schedule(rp)
            # the budget prunes only the AUTO sweep (pick a c that fits)
            if replicate == "auto" and budget is not None:
                need = replicated_device_bytes(rp, rsched, n_hint)
                if need > budget:
                    infeasible[c] = (f"replica footprint {need} B/rank "
                                     f"exceeds memory_budget {budget}")
                    continue
            t_rep = modeled_time_replicated(rp, rsched, n_hint, net)
            decisions[f"modeled_time_replicated_c{c}"] = t_rep
            if best is None or t_rep < best[0]:
                best = (t_rep, c, rsched)
        if best is None and replicate != "auto":
            c = int(replicate)
            raise ValueError(
                f"replicate={c} is infeasible: "
                f"{infeasible.get(c, 'no candidate survived')}")
        if best is not None and (replicate != "auto" or best[0] < t_base):
            t_rep, c, rsched = best
            plan = rsched.rplan.base
            hier = None
            schedule = rsched
            decisions["overlap"] = False
            decisions["replicate"] = c
            decisions["modeled_time_replicated"] = t_rep
            decisions["modeled_time_unreplicated"] = t_base

    # ----- measured overlay (timed profiling / on-disk cache) ---------
    # Only when measurement is enabled AND the plan targets THIS
    # substrate: a ladder rung with P != topo.P is not timed. The
    # profiler drives spmm calls, so sibling kernels stay model-only, and
    # so do replicated rungs (their decision is a cross-tier model
    # comparison already) and fleets of processes (each process would
    # time, and could pick, on its own), as in the reference.
    from . import autotune as _autotune

    if (kernel == "spmm" and _autotune.measurement_enabled(config)
            and decisions.get("replicate", 1) == 1 and topo.P == P
            and not topo.is_multiprocess):
        plan, hier, schedule, decisions = _autotune.measured_decide(
            a, P, config, topo, plan=plan, hier=hier,
            hier_cand=hier_cand, schedule=schedule, decisions=decisions)
    return plan, hier, schedule, decisions


def _ladder_grouping(P: int, net: NetworkSpec) -> Optional[Tuple[int, int]]:
    """hier="auto" grouping for a ladder rung whose P differs from the
    topology's: the structureless fallback sweep over P itself."""
    from ..distributed.topology import fallback_grouping

    return fallback_grouping(P, int(net.group_size))


def compile_spmm(a: CSRMatrix, where: Union[Topology, int],
                 config: Optional[SpmmConfig] = None, *,
                 device: Union[str, torch.device] = "cuda",
                 **overrides) -> DistSpmm:
    """Plan, autotune and prepare a distributed SpMM handle for ``a``.

    ``where``: a ``Topology`` or an int P (P ranks emulated on
    ``device``). ``config`` fields can also be passed as keyword
    overrides: ``compile_spmm(a, 8, backends=("coo", "bsr"))``.

    This is the one-rung form of ``SpmmSession``: the session it builds
    owns one ladder rung at the topology's P and is discarded after
    handing out its handle. Keep the session instead
    (``SpmmSession.build``) when the pattern drifts or the ranks resize.
    """
    from .session import SpmmSession

    return SpmmSession.build(a, where, config, device=device,
                             **overrides).handle()


def compile_sddmm(a: CSRMatrix, where: Union[Topology, int],
                  config: Optional[SpmmConfig] = None, *,
                  device: Union[str, torch.device] = "cuda",
                  **overrides) -> DistSpmm:
    """``compile_spmm`` with ``kernel="sddmm"``: the handle's calls take
    the two dense operands and return A-patterned sampled values,
    ``h(x, y) = A ⊙ (x yᵀ)``, through the same autotuned plan."""
    overrides.setdefault("kernel", "sddmm")
    return compile_spmm(a, where, config, device=device, **overrides)


def compile_fused(a: CSRMatrix, where: Union[Topology, int],
                  config: Optional[SpmmConfig] = None, *,
                  device: Union[str, torch.device] = "cuda",
                  **overrides) -> DistSpmm:
    """``compile_spmm`` with ``kernel="fused"``: FusedMM handles —
    ``h(x, y, b) = edge(A ⊙ (x yᵀ)) @ b`` with the SDDMM and SpMM
    phases chained through ONE set of collectives (the B/Y gather rides
    the same rounds, width F+N)."""
    overrides.setdefault("kernel", "fused")
    return compile_spmm(a, where, config, device=device, **overrides)


def make_spmm_fn(ex: Union[DistSpmm, FlatExecPlan, HierExecPlan,
                            ReplicatedExecPlan],
                 comm: Optional[LocalComm] = None,
                 backend: Optional[BackendSpec] = None
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Close a SHIRO executor over its plan for model code (``H -> Â·H``).

    Preferred form: pass a ``DistSpmm`` handle (it owns its comm and its
    executable memo; the closure carries it as ``.handle``). A raw
    ``FlatExecPlan`` / ``HierExecPlan`` / ``ReplicatedExecPlan`` runs its
    executor (staged) with ``comm`` (a fresh ``LocalComm`` on the plan's
    layout per call when None). The closure is differentiable wherever
    the executor is.
    """
    if isinstance(ex, DistSpmm):
        if comm is not None:
            raise TypeError("a DistSpmm handle owns its comm; pass comm= "
                            "only with a raw exec plan")

        def spmm(h):
            return ex(h, backend=backend)
        spmm.handle = ex  # the models' losses read a fleet's rows off it
        return spmm
    fn = {FlatExecPlan: flat_spmm, HierExecPlan: hier_spmm,
          ReplicatedExecPlan: replicated_spmm}.get(type(ex))
    if fn is None:
        raise TypeError(f"make_spmm_fn takes a DistSpmm or an exec plan, "
                        f"got {type(ex).__name__}")
    return lambda h: fn(ex, h, comm, backend=backend)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _operand_dtype(x) -> torch.dtype:
    """The dtype ``DistSpmm._as_operand`` gives ``x`` (numpy's kept)."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, np.asarray(x).dtype)).dtype


def _callers_memory(b_dev: torch.Tensor, b) -> bool:
    """Whether the operand tensor ``b_dev`` made from ``b`` is the caller's
    own memory: ``b`` itself, or, on the CPU, a tensor over the caller's
    numpy array. Anything else is a copy only the handle holds."""
    if isinstance(b, torch.Tensor):
        return b_dev is b
    return (b_dev.device.type == "cpu" and isinstance(b, np.ndarray)
            and b_dev.data_ptr() == b.__array_interface__["data"][0])


def _width(x) -> int:
    """Columns of a dense operand (a tensor, an array or nested lists)."""
    return int(np.shape(x)[1])


def _tensor_leaves(ex) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of an exec plan, in field and key
    order — what ``refresh_values`` compares old and new plans by."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            out.append((path, obj))
        elif isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k], f"{path}/{k}")

    for f in dataclasses.fields(ex):
        if f.name != "meta":
            walk(getattr(ex, f.name), f.name)
    return out
