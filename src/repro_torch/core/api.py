"""One front door: ``compile_spmm`` — a planned, autotuned DistSpmm handle.

Port of ``repro/core/api.py`` for the flat executor:

    cfg = SpmmConfig(backends=("coo", "bsr"))
    h   = compile_spmm(a, 8, cfg)        # plan + autotune + prepare, once
    c   = h(b)                           # C = A @ B on the card
    h.stats()                            # what it decided, and why
    h.save("plan.shiro-torch")           # ship the host-side plan
    h2  = DistSpmm.load("plan.shiro-torch")   # no MWVC re-run

The decision procedure is the reference's model-only path, on the same
host code (``core.planner`` / ``comm_schedule`` / ``comm_model`` are
copies), so the decisions are the reference's:

1. ``build_plan(a, P, strategy, pad_to)`` — the flat SHIRO plan (MWVC).
2. schedule: ``"auto"`` sweeps K = 1..k_max bucketed ppermute schedules
   against the single max-padded all_to_all (``choose_schedule``),
   co-optimised with the execution mode; ``"single"`` keeps the one
   round; an int K forces that bucketing.
3. execution mode: ``overlap="auto"`` runs the round-pipelined body iff
   ``modeled_time_overlap`` beats the staged total.
4. every backend in ``backends`` gets its layout prepared once and moved
   to the device; calls pick among them (``h(b, backend="bsr")``).

The P ranks are emulated on ONE device (``distributed.topology``): the
handle's tensors live on ``device`` (default ``"cuda"``; raises without a
card, ``device="cpu"`` runs the kernels' plain versions). The
hierarchical executor, replication, measured autotuning, SDDMM/fused
kernels and sessions are later slices of the port: a config that asks for
them raises ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import pickle
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..distributed.comm import LocalComm
from ..distributed.topology import Topology
from ..robustness import guards
from .comm_model import (
    NetworkSpec, choose_schedule, modeled_time, modeled_time_overlap,
    modeled_time_schedule, modeled_time_staged,
)
from .comm_schedule import (
    CommSchedule, build_comm_schedule, single_round_schedule,
)
from .dist_spmm import BackendSpec, FlatExecPlan, flat_exec_arrays, flat_spmm
from .local_backend import get_backend
from .planner import SpmmPlan, Strategy, build_plan
from .sparse import CSRMatrix, PatternSnapshot, pattern_snapshot

__all__ = ["SpmmConfig", "DistSpmm", "compile_spmm"]

_SCHEDULE_POLICIES = ("auto", "single")
_SAVE_FORMAT = "repro_torch.DistSpmm"
_SAVE_VERSION = 1


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, open item "
        f"{item}); use the JAX package (repro) for it meanwhile")


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    """Everything ``compile_spmm`` needs beyond the matrix and the ranks.

    ``strategy``       planner cover strategy ('block'|'col'|'row'|'joint').
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
    ``check``          ``"auto"``: validate B before the kernels, validate
                       the sparse values at plan time, sampled isfinite
                       sweep of each C; ``"full"``/``True``: sweep every
                       row; ``False``: none of it.

    Fields of the reference the port does not run yet — ``kernel`` other
    than "spmm", ``edge``, ``hier``, ``replicate`` other than 1,
    ``measure=True`` — raise ``NotImplementedError``.
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
    measure: Union[str, bool] = "auto"
    check: Union[str, bool] = "auto"
    replicate: Union[int, str] = 1

    def __post_init__(self) -> None:
        if self.kernel != "spmm" or self.edge is not None:
            raise _not_ported(f"kernel={self.kernel!r}/edge={self.edge!r} "
                              f"(SDDMM / FusedMM)", "8")
        if self.hier is not None:
            raise _not_ported(f"hier={self.hier!r} (the hierarchical "
                              f"executor)", "7")
        if self.replicate != 1:
            raise _not_ported(f"replicate={self.replicate!r} (1.5D "
                              f"replication)", "10")
        if self.measure is True:
            raise _not_ported("measure=True (measured autotuning)", "11")
        if self.measure not in ("auto", False):
            raise ValueError(f"measure must be 'auto', True or False; "
                             f"got {self.measure!r}")
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

    Built by ``compile_spmm`` (or ``DistSpmm.load``); owns the offline
    plan, the autotuned schedule and the prepared backend layouts on the
    device. PyTorch runs eagerly, so an "executable" here is the executor
    bound to one ``(n_cols, dtype, backend)`` key; the memo counts
    first uses (``lowerings``) and hits exactly as the reference's AOT
    cache does. ``comm.log`` holds the last call's collectives.
    """

    def __init__(self, *, config: SpmmConfig, plan: SpmmPlan,
                 schedule: CommSchedule, ex: FlatExecPlan,
                 decisions: Dict[str, Any], topology: Topology,
                 snapshot: Optional[PatternSnapshot] = None):
        self.config = config
        self.plan = plan
        self.schedule = schedule
        self.ex = ex
        self.topology = topology
        self.device = topology.device
        self.snapshot = snapshot
        self.decisions = dict(decisions)
        self.overlap = bool(self.decisions.get("overlap", False))
        self.default_backend = (config.default_backend
                                or config.backend_names()[0])
        if self.default_backend not in self.ex.backends:
            raise ValueError(
                f"default_backend {self.default_backend!r} not among "
                f"prepared backends {self.ex.backends}")
        self.comm = LocalComm(plan.P)
        self._executables: Dict[Tuple[Any, ...], Callable] = {}
        self.lowerings: List[Tuple[Any, ...]] = []
        self.cache_hits = 0
        self._check = guards.check_mode(config)
        self.calls = 0
        self.numerical_faults = 0

    @property
    def strategy(self) -> str:
        """Chosen executor tier (only 'flat' in this slice)."""
        return "flat"

    @property
    def backends(self) -> Tuple[str, ...]:
        return self.ex.backends

    def _executable(self, n_cols: int, dtype: torch.dtype, backend: str
                    ) -> Callable:
        key = (int(n_cols), str(dtype).replace("torch.", ""), backend)
        fn = self._executables.get(key)
        if fn is not None:
            self.cache_hits += 1
            return fn
        fn = functools.partial(flat_spmm, self.ex, backend=backend,
                               overlap=self.overlap)
        self._executables[key] = fn
        self.lowerings.append(key)
        return fn

    def _as_operand(self, b) -> torch.Tensor:
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        return b.to(self.device).contiguous()

    def __call__(self, b, *, backend: Optional[BackendSpec] = None
                 ) -> torch.Tensor:
        """C [M, N] = A @ b on the handle's device.

        ``b`` is [K, N] (a tensor on any device or a numpy array).
        ``backend`` selects the local-compute layout (default: the
        config's). Under ``config.check`` b is validated first and C gets
        the sampled isfinite sweep.
        """
        name = self.default_backend if backend is None else \
            get_backend(backend).name
        context = f"DistSpmm(P={self.plan.P})"
        if self._check:
            guards.validate_dense_operand(b, k_expected=self.plan.shape[1],
                                          context=f"{context} call")
        b = self._as_operand(b)
        fn = self._executable(b.shape[1], b.dtype, name)
        self.comm.reset()
        c = fn(b, self.comm)
        self.calls += 1
        if self._check:
            try:
                guards.sampled_finite_check(
                    c, ranks=self.plan.P, mode=self._check,
                    call_index=self.calls,
                    context=f"{context} backend={name!r}")
            except guards.NumericalFault:
                self.numerical_faults += 1
                raise
        return c

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
            kernel="spmm",
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
            volume_rows_padded_single=plan.volume_rows_padded(),
            cache=self.cache_info(),
            check=self._check,
            calls=self.calls,
            numerical_faults=self.numerical_faults,
            topology=self.topology.describe(),
            device=str(self.device),
        )
        out.setdefault("decision_source", "model")
        out.setdefault("replicate", 1)
        if self.snapshot is not None:
            out["pattern_nnz"] = self.snapshot.nnz
            out["pattern_fingerprint"] = self.snapshot.fingerprint[:12]
        return out

    def __repr__(self) -> str:
        sched = self.schedule
        return (f"DistSpmm({self.plan.shape[0]}x{self.plan.shape[1]}, "
                f"P={self.plan.P}, flat, schedule={sched.kind}"
                f"{f'/K={sched.K}' if sched.kind == 'bucketed' else ''}"
                f"{', overlapped' if self.overlap else ''}"
                f", backends={self.backends}, device={self.device})")

    # ----- serialization ----------------------------------------------

    def save(self, path: str) -> None:
        """Persist the host-side plan (no device state) as a pickle.

        ``load`` rebuilds the exec arrays deterministically, so C is
        bit-identical and MWVC never re-runs. TRUSTED INPUT ONLY:
        unpickling a file executes code from it.
        """
        payload = {
            "format": _SAVE_FORMAT,
            "version": _SAVE_VERSION,
            "config": self.config,
            "plan": self.plan,
            "schedule": self.schedule,
            "decisions": self.decisions,
            "snapshot": self.snapshot,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @classmethod
    def load(cls, path: str, where: Union[Topology, int, None] = None, *,
             device: Union[str, torch.device] = "cuda") -> "DistSpmm":
        """Rebuild a handle from ``save`` output (``where`` defaults to
        the plan's P on ``device``)."""
        if os.path.getsize(path) == 0:
            raise ValueError(f"{path!r} is empty (0 bytes); re-run "
                             f"compile_spmm(...).save()")
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if not isinstance(payload, dict) or \
                payload.get("format") != _SAVE_FORMAT:
            raise ValueError(f"{path!r} is not a saved repro_torch DistSpmm")
        if payload.get("version") != _SAVE_VERSION:
            raise ValueError(
                f"{path!r} carries format version {payload.get('version')!r};"
                f" this library reads version {_SAVE_VERSION}")
        plan: SpmmPlan = payload["plan"]
        topo = Topology.resolve(plan.P if where is None else where, device,
                                expect_p=plan.P)
        return _materialize(payload["config"], plan, payload["schedule"],
                            payload["decisions"], topo,
                            snapshot=payload.get("snapshot"))


# ---------------------------------------------------------------------------
# compilation pipeline
# ---------------------------------------------------------------------------


def _materialize(config: SpmmConfig, plan: SpmmPlan, schedule: CommSchedule,
                 decisions: Dict[str, Any], topo: Topology,
                 snapshot: Optional[PatternSnapshot] = None) -> DistSpmm:
    """Deterministic device-side prep: exec arrays on the device + handle."""
    # the per-round consumable layouts only when execution is overlapped
    overlap = bool(decisions.get("overlap", False))
    ex = flat_exec_arrays(plan, backends=config.backends, schedule=schedule,
                          overlap_layouts=overlap).to(topo.device)
    return DistSpmm(config=config, plan=plan, schedule=schedule, ex=ex,
                    decisions=decisions, topology=topo, snapshot=snapshot)


def _plan_and_tune(a: CSRMatrix, P: int, config: SpmmConfig, topo: Topology
                   ) -> Tuple[SpmmPlan, CommSchedule, Dict[str, Any]]:
    """The offline pipeline: MWVC plan + every model decision (host only)."""
    net, n_hint = config.resolve_net(topo), config.n_dense_hint
    plan = build_plan(a, P, config.strategy, pad_to=config.pad_to)
    decisions: Dict[str, Any] = {
        "kernel": "spmm",
        "net": net.name,
        "net_source": "topology" if config.net == "auto" else "config",
        "n_dense_hint": n_hint,
        "modeled_time_flat": modeled_time(plan, n_hint, net),
    }
    if config.schedule == "single":
        schedule = single_round_schedule(plan)
    elif isinstance(config.schedule, int):
        schedule = build_comm_schedule(plan, K=config.schedule)
    elif config.overlap is False:
        schedule, _ = choose_schedule(plan, n_hint, net, k_max=config.k_max)
    else:
        schedule, _, _ = choose_schedule(plan, n_hint, net,
                                         k_max=config.k_max,
                                         overlap=config.overlap)
    fields = {
        "modeled_time_schedule": modeled_time_schedule(plan, schedule,
                                                       n_hint, net),
        "modeled_time_staged": modeled_time_staged(plan, schedule, n_hint,
                                                   net),
        "modeled_time_overlap": modeled_time_overlap(plan, schedule, n_hint,
                                                     net),
    }
    decisions.update(fields)
    use_overlap = False
    if schedule.kind == "bucketed":
        if config.overlap is True:
            use_overlap = True
        elif config.overlap == "auto":
            use_overlap = (fields["modeled_time_overlap"]
                           < fields["modeled_time_staged"])
    decisions["overlap"] = use_overlap
    decisions["decision_source"] = "model"
    decisions["replicate"] = 1
    return plan, schedule, decisions


def compile_spmm(a: CSRMatrix, where: Union[Topology, int],
                 config: Optional[SpmmConfig] = None, *,
                 device: Union[str, torch.device] = "cuda",
                 **overrides) -> DistSpmm:
    """Plan, autotune and prepare a distributed SpMM handle for ``a``.

    ``where``: a ``Topology`` or an int P (P ranks emulated on
    ``device``). ``config`` fields can also be passed as keyword
    overrides: ``compile_spmm(a, 8, backends=("coo", "bsr"))``.
    """
    config = config or SpmmConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    topo = Topology.resolve(where, device)
    if guards.check_mode(config):
        guards.validate_sparse_values(a, context="compile_spmm")
    plan, schedule, decisions = _plan_and_tune(a, topo.P, config, topo)
    return _materialize(config, plan, schedule, decisions, topo,
                        snapshot=pattern_snapshot(a))
