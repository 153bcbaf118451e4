"""SpmmFleet: multi-tenant SpMM serving over one carved Topology.

Port of ``repro/serving/fleet.py``, host logic copied. The communication
plan is a host-side, deterministic function of (pattern, P, config), so
tenant placement is a pure scoring problem over candidate rank groups,
and migration between groups is a host-computable reshard plus the
session's hot-swap. The fleet owns four pieces:

* **sub-topology groups** — ``Topology.split(sizes)`` carves the fleet
  into disjoint contiguous rank spans. On one card a group is a span of
  the emulated ranks, served by its own ``LocalComm`` of the group's
  width on the same device, with its own ``fingerprint()``. On a fleet
  of processes (``Topology.multiprocess()``) each process keeps its
  span of every group (possibly empty) and runs every tenant's waves,
  returning its rows of C.
* **placement** — ``admit(name, a, cfg)`` runs the offline planner
  (``_plan_and_tune`` with measurement forced OFF, so scoring is
  deterministic) once per candidate group, filters groups whose
  estimated per-rank footprint (``autotune.estimate_device_bytes``)
  exceeds ``cfg.memory_budget``, and places the tenant's
  ``SpmmSession`` on the group with the lowest modeled time
  (``autotune.decision_modeled_time``). Ties break by a hash of the
  PATTERN fingerprint — never by admission order — so the same tenant
  set admitted in any order lands identically.
* **serving** — requests route through one ``SpmmWaveServer`` per
  tenant (``submit(name, b)``); ``serve()`` drains the per-tenant
  queues in weighted round-robin, at most ``weight`` waves per tenant
  per round, each wave on one handle (the hot-swap contract).
* **rebalancing** — ``rebalance()`` migrates a session between groups
  when the modeled load imbalance crosses
  ``REPRO_FLEET_REBALANCE_THRESHOLD``. A migration stages the session
  on the destination (plan reuse + materialize + ``warm_from`` — zero
  serving interruption), moves the resident B/C slabs by a host-side
  ``ReshardSpec`` (exact per-rank send/recv row ranges computed from
  the outgoing and incoming partitions), then commits with one
  reference swap. On one card a reshard is a device copy. On a fleet of
  processes each process holds its ranks' slabs; a route between two
  ranks of one process is a device copy and the rest cross in one
  exchange per operand (``ReshardSpec.apply_fleet``), counted beside
  ``moved_rows()`` in ``reshards``. An injected ``fleet_migrate_fail``
  (``robustness.faults``, kind ``wave_error``) fires BETWEEN stage and
  commit: rollback is discarding the staged state, the source group
  keeps serving, ``dropped_waves`` stays 0. On a fleet the outcome is
  folded over the processes first, so a fault on one process rolls the
  migration back on all of them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..core.api import SpmmConfig, _plan_and_tune
from ..core.autotune import decision_modeled_time, estimate_device_bytes
from ..core.session import SpmmSession
from ..core.sparse import CSRMatrix, block_rows
from ..distributed.topology import Topology, TopologyError
from ..robustness import faults
from .scheduler import SpmmRequest, SpmmWaveServer

__all__ = ["SpmmFleet", "ReshardSpec", "REBALANCE_THRESHOLD_ENV",
           "rebalance_threshold"]

REBALANCE_THRESHOLD_ENV = "REPRO_FLEET_REBALANCE_THRESHOLD"
_DEFAULT_REBALANCE_THRESHOLD = 0.25

# a row-sharded slab: a host array or a tensor on any device
Rows = Union[np.ndarray, torch.Tensor]


def rebalance_threshold(override: Optional[float] = None) -> float:
    """The modeled-imbalance ratio above which ``rebalance`` migrates."""
    if override is not None:
        return float(override)
    env = os.environ.get(REBALANCE_THRESHOLD_ENV, "")
    return float(env) if env else _DEFAULT_REBALANCE_THRESHOLD


# ---------------------------------------------------------------------------
# host-side cross-group resharding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReshardSpec:
    """Exact cross-partition routes for one row-sharded array.

    Computed host-side from the outgoing and incoming contiguous row
    partitions: ``routes`` is every non-empty interval intersection, as
    ``(src_rank, dst_rank, lo, hi)`` absolute row ranges.
    ``send_ranges``/``recv_ranges`` give one rank's view — what a real
    transport would pack per peer — and ``apply`` executes the whole
    spec on the shards (on one card, device copies).
    """

    rows: int
    src_bounds: Tuple[Tuple[int, int], ...]
    dst_bounds: Tuple[Tuple[int, int], ...]
    routes: Tuple[Tuple[int, int, int, int], ...]

    @classmethod
    def between(cls, src_bounds: Sequence[Tuple[int, int]],
                dst_bounds: Sequence[Tuple[int, int]]) -> "ReshardSpec":
        """Routes from one contiguous row partition to another."""
        src = tuple((int(lo), int(hi)) for lo, hi in src_bounds)
        dst = tuple((int(lo), int(hi)) for lo, hi in dst_bounds)
        rows_src, rows_dst = src[-1][1], dst[-1][1]
        if rows_src != rows_dst:
            raise ValueError(
                f"partitions cover different row counts: src ends at "
                f"{rows_src}, dst at {rows_dst}")
        routes = []
        for s, (slo, shi) in enumerate(src):
            for d, (dlo, dhi) in enumerate(dst):
                lo, hi = max(slo, dlo), min(shi, dhi)
                if lo < hi:
                    routes.append((s, d, lo, hi))
        return cls(rows=rows_src, src_bounds=src, dst_bounds=dst,
                   routes=tuple(routes))

    def send_ranges(self, src: int) -> List[Tuple[int, int, int]]:
        """``(dst_rank, lo, hi)`` ranges rank ``src`` ships out."""
        return [(d, lo, hi) for s, d, lo, hi in self.routes if s == src]

    def recv_ranges(self, dst: int) -> List[Tuple[int, int, int]]:
        """``(src_rank, lo, hi)`` ranges rank ``dst`` takes in."""
        return [(s, lo, hi) for s, d, lo, hi in self.routes if d == dst]

    def moved_rows(self) -> int:
        """Rows that actually change ranks (self-routes excluded)."""
        return sum(hi - lo for s, d, lo, hi in self.routes if s != d)

    def apply(self, shards: Sequence[Rows]) -> List[Rows]:
        """Execute the spec on per-rank shards.

        ``shards`` follow ``src_bounds`` and are all numpy arrays or all
        tensors; the result follows ``dst_bounds``, of the same kind
        (tensors are concatenated on their device). Every output row
        arrives via exactly one route (contiguous partitions tile the row
        space), which ``between`` guarantees by construction.
        """
        if len(shards) != len(self.src_bounds):
            raise ValueError(
                f"ReshardSpec expects {len(self.src_bounds)} source "
                f"shard(s), got {len(shards)}")
        tensors = isinstance(shards[0], torch.Tensor)
        out: List[Rows] = []
        for d in range(len(self.dst_bounds)):
            parts = []
            for s, lo, hi in self.recv_ranges(d):
                slo = self.src_bounds[s][0]
                parts.append(shards[s][lo - slo:hi - slo])
            if tensors:
                out.append(torch.cat(parts, dim=0) if parts
                           else shards[0][:0].clone())
            else:
                out.append(np.concatenate(parts, axis=0) if parts
                           else np.zeros((0,) + np.shape(shards[0])[1:],
                                         np.asarray(shards[0]).dtype))
        return out


    def apply_fleet(self, shards: Sequence[torch.Tensor], like: torch.Tensor,
                    comm, src: "_Side", dst: "_Side"
                    ) -> Tuple[List[torch.Tensor], Dict[str, int]]:
        """Execute the spec across a fleet of processes.

        ``src`` / ``dst`` name the outgoing and incoming partitions on
        the fleet: this process's ranks of each (rank indices of the
        partition, possibly none) and every rank's process. ``shards``
        are this process's outgoing ranks' slabs, tensors; ``like`` an
        empty [0, N] tensor of their dtype and device (a process with no
        outgoing rank has no slab to take them from). The result is this
        process's incoming ranks' slabs. A route whose two ranks are on
        this process is a device copy; the rows of every other route go
        through ``comm`` (a ``ProcessComm`` over the fleet) in ONE
        exchange, as bytes, in route order per process pair: every
        process enters it, with nothing to send or receive where it has
        no such route. Also returns what crossed processes, fleet-wide
        (``rows``, ``bytes``: the host-side route table's, the same on
        every process)."""
        me = comm.proc
        if len(shards) != src.hi - src.lo:
            raise ValueError(f"ReshardSpec expects this process's "
                             f"{src.hi - src.lo} source shard(s), got "
                             f"{len(shards)}")
        width = int(like.shape[1])

        def piece(s: int, lo: int, hi: int) -> torch.Tensor:
            base = self.src_bounds[s][0]
            return shards[s - src.lo][lo - base:hi - base]

        got: Dict[Tuple[int, int, int, int], torch.Tensor] = {
            r: piece(r[0], r[2], r[3]) for r in self.routes
            if src.owners[r[0]] == me and dst.owners[r[1]] == me}
        cross = [r for r in self.routes
                 if src.owners[r[0]] != dst.owners[r[1]]]
        if cross:  # the same on every process
            row_bytes = width * like.element_size()
            send = sorted((r for r in cross if src.owners[r[0]] == me),
                          key=lambda r: dst.owners[r[1]])
            recv = sorted((r for r in cross if dst.owners[r[1]] == me),
                          key=lambda r: src.owners[r[0]])
            in_splits, out_splits = [0] * comm.n_proc, [0] * comm.n_proc
            for s, d, lo, hi in send:
                in_splits[dst.owners[d]] += (hi - lo) * row_bytes
            for s, d, lo, hi in recv:
                out_splits[src.owners[s]] += (hi - lo) * row_bytes
            buf = torch.cat([piece(s, lo, hi).reshape(-1)
                             for s, _, lo, hi in send]) if send \
                else like.new_empty(0)
            vals = comm.exchange_bytes(buf, in_splits, out_splits,
                                       like.dtype)
            off = 0
            for r in recv:
                n = (r[3] - r[2]) * width
                got[r] = vals[off:off + n].view(r[3] - r[2], width)
                off += n
        out = []
        for d in range(dst.lo, dst.hi):
            parts = [got[r] for r in self.routes if r[1] == d]
            out.append(torch.cat(parts) if parts else like.clone())
        rows = sum(hi - lo for _, _, lo, hi in cross)
        return out, {"rows": rows,
                     "bytes": rows * width * like.element_size()}


class _Side(NamedTuple):
    """One partition of a reshard on a fleet: this process's ranks of it
    [lo, hi) and each rank's process."""

    lo: int
    hi: int
    owners: Tuple[int, ...]


def _shard_rows(arr: Rows, bounds: Sequence[Tuple[int, int]],
                span: Optional[Tuple[int, int]] = None) -> List[Rows]:
    """Row views of ``arr``, one per (lo, hi) of ``bounds`` — or, with
    ``span``, one per rank of it, ``arr`` then holding just those ranks'
    rows (a fleet process's slab)."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    if span is None:
        return [arr[lo:hi] for lo, hi in bounds]
    mine = bounds[span[0]:span[1]]
    base = mine[0][0] if mine else 0
    return [arr[lo - base:hi - base] for lo, hi in mine]


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Tenant:
    """One admitted pattern: its session, server, and placement state."""

    name: str
    session: SpmmSession
    server: SpmmWaveServer
    group_idx: int
    weight: int
    # per-group admission scores: group_idx -> (modeled_time, est_bytes);
    # groups pruned by the memory budget are absent
    scores: Dict[int, Tuple[float, int]]
    # the most recently served operand/result, held as per-rank row
    # views in the CURRENT group's partition — what a migration reshards
    resident_b: Optional[List[Rows]] = None
    resident_c: Optional[List[Rows]] = None
    # on a fleet of processes: empty [0, N] B and C tensors of the served
    # dtypes and device (a process may hold no rank of the group)
    resident_like: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    inflight: List[SpmmRequest] = dataclasses.field(default_factory=list)

    @property
    def modeled_time(self) -> float:
        return self.scores[self.group_idx][0]


class SpmmFleet:
    """Multi-tenant SpMM serving over disjoint sub-topology groups.

    ::

        fleet = SpmmFleet(Topology.local(8), group_sizes=(4, 4))
        fleet.admit("social", a_social, SpmmConfig(hier="auto"))
        fleet.admit("web", a_web)
        fleet.submit("social", b)
        served = fleet.serve()           # {"social": [C], ...}
        fleet.rebalance()                # modeled-load migrations

    ``where`` is a Topology or an int P (P ranks on ``device``). Every
    tenant keeps serving across ``rebalance`` migrations with
    ``dropped_waves == 0``: waves only ever run between handle
    re-resolutions, and a migration swaps handles exactly there.
    """

    def __init__(self, where: Union[Topology, int],
                 group_sizes: Sequence[int],
                 config: Optional[SpmmConfig] = None,
                 rebalance_threshold: Optional[float] = None,
                 max_batch: int = 8, *,
                 device: Union[str, torch.device] = "cuda"):
        self.topology = Topology.resolve(where, device)
        self.groups: Tuple[Topology, ...] = self.topology.split(
            tuple(group_sizes))
        self.default_config = config or SpmmConfig()
        self.threshold = globals()["rebalance_threshold"](
            rebalance_threshold)
        self.max_batch = int(max_batch)
        self.tenants: Dict[str, _Tenant] = {}
        self.migrations = 0
        self.failed_migrations = 0
        self.events: List[dict] = []
        # per committed migration: the rows ``ReshardSpec.moved_rows``
        # counts and what really crossed processes (0 on one device)
        self.reshards: List[dict] = []
        self._next_rid = 0
        # on a fleet of processes: its communicator (the reshards' one
        # exchange, the agreed rollback, each rank's process)
        self._comm = None
        if self.topology.is_multiprocess:
            self._comm = self.topology.comm()

    # ----- placement ---------------------------------------------------

    def score_groups(self, a: CSRMatrix, config: SpmmConfig
                     ) -> Dict[int, Tuple[float, int]]:
        """Deterministic per-group placement scores for one pattern.

        Runs the pure offline planner against each group's OWN topology,
        with the measured overlay forced off — admission must not depend
        on what happens to be in an autotune cache. Groups whose
        estimated footprint exceeds ``config.memory_budget`` are pruned
        here, mirroring the session's rung budget filter.
        """
        score_cfg = dataclasses.replace(config, measure=False)
        budget = config.memory_budget
        scores: Dict[int, Tuple[float, int]] = {}
        for gi, group in enumerate(self.groups):
            plan, _, schedule, decisions = _plan_and_tune(
                a, group.P, score_cfg, group)
            need = estimate_device_bytes(plan, schedule, score_cfg)
            if budget is not None and need > int(budget):
                continue
            scores[gi] = (decision_modeled_time(decisions), int(need))
        return scores

    def admit(self, name: str, a: CSRMatrix,
              config: Optional[SpmmConfig] = None,
              p_ladder: Optional[Sequence[int]] = None,
              weight: int = 1) -> int:
        """Place one tenant pattern onto its best group; returns the
        group index. Placement is a pure function of (pattern, groups,
        config) — admission ORDER never changes where a tenant lands."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} is already admitted")
        config = config or self.default_config
        scores = self.score_groups(a, config)
        if not scores:
            raise TopologyError(
                f"no group can hold tenant {name!r}: every candidate "
                f"exceeds memory_budget={config.memory_budget} bytes per "
                f"device; raise the budget or carve larger groups")
        best_t = min(t for t, _ in scores.values())
        tied = sorted(gi for gi, (t, _) in scores.items() if t == best_t)
        session = SpmmSession.build(a, self.groups[tied[0]], config,
                                    p_ladder=p_ladder)
        # order-independent tie-break: hash the pattern identity, not
        # the admission sequence
        gi = tied[int(session.snapshot.fingerprint[:8], 16) % len(tied)]
        if gi != tied[0]:
            session = SpmmSession.build(a, self.groups[gi], config,
                                        p_ladder=p_ladder)
        tenant = _Tenant(
            name=name, session=session,
            server=SpmmWaveServer(session, max_batch=self.max_batch),
            group_idx=gi, weight=max(1, int(weight)), scores=scores)
        self.tenants[name] = tenant
        self.events.append({
            "action": "admit", "tenant": name, "group": gi,
            "scores": {g: t for g, (t, _) in sorted(scores.items())}})
        return gi

    # ----- serving -----------------------------------------------------

    def submit(self, name: str, b: Rows) -> SpmmRequest:
        """Queue one dense operand (numpy or a tensor) on a tenant's wave
        server."""
        tenant = self._tenant(name)
        req = SpmmRequest(rid=self._next_rid, b=b)
        self._next_rid += 1
        tenant.inflight.append(req)
        tenant.server.submit(req)
        return req

    def serve(self, rounds: int = 1) -> Dict[str, List[torch.Tensor]]:
        """Drain tenant queues in weighted round-robin.

        Each round gives every tenant (admission order) at most
        ``weight`` waves — ``SpmmWaveServer.run`` counts waves
        cumulatively, so the cap is expressed relative to the tenant's
        own running total. Returns the outputs completed by this call,
        tensors on the tenants' device.
        """
        done: Dict[str, List[torch.Tensor]] = {}
        for _ in range(max(1, int(rounds))):
            for name, tenant in self.tenants.items():
                if not tenant.server.queue:
                    continue
                tenant.server.run(
                    max_waves=tenant.server.stats.waves + tenant.weight)
                for req in [r for r in tenant.inflight
                            if r.output is not None]:
                    tenant.inflight.remove(req)
                    self._update_resident(tenant, req)
                    done.setdefault(name, []).append(req.output)
        return done

    def _update_resident(self, tenant: _Tenant, req: SpmmRequest) -> None:
        """Pin the latest served B/C as row views in the CURRENT
        partition: on a fleet of processes, of this process's ranks of
        the group (its span there; none on an empty one), cut from B
        (the full operand where it is on the device, else its slab,
        ``put_global``) and from its rows of C."""
        h = tenant.session.handle()
        plan = h.plan
        b_bounds = block_rows(plan.shape[1], plan.P)
        if self._comm is None:
            tenant.resident_b = _shard_rows(req.b, b_bounds)
            tenant.resident_c = _shard_rows(req.output, tuple(plan.bounds))
            return
        span = h.topology.span
        b = req.b
        if isinstance(b, torch.Tensor) and b.device == req.output.device \
                and b.shape[0] == plan.shape[1]:
            tenant.resident_b = _shard_rows(b, b_bounds)[span[0]:span[1]]
        else:
            b = h.topology.put_global(b, plan.shape[1])
            tenant.resident_b = _shard_rows(b, b_bounds, span)
        tenant.resident_c = _shard_rows(req.output, tuple(plan.bounds), span)
        tenant.resident_like = (b[:0], req.output[:0])

    def maybe_replan(self, name: str, a_new: CSRMatrix
                     ) -> Tuple[float, bool]:
        """Drift-check one tenant's live pattern (the session contract:
        replans run off the serving path, the next wave picks up the
        warm swapped-in handle). A replan also re-scores the tenant's
        placement — future ``rebalance`` calls see the NEW pattern's
        modeled load, not the admission-time one."""
        tenant = self._tenant(name)
        d, replanned = tenant.session.maybe_replan(a_new)
        if replanned:
            scores = self.score_groups(a_new, tenant.session.config)
            if tenant.group_idx in scores:
                tenant.scores = scores
            self.events.append({"action": "drift_replan", "tenant": name,
                                "drift": d})
        return d, replanned

    # ----- rebalancing -------------------------------------------------

    def group_loads(self) -> List[float]:
        """Modeled load per group: Σ tenant modeled_time × weight."""
        loads = [0.0] * len(self.groups)
        for tenant in self.tenants.values():
            loads[tenant.group_idx] += tenant.modeled_time * tenant.weight
        return loads

    def imbalance(self) -> float:
        """(max − min) / mean of the modeled group loads (0 when idle)."""
        loads = self.group_loads()
        mean = sum(loads) / len(loads)
        if mean <= 0.0:
            return 0.0
        return (max(loads) - min(loads)) / mean

    def rebalance(self, max_migrations: int = 4) -> List[Tuple[str, int]]:
        """Migrate tenants until the modeled imbalance is within the
        threshold (or no move strictly improves the spread). Returns the
        ``(tenant, dst_group)`` migrations performed."""
        performed: List[Tuple[str, int]] = []
        for _ in range(max(0, int(max_migrations))):
            if self.imbalance() <= self.threshold:
                break
            move = self._best_move()
            if move is None:
                break
            name, dst = move
            if not self.migrate(name, dst):
                break  # injected failure: rolled back, stop rebalancing
            performed.append((name, dst))
        return performed

    def _best_move(self) -> Optional[Tuple[str, int]]:
        """The single migration minimizing the post-move load spread —
        only if it STRICTLY improves on the current spread (no
        oscillation)."""
        loads = self.group_loads()
        spread = max(loads) - min(loads)
        best: Optional[Tuple[float, str, int]] = None
        src = loads.index(max(loads))
        for name, tenant in self.tenants.items():
            if tenant.group_idx != src:
                continue
            contrib = tenant.modeled_time * tenant.weight
            for dst, (t_dst, _) in sorted(tenant.scores.items()):
                if dst == src:
                    continue
                after = list(loads)
                after[src] -= contrib
                after[dst] += t_dst * tenant.weight
                new_spread = max(after) - min(after)
                if new_spread < spread and (
                        best is None or new_spread < best[0]):
                    best = (new_spread, name, dst)
        return None if best is None else (best[1], best[2])

    def migrate(self, name: str, dst_idx: int) -> bool:
        """Move one tenant to another group, serving-safely.

        Stage (plan reuse + materialize on the destination group +
        ``warm_from`` the serving handle), fire the
        ``fleet_migrate_fail`` fault site, reshard the resident B/C
        slabs by ``ReshardSpec``, then commit with one reference swap. A
        failure before commit rolls back by discarding staged state —
        the source group never stopped serving, so no wave is dropped.
        Returns whether the migration committed.
        """
        tenant = self._tenant(name)
        src_idx = tenant.group_idx
        if dst_idx == src_idx:
            return True
        if dst_idx not in tenant.scores:
            raise TopologyError(
                f"tenant {name!r} does not fit group {dst_idx} "
                f"(pruned by the memory budget at admission)")
        old = tenant.session.handle()
        old_plan = old.plan
        staged = tenant.session.stage_topology(self.groups[dst_idx])
        error = None
        try:
            # the testable failure point: everything staged, nothing
            # committed — rollback is garbage collection
            faults.maybe_error("fleet_migrate_fail")
        except faults.InjectedFault as e:
            error = f"{type(e).__name__}: {e}"
        if self._comm is not None:
            # one commit-or-rollback decision for the fleet: where any
            # process failed, every one rolls back with the first failing
            # process's message, so counters and events stay the same
            error = self._comm.fold_first(error)
        if error is not None:
            self.failed_migrations += 1
            self.events.append({
                "action": "migrate_rollback", "tenant": name,
                "from": src_idx, "to": dst_idx, "error": error})
            return False
        new_plan = staged.rung.payload["plan"]
        moved = {}
        crossed = {"b_rows_crossing": 0, "c_rows_crossing": 0,
                   "bytes_crossing": 0}
        for key, spec, held in (
                ("b", ReshardSpec.between(
                    block_rows(old_plan.shape[1], old_plan.P),
                    block_rows(new_plan.shape[1], new_plan.P)),
                 tenant.resident_b),
                ("c", ReshardSpec.between(tuple(old_plan.bounds),
                                          tuple(new_plan.bounds)),
                 tenant.resident_c)):
            if held is None:
                continue
            if self._comm is None:
                held = spec.apply(held)
            else:
                like = tenant.resident_like[key == "c"]
                held, info = spec.apply_fleet(
                    held, like, self._comm, self._side(old.topology),
                    self._side(staged.rung.handle.topology))
                crossed[f"{key}_rows_crossing"] = info["rows"]
                crossed["bytes_crossing"] += info["bytes"]
            setattr(tenant, f"resident_{key}", held)
            moved[f"{key}_rows"] = spec.moved_rows()
        tenant.session.commit_topology(staged)
        tenant.group_idx = dst_idx
        self.migrations += 1
        self.events.append({"action": "migrate", "tenant": name,
                            "from": src_idx, "to": dst_idx, **moved})
        self.reshards.append({"tenant": name, "from": src_idx,
                              "to": dst_idx, **moved, **crossed})
        return True

    def _side(self, topo: Topology) -> _Side:
        """A handle's partition on the fleet (its topology: a group, or
        the first P ranks of one where a smaller rung serves): this
        process's ranks of it and each of its ranks' process."""
        lo, hi = topo.span
        g0 = topo.group[0]
        return _Side(lo, hi, self._comm.owners[g0:g0 + topo.P])

    # ----- introspection -----------------------------------------------

    def _tenant(self, name: str) -> _Tenant:
        try:
            return self.tenants[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; admitted: "
                f"{sorted(self.tenants)}") from None

    def placements(self) -> Dict[str, int]:
        return {name: t.group_idx for name, t in self.tenants.items()}

    def stats(self) -> Dict[str, Any]:
        """Fleet-level counters + per-tenant serving stats."""
        return {
            "groups": [g.describe() for g in self.groups],
            "group_loads": self.group_loads(),
            "imbalance": self.imbalance(),
            "threshold": self.threshold,
            "migrations": self.migrations,
            "failed_migrations": self.failed_migrations,
            "placements": self.placements(),
            "tenants": {
                name: {
                    "group": t.group_idx,
                    "weight": t.weight,
                    "modeled_time": t.modeled_time,
                    "queued": len(t.server.queue),
                    "server": dataclasses.asdict(t.server.stats),
                } for name, t in self.tenants.items()},
        }
