"""SpmmSession: the topology-aware handle lifecycle.

Port of ``repro/core/session.py``. The port emulates P ranks on one
device, so a ladder rung of any P can always serve there: a smaller rung
narrows the topology, a larger one grows a local topology on the same
device — except on a carved group (``Topology.split``) or a fleet of
processes, where a larger rung raises the reference's
``TopologyError``. On a fleet a smaller rung serves on the first P
ranks, every process keeping its clipped span (an empty one too). Rung
payloads are the
port's ``DistSpmm.save`` dicts, and the bundle goes through
``checkpoint.manager.atomic_dir`` with a per-file digest manifest, as in
the reference.

A ``DistSpmm`` handle is frozen to one (P, sparsity pattern). Real
deployments freeze neither: fleets grow and shrink (elastic training),
and the pattern drifts (MoE routing shift, graph updates). The session
owns both events as first-class lifecycle transitions instead of
rebuild-the-world errors:

* **plan ladder** — a set of pre-autotuned plans over a P-ladder, all
  built against one sparsity snapshot. ``handle()`` serves the current
  rung; a resize event (``on_resize``) selects
  the nearest rung and re-materializes device state WITHOUT re-running
  MWVC (pinned by ``planner.plan_build_count`` in tests).
* **drift-triggered replans** — ``drift(a_new)`` measures the live
  pattern against the planned snapshot (Jaccard distance over nonzero
  coordinates); ``maybe_replan`` re-runs MWVC + autotune off the
  serving path once it crosses ``SpmmConfig.drift_threshold``.
* **hot-swap serving** — ``replan`` builds and WARMS the incoming
  handle (every executable the outgoing handle has served is lowered
  first — ``DistSpmm.warm_from``), then swaps it in with a single
  reference assignment. Holders of the old handle keep a fully working
  handle until they re-resolve, so a server that re-resolves between
  waves never drops one across a swap.
* **bundle save/load** — ``save()`` persists the whole ladder + operand
  + snapshot through ``checkpoint.manager.atomic_dir`` (same
  stage-then-rename invariant as model checkpoints: readers see absent
  or complete bundles, never torn ones); ``load()`` rebuilds on any
  topology with a matching rung.

``compile_spmm`` is the thin one-rung special case of this class.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from ..distributed.topology import Topology, TopologyError
from ..robustness import faults, guards
from .api import (
    DistSpmm, SpmmConfig, _materialize, _plan_and_tune,
    check_payload_version, materialize_payload,
)
# a rung's host-side dict is the one ``DistSpmm.save`` writes
from .api import _payload as _rung_payload
from .sparse import CSRMatrix, PatternSnapshot, pattern_snapshot

__all__ = ["SpmmSession", "LadderRung", "StagedTopology"]

Device = Union[str, torch.device]

_SESSION_FORMAT = "repro_torch.SpmmSession"
_SESSION_VERSION = 1
_KNOWN_SESSION_VERSIONS = (1,)


@dataclasses.dataclass
class StagedTopology:
    """A fully-warmed migration target from ``SpmmSession.stage_topology``.

    Carries everything ``commit_topology`` needs to take over serving in
    one reference assignment; discarding it (migration abort/rollback)
    leaves the session untouched."""

    topology: Topology
    P: int
    rung: "LadderRung"


@dataclasses.dataclass
class LadderRung:
    """One pre-autotuned plan of the ladder: host-side payload plus the
    lazily-materialized handle serving it."""

    P: int
    payload: Dict[str, Any]  # DistSpmm save-format dict (host-side only)
    generation: int = 0      # pattern generation the plan was built for
    handle: Optional[DistSpmm] = None

    @property
    def materialized(self) -> bool:
        return self.handle is not None


class SpmmSession:
    """A ladder of pre-autotuned SpMM plans with a lifecycle.

    Build with ``SpmmSession.build(a, where, config, p_ladder=(2, 4, 8))``
    or load a saved bundle. ``handle()`` is the only serving entry point
    — callers re-resolve it at their swap granularity (per call, per
    wave); everything else mutates which handle it returns.
    """

    def __init__(self, *, config: SpmmConfig, topology: Topology,
                 rungs: Dict[int, LadderRung], current_P: int,
                 snapshot: PatternSnapshot,
                 operand: Optional[CSRMatrix] = None,
                 generation: int = 0):
        self.config = config
        self.topology = topology
        self._rungs = dict(rungs)
        self.current_P = int(current_P)
        self.snapshot = snapshot
        self._operand = operand
        self.generation = generation
        self.replans = 0
        self.swaps = 0
        self.values_refreshes = 0
        # rungs build() dropped for exceeding config.memory_budget:
        # P -> estimated/measured per-device bytes
        self.skipped_rungs: Dict[int, int] = {}
        self.events: List[dict] = []

    # ----- construction ------------------------------------------------

    @classmethod
    def build(cls, a: CSRMatrix, where: Union[Topology, int],
              config: Optional[SpmmConfig] = None,
              p_ladder: Optional[Sequence[int]] = None, *,
              device: Device = "cuda", **overrides) -> "SpmmSession":
        """Plan + autotune every rung of the ladder for ``a``.

        ``where``: a ``Topology`` or an int P (P ranks on ``device``).
        ``p_ladder`` defaults to the topology's P (the one-rung session
        ``compile_spmm`` builds). Rungs are host-side plans — they may
        include P values above the current fleet (grow headroom); only
        the current rung touches the device, lazily, at ``handle()``.
        """
        config = config or SpmmConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        a = _guard_operand(a, config, "SpmmSession.build")
        topo = Topology.resolve(where, device)
        ladder = tuple(sorted(set(int(p) for p in (p_ladder or (topo.P,)))))
        if any(p < 1 for p in ladder):
            raise ValueError(f"ladder rungs must be >= 1, got {ladder}")
        current = cls._nearest_rung(ladder, topo.P)
        if current is None:
            raise TopologyError(
                f"no ladder rung fits the topology: ladder={ladder}, "
                f"P={topo.P}; include a rung <= {topo.P}")
        snapshot = pattern_snapshot(a)
        rungs: Dict[int, LadderRung] = {}
        skipped: Dict[int, int] = {}
        # the replicate decision each skipped rung was holding when it
        # blew the budget (c-lane rungs carry c-1 extra B shards per
        # device; ``rung_device_bytes`` prices that via the replicated
        # estimate) — rides in the budget_skip event, keyed like skipped
        skipped_replicate: Dict[int, int] = {}
        budget = config.memory_budget
        for P in ladder:
            plan, hier, schedule, decisions = _plan_and_tune(
                a, P, config, topo)
            if budget is not None:
                from .autotune import rung_device_bytes

                need = rung_device_bytes(plan, schedule, decisions, config)
                if need > int(budget):
                    skipped[P] = int(need)
                    skipped_replicate[P] = int(
                        decisions.get("replicate", 1))
                    continue
            rungs[P] = LadderRung(P, _rung_payload(
                config, plan, hier, schedule, decisions, snapshot))
        if not rungs:
            detail = ", ".join(f"P={p}: ~{b} B" for p, b in skipped.items())
            raise TopologyError(
                f"every ladder rung exceeds memory_budget={budget} bytes "
                f"per device ({detail}); raise the budget or pick rungs "
                f"with a smaller per-device footprint")
        current = cls._nearest_rung(tuple(rungs), topo.P)
        if current is None:
            raise TopologyError(
                f"no within-budget ladder rung fits the topology: kept "
                f"{tuple(rungs)}, skipped {tuple(skipped)} (over "
                f"memory_budget={budget}), P={topo.P}")
        session = cls(config=config, topology=topo, rungs=rungs,
                      current_P=current, snapshot=snapshot, operand=a)
        session.skipped_rungs = skipped
        if skipped:
            session.events.append({"action": "budget_skip",
                                   "skipped": dict(skipped),
                                   "replicate": dict(skipped_replicate),
                                   "budget": int(budget)})
        return session

    @staticmethod
    def _nearest_rung(ladder: Sequence[int], n: int) -> Optional[int]:
        """Largest rung that fits n devices (the elastic selection)."""
        fitting = [p for p in ladder if p <= n]
        return max(fitting) if fitting else None

    # ----- serving -----------------------------------------------------

    @property
    def ladder(self) -> Tuple[int, ...]:
        return tuple(sorted(self._rungs))

    def handle(self) -> DistSpmm:
        """The handle serving the current (P, pattern).

        Materializes device state lazily and caches it per rung; the
        returned object stays valid across later ``replan``/``on_resize``
        calls (old handles serve until their holder re-resolves).
        """
        rung = self._rungs[self.current_P]
        if rung.generation != self.generation:
            self._replan_rung(rung.P, warm=True)
            rung = self._rungs[self.current_P]
        if rung.handle is None:
            rung.handle = materialize_payload(
                rung.payload, self._topology_for(rung.P),
                source=f"<session rung P={rung.P}>")
        return rung.handle

    def _topology_for(self, P: int) -> Topology:
        """The substrate rung P serves on, as the reference's: a smaller
        rung narrows the topology (on a fleet of processes, its first P
        ranks, each process keeping its clipped span), and a larger one
        grows a local topology on the session's device, where the ranks
        are emulated — unless the session sits on a carved group
        (``Topology.split``), which it must not escape, or on a fleet,
        which only a grown fleet's Topology (``on_resize(topo)``) can
        widen."""
        if P == self.topology.P:
            return self.topology
        if P < self.topology.P:
            return self.topology.narrow(P)
        if self.topology.group is not None:
            raise TopologyError(
                f"rung P={P} exceeds the session's sub-topology group "
                f"(span={self.topology.group}, P={self.topology.P}); a "
                f"grouped session must not escape onto the wider fleet — "
                f"migrate it to a larger group (stage_topology/"
                f"adopt_topology) instead")
        if self.topology.is_multiprocess:
            raise TopologyError(
                f"rung P={P} exceeds the session topology "
                f"(P={self.topology.P}, kind={self.topology.kind}); pass "
                f"the grown fleet's Topology to on_resize()")
        return Topology.local(P, self.topology.device)

    # ----- drift + replan ----------------------------------------------

    def drift(self, a_new: Union[CSRMatrix, PatternSnapshot]) -> float:
        """Pattern drift of ``a_new`` (matrix or pre-built snapshot) vs
        the session snapshot, recorded on the current handle so
        ``h.stats()`` / BENCH records carry it."""
        d = self.snapshot.drift(a_new)
        rung = self._rungs.get(self.current_P)
        if rung is not None and rung.handle is not None:
            rung.handle.last_drift = d
        return d

    def maybe_replan(self, a_new: CSRMatrix) -> Tuple[float, bool]:
        """Replan iff drift crosses ``config.drift_threshold``.

        Returns (drift, replanned). The serving contract on the replan
        path is ``replan``'s: the swapped-in handle is warm before the
        old one stops being returned.
        """
        a_new = _guard_operand(a_new, self.config,
                               "SpmmSession.maybe_replan")
        snap_new = pattern_snapshot(a_new)  # once; drift + replan reuse it
        d = self.drift(snap_new)
        if d <= self.config.drift_threshold:
            old_digest = getattr(self.snapshot, "values_digest", None)
            if (d == 0.0 and old_digest is not None
                    and snap_new.values_digest is not None
                    and snap_new.values_digest != old_digest):
                # same pattern, new nonzero VALUES: the compiled
                # executables stay valid (exec arrays are runtime
                # arguments) — refresh arrays in place, zero re-lowering
                self._refresh_values(a_new, snap_new)
                self.events.append({"action": "values_refresh", "drift": d})
            else:
                self.events.append({"action": "drift_ok", "drift": d})
            return d, False
        self.events.append({"action": "drift_replan", "drift": d})
        self.replan(a_new, _snapshot=snap_new)
        return d, True

    def replan(self, a_new: CSRMatrix,
               rungs: Union[str, Iterable[int]] = "current",
               _snapshot: Optional[PatternSnapshot] = None) -> DistSpmm:
        """Re-run MWVC + autotune for ``a_new`` and hot-swap the handle.

        Planning and warming happen OFF the serving path: the current
        handle keeps serving (and stays valid for holders) while the
        replacement plans, materializes, and pre-lowers the outgoing
        handle's executable working set; only then does one reference
        assignment make ``handle()`` return the replacement.

        ``rungs``: "current" (default — other rungs replan lazily when a
        resize selects them), "all", or explicit P values.
        """
        if _snapshot is None:  # direct call; maybe_replan already guarded
            a_new = _guard_operand(a_new, self.config,
                                   "SpmmSession.replan")
        snap_new = _snapshot or pattern_snapshot(a_new)
        drift = self.snapshot.drift(snap_new)
        self.snapshot = snap_new
        self._operand = a_new
        self.generation += 1
        if rungs == "current":
            targets: Tuple[int, ...] = (self.current_P,)
        elif rungs == "all":
            targets = self.ladder
        else:
            targets = tuple(int(p) for p in rungs)
            unknown = [p for p in targets if p not in self._rungs]
            if unknown:
                raise ValueError(
                    f"not ladder rungs: {unknown} (ladder={self.ladder})")
        for P in targets:
            self._replan_rung(P, warm=(P == self.current_P))
        self.replans += 1
        handle = self.handle()
        handle.last_drift = drift
        self.events.append({"action": "replan", "drift": drift,
                            "rungs": list(targets),
                            "generation": self.generation})
        return handle

    def _refresh_values(self, a_new: CSRMatrix,
                        snap_new: PatternSnapshot) -> None:
        """Carry compiled executables across a values-only operand update.

        The pattern digest is unchanged, so every rung's plan STRUCTURE
        (cover, schedule, layouts) is reproduced identically by
        ``_plan_and_tune`` — only the packed nonzero values differ.
        Materialized handles keep their identity and their whole
        executable cache (``DistSpmm.refresh_values`` swaps the exec
        arrays under the compiled code); payloads are rebuilt so lazily
        materialized rungs also pick up the new values. Falls back to
        dropping a handle (lazy re-materialization, which re-lowers)
        only if a rung's refreshed geometry surprisingly mismatches.
        """
        if guards.check_mode(self.config):
            # values-refresh is the one path that swaps arrays under
            # compiled code — digest-check the pattern really is the
            # planned one before anything is touched
            guards.validate_pattern(snap_new, self.snapshot,
                                    context="SpmmSession.values_refresh")
        self.snapshot = snap_new
        self._operand = a_new
        for P, rung in sorted(self._rungs.items()):
            plan, hier, schedule, decisions = _plan_and_tune(
                a_new, P, self.config, self.topology)
            rung.payload = _rung_payload(self.config, plan, hier, schedule,
                                         decisions, snap_new)
            if rung.handle is not None:
                ok = rung.handle.refresh_values(
                    plan=plan, hier=hier, schedule=schedule,
                    decisions=decisions, snapshot=snap_new)
                if not ok:  # pragma: no cover — same-pattern plans match
                    rung.handle = None
        self.values_refreshes += 1

    def _replan_rung(self, P: int, warm: bool) -> None:
        """Rebuild one rung against the session operand + snapshot."""
        if self._operand is None:
            raise ValueError(
                "session has no operand matrix to replan from (loaded "
                "with include_operand=False); call replan(a_new) with "
                "the live matrix instead")
        plan, hier, schedule, decisions = _plan_and_tune(
            self._operand, P, self.config, self.topology)
        payload = _rung_payload(self.config, plan, hier, schedule,
                                decisions, self.snapshot)
        new_rung = LadderRung(P, payload, generation=self.generation)
        old = self._rungs.get(P)
        if warm:
            new_rung.handle = _materialize(
                self.config, plan, hier, schedule, decisions,
                self._topology_for(P), snapshot=self.snapshot)
            if old is not None and old.handle is not None:
                new_rung.handle.warm_from(old.handle)
                self.swaps += 1
        self._rungs[P] = new_rung  # the atomic swap: one assignment

    # ----- migration (fleet placement) ---------------------------------

    def stage_topology(self, where: Union[Topology, int],
                       device: Optional[Device] = None
                       ) -> "StagedTopology":
        """Prepare serving on another substrate WITHOUT mutating state.

        Phase one of the migration primitive: select the nearest ladder
        rung for the target topology, re-plan host-side only if that
        rung predates the live pattern generation (a rung left behind by
        ``replan(rungs="current")``), materialize device state on the
        TARGET devices, and pre-lower the currently serving handle's
        executable working set there (``DistSpmm.warm_from``). The
        session keeps serving from its current topology throughout, and
        nothing here touches ``self`` — a failure anywhere in staging
        rolls back by simply discarding the returned object.
        ``commit_topology`` is the separate, infallible reference swap.
        An int ``where`` names P ranks on ``device`` (default: the
        session's device).
        """
        topo = Topology.resolve(
            where, self.topology.device if device is None else device)
        rung_P = self._nearest_rung(self.ladder, topo.P)
        if rung_P is None:
            raise TopologyError(
                f"no ladder rung fits the target topology (P={topo.P}, "
                f"ladder={self.ladder}); stage onto a group with >= "
                f"{min(self.ladder)} device(s)")
        src = self._rungs[rung_P]
        if src.generation != self.generation:
            if self._operand is None:
                raise ValueError(
                    "session has no operand matrix to replan the staged "
                    "rung from (loaded with include_operand=False)")
            plan, hier, schedule, decisions = _plan_and_tune(
                self._operand, rung_P, self.config, topo)
            payload = _rung_payload(self.config, plan, hier, schedule,
                                    decisions, self.snapshot)
        else:
            payload = src.payload  # reuse: staging never re-runs MWVC
        staged = LadderRung(rung_P, payload, generation=self.generation)
        staged.handle = materialize_payload(
            payload, topo if topo.P == rung_P else topo.narrow(rung_P),
            source=f"<staged rung P={rung_P}>")
        cur = self._rungs.get(self.current_P)
        if cur is not None and cur.handle is not None:
            staged.handle.warm_from(cur.handle)
        return StagedTopology(topology=topo, P=rung_P, rung=staged)

    def commit_topology(self, staged: "StagedTopology") -> DistSpmm:
        """Adopt a staged substrate: one reference swap, serving-safe.

        Holders of the outgoing handle keep a fully working handle on
        the old devices until they re-resolve (the hot-swap contract);
        every other cached handle is dropped as stale — those rungs
        re-materialize lazily on the new substrate.
        """
        for rung in self._rungs.values():
            rung.handle = None
        self.topology = staged.topology
        self._rungs[staged.P] = staged.rung
        self.current_P = staged.P
        self.swaps += 1
        self.events.append({"action": "adopt_topology", "P": staged.P,
                            "topology": staged.topology.describe()})
        return staged.rung.handle

    def adopt_topology(self, where: Union[Topology, int],
                       device: Optional[Device] = None) -> DistSpmm:
        """``stage_topology`` + ``commit_topology`` in one call."""
        return self.commit_topology(self.stage_topology(where, device))

    # ----- elastic -----------------------------------------------------

    def on_resize(self, census: Union[int, Topology]) -> DistSpmm:
        """Select the nearest ladder rung for a new rank census.

        The elastic contract: a resize NEVER re-runs MWVC for a rung
        whose plan matches the current pattern generation — it only
        materializes device state (exec arrays + a fresh executable
        memo) for the selected rung, once per rung. A rung left behind by a
        ``replan(rungs="current")`` is transparently re-planned first
        (that replan is the drift's cost, not the resize's).

        ``census``: rank count, or the grown/shrunk fleet's Topology.
        """
        if isinstance(census, Topology):
            topo, n = census, census.P
        else:
            topo, n = None, int(census)
        rung_P = self._nearest_rung(self.ladder, n)
        if rung_P is None:
            raise TopologyError(
                f"no ladder rung fits {n} device(s) (ladder="
                f"{self.ladder}); re-build the session with a smaller "
                f"rung or restore capacity")
        if topo is not None:
            self.topology = topo
            # device identities changed: cached handles are stale
            for rung in self._rungs.values():
                rung.handle = None
        changed = rung_P != self.current_P
        self.current_P = rung_P
        self.events.append({"action": "resize", "census": n,
                            "rung": rung_P, "changed": changed})
        return self.handle()

    # ----- introspection -----------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Session lifecycle counters + the current handle's stats."""
        out = {
            "ladder": self.ladder,
            "current_P": self.current_P,
            "generation": self.generation,
            "replans": self.replans,
            "swaps": self.swaps,
            "values_refreshes": self.values_refreshes,
            "skipped_rungs": dict(self.skipped_rungs),
            "pattern_nnz": self.snapshot.nnz,
            "pattern_fingerprint": self.snapshot.fingerprint[:12],
            "drift_threshold": self.config.drift_threshold,
            "topology": self.topology.describe(),
            "materialized": tuple(p for p, r in sorted(self._rungs.items())
                                  if r.materialized),
        }
        rung = self._rungs[self.current_P]
        if rung.materialized and rung.generation == self.generation:
            out["handle"] = rung.handle.stats()
        return out

    def __repr__(self) -> str:
        return (f"SpmmSession(ladder={self.ladder}, "
                f"current_P={self.current_P}, gen={self.generation}, "
                f"pattern={self.snapshot.fingerprint[:8]}, "
                f"topology={self.topology.kind}/{self.topology.P})")

    # ----- serialization -----------------------------------------------

    def save(self, path: str, include_operand: bool = True) -> str:
        """Persist the whole ladder as an atomic directory bundle.

        Layout (published by one rename — see ``atomic_dir``):
          session.json        format/version stamp + ladder index
          rung_P{P}.shiro     per-rung DistSpmm payload (pickle)
          operand.pkl         the live sparse operand (optional; needed
                              for post-load replans)

        session.json carries a per-file size+sha256 manifest of the
        other bundle files; ``load`` verifies it before unpickling, so a
        bundle torn in transit fails naming the damaged file.
        """
        from ..checkpoint.manager import atomic_dir, bundle_manifest

        with atomic_dir(path) as tmp:
            for P, rung in sorted(self._rungs.items()):
                with open(os.path.join(tmp, _rung_file(P)), "wb") as f:
                    pickle.dump(rung.payload, f)
            if include_operand and self._operand is not None:
                with open(os.path.join(tmp, "operand.pkl"), "wb") as f:
                    pickle.dump(self._operand, f)
            meta = {
                "files": bundle_manifest(tmp),
                "format": _SESSION_FORMAT,
                "version": _SESSION_VERSION,
                "ladder": list(self.ladder),
                "current_P": self.current_P,
                "generation": self.generation,
                "pattern_fingerprint": self.snapshot.fingerprint,
                "drift_threshold": self.config.drift_threshold,
                "has_operand": bool(include_operand
                                    and self._operand is not None),
            }
            with open(os.path.join(tmp, "session.json"), "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str, where: Union[Topology, int, None] = None, *,
             device: Device = "cuda") -> "SpmmSession":
        """Rebuild a session from a ``save`` bundle on this process.

        ``where``: a Topology or an int P on ``device``; None selects the
        bundle's current rung P. Handles materialize lazily — loading
        never runs MWVC and never touches the device. TRUSTED INPUT ONLY
        (rung files are pickles, exactly like ``DistSpmm.load``).
        """
        meta_path = os.path.join(path, "session.json")
        if not os.path.exists(meta_path):
            raise ValueError(
                f"{path!r} is not a saved SpmmSession bundle (no "
                f"session.json); DistSpmm plans are single files — use "
                f"DistSpmm.load for those")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != _SESSION_FORMAT:
            raise ValueError(f"{path!r} is not a saved SpmmSession bundle")
        if meta.get("version") not in _KNOWN_SESSION_VERSIONS:
            raise ValueError(
                f"{path!r} carries SpmmSession bundle version "
                f"{meta.get('version')!r}; this library understands "
                f"{_KNOWN_SESSION_VERSIONS}. Re-save the session with "
                f"the version that will load it — bundles regenerate "
                f"cheaply from the operand matrix.")
        from ..checkpoint.manager import verify_bundle

        # digest-verify every bundle file BEFORE unpickling anything: a
        # torn/truncated copy fails here naming the file (old bundles
        # without a manifest skip verification and load as before)
        verify_bundle(path, meta.get("files"),
                      source=f"SpmmSession bundle {path!r}")
        rungs: Dict[int, LadderRung] = {}
        snapshot: Optional[PatternSnapshot] = None
        config: Optional[SpmmConfig] = None
        for P in meta["ladder"]:
            fname = os.path.join(path, _rung_file(P))
            if not os.path.exists(fname):
                raise ValueError(
                    f"SpmmSession bundle {path!r} is missing "
                    f"{_rung_file(P)} for ladder rung P={P} — the bundle "
                    f"is incomplete (torn copy); re-fetch or re-save it.")
            with open(fname, "rb") as f:
                payload = pickle.load(f)
            check_payload_version(payload, fname)
            rungs[int(P)] = LadderRung(int(P), payload,
                                       generation=0)
            snapshot = payload.get("snapshot") or snapshot
            config = payload["config"]
        operand = None
        if meta.get("has_operand"):
            with open(os.path.join(path, "operand.pkl"), "rb") as f:
                operand = pickle.load(f)
        current = int(meta["current_P"])
        topo = Topology.resolve(current if where is None else where, device)
        if snapshot is None:
            raise ValueError(
                f"{path!r} carries no pattern snapshot in any rung; the "
                f"bundle predates drift detection — re-save it")
        session = cls(config=config, topology=topo, rungs=rungs,
                      current_P=current, snapshot=snapshot,
                      operand=operand, generation=0)
        # the loaded topology may not fit the bundle's current rung
        rung = session._nearest_rung(session.ladder, topo.P)
        if rung is None:
            raise TopologyError(
                f"bundle ladder {session.ladder} has no rung fitting the "
                f"topology (P={topo.P}); load on a bigger fleet or "
                f"re-build with a smaller rung")
        session.current_P = rung
        return session


def _guard_operand(a: CSRMatrix, config: SpmmConfig,
                   context: str) -> CSRMatrix:
    """The plan-time operand gate: apply any scheduled ``nan_poison``
    fault (site ``operand``), then — under ``config.check`` — validate
    the nonzero values are finite before MWVC sees them."""
    a = faults.maybe_poison_values(a, site="operand")
    if guards.check_mode(config):
        guards.validate_sparse_values(a, context=context)
    return a


def _rung_file(P: int) -> str:
    return f"rung_P{int(P):05d}.shiro"
