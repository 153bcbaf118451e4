"""Elastic-scaling controller: topology changes without losing progress.

Port of ``repro/train/elastic.py``, host logic copied. This controller
owns the DECISIONS of a resize:

  * given a reported device census, pick the largest valid mesh that the
    config still shards onto (batch divisibility, expert divisibility);
  * forward every census change to the attached ``SpmmSession``s, which
    select their nearest pre-planned ladder rung.

The census is injected and the remesh math is pure, so it runs the same
on the CPU and beside the card.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

from ..models.config import ModelConfig

log = logging.getLogger("repro_torch.elastic")

__all__ = ["MeshPlan", "propose_mesh", "ElasticController"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    reason: str

    @property
    def size(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


def _divisors_desc(n: int) -> List[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def propose_mesh(cfg: ModelConfig, n_devices: int, global_batch: int,
                 prefer_model: int = 16) -> Optional[MeshPlan]:
    """Largest (data, model) mesh for a device census.

    Constraints: data·model ≤ n_devices; global_batch % data == 0;
    MoE prefers n_experts % model == 0 (falls back otherwise). Greedy on
    total size, then on model-axis closeness to ``prefer_model``.
    """
    best: Optional[MeshPlan] = None
    for model in _divisors_desc(prefer_model * 4):
        if cfg.is_moe and cfg.n_experts % model:
            continue
        data = n_devices // model
        while data > 0 and global_batch % data:
            data -= 1
        if data == 0:
            continue
        plan = MeshPlan((data, model), ("data", "model"),
                        f"census={n_devices} batch={global_batch}")
        if best is None or plan.size > best.size or (
                plan.size == best.size
                and abs(model - prefer_model)
                < abs(best.shape[1] - prefer_model)):
            best = plan
    return best


class ElasticController:
    """Drives resize events: drain -> checkpoint -> remesh -> resume.

    SpMM handles resize through attached ``SpmmSession``s: every census
    change is forwarded to each session's ``on_resize``, which selects
    the nearest pre-planned ladder rung — never re-running MWVC — so a
    remesh costs the sessions only device re-materialization.
    """

    def __init__(self, cfg: ModelConfig, global_batch: int):
        self.cfg = cfg
        self.global_batch = global_batch
        self.current: Optional[MeshPlan] = None
        self.events: List[dict] = []
        self.spmm_sessions: List[object] = []
        self._last_census: Optional[int] = None

    def attach_spmm(self, session) -> None:
        """Subscribe a ``repro_torch.SpmmSession`` to census changes."""
        self.spmm_sessions.append(session)

    def _notify_spmm(self, n_devices: int) -> None:
        from ..distributed.topology import TopologyError

        for session in self.spmm_sessions:
            try:
                handle = session.on_resize(n_devices)
            except TopologyError as e:
                # census fell below the session's smallest rung: that
                # session cannot serve, but the CONTROLLER must keep
                # driving the rest of the fleet (dense remesh, other
                # sessions) — record the halt instead of crashing the
                # census handler; the session keeps its last valid rung
                # for when capacity returns
                self.events.append({"census": n_devices,
                                    "action": "spmm_halt",
                                    "ladder": session.ladder,
                                    "reason": str(e)})
                log.warning("spmm session halted at census %d: %s",
                            n_devices, e)
                continue
            self.events.append({"census": n_devices, "action": "spmm_rung",
                                "rung": handle.plan.P,
                                "ladder": session.ladder})

    def on_census(self, n_devices: int) -> Tuple[bool, Optional[MeshPlan]]:
        """Returns (resize_needed, plan). Idempotent for a stable census."""
        # sessions key on the raw census, NOT the dense mesh shape: a
        # shrink that leaves the (batch-divisibility-capped) dense mesh
        # unchanged — or that halts dense training entirely — must still
        # move SpMM serving off the lost devices
        if n_devices != self._last_census:
            self._last_census = n_devices
            self._notify_spmm(n_devices)
        plan = propose_mesh(self.cfg, n_devices, self.global_batch)
        if plan is None:
            self.events.append({"census": n_devices, "action": "halt",
                                "reason": "no valid mesh"})
            return True, None
        if self.current is not None and plan.shape == self.current.shape:
            return False, self.current
        self.events.append({"census": n_devices, "action": "remesh",
                            "from": self.current.shape if self.current
                            else None,
                            "to": plan.shape})
        log.warning("elastic remesh: %s -> %s (census %d)",
                    self.current.shape if self.current else None,
                    plan.shape, n_devices)
        self.current = plan
        return True, plan
