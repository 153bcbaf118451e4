"""Fault injection + guardrails: the port's robustness layer.

``faults`` schedules deterministic failures (cache corruption, torn
writes, NaN poisoning, and the kinds the serving and multi-process
slices will honor) against named fire sites; ``guards`` owns the
``SpmmConfig.check`` validation the serving path runs against bad
inputs. Ports of ``repro/robustness``; see each module's docstring.
"""
from .faults import (  # noqa: F401
    FAULTS_ENV, EPOCH_ENV, KILL_EXIT_CODE, Fault, FaultPlan,
    InjectedFault, active_plan, inject, install, uninstall,
)
from .guards import NumericalFault  # noqa: F401

__all__ = [
    "FAULTS_ENV",
    "EPOCH_ENV",
    "KILL_EXIT_CODE",
    "Fault",
    "FaultPlan",
    "InjectedFault",
    "NumericalFault",
    "active_plan",
    "inject",
    "install",
    "uninstall",
]
