"""Deterministic fault injection: a scheduled ``FaultPlan`` for the stack.

Port of ``repro/robustness/faults.py``. The plans, the environment
variables and their JSON are the reference's, so one ``REPRO_FAULTS``
value drives both packages; ``maybe_poison_array`` poisons a torch
tensor (a clone), and the fire sites this package has so far are
``autotune_cache`` (``core.autotune``), ``atomic_dir``
(``checkpoint.manager``), ``operand`` (``core.session``), ``output``
(``DistSpmm`` calls), ``wave`` (``serving.scheduler.SpmmWaveServer``)
and ``fleet_migrate_fail`` (``serving.fleet.SpmmFleet.migrate``). The
worker sites come with the multi-process slice.

At 128-GPU scale worker loss, slow links, torn writes and poisoned
inputs are routine events; a fault-tolerance story that is never
exercised is a story, not a property. This module makes the messy parts
injectable and DETERMINISTIC — every fault is scheduled against a named
fire site and a match counter, so a chaos test replays bit-for-bit:

    plan = FaultPlan([Fault(kind="wave_error", site="wave", times=2)])
    with inject(plan):
        server.run()          # the first two waves raise InjectedFault
    assert plan.fired("wave_error") == 2

Fault kinds and the sites that honor them:

  ``worker_kill``       ``launch.multiprocess`` worker stage boundaries
                        (sites ``stage:init``/``stage:plan``/
                        ``stage:serve``/``stage:replan``) — the process
                        dies with ``os._exit(KILL_EXIT_CODE)``, exactly
                        like a preempted host.
  ``collective_delay``  sleeps ``delay`` seconds at the site (``wave``
                        in ``SpmmWaveServer``, worker stages in
                        multiprocess) — a slow link / straggler.
  ``wave_error``        raises ``InjectedFault`` at the site (``wave``
                        in ``SpmmWaveServer`` — a transient execution
                        failure the retry path must absorb; or
                        ``fleet_migrate_fail`` in ``SpmmFleet.migrate``,
                        between stage and commit — the migration must
                        roll back to the source group without dropping
                        a wave).
  ``autotune_corrupt``  corrupts the just-written autotune cache entry
                        (site ``autotune_cache``; ``mode`` picks
                        zero-byte / truncated / garbage bytes) — a torn
                        concurrent write.
  ``torn_checkpoint``   truncates one staged file inside an
                        ``atomic_dir`` bundle right before it publishes
                        (site ``atomic_dir``) — a torn object-store
                        copy; manifests with per-file digests must catch
                        it at load.
  ``nan_poison``        poisons an array with NaNs (site ``operand`` =
                        the sparse operand's nonzero values at
                        build/replan; site ``output`` = the computed C
                        inside ``DistSpmm.__call__``) — the
                        ``check=`` guardrails must catch both.

Activation: programmatic (``install``/``inject`` — the test fixture
path) or the ``REPRO_FAULTS`` env var (a JSON list of fault dicts, or
``@/path/to/plan.json``) — the path worker subprocesses inherit.
``REPRO_FAULTS_EPOCH`` names the supervisor restart generation: a fault
only fires when its ``epoch`` matches, so a killed-then-restarted fleet
runs clean (recovery) unless the plan schedules faults for later epochs
too (exhausted-retries degradation).

With no active plan every hook is a no-op returning its input — the
instrumented hot paths stay bit-identical to the uninstrumented tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Union

__all__ = [
    "FAULTS_ENV",
    "EPOCH_ENV",
    "KILL_EXIT_CODE",
    "FAULT_KINDS",
    "InjectedFault",
    "Fault",
    "FaultPlan",
    "install",
    "uninstall",
    "active_plan",
    "inject",
    "fire",
    "maybe_kill",
    "maybe_delay",
    "maybe_error",
    "maybe_poison_values",
    "maybe_poison_array",
    "maybe_corrupt_file",
    "maybe_tear_dir",
    "corrupt_file",
]

FAULTS_ENV = "REPRO_FAULTS"
EPOCH_ENV = "REPRO_FAULTS_EPOCH"
# the exit code an injected worker_kill dies with — distinguishable from
# a real crash (1) and from SIGKILL (-9) in supervisor incident logs
KILL_EXIT_CODE = 117

FAULT_KINDS = ("worker_kill", "collective_delay", "wave_error",
               "autotune_corrupt", "torn_checkpoint", "nan_poison")

_CORRUPT_MODES = ("empty", "truncate", "garbage")


class InjectedFault(RuntimeError):
    """The exception a ``wave_error`` fault raises at its site."""


@dataclasses.dataclass
class Fault:
    """One scheduled fault.

    ``kind``   one of ``FAULT_KINDS``.
    ``site``   fire-site name to match (``"*"`` matches every site the
               kind is honored at).
    ``rank``   multiprocess: only this worker rank (None = any).
    ``after``  skip the first ``after`` matching events before firing.
    ``times``  fire on this many events, then disarm.
    ``epoch``  supervisor restart generation the fault is armed in
               (``REPRO_FAULTS_EPOCH``; 0 = the first launch).
    ``delay``  ``collective_delay``: seconds to sleep.
    ``mode``   file-corruption flavor for ``autotune_corrupt`` /
               ``torn_checkpoint``: 'empty' | 'truncate' | 'garbage'.
    ``file``   ``torn_checkpoint``: substring selecting which staged
               file to tear (None = the largest file in the bundle).
    """

    kind: str
    site: str = "*"
    rank: Optional[int] = None
    after: int = 0
    times: int = 1
    epoch: int = 0
    delay: float = 0.0
    mode: str = "truncate"
    file: Optional[str] = None
    # bookkeeping (not part of the schedule)
    seen: int = dataclasses.field(default=0, compare=False)
    hits: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.mode not in _CORRUPT_MODES:
            raise ValueError(
                f"unknown corruption mode {self.mode!r}; "
                f"known: {_CORRUPT_MODES}")
        if int(self.times) < 1 or int(self.after) < 0:
            raise ValueError(
                f"fault needs times >= 1 and after >= 0; got "
                f"times={self.times!r} after={self.after!r}")

    def matches(self, site: str, rank: Optional[int], epoch: int) -> bool:
        if int(self.epoch) != int(epoch):
            return False
        if self.site != "*" and self.site != site:
            return False
        if self.rank is not None and rank is not None \
                and int(self.rank) != int(rank):
            return False
        return True

    def to_dict(self) -> Dict[str, Any]:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)
               if f.name not in ("seen", "hits")}
        return {k: v for k, v in out.items()
                if v != _FAULT_DEFAULTS.get(k, object())}


_FAULT_DEFAULTS = {f.name: f.default for f in dataclasses.fields(Fault)
                   if f.default is not dataclasses.MISSING}


class FaultPlan:
    """A deterministic schedule of faults plus its firing state.

    ``take(kind, site, rank)`` is the single decision point every hook
    routes through: the first fault matching (kind, site, rank, epoch)
    counts the event, and fires iff the event index lands inside its
    ``[after, after + times)`` window. Counters make assertions easy
    (``plan.fired(kind)``) and firing deterministic — the same call
    sequence always trips the same faults.
    """

    def __init__(self, faults: Sequence[Union[Fault, Dict[str, Any]]],
                 epoch: int = 0):
        self.faults: List[Fault] = [
            f if isinstance(f, Fault) else Fault(**f) for f in faults]
        self.epoch = int(epoch)

    def take(self, kind: str, site: str,
             rank: Optional[int] = None) -> Optional[Fault]:
        for f in self.faults:
            if f.kind != kind or not f.matches(site, rank, self.epoch):
                continue
            f.seen += 1
            if f.after < f.seen <= f.after + f.times:
                f.hits += 1
                _log(f"fired {kind} at {site!r}"
                     + (f" rank={rank}" if rank is not None else "")
                     + f" (hit {f.hits}/{f.times})")
                return f
            return None  # first match owns the event, fired or not
        return None

    def fired(self, kind: Optional[str] = None) -> int:
        """Total fault firings (optionally of one kind) — for asserts."""
        return sum(f.hits for f in self.faults
                   if kind is None or f.kind == kind)

    def to_env(self) -> str:
        """The ``REPRO_FAULTS`` value reproducing this plan's schedule."""
        return json.dumps([f.to_dict() for f in self.faults])

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        """Parse ``REPRO_FAULTS`` (inline JSON or ``@file``); None when
        unset/empty. A malformed spec raises — a chaos run silently
        testing nothing is worse than a loud config error."""
        env = os.environ if environ is None else environ
        spec = env.get(FAULTS_ENV, "").strip()
        if not spec:
            return None
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read()
        try:
            raw = json.loads(spec)
        except ValueError as e:
            raise ValueError(
                f"{FAULTS_ENV} is not valid JSON ({e}); expected a list "
                f"of fault dicts or @/path/to/plan.json") from None
        if isinstance(raw, dict):
            raw = [raw]
        epoch = int(env.get(EPOCH_ENV, "0") or 0)
        return cls(raw, epoch=epoch)

    def __repr__(self) -> str:
        kinds = ",".join(f"{f.kind}@{f.site}" for f in self.faults)
        return f"FaultPlan([{kinds}], epoch={self.epoch})"


# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None
_ENV_CHECKED = False


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Make ``plan`` the process-wide active plan (None deactivates)."""
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = plan
    _ENV_CHECKED = True  # an explicit install wins over the env var
    return plan


def uninstall() -> None:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = False  # next active_plan() re-reads REPRO_FAULTS


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else the ``REPRO_FAULTS`` plan (parsed once)."""
    global _ACTIVE, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        if _ACTIVE is None:
            _ACTIVE = FaultPlan.from_env()
    return _ACTIVE


@contextlib.contextmanager
def inject(plan_or_faults: Union[FaultPlan, Sequence[Fault]]):
    """Test-fixture activation: install for the block, restore after."""
    global _ACTIVE, _ENV_CHECKED
    plan = (plan_or_faults if isinstance(plan_or_faults, FaultPlan)
            else FaultPlan(list(plan_or_faults)))
    prev, prev_checked = _ACTIVE, _ENV_CHECKED
    install(plan)
    try:
        yield plan
    finally:
        _ACTIVE, _ENV_CHECKED = prev, prev_checked


def _log(msg: str) -> None:
    print(f"[repro_torch.faults] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# fire sites — every hook is a no-op without an active plan
# ---------------------------------------------------------------------------


def fire(kind: str, site: str, rank: Optional[int] = None) -> Optional[Fault]:
    plan = active_plan()
    if plan is None:
        return None
    return plan.take(kind, site, rank)


def maybe_kill(site: str, rank: Optional[int] = None) -> None:
    """``worker_kill``: die like a preempted host — no cleanup, no
    goodbye, exit ``KILL_EXIT_CODE``."""
    if fire("worker_kill", site, rank) is not None:
        _log(f"worker_kill: exiting {KILL_EXIT_CODE} at {site!r}")
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(KILL_EXIT_CODE)


def maybe_delay(site: str, rank: Optional[int] = None) -> float:
    """``collective_delay``: sleep the fault's delay; returns seconds
    slept (0.0 when nothing fired)."""
    f = fire("collective_delay", site, rank)
    if f is None:
        return 0.0
    time.sleep(float(f.delay))
    return float(f.delay)


def maybe_error(site: str, rank: Optional[int] = None) -> None:
    """``wave_error``: raise ``InjectedFault`` at the site."""
    f = fire("wave_error", site, rank)
    if f is not None:
        raise InjectedFault(
            f"injected wave_error at {site!r} (hit {f.hits}/{f.times})")


def maybe_poison_values(a, site: str = "operand"):
    """``nan_poison`` on a sparse operand: NaN its first nonzero value.

    Returns a poisoned copy (CSR containers are frozen) or ``a``
    untouched when no fault fires / the matrix has no nonzeros.
    """
    if fire("nan_poison", site) is None or getattr(a, "nnz", 0) == 0:
        return a
    data = a.data.copy()
    data[0] = float("nan")
    return dataclasses.replace(a, data=data)


def maybe_poison_array(c, site: str = "output"):
    """``nan_poison`` on a dense tensor (or a numpy array): a clone with
    element [0, ..., 0] set to NaN; ``c`` itself (the same object) when
    nothing fires."""
    if fire("nan_poison", site) is None:
        return c
    c = c.clone() if hasattr(c, "clone") else c.copy()
    c[(0,) * c.ndim] = float("nan")
    return c


def corrupt_file(path: str, mode: str) -> None:
    """Damage ``path`` the way real storage does: zero-byte ('empty'),
    cut in half ('truncate'), or overwritten with junk ('garbage')."""
    if mode == "empty":
        open(path, "wb").close()
    elif mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "rb+") as f:
            f.truncate(max(0, size // 2))
    elif mode == "garbage":
        with open(path, "wb") as f:
            f.write(b"\x00garbage\xff" * 4)
    else:  # pragma: no cover — Fault.__post_init__ validates modes
        raise ValueError(f"unknown corruption mode {mode!r}")


def maybe_corrupt_file(kind: str, site: str, path: str) -> bool:
    """File-corruption kinds (``autotune_corrupt``): damage ``path``
    in place per the fault's ``mode``. Returns whether it fired."""
    f = fire(kind, site)
    if f is None or not os.path.exists(path):
        return False
    corrupt_file(path, f.mode)
    _log(f"{kind}: {f.mode} {path}")
    return True


def maybe_tear_dir(site: str, staged: str) -> Optional[str]:
    """``torn_checkpoint``: truncate one staged bundle file just before
    the directory publishes. Picks the fault's ``file`` substring match,
    else the largest staged file. Returns the torn filename (or None).
    """
    f = fire("torn_checkpoint", site)
    if f is None:
        return None
    names = sorted(n for n in os.listdir(staged)
                   if os.path.isfile(os.path.join(staged, n)))
    if f.file is not None:
        names = [n for n in names if f.file in n]
    if not names:
        return None
    victim = max(names, key=lambda n: os.path.getsize(
        os.path.join(staged, n)))
    corrupt_file(os.path.join(staged, victim), f.mode)
    _log(f"torn_checkpoint: {f.mode} {victim} in {staged}")
    return victim
