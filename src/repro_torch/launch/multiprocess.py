"""Multi-process launch: SHIRO across real processes.

Port of ``repro/launch/multiprocess.py``. Every other path of the port
runs its P ranks inside one process; this module runs the front door
across a fleet of processes, each owning a contiguous span of the ranks:

* every process executes the SAME program (plan → session → serve);
* planning is deterministic host code, so each process derives
  byte-identical plans from the operand — no plan broadcast needed;
* per-process data: ``Topology.put_global`` hands each process only its
  rows of an operand, and only its span of the exec arrays goes to its
  device; a call returns its rows of C (``DistSpmm.row_blocks``);
* ``Topology.multiprocess()`` names the fleet (processes × local ranks =
  the intrinsic two-tier structure), so ``hier="auto"`` / ``net="auto"``
  read the real substrate, and the rows that cross the process boundary
  really leave the process (``distributed.comm.ProcessComm``, over gloo).

A CUDA fleet runs process i on ``cuda:{i % device_count}``: on a one-card
machine every process shares ``cuda:0``, which is why the exchange is
gloo through pinned host buffers (NCCL refuses two ranks on one device).

Two entry modes:

  launcher (the default):
      python -m repro_torch.launch.multiprocess --nproc 2 --local-devices 4
  spawns ``--nproc`` copies of itself as workers on this machine with a
  local coordinator, waits, and propagates any worker failure. With
  ``--device cuda`` (the default) it builds the kernel library once
  first, so the workers load it instead of each running nvcc.

  worker (``REPRO_MP_RANK`` set by the launcher, or exported by hand):
  initializes ``torch.distributed`` and runs the quickstart smoke across
  the fleet — compile through ``SpmmSession``, serve two call shapes,
  check every row this process holds against the dense reference,
  exercise a replan hot-swap.

Supervised mode (``--supervise``) wraps the launcher in a recovery
loop: workers write heartbeat files (progress-stamped, atomic) into a
shared rundir; the ``Supervisor`` detects a dead worker (nonzero exit)
or a stalled one (no progress within ``REPRO_MP_HEARTBEAT_TIMEOUT``)
within one poll interval, kills the remaining fleet (a dead rank leaves
its siblings blocked in collectives, so the recoverable unit is the
fleet), and relaunches it with bounded exponential backoff. Each
relaunch bumps ``REPRO_FAULTS_EPOCH`` so injected faults scheduled for
epoch 0 don't re-fire — a restarted fleet runs clean. When
``REPRO_MP_MAX_RESTARTS`` is exhausted the supervisor DEGRADES instead
of giving up: it relaunches with one fewer process, and the workers —
whose ``SpmmSession`` is built over the full P-ladder
(``REPRO_MP_LADDER``) — drive ``session.on_resize`` down to the largest
rung the surviving processes fit. Every wait is deadline-bounded; the
supervisor never hangs.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..robustness import faults

__all__ = ["initialize", "shutdown", "worker_smoke", "launch_local", "main",
           "Heartbeat", "Supervisor", "SupervisorPolicy",
           "write_heartbeat", "read_heartbeat", "heartbeat_path"]

COORD_ENV = "REPRO_MP_COORD"
NPROC_ENV = "REPRO_MP_NPROC"
RANK_ENV = "REPRO_MP_RANK"
LOCAL_ENV = "REPRO_MP_LOCAL_DEVICES"
DEVICE_ENV = "REPRO_MP_DEVICE"
RUNDIR_ENV = "REPRO_MP_RUNDIR"
LADDER_ENV = "REPRO_MP_LADDER"
DEGRADED_ENV = "REPRO_MP_DEGRADED"
HEARTBEAT_ENV = "REPRO_MP_HEARTBEAT"
HEARTBEAT_TIMEOUT_ENV = "REPRO_MP_HEARTBEAT_TIMEOUT"
MAX_RESTARTS_ENV = "REPRO_MP_MAX_RESTARTS"
BACKOFF_ENV = "REPRO_MP_BACKOFF"

# the directory holding the ``repro_torch`` package, put on a worker's
# PYTHONPATH so ``python -m repro_torch.launch.multiprocess`` finds it
_SRC = str(Path(__file__).resolve().parents[2])
WORKER_MODULE = "repro_torch.launch.multiprocess"


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------


def heartbeat_path(rundir: str, rank: int) -> str:
    return os.path.join(rundir, f"hb_{int(rank)}.json")


def write_heartbeat(rundir: str, rank: int, *, stage: str, progress: int,
                    progress_time: Optional[float] = None) -> None:
    """One atomic heartbeat-file update (tmp + replace, like every other
    publish in the repo — the supervisor never reads half a record)."""
    now = time.time()
    rec = {"rank": int(rank), "pid": os.getpid(), "stage": stage,
           "progress": int(progress),
           "progress_time": float(progress_time
                                  if progress_time is not None else now),
           "time": now}
    path = heartbeat_path(rundir, rank)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
    except OSError:  # rundir torn down mid-shutdown: never fatal
        pass


def read_heartbeat(rundir: str, rank: int) -> Optional[dict]:
    try:
        with open(heartbeat_path(rundir, rank)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class Heartbeat:
    """A worker's liveness signal: a background writer thread plus
    MAIN-THREAD progress stamps.

    The writer thread updates the file even while the main thread is
    stuck in a collective, so mere file freshness can't detect a stall.
    ``progress_time`` is only advanced by ``tick()`` / ``stage()`` calls
    from the worker's main thread — the supervisor keys stall detection
    on THAT, catching both a wedged process (file goes stale too) and a
    wedged main thread (file fresh, progress old).
    """

    def __init__(self, rundir: str, rank: int, interval: float = 0.5):
        self.rundir = rundir
        self.rank = int(rank)
        self.interval = float(interval)
        self.progress = 0
        self.progress_time = time.time()
        self._stage = "start"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"heartbeat-{rank}")

    @classmethod
    def maybe_start(cls, rank: int) -> Optional["Heartbeat"]:
        """Start a heartbeat iff the supervisor provided a rundir —
        unsupervised launches carry no new machinery."""
        rundir = os.environ.get(RUNDIR_ENV)
        if not rundir:
            return None
        hb = cls(rundir, rank,
                 interval=float(os.environ.get(HEARTBEAT_ENV, "0.5")))
        hb._write()
        hb._thread.start()
        return hb

    def stage(self, name: str) -> None:
        self._stage = name
        self.tick()

    def tick(self) -> None:
        self.progress += 1
        self.progress_time = time.time()
        self._write()

    def stop(self) -> None:
        self._stop.set()
        self._write()

    def _write(self) -> None:
        write_heartbeat(self.rundir, self.rank, stage=self._stage,
                        progress=self.progress,
                        progress_time=self.progress_time)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._write()


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------


def _loopback(coordinator: str) -> bool:
    host = coordinator.rsplit(":", 1)[0]
    return host in ("localhost", "::1") or host.startswith("127.")


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: Optional[str] = None, timeout: float = 300.0):
    """``torch.distributed.init_process_group("gloo")`` from the arguments
    or the ``REPRO_MP_*`` environment.

    ``coordinator`` is ``host:port`` of process 0's store
    (``REPRO_MP_COORD``), ``num_processes`` / ``process_id`` the fleet's
    size and this process's index (``REPRO_MP_NPROC`` / ``REPRO_MP_RANK``),
    ``device`` ``"cuda"`` or ``"cpu"`` (``REPRO_MP_DEVICE``, default
    ``"cuda"``; a CUDA fleet without a card raises); each process runs
    ``REPRO_MP_LOCAL_DEVICES`` ranks (``Topology.multiprocess``). Every
    collective waits at most ``timeout`` seconds. A coordinator on
    loopback keeps gloo's own connections on the loopback interface.
    Returns the fleet's ``Topology`` (multiprocess kind).
    """
    import torch.distributed as dist

    from ..distributed.topology import Topology

    coordinator = coordinator or os.environ.get(COORD_ENV)
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get(NPROC_ENV, "0"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get(RANK_ENV, "-1"))
    device = device or os.environ.get(DEVICE_ENV, "cuda")
    if not coordinator or num_processes < 1 or process_id < 0:
        raise ValueError(
            f"initialize needs the coordinator, the process count and this "
            f"process's index ({COORD_ENV}, {NPROC_ENV}, {RANK_ENV}); got "
            f"{coordinator!r}, {num_processes}, {process_id}")
    # fail before the rendezvous, not inside a collective
    from ..distributed.topology import resolve_device

    resolve_device(device)
    if _loopback(coordinator) and "GLOO_SOCKET_IFNAME" not in os.environ \
            and "lo" in (name for _, name in socket.if_nameindex()):
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=float(timeout)))
    return Topology.multiprocess(device=device)


def shutdown() -> None:
    """Leave the fleet (``destroy_process_group``) if this process is in
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def worker_smoke() -> None:
    """The quickstart flow across the fleet: one session, real processes.

    Under a supervisor (``REPRO_MP_RUNDIR`` set) the worker heartbeats
    through named stages — each stage boundary is a fault fire site
    (``stage:init`` / ``stage:plan`` / ``stage:serve`` /
    ``stage:replan``) for injected worker kills and delays, and each call
    passes the ``collective`` delay site — and builds its session over
    the supervisor's full P-ladder (``REPRO_MP_LADDER``), driving
    ``on_resize`` to the largest rung the live fleet fits; a degraded
    relaunch therefore serves the surviving rung of the SAME ladder. A
    one-process relaunch (``nproc=1``, the last degradation step) skips
    ``torch.distributed`` and runs the identical flow on
    ``Topology.local``.
    """
    import numpy as np

    env_rank = int(os.environ.get(RANK_ENV, "0") or 0)
    hb = Heartbeat.maybe_start(env_rank)

    def stage(name: str) -> None:
        if hb is not None:
            hb.stage(name)
        faults.maybe_kill(f"stage:{name}", rank=env_rank)
        faults.maybe_delay(f"stage:{name}", rank=env_rank)

    stage("init")
    nproc = int(os.environ.get(NPROC_ENV, "0") or 0)
    device = os.environ.get(DEVICE_ENV, "cuda")
    from ..distributed.topology import Topology

    if nproc == 1:
        # degraded one-process relaunch: no fleet to coordinate
        topo = Topology.local(int(os.environ.get(LOCAL_ENV, "4")), device)
    else:
        topo = initialize()
    rank = topo.process_index
    print(f"[rank {rank}] fleet: {topo.n_hosts} processes x "
          f"{topo.local_device_count or topo.P} ranks = P={topo.P} "
          f"(tiers={topo.tiers}) on {topo.device}", flush=True)

    from ..core.api import SpmmConfig
    from ..core.session import SpmmSession
    from ..core.sparse import power_law_sparse

    stage("plan")
    ladder_env = os.environ.get(LADDER_ENV, "")
    p_ladder = tuple(int(p) for p in ladder_env.split(",") if p) or None
    a = power_law_sparse(128, 128, 1024, 1.3, seed=0)
    session = SpmmSession.build(a, topo, SpmmConfig(schedule="auto"),
                                p_ladder=p_ladder)
    if p_ladder is not None:
        # the elastic path: the ladder may span fleets bigger than this
        # one — serve the largest rung the live rank census fits
        handle = session.on_resize(topo.P)
        degraded = os.environ.get(DEGRADED_ENV, "")
        if degraded:
            print(f"[rank {rank}] degraded fleet ({degraded}): "
                  f"on_resize -> surviving rung P={session.current_P} "
                  f"of ladder {session.ladder}", flush=True)
    else:
        handle = session.handle()
    st = handle.stats()
    print(f"[rank {rank}] {handle} schedule={st['schedule_kind']}"
          f"/K={st['schedule_K']} net={st['net']}", flush=True)

    stage("serve")
    rng = np.random.default_rng(1)
    for n_cols in (8, 16):
        faults.maybe_delay("collective", rank=env_rank)
        b = rng.standard_normal((128, n_cols)).astype(np.float32)
        c = handle(b)
        ref = a.to_dense() @ b
        _check_shards(c, handle.row_blocks(), ref, rank, f"N={n_cols}")
        if hb is not None:
            hb.tick()
    print(f"[rank {rank}] smoke N=8,16 == dense reference  OK", flush=True)

    # drift -> replan hot-swap across the fleet: every process replans
    # deterministically, the swapped handle serves the same fleet
    stage("replan")
    a2 = power_law_sparse(128, 128, 1024, 1.3, seed=7)
    drift, replanned = session.maybe_replan(a2)
    assert replanned, f"expected a replan, drift={drift}"
    b = rng.standard_normal((128, 8)).astype(np.float32)
    h2 = session.handle()
    _check_shards(h2(b), h2.row_blocks(), a2.to_dense() @ b, rank, "replan")
    print(f"[rank {rank}] drift={drift:.2f} replan hot-swap OK", flush=True)
    stage("done")
    if hb is not None:
        hb.stop()
    shutdown()


def _check_shards(c, blocks: Sequence[Tuple[int, int]], ref, rank: int,
                  tag: str) -> None:
    """Every row block this process holds (``DistSpmm.row_blocks``, in
    the order of ``c``'s rows) must match its rows of the reference."""
    import numpy as np

    got = c.detach().cpu().numpy()
    off = 0
    for start, stop in blocks:
        np.testing.assert_allclose(
            got[off:off + stop - start], ref[start:stop],
            rtol=2e-4, atol=2e-4,
            err_msg=f"rank {rank} rows [{start}, {stop}) mismatch ({tag})")
        off += stop - start
    if off != got.shape[0]:
        raise AssertionError(f"rank {rank}: C has {got.shape[0]} rows, the "
                             f"handle names {off} ({tag})")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(rank: int, nproc: int, local_devices: int, device: str,
                coord: str, **extra: str) -> Dict[str, str]:
    env = dict(os.environ, **{COORD_ENV: coord, NPROC_ENV: str(nproc),
                              RANK_ENV: str(rank),
                              LOCAL_ENV: str(local_devices),
                              DEVICE_ENV: device}, **extra)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _SRC + (os.pathsep + path if path else "")
    return env


def _prepare_device(device: str) -> None:
    """Build (or load) the kernel library once, before a CUDA fleet's
    workers start, so none of them runs nvcc."""
    if device == "cuda":
        from ..distributed.topology import resolve_device
        from ..kernels import build

        resolve_device(device)
        build.library()


def _kill_all(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover
            pass


def launch_local(nproc: int, local_devices: int, timeout: float = 600.0,
                 device: str = "cuda", argv: Optional[List[str]] = None
                 ) -> int:
    """Spawn ``nproc`` workers on this machine and wait for them.

    Each worker runs ``argv`` (default: this module's worker,
    ``worker_smoke``) with the ``REPRO_MP_*`` environment naming a fresh loopback coordinator, its index, the fleet's size, its
    ``local_devices`` ranks and ``device``. Returns 0 when every worker
    exits 0; otherwise the first failure's code, after killing the rest
    at once (they would wait in a collective for the dead one). Every
    worker is killed at ``timeout`` seconds.
    """
    _prepare_device(device)
    coord = f"127.0.0.1:{_free_port()}"
    cmd = argv or [sys.executable, "-m", WORKER_MODULE]
    procs = [subprocess.Popen(cmd, env=_worker_env(
        rank, nproc, local_devices, device, coord)) for rank in range(nproc)]
    deadline = time.time() + timeout
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed:
                rank, code = failed[0]
                print(f"worker {rank} exited with {code}", file=sys.stderr,
                      flush=True)
                rc = code if code > 0 else 1
                break
            if all(c == 0 for c in codes):
                break
            if time.time() > deadline:
                print(f"workers timed out after {timeout:.0f}s",
                      file=sys.stderr, flush=True)
                rc = 1
                break
            time.sleep(0.05)
    finally:
        _kill_all(procs)
    return rc


# ---------------------------------------------------------------------------
# supervised fleet recovery
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SupervisorPolicy:
    """Recovery knobs (each with an env override, see ``from_env``).

    ``heartbeat_timeout``  seconds without main-thread progress before a
                           live worker counts as stalled.
    ``max_restarts``       full-fleet relaunches per fleet size before
                           degrading to a smaller fleet.
    ``backoff``            base of the exponential restart backoff;
                           capped at ``backoff_max``.
    ``timeout``            wall-clock bound per fleet launch — the
                           supervisor's promise to never hang.
    """

    heartbeat_timeout: float = 90.0
    max_restarts: int = 2
    backoff: float = 0.5
    backoff_max: float = 10.0
    poll: float = 0.2
    timeout: float = 600.0

    @classmethod
    def from_env(cls, **overrides) -> "SupervisorPolicy":
        kw = {
            "heartbeat_timeout": float(os.environ.get(
                HEARTBEAT_TIMEOUT_ENV, cls.heartbeat_timeout)),
            "max_restarts": int(os.environ.get(
                MAX_RESTARTS_ENV, cls.max_restarts)),
            "backoff": float(os.environ.get(BACKOFF_ENV, cls.backoff)),
        }
        kw.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kw)


class Supervisor:
    """Heartbeat-watching fleet supervisor: restart, then degrade.

    One ``run()`` drives launches until either a fleet finishes clean
    (exit 0) or recovery is exhausted down to a failing single process
    (exit 1). Per incident (worker died / stalled / fleet timeout) the
    surviving processes are killed — a dead rank leaves siblings blocked
    in collectives — and the whole fleet relaunches with a fresh
    coordinator, a bumped fault epoch (``REPRO_FAULTS_EPOCH``), and
    exponential backoff. After ``policy.max_restarts`` failures at one
    fleet size the supervisor relaunches with ``nproc - 1`` processes:
    workers rebuild over the same ``REPRO_MP_LADDER`` and ``on_resize``
    onto the largest surviving rung (graceful degradation, not an
    error). ``spawn`` is injectable so the recovery logic is testable
    with fake workers and no fleet.
    """

    def __init__(self, nproc: int, local_devices: int,
                 policy: Optional[SupervisorPolicy] = None, spawn=None,
                 device: str = "cuda"):
        self.nproc = int(nproc)
        self.local_devices = int(local_devices)
        self.device = device
        self.policy = policy or SupervisorPolicy.from_env()
        self.spawn = spawn or self._spawn_worker
        self.report: dict = {"restarts": 0, "epoch": 0,
                             "nproc": self.nproc, "degraded": False,
                             "incidents": []}

    # -- spawning -------------------------------------------------------

    def _ladder_env(self) -> str:
        """The full P-ladder every (possibly degraded) fleet size serves
        a rung of: one rung per surviving process count."""
        return ",".join(str(n * self.local_devices)
                        for n in range(1, self.nproc + 1))

    def _spawn_worker(self, rank: int, nproc: int, epoch: int,
                      coord: str, rundir: str) -> subprocess.Popen:
        extra = {RUNDIR_ENV: rundir, LADDER_ENV: self._ladder_env(),
                 faults.EPOCH_ENV: str(epoch)}
        if nproc < self.nproc:
            extra[DEGRADED_ENV] = (f"{self.nproc * self.local_devices}->"
                                   f"{nproc * self.local_devices}")
        return subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE],
            env=_worker_env(rank, nproc, self.local_devices, self.device,
                            coord, **extra))

    # -- watching -------------------------------------------------------

    def _watch(self, procs: Dict[int, subprocess.Popen], rundir: str
               ) -> Optional[Tuple[str, Optional[int], str]]:
        """Block until the fleet finishes clean (None) or an incident
        ``(kind, rank, detail)`` occurs. Deadline-bounded — never hangs."""
        pol = self.policy
        start = time.time()
        deadline = start + pol.timeout
        while True:
            alive = False
            for rank, p in procs.items():
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    return ("died", rank, f"exit {rc}")
            if not alive:
                return None  # every worker exited 0
            now = time.time()
            if now > deadline:
                return ("timeout", None,
                        f"fleet exceeded {pol.timeout:.0f}s")
            for rank, p in procs.items():
                if p.poll() is not None:
                    continue
                hb = read_heartbeat(rundir, rank)
                ref = float((hb or {}).get("progress_time") or start)
                if now - ref > pol.heartbeat_timeout:
                    at = (hb or {}).get("stage", "<no heartbeat>")
                    return ("stalled", rank,
                            f"no progress for {now - ref:.1f}s at "
                            f"stage {at!r}")
            time.sleep(pol.poll)

    @staticmethod
    def _kill_fleet(procs: Dict[int, subprocess.Popen]) -> None:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 5.0
        for p in procs.values():
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=5.0)
            except Exception:
                pass

    # -- the recovery loop ----------------------------------------------

    def run(self) -> int:
        pol = self.policy
        nproc = self.nproc
        epoch = 0
        restarts_at_size = 0
        if self.spawn == self._spawn_worker:
            _prepare_device(self.device)
        while True:
            rundir = tempfile.mkdtemp(prefix="repro_mp_hb_")
            coord = f"127.0.0.1:{_free_port()}"
            procs = {r: self.spawn(r, nproc, epoch, coord, rundir)
                     for r in range(nproc)}
            incident = self._watch(procs, rundir)
            self._kill_fleet(procs)
            shutil.rmtree(rundir, ignore_errors=True)
            self.report["epoch"] = epoch
            self.report["nproc"] = nproc
            if incident is None:
                total = self.report["restarts"]
                if self.report["degraded"]:
                    print(f"supervisor: recovered DEGRADED — fleet "
                          f"nproc={nproc} after {total} restart(s), "
                          f"serving the surviving rung  OK", flush=True)
                elif total:
                    print(f"supervisor: recovered after {total} "
                          f"restart(s) (nproc={nproc})  OK", flush=True)
                else:
                    print(f"supervisor: fleet healthy "
                          f"(nproc={nproc}, no incidents)  OK", flush=True)
                return 0
            kind, rank, detail = incident
            self.report["incidents"].append(
                {"kind": kind, "rank": rank, "detail": detail,
                 "epoch": epoch})
            who = f"worker {rank}" if rank is not None else "fleet"
            print(f"supervisor: {who} {kind} ({detail}) in epoch {epoch}",
                  file=sys.stderr, flush=True)
            epoch += 1
            if restarts_at_size < pol.max_restarts:
                restarts_at_size += 1
                self.report["restarts"] += 1
                delay = min(pol.backoff * 2.0 ** (restarts_at_size - 1),
                            pol.backoff_max)
                print(f"supervisor: restarting fleet (attempt "
                      f"{restarts_at_size}/{pol.max_restarts}, backoff "
                      f"{delay:.1f}s)", file=sys.stderr, flush=True)
                time.sleep(delay)
                continue
            if nproc > 1:
                nproc -= 1
                restarts_at_size = 0
                self.report["degraded"] = True
                print(f"supervisor: restarts exhausted — degrading to "
                      f"nproc={nproc} (ladder rung "
                      f"P={nproc * self.local_devices} serves the "
                      f"surviving ranks)", file=sys.stderr, flush=True)
                continue
            print("supervisor: restarts exhausted at nproc=1; giving up",
                  file=sys.stderr, flush=True)
            return 1


def main() -> None:
    if os.environ.get(RANK_ENV) is not None:
        worker_smoke()
        return
    ap = argparse.ArgumentParser(
        description="local multi-process smoke launcher")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4,
                    help="ranks per worker process")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every worker's ranks run (cuda: "
                         "cuda:{rank %% device_count})")
    ap.add_argument("--supervise", action="store_true",
                    help="wrap the launch in heartbeat-watching fleet "
                         "recovery (restart with backoff, then degrade)")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help=f"fleet relaunches per size before degrading "
                         f"(default {SupervisorPolicy.max_restarts}; env "
                         f"{MAX_RESTARTS_ENV})")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help=f"stall detection threshold in seconds (default "
                         f"{SupervisorPolicy.heartbeat_timeout}; env "
                         f"{HEARTBEAT_TIMEOUT_ENV})")
    ap.add_argument("--backoff", type=float, default=None,
                    help=f"restart backoff base in seconds (default "
                         f"{SupervisorPolicy.backoff}; env {BACKOFF_ENV})")
    args = ap.parse_args()
    if args.supervise:
        policy = SupervisorPolicy.from_env(
            max_restarts=args.max_restarts,
            heartbeat_timeout=args.heartbeat_timeout,
            backoff=args.backoff, timeout=args.timeout)
        rc = Supervisor(args.nproc, args.local_devices, policy=policy,
                        device=args.device).run()
        if rc:
            raise SystemExit(rc)
        return
    rc = launch_local(args.nproc, args.local_devices, timeout=args.timeout,
                      device=args.device)
    if rc:
        raise SystemExit(rc)
    print(f"multiprocess smoke: {args.nproc} processes x "
          f"{args.local_devices} ranks on {args.device}  OK")


if __name__ == "__main__":
    main()
