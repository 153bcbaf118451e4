"""Measured autotuning: timed candidate profiling + an on-disk cache.

Port of ``repro/core/autotune.py``: the same candidate space, cache and
record schema. The card is timed with ``torch.cuda.synchronize()``
around each run (the CPU keeps ``perf_counter`` alone); the cache keys
stamp the torch and CUDA versions (``torch_version``) where the
reference stamps jax's, and the topology fingerprint carries the
card's name. Memory per candidate is ``launch.memory.executable_memory``
of the handle's first call.

The α-β model in ``comm_model`` ranks candidates for free, but its
constants are a stylized network — on a real substrate the best
(strategy tier, schedule K, execution mode, backend) can differ. This
module closes the loop with actual timed executions:

1. ``measured_decide`` enumerates the same candidate space the model
   sweeps (flat vs hier tier x single/bucketed-K schedule x
   staged/overlapped mode), ranks it with the model, and profiles the
   top ``SpmmConfig.profile_topk`` candidates for real: each one is
   materialized into a throwaway handle and timed per backend
   (``profile_warmup`` discarded runs, then the median of
   ``profile_iters`` timed runs).
2. The winner is written to an on-disk cache keyed by (pattern
   fingerprint, topology fingerprint, torch + CUDA version, package
   version, P, config signature). A later ``compile_spmm`` of the same problem on
   the same substrate replays the cached decision with ZERO profiling
   runs and bit-identical decisions (``decision_source`` tells the
   paths apart: ``model`` / ``measured`` / ``cache``).
3. Per-candidate memory comes along for free: the profiled handle's
   first call reports ``total_allocation_size`` (see
   ``launch.memory.executable_memory``; the card only), recorded next
   to the timing — and reused by ``SpmmSession`` to skip ladder rungs over
   ``SpmmConfig.memory_budget`` (``rung_device_bytes``).

Environment:

* ``REPRO_AUTOTUNE_CACHE`` — cache directory; empty/unset disables the
  on-disk cache (and, under ``measure="auto"``, measurement itself).
* ``REPRO_MEASURE`` — ``0`` forces model-only decisions everywhere,
  ``1`` forces measurement even without a cache dir.

Cache files are one JSON object per key; corrupt or unreadable entries
are treated as misses (a warning, then a re-profile) — the cache can
never take serving down.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "CACHE_ENV",
    "MEASURE_ENV",
    "AutotuneCache",
    "get_cache",
    "cache_key",
    "measurement_enabled",
    "measured_decide",
    "profile_candidate",
    "register_profile_hook",
    "unregister_profile_hook",
    "estimate_device_bytes",
    "rung_device_bytes",
    "decision_modeled_time",
]

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
MEASURE_ENV = "REPRO_MEASURE"
# bump when the record schema changes; old entries then read as misses
CACHE_VERSION = 1

# hooks called as hook(info_dict) once per TIMED candidate profiling
# series — tests assert cache hits fire zero of these
_PROFILE_HOOKS: List[Callable[[Dict[str, Any]], None]] = []


def register_profile_hook(fn: Callable) -> Callable:
    """Install a callback fired before each timed candidate profiling."""
    _PROFILE_HOOKS.append(fn)
    return fn


def unregister_profile_hook(fn: Callable) -> None:
    _PROFILE_HOOKS.remove(fn)


def torch_version() -> str:
    """The torch and CUDA versions stamped into cache keys (seam for
    tests): a timing taken under another build never replays."""
    import torch

    return f"torch {torch.__version__} cuda {torch.version.cuda}"


def repro_version() -> str:
    import repro_torch

    return getattr(repro_torch, "__version__", "0")


def cache_dir() -> Optional[str]:
    d = os.environ.get(CACHE_ENV, "")
    return d or None


def measurement_enabled(config) -> bool:
    """Whether ``compile_spmm`` should run timed profiling at all.

    ``REPRO_MEASURE=0``/``1`` overrides everything; otherwise
    ``config.measure`` decides, with ``"auto"`` measuring iff a cache
    directory is configured — so default builds stay model-only-fast
    unless the user opted into persistent measured tuning.
    """
    env = os.environ.get(MEASURE_ENV)
    if env == "0":
        return False
    if env == "1":
        return True
    m = getattr(config, "measure", "auto")
    if m == "auto":
        return cache_dir() is not None
    return bool(m)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


class AutotuneCache:
    """One JSON file per key under ``path``; misses on any damage."""

    def __init__(self, path: str):
        self.path = path

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        fname = self._file(key)
        try:
            if os.path.getsize(fname) == 0:
                # a zero-byte entry is what a torn write looks like on
                # filesystems that journal metadata before data — name
                # it instead of surfacing a bare JSONDecodeError
                raise ValueError("zero-byte entry (torn write)")
            with open(fname) as f:
                rec = json.load(f)
            if not isinstance(rec, dict) \
                    or rec.get("cache_version") != CACHE_VERSION:
                raise ValueError(
                    f"unrecognized record schema "
                    f"(cache_version="
                    f"{rec.get('cache_version') if isinstance(rec, dict) else None!r})")
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            # json.JSONDecodeError subclasses ValueError — corrupt files
            # land here too. A broken cache entry must never take a
            # build down: warn, miss, re-profile, overwrite.
            warnings.warn(
                f"autotune cache entry {fname} unreadable ({e}); "
                f"re-profiling", stacklevel=2)
            return None
        return rec

    def put(self, key: str, rec: Dict[str, Any]) -> None:
        rec = dict(rec, cache_version=CACHE_VERSION)
        fname = self._file(key)
        try:
            os.makedirs(self.path, exist_ok=True)
            # a PRIVATE temp name per writer: concurrent compile_spmm
            # processes racing on one key must never share a staging
            # file (a fixed "<key>.tmp" lets writer B rename writer A's
            # half-written bytes into place); mkstemp + replace keeps
            # last-writer-wins with every published entry complete
            fd, tmp = tempfile.mkstemp(
                dir=self.path, prefix=f"{key}.", suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(rec, f, indent=1, sort_keys=True)
                os.replace(tmp, fname)  # atomic: readers see all or nothing
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError as e:  # read-only cache dir etc — non-fatal
            warnings.warn(f"autotune cache write to {fname} failed ({e})",
                          stacklevel=2)
            return
        from ..robustness import faults

        # chaos hook: a scheduled autotune_corrupt fault damages the
        # entry we just published, exactly like a torn concurrent write
        faults.maybe_corrupt_file("autotune_corrupt", "autotune_cache",
                                  fname)


def get_cache() -> Optional[AutotuneCache]:
    d = cache_dir()
    return AutotuneCache(d) if d else None


def _config_signature(config) -> Dict[str, Any]:
    """The config fields that change what profiling would decide."""
    net = config.net
    return {
        "strategy": config.strategy,
        "kernel": getattr(config, "kernel", "spmm"),
        "edge": getattr(config, "edge", None),
        "hier": list(config.hier) if isinstance(config.hier, tuple)
                else config.hier,
        "backends": list(config.backend_names()),
        "default_backend": config.default_backend,
        "schedule": config.schedule,
        "overlap": config.overlap,
        "replicate": getattr(config, "replicate", 1),
        "net": "auto" if net == "auto" else dataclasses.asdict(net),
        "pad_to": config.pad_to,
        "n_dense_hint": config.n_dense_hint,
        "k_max": config.k_max,
        "donate": config.donate,
        "profile_topk": config.profile_topk,
        "profile_iters": config.profile_iters,
        "profile_warmup": config.profile_warmup,
    }


def cache_key(pattern_fingerprint: str, topo_fingerprint: str,
              config, P: int) -> str:
    """Stable identity of one measured-autotune problem instance."""
    payload = {
        "pattern": pattern_fingerprint,
        "topology": topo_fingerprint,
        "torch": torch_version(),
        "repro": repro_version(),
        "P": int(P),
        "config": _config_signature(config),
    }
    blob = json.dumps(payload, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


# ---------------------------------------------------------------------------
# candidate space
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Candidate:
    tier: str  # 'flat' | 'hier'
    kind: str  # 'single' | 'bucketed'
    K: Optional[int]
    overlap: bool
    model_time: float = 0.0


def _enumerate(plan, hier_cand, config, net) -> List[_Candidate]:
    """The model-ranked candidate list (no backend axis — backends share
    a candidate's handle and are timed against each other inside it)."""
    from .api import _candidate_schedule, _schedule_fields

    n_hint = config.n_dense_hint
    tiers: List[Tuple[str, Any]] = [("flat", None)]
    if hier_cand is not None:
        if isinstance(config.hier, tuple):
            tiers = [("hier", hier_cand)]  # forced (G, L): no flat option
        else:  # "auto": measure both tiers
            tiers.append(("hier", hier_cand))
    if config.schedule == "single":
        kinds: List[Tuple[str, Optional[int]]] = [("single", None)]
    elif isinstance(config.schedule, int):
        kinds = [("bucketed", int(config.schedule))]
    else:
        kinds = [("single", None)] + [("bucketed", K)
                                      for K in range(1, config.k_max + 1)]
    out: List[_Candidate] = []
    for tier, hp in tiers:
        for kind, K in kinds:
            sched = _candidate_schedule(plan, hp, kind, K)
            fields = _schedule_fields(plan, hp, sched, n_hint, net)
            if kind == "bucketed" and config.overlap is not False:
                modes = [True] if config.overlap is True else [False, True]
            else:
                modes = [False]
            for ov in modes:
                t = (fields["modeled_time_overlap"] if ov
                     else fields["modeled_time_staged"])
                out.append(_Candidate(tier, kind, K, ov, t))
    out.sort(key=lambda c: (c.model_time, c.tier, c.kind,
                            c.K or 0, c.overlap))
    return out


def _probe_operand(k_rows: int, n_cols: int) -> np.ndarray:
    """Deterministic dense probe B (same bytes every run — cache keys
    don't cover it, so it must not vary)."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((int(k_rows), int(n_cols))).astype(np.float32)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile_candidate(handle, b, backend: str, *, warmup: int, iters: int,
                      info: Dict[str, Any]) -> float:
    """Median-of-``iters`` wall time of ``handle(b, backend=...)``.

    Fires the profile hooks once (the zero-profiling-on-cache-hit test
    counts these), discards ``warmup`` runs (first-touch), then keeps the
    median of the timed runs — robust to one slow outlier without
    needing many iterations. On the card each run is bracketed by
    ``torch.cuda.synchronize()``, so a time covers the kernels, not just
    their launches.
    """
    for hook in list(_PROFILE_HOOKS):
        hook(dict(info))
    for _ in range(max(0, int(warmup))):
        handle(b, backend=backend)
    times = []
    for _ in range(max(1, int(iters))):
        _sync(handle.device)
        t0 = time.perf_counter()
        handle(b, backend=backend)
        _sync(handle.device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return float(times[len(times) // 2])


# ---------------------------------------------------------------------------
# the measured overlay
# ---------------------------------------------------------------------------


def _apply(plan, hier_cand, config, net, decisions, *, tier: str, kind: str,
           K: Optional[int], overlap: bool, backend: Optional[str],
           measured_time: Optional[float],
           total_allocation_size: Optional[int], source: str):
    """Rebuild (hier, schedule, decisions) for a chosen candidate.

    Both the just-measured path and the cache-hit path come through
    here, so a hit reproduces the measured run's outputs bit-for-bit —
    only ``decision_source`` differs.
    """
    from .api import _candidate_schedule, _schedule_fields

    hp = hier_cand if tier == "hier" else None
    sched = _candidate_schedule(plan, hp, kind, K)
    out = dict(decisions)
    out.update(_schedule_fields(plan, hp, sched, config.n_dense_hint, net))
    out["overlap"] = bool(overlap) and sched.kind == "bucketed"
    if backend is not None:
        out["backend"] = backend
    out["measured_time"] = measured_time
    out["total_allocation_size"] = total_allocation_size
    out["decision_source"] = source
    return plan, hp, sched, out


def measured_decide(a, P: int, config, topo, *, plan, hier, hier_cand,
                    schedule, decisions):
    """Overlay timed-profiling (or cached) decisions on the model's.

    Falls back to the model's choice untouched when every candidate
    fails to profile (the model path is always a safe answer).
    """
    import torch

    from .api import _materialize
    from .sparse import pattern_snapshot

    net = config.resolve_net(topo)
    key = cache_key(pattern_snapshot(a).fingerprint, topo.fingerprint(),
                    config, P)
    cache = get_cache()
    if cache is not None:
        rec = cache.get(key)
        if rec is not None:
            if rec.get("tier") == "hier" and hier_cand is None:
                warnings.warn(
                    "autotune cache entry names a hier tier this build "
                    "has no candidate for; ignoring it", stacklevel=2)
            else:
                return _apply(
                    plan, hier_cand, config, net, decisions,
                    tier=rec["tier"], kind=rec["kind"], K=rec.get("K"),
                    overlap=bool(rec.get("overlap")),
                    backend=rec.get("backend"),
                    measured_time=rec.get("measured_time"),
                    total_allocation_size=rec.get("total_allocation_size"),
                    source="cache")

    candidates = _enumerate(plan, hier_cand, config, net)
    top = candidates[:max(1, int(config.profile_topk))]
    best: Optional[Dict[str, Any]] = None
    for c in top:
        hp = hier_cand if c.tier == "hier" else None
        from .api import _candidate_schedule

        sched = _candidate_schedule(plan, hp, c.kind, c.K)
        dec_c = dict(decisions, overlap=c.overlap)
        try:
            h = _materialize(config, plan, hp, sched, dec_c, topo)
        except Exception as e:  # a candidate that can't build isn't fatal
            warnings.warn(f"autotune candidate {c} failed to materialize "
                          f"({e}); skipping", stacklevel=2)
            continue
        # placed once on the handle's device: a run times the executor,
        # not the host-to-device copy of the probe
        b = torch.from_numpy(_probe_operand(
            plan.shape[1], config.n_dense_hint)).to(h.device)
        for be in config.backend_names():
            info = {"tier": c.tier, "kind": c.kind, "K": c.K,
                    "overlap": c.overlap, "backend": be,
                    "model_time": c.model_time}
            try:
                t = profile_candidate(h, b, be,
                                      warmup=config.profile_warmup,
                                      iters=config.profile_iters, info=info)
            except Exception as e:
                warnings.warn(f"autotune candidate {c} backend {be!r} "
                              f"failed to profile ({e}); skipping",
                              stacklevel=2)
                continue
            if best is None or t < best["measured_time"]:
                best = {
                    "tier": c.tier, "kind": c.kind, "K": c.K,
                    "overlap": c.overlap, "backend": be,
                    "measured_time": t,
                    "total_allocation_size":
                        h.stats().get("total_allocation_size"),
                    "torch": torch_version(),
                    "repro": repro_version(),
                    "topology": topo.describe(),
                }
    if best is None:
        return plan, hier, schedule, decisions
    if cache is not None:
        cache.put(key, best)
    return _apply(plan, hier_cand, config, net, decisions,
                  tier=best["tier"], kind=best["kind"], K=best["K"],
                  overlap=best["overlap"], backend=best["backend"],
                  measured_time=best["measured_time"],
                  total_allocation_size=best["total_allocation_size"],
                  source="measured")


# ---------------------------------------------------------------------------
# per-device memory (ladder budgeting)
# ---------------------------------------------------------------------------


def estimate_device_bytes(plan, schedule, config) -> int:
    """Coarse deterministic per-device allocation estimate for a rung.

    Host-side only (usable for ladder rungs with no devices to compile
    on): local B and C shards, double-buffered schedule traffic at the
    padded volume, and the plan's covered row slots — all at
    ``n_dense_hint`` f32 columns. Intentionally simple; when a rung HAS
    been compiled or profiled, ``rung_device_bytes`` prefers the
    measured ``total_allocation_size``.
    """
    n = int(config.n_dense_hint)
    if getattr(schedule, "kind", None) == "replicated":
        # one B copy PER LANE, not per fleet: the flat estimate below
        # would undercount a c-lane rung by (c-1) B shards per device
        from .comm_model import replicated_device_bytes

        return int(replicated_device_bytes(schedule.rplan, schedule,
                                           int(config.n_dense_hint)))
    P = int(plan.P)
    m, k = plan.shape

    def per(rows: int) -> int:
        return -(-int(rows) // P)

    rows = (per(k)                                   # local B shard
            + 2 * per(m)                             # C accumulator + output
            + 2 * per(schedule.volume_rows_padded()) # send + recv slabs
            + per(plan.volume_rows()))               # gathered partials
    # piece arrays: ~3 words per covered nonzero row slot
    return rows * n * 4 + per(plan.volume_rows()) * 12


def rung_device_bytes(plan, schedule, decisions, config) -> int:
    """Best-available per-device byte cost of one ladder rung."""
    rec = (decisions or {}).get("total_allocation_size")
    if rec:
        return int(rec)
    return estimate_device_bytes(plan, schedule, config)


def decision_modeled_time(decisions) -> float:
    """The α-β modeled time of the execution path a plan actually took.

    ``_plan_and_tune`` records a modeled time per candidate it swept;
    this picks the one matching the decisions that won — replicated
    rungs report the replica estimate, overlapped bucketed schedules the
    overlap estimate, everything else the staged estimate. The single
    scalar the fleet placement policy ranks candidate groups by.
    """
    d = decisions or {}
    if d.get("replicate", 1) != 1 and "modeled_time_replicated" in d:
        return float(d["modeled_time_replicated"])
    if d.get("overlap") and "modeled_time_overlap" in d:
        return float(d["modeled_time_overlap"])
    if "modeled_time_staged" in d:
        return float(d["modeled_time_staged"])
    return float(d.get("modeled_time_flat", 0.0))
