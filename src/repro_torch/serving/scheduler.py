"""Continuous-batching serving scheduler.

Port of ``repro/serving/scheduler.py``'s ``Request``, ``ServeStats`` and
``ContinuousBatcher``, host logic copied: a fixed pool of ``max_batch``
decode slots; requests stream in with prompts and token budgets. Slots
are packed per WAVE: admission happens whenever the active set drains,
which resets the shared cache clock — the granularity a single global
``cache.length`` allows (per-slot recycling needs per-row lengths or a
paged KV cache). Early-finished slots simply stop sampling, which the
occupancy statistic makes visible.

Each step is the port's ``decode_step`` on the device the params live on,
under the batcher's ``dist`` (a ``DistContext``: the MoE blocks run the
expert-parallel path over its grid), one token for every slot; prompts
are fed token by token (teacher forced), and the next token is the
greedy argmax, which takes the FIRST maximum as ``jnp.argmax`` does. On
a fleet's grid each process decodes its rows of the batch and the
sampled tokens are gathered (``DistContext.gather_batch``), so every
process holds the same slots, tokens and outputs.

``SpmmWaveServer`` applies the same wave discipline to SpMM serving over
a hot-swappable ``DistSpmm`` / ``SpmmSession``: the handle is
re-resolved only at wave boundaries, which is exactly the granularity at
which ``SpmmSession.replan``'s warm hot-swap is safe — no wave ever
straddles two plans and none is dropped across a swap. A request's
output stays a tensor on the handle's device; each wave attempt ends
with one synchronize of that device's stream, so a failure on the device
surfaces inside the attempt and takes the retry path.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ..distributed.context import check_dist
from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_decode_cache
from ..robustness import faults

__all__ = ["Request", "ServeStats", "ContinuousBatcher",
           "SpmmRequest", "SpmmWaveStats", "SpmmWaveServer"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    arrived_at: float = 0.0
    # filled by the scheduler
    output: Optional[List[int]] = None
    finished_at: Optional[float] = None


@dataclasses.dataclass
class ServeStats:
    served: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0
    occupancy_sum: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)


@dataclasses.dataclass
class SpmmRequest:
    rid: int
    b: Any  # [K, N] dense operand: a numpy array or a tensor
    # filled by the server: C [M, N] on the handle's device
    output: Optional[torch.Tensor] = None
    wave: Optional[int] = None


@dataclasses.dataclass
class SpmmWaveStats:
    waves: int = 0
    served: int = 0
    swaps: int = 0          # handle identity changed between waves
    dropped_waves: int = 0  # MUST stay 0: the hot-swap contract
    failed_waves: int = 0   # wave ATTEMPTS that raised (retries included)
    retried_waves: int = 0  # waves that succeeded after >= 1 failure
    degraded_rungs: int = 0  # session driven down a ladder rung by retry


def _synchronize(handle) -> None:
    """Wait for the handle's device stream (no-op off the card)."""
    device = getattr(handle, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class SpmmWaveServer:
    """Wave-granular SpMM serving over a hot-swappable handle.

    The serving half of ``SpmmSession``'s lifecycle: the handle is
    re-resolved once per WAVE (a batch of queued requests), never
    mid-wave — so a ``session.replan`` or ``session.on_resize`` between
    waves swaps cleanly (old handle finishes its wave, the next wave
    picks up the warm replacement) and ``dropped_waves`` stays 0 by
    construction. ``source``:

      * an ``SpmmSession`` — swaps follow the session lifecycle;
      * a ``DistSpmm`` handle — static serving, no swaps;
      * any zero-arg callable returning a handle — custom resolution.

    A wave that RAISES is retried, not dropped: the failed attempt
    counts in ``failed_waves``, the server backs off exponentially,
    re-resolves the handle (an elastic resize or replan that happened
    mid-failure is picked up for free), and — when the same rung keeps
    failing and the source is a ladder session — drives
    ``session.on_resize`` down to the next rung (``degrade=True``).
    Only after ``max_retries`` extra attempts is the wave requeued,
    counted in ``dropped_waves``, and the failure surfaced; a wave that
    eventually succeeds counts once in ``retried_waves`` and
    ``dropped_waves`` stays 0.
    """

    def __init__(self, source, max_batch: int = 8, max_retries: int = 2,
                 backoff: float = 0.05, degrade: bool = True,
                 max_events: int = 256):
        self.source = source
        self.max_batch = max_batch
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.degrade = bool(degrade)
        self.queue: Deque[SpmmRequest] = deque()
        self.stats = SpmmWaveStats()
        # a long-lived server must not grow without bound: the ring
        # keeps the newest ``max_events`` for inspection while
        # ``events_total`` stays monotonic for assertions/telemetry
        self.events: Deque[dict] = deque(maxlen=int(max_events))
        self.events_total = 0
        self._last_handle_id: Optional[int] = None

    def _event(self, event: dict) -> None:
        self.events.append(event)
        self.events_total += 1

    def _resolve_handle(self):
        if callable(getattr(self.source, "handle", None)):
            return self.source.handle()  # SpmmSession
        if callable(self.source) and not hasattr(self.source, "plan"):
            return self.source()  # custom resolver
        return self.source  # a bare DistSpmm handle

    def _degrade_rung(self) -> bool:
        """Drive a ladder session down to the next-lower rung — the
        graceful-degradation half of retry (a rung that keeps failing is
        treated like lost capacity). No-op for non-session sources or
        when already on the lowest rung."""
        s = self.source
        ladder = getattr(s, "ladder", None)
        current = getattr(s, "current_P", None)
        if (not callable(getattr(s, "on_resize", None))
                or not ladder or current is None):
            return False
        lower = [p for p in ladder if p < current]
        if not lower:
            return False
        s.on_resize(max(lower))
        self.stats.degraded_rungs += 1
        self._event({"action": "degrade", "from": current,
                     "to": max(lower)})
        return True

    def submit(self, req: SpmmRequest) -> None:
        req.output = None
        self.queue.append(req)

    def run(self, max_waves: int = 10_000) -> SpmmWaveStats:
        """Drain the queue wave by wave (each wave on ONE handle)."""
        while self.queue and self.stats.waves < max_waves:
            wave = [self.queue.popleft()
                    for _ in range(min(self.max_batch, len(self.queue)))]
            attempts = 0
            while True:
                handle = self._resolve_handle()
                if (self._last_handle_id is not None
                        and id(handle) != self._last_handle_id):
                    self.stats.swaps += 1
                self._last_handle_id = id(handle)
                faults.maybe_delay("wave")
                try:
                    faults.maybe_error("wave")
                    for req in wave:
                        req.output = handle(req.b)
                        req.wave = self.stats.waves
                    # a failure on the device raises here, in the attempt
                    _synchronize(handle)
                    break
                except Exception as e:
                    for req in wave:  # no partial results survive
                        req.output = None
                        req.wave = None
                    self.stats.failed_waves += 1
                    self._event(
                        {"action": "wave_failed", "wave": self.stats.waves,
                         "attempt": attempts,
                         "error": f"{type(e).__name__}: {e}"})
                    if attempts >= self.max_retries:
                        # retries exhausted: requeue the whole wave so no
                        # request is lost, count the drop, and surface
                        # the failure to the operator
                        for req in reversed(wave):
                            self.queue.appendleft(req)
                        self.stats.dropped_waves += 1
                        self._event({"action": "wave_dropped",
                                     "wave": self.stats.waves})
                        raise
                    attempts += 1
                    if self.backoff > 0.0:
                        time.sleep(self.backoff * 2.0 ** (attempts - 1))
                    # first retry just re-resolves (an external resize /
                    # replan may already have moved the session); if the
                    # same rung fails AGAIN, degrade down the ladder
                    if self.degrade and attempts >= 2:
                        self._degrade_rung()
            self.stats.served += len(wave)
            if attempts:
                self.stats.retried_waves += 1
            self.stats.waves += 1
        return self.stats


class ContinuousBatcher:
    """Slot-based continuous batching over a single decode cache."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int,
                 max_len: int, dist=None, eos_token: Optional[int] = None):
        check_dist(dist)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.dist = dist
        self.eos = eos_token
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.slot_pos = np.zeros(max_batch, np.int64)  # tokens fed per slot
        self.slot_budget = np.zeros(max_batch, np.int64)
        self.free_slots = list(range(max_batch))
        self.stats = ServeStats()
        # per-slot caches: one batched cache; slots are batch rows.
        self.cache = init_decode_cache(cfg, max_batch, max_len, self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrived_at = req.arrived_at or time.time()
        req.output = []
        self.queue.append(req)

    def _admit(self) -> None:
        """Wave admission: only when the active set is empty (a shared
        cache clock cannot recycle rows mid-wave without per-slot lengths:
        a new request would attend to the previous occupant's stale KV
        rows)."""
        if self.active:
            return
        if not self.queue:
            return
        self.cache = init_decode_cache(self.cfg, self.max_batch, self.max_len,
                                       self.device)
        while self.queue and self.free_slots:
            slot = self.free_slots.pop()
            req = self.queue.popleft()
            self.active[slot] = req
            self.slot_pos[slot] = 0
            self.slot_budget[slot] = req.max_new_tokens

    def _next_tokens(self, sampled: np.ndarray) -> np.ndarray:
        """Per-slot next input token: prompt feed or generated token."""
        toks = np.zeros((self.max_batch, 1), np.int32)
        for slot, req in self.active.items():
            pos = self.slot_pos[slot]
            if pos < len(req.prompt):
                toks[slot, 0] = req.prompt[pos]  # teacher-forced prefill
            else:
                toks[slot, 0] = sampled[slot]
        return toks

    def run(self, max_steps: int = 10_000) -> ServeStats:
        """Drive until queue + active drain (or step cap)."""
        sampled = np.zeros(self.max_batch, np.int32)
        for _ in range(max_steps):
            self._admit()
            if not self.active:
                if not self.queue:
                    break
                continue
            toks = torch.from_numpy(self._next_tokens(sampled)).to(self.device)
            logits, self.cache = decode_step(self.params, self.cfg,
                                             self.dist, toks, self.cache)
            # torch.argmax returns the first maximal index, as jnp.argmax
            sampled = logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
            if self.dist is not None:  # a fleet's rows -> the whole batch
                sampled = self.dist.gather_batch(sampled, self.max_batch)
            self.stats.decode_steps += 1
            self.stats.occupancy_sum += len(self.active) / self.max_batch

            done_slots = []
            for slot, req in list(self.active.items()):
                self.slot_pos[slot] += 1
                pos = self.slot_pos[slot]
                if pos >= len(req.prompt):
                    tok = int(sampled[slot])
                    req.output.append(tok)
                    self.stats.generated_tokens += 1
                    gen = pos - len(req.prompt) + 1
                    if gen >= req.max_new_tokens or \
                            (self.eos is not None and tok == self.eos):
                        done_slots.append(slot)
                if self.slot_pos[slot] + 1 >= self.max_len:
                    if slot not in done_slots:
                        done_slots.append(slot)
            for slot in done_slots:
                req = self.active.pop(slot)
                req.finished_at = time.time()
                self.stats.served += 1
                self.free_slots.append(slot)
        return self.stats
