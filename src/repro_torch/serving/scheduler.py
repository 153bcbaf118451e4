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
one token for every slot; prompts are fed token by token (teacher
forced), and the next token is the greedy argmax, which takes the FIRST
maximum as ``jnp.argmax`` does.

``SpmmWaveServer`` waits for ROADMAP item 13 (it needs sessions and
``robustness/faults.py``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.layers import no_dist
from ..models.transformer import decode_step, init_decode_cache

__all__ = ["Request", "ServeStats", "ContinuousBatcher"]


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


class ContinuousBatcher:
    """Slot-based continuous batching over a single decode cache."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int,
                 max_len: int, dist=None, eos_token: Optional[int] = None):
        no_dist(dist, "ContinuousBatcher")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.max_len = max_len
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
            logits, self.cache = decode_step(self.params, self.cfg, None,
                                             toks, self.cache)
            # torch.argmax returns the first maximal index, as jnp.argmax
            sampled = logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
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
