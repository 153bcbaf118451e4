"""Fault-tolerant training loop.

Port of ``repro/train/trainer.py``:

* checkpoint / restart: periodic atomic saves (``checkpoint.manager``),
  resume from the latest step, a save on SIGTERM / SIGINT (preemption)
  and a final save;
* straggler watchdog: an EMA of the per-step wall time; after
  ``straggler_warmup`` steps a step slower than ``straggler_factor`` ×
  EMA is logged with its index and kept in ``straggler_events``.

A step's wall time ends with the loss read back to the host (the
reference's ``block_until_ready``). ``fit`` takes an iterator of batches,
as the reference's does, or a data source with ``batch(step)``
(``SyntheticLM``, ``MemmapTokens``): a source's stream starts at the
step the run resumes from, so a resumed run sees the batches of the run
it continues (the reference restarts its stream at batch 0). The step is ``train.steps.
make_train_step``'s; the parameters live on the device of the tree
``fit`` is given, and numpy batches move there. The signal handlers are
the previous ones again once ``fit`` returns.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import tempfile
import time
from typing import Any, Dict, Optional

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import make_batches
from ..distributed.context import DistContext
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_init
from .steps import make_train_step

log = logging.getLogger("repro_torch.trainer")

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_retain: int = 3
    straggler_factor: float = 3.0
    straggler_warmup: int = 5
    microbatches: int = 1


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, dist: Optional[DistContext] = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.dist = dist
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_retain)
        self._stop = False
        self.straggler_events = []
        self.step_fn = make_train_step(cfg, dist, opt_cfg,
                                       microbatches=tcfg.microbatches)

    # ------------------------------------------------------------------
    def _install_signals(self) -> dict:
        def handler(signum, frame):
            log.warning("signal %s: checkpoint-and-exit requested", signum)
            self._stop = True

        saved = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                saved[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread
        return saved

    # ------------------------------------------------------------------
    def fit(self, params: Any, batches: Any,
            resume: bool = True) -> Dict[str, Any]:
        """Train to ``total_steps``; ``batches`` is an iterator of batches
        or a data source whose stream starts at the resumed step."""
        saved = self._install_signals()
        try:
            return self._fit(params, batches, resume)
        finally:
            for sig, old in saved.items():
                signal.signal(sig, old)

    def _fit(self, params, batches, resume):
        opt_state = adamw_init(params)
        start_step = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state = {"params": params, "opt": opt_state}
                restored = self.ckpt.restore(latest, state)
                params, opt_state = restored["params"], restored["opt"]
                start_step = latest
                log.info("resumed from step %d", latest)
        if hasattr(batches, "batch"):
            batches = make_batches(batches, start_step=start_step)

        ema = None
        history = []
        step = start_step
        for step in range(start_step, self.tcfg.total_steps):
            batch = next(batches)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0

            # straggler watchdog
            if step - start_step >= self.tcfg.straggler_warmup:
                if ema is not None and dt > self.tcfg.straggler_factor * ema:
                    self.straggler_events.append(
                        {"step": step, "dt": dt, "ema": ema})
                    log.warning("straggler: step %d took %.3fs (ema %.3fs)",
                                step, dt, ema)
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            elif step - start_step == self.tcfg.straggler_warmup - 1:
                ema = dt

            if step % self.tcfg.log_every == 0:
                history.append({"step": step, "loss": loss, "dt": dt})
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            if (step + 1) % self.tcfg.ckpt_every == 0 or self._stop:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state})
                if self._stop:
                    log.warning("preemption save at step %d; exiting",
                                step + 1)
                    break
        else:
            step = self.tcfg.total_steps - 1
        final = {"params": params, "opt": opt_state}
        self.ckpt.save(step + 1, final)
        return {"params": params, "opt_state": opt_state,
                "history": history,
                "straggler_events": self.straggler_events,
                "last_step": step + 1}
