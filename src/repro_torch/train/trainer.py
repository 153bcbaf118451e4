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
it continues (the reference restarts its stream at batch 0). The step is
``train.steps.make_train_step``'s with ``donate=True``, as the
reference jits its step with ``donate_argnums=(0, 1)``: ``fit`` consumes
the tree it is given — its tensors are updated in place, and a resumed
run restores into them — so they end as the final parameters (pass a
copy to keep the initial values). The parameters live on the device of
that tree, and numpy batches move there. The signal handlers are the
previous ones again once ``fit`` returns.

On a fleet's grid (``dist`` over ``Topology.multiprocess(mesh=...)``,
every process running ``fit`` on its own leaves: its model ranks'
experts, every other leaf whole):

* every process resumes from the lead's ``latest_step()`` (folded to
  all), and a data source's stream starts there on each, every process
  getting the whole batch;
* a checkpoint is one unsharded tree, written by the lead
  (``CheckpointManager(..., dist=)``: the experts' params and moments
  gathered over the model ranks), which restores onto any grid;
* a stop requested on any process (SIGTERM / SIGINT) is folded once a
  step, after the step, so every process stops after the same step and
  takes part in one preemption save (a request that lands during or
  after a step's fold is folded with the next step);
* the straggler watchdog stays per process.

A step whose checkpoint the loop has just written is not saved again at
the end (the reference writes the same step twice).
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
        self.fleet = dist is not None and dist.is_fleet
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_retain,
                                      dist=dist)
        self._stop = False
        self.straggler_events = []
        self.step_fn = make_train_step(cfg, dist, opt_cfg,
                                       microbatches=tcfg.microbatches,
                                       donate=True)

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
        or a data source whose stream starts at the resumed step.
        ``params`` is consumed: its tensors end as the final parameters
        (the result's ``params`` is the same tree)."""
        saved = self._install_signals()
        try:
            return self._fit(params, batches, resume)
        finally:
            for sig, old in saved.items():
                signal.signal(sig, old)

    def _latest_step(self) -> Optional[int]:
        """The lead's newest complete checkpoint, on every process."""
        if not self.fleet:
            return self.ckpt.latest_step()
        mine = 0  # the others give 0; the lead its step, or -1 for none
        if self.ckpt.lead:
            latest = self.ckpt.latest_step()
            mine = -1 if latest is None else latest
        n = self.dist.comm.fold_host(mine)
        return None if n < 0 else n

    def _fit(self, params, batches, resume):
        opt_state = adamw_init(params)
        state = {"params": params, "opt": opt_state}
        shards = self.dist.leaf_splits(state, self.cfg) if self.fleet \
            else None
        start_step = 0
        if resume:
            latest = self._latest_step()
            if latest is not None:
                self.ckpt.restore(latest, state, shards=shards, inplace=True)
                start_step = latest
                log.info("resumed from step %d", latest)
        if hasattr(batches, "batch"):
            batches = make_batches(batches, start_step=start_step)

        ema = None
        history = []
        step = start_step
        saved_at = None
        for step in range(start_step, self.tcfg.total_steps):
            batch = next(batches)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            # a stop on any process stops every one; the handler's flag
            # is only read, so a signal that lands in or after the fold
            # is carried to the next step's fold on every process
            stop = (self.dist.comm.fold_host(self._stop) > 0 if self.fleet
                    else self._stop)

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
            if (step + 1) % self.tcfg.ckpt_every == 0 or stop:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state},
                               shards=shards)
                saved_at = step + 1
                if stop:
                    log.warning("preemption save at step %d; exiting",
                                step + 1)
                    break
        else:
            step = self.tcfg.total_steps - 1
        if saved_at != step + 1:
            self.ckpt.save(step + 1, {"params": params, "opt": opt_state},
                           shards=shards)
        return {"params": params, "opt_state": opt_state,
                "history": history,
                "straggler_events": self.straggler_events,
                "last_step": step + 1}
