"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``, with the reference's flags and
printout. It trains the smoke variant of any arch (``--full``: the
published config) with the real optimizer, checkpointing, resume and the
straggler watchdog, on the card unless ``--device cpu``. Weights are
random (``torch.Generator(device)`` seed 0), the data ``SyntheticLM``
with the reference's per-family inputs at every step (``FamilyInputs``):
``enc_embeds`` for the encdec family, ``prefix_embeds`` for an arch
with a frontend, each ``np.random.default_rng(step).standard_normal(
(batch, frontend_len, d_model))`` in float32.

One difference from the reference: the trainer is given the data
source, so a resumed run's stream starts at the step it resumes from
(the pipeline's batches, embeddings included, are a function of the
step) and the run continues the one it was cut from; the reference
restarts the stream at batch 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..data.pipeline import SyntheticLM
from ..models.config import ModelConfig
from ..models.transformer import init_params
from ..optim.adamw import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


@dataclasses.dataclass
class FamilyInputs:
    """A data source (``batch(step, shard, n_shards)``) whose batches also
    carry the reference launcher's per-family input of that step: for the
    encdec family ``enc_embeds``, for an arch with a frontend
    ``prefix_embeds``, each ``default_rng(step).standard_normal((batch,
    frontend_len, d_model))`` as float32 (a shard: its rows of it); other
    families' batches pass through."""

    source: Any
    cfg: ModelConfig
    batch_size: int

    @property
    def key(self) -> Optional[str]:
        if self.cfg.family == "encdec":
            return "enc_embeds"
        return "prefix_embeds" if self.cfg.frontend is not None else None

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        out = self.source.batch(step, shard, n_shards)
        if self.key is not None:
            whole = np.random.default_rng(step).standard_normal(
                (self.batch_size, self.cfg.frontend_len, self.cfg.d_model)
            ).astype(np.float32)
            rows = self.batch_size // n_shards
            out[self.key] = whole[shard * rows:(shard + 1) * rows]
        return out


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="the published (non-smoke) config")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu "
                         "to train on the CPU")
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1))
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch_ckpt_{args.arch}"),
        microbatches=args.microbatches,
    )
    data = FamilyInputs(SyntheticLM(cfg.vocab_size, args.seq, args.batch),
                        cfg, args.batch)
    params = init_params(cfg, torch.Generator(args.device).manual_seed(0),
                         device=args.device)
    trainer = Trainer(cfg, opt, tcfg)
    out = trainer.fit(params, data, resume=not args.no_resume)
    print(f"finished at step {out['last_step']}; "
          f"final loss {out['history'][-1]['loss'] if out['history'] else float('nan'):.4f}; "
          f"stragglers observed: {len(out['straggler_events'])}")
    return out


if __name__ == "__main__":
    main()
