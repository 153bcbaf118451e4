"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``, with the reference's flags and
printout. It trains the smoke variant of a dense, moe or ssm arch (``--full``:
the published config; the other families raise, ROADMAP item 17) with the real optimizer, checkpointing, resume
and the straggler watchdog, on the card unless ``--device cpu``. Weights
are random (``torch.Generator(device)`` seed 0), the data ``SyntheticLM``.

One difference from the reference: the trainer is given the data
source, so a resumed run's stream starts at the step it resumes from
(the pipeline's batches are a function of the step) and the run
continues the one it was cut from; the reference restarts the stream at
batch 0.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Optional, Sequence

import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..data.pipeline import SyntheticLM
from ..models.transformer import init_params
from ..optim.adamw import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


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
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
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
