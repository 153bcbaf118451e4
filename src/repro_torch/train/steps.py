"""The train / serve steps: ``make_train_step``, ``make_prefill_step``,
``make_decode_step``.

Port of ``repro/train/steps.py``. ``make_train_step`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
``lm_loss``'s value and gradient (autograd through the port's kernels:
K6's backward pair for every RMSNorm, K1 / K2 for the embedding and the
expert-parallel MoE), then ``adamw_update``. With ``microbatches`` > 1
the batch is cut along its first dim into that many equal slices; the
gradients accumulate in float32 in slice order, and loss and gradients
are divided by their number, as the reference's ``lax.scan`` does.

With a grid (``dist``) the global norm that AdamW clips by sums the MoE
experts' squares over the model ranks in one order (``GradShards``). On
a fleet's grid (``Topology.multiprocess(mesh=...)``) every process gets
the whole batch and runs its rows: ``lm_loss`` is its share of the
global mean (each data group's rows counted once), the microbatches
accumulate locally, then ``ProcessMeshComm.fold_leaves`` sums each
leaf's gradient over the data groups in ascending order (a whole leaf
from each group's counting process, an expert shard from the process of
each group that holds it; the experts of other model ranks stay where
they are), the loss shares fold the same way, and every process runs
the same AdamW update on its leaves. The expert-parallel layer's
backward crosses processes through ``_Exchange``.

The step is functional like the reference's bare step: ``params`` is
not changed in place, and new parameter and state trees come back. With
``donate=True`` it is the reference's ``jax.jit(step, donate_argnums=(0,
1))``: the step consumes ``params`` and ``opt_state``, writes the new
parameters, moments and step counter into their tensors (``adamw_update
(..., donate=True)``, the same bits) and returns those same trees; the
old values are gone. A batch of numpy arrays moves to the parameters'
device first.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..distributed.context import DistContext
from ..models.config import ModelConfig
from ..models.transformer import decode_step, forward, lm_loss
from ..optim.adamw import AdamWConfig, _leaves, _rebuild, adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "loss_and_grads"]


def _device_of(params: Any) -> torch.device:
    return _leaves(params)[0].device


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors, as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def loss_and_grads(params: Any, cfg: ModelConfig,
                   dist: Optional[DistContext], batch: Dict[str, Any]):
    """``lm_loss`` and its gradient with respect to every leaf of
    ``params`` (the reference's ``jax.value_and_grad``): (loss, grads
    tree in ``params``' structure and dtypes)."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    live = _rebuild(params, iter(leaves))
    with torch.enable_grad():
        loss = lm_loss(live, cfg, dist, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _rebuild(params, iter(grads))


def make_train_step(cfg: ModelConfig, dist: Optional[DistContext],
                    opt_cfg: AdamWConfig, microbatches: int = 1,
                    donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics); metrics: ``loss``, ``grad_norm``, ``lr`` (0-d tensors; on a
    fleet the global values, the same on every process). ``donate``: the
    step updates ``params`` and ``opt_state`` in place and returns them."""
    fleet = dist is not None and dist.is_fleet
    layout = {}  # per params structure: (GradShards, fold sources)

    def train_step(params, opt_state, batch):
        batch = to_device(batch, _device_of(params))
        if microbatches <= 1:
            loss, grads = loss_and_grads(params, cfg, dist, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch {n} is not divisible by "
                                 f"{microbatches} microbatches")
            mb = n // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=_device_of(params))
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in _leaves(params)]
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                li, gi = loss_and_grads(params, cfg, dist, part)
                acc = [a + g.to(a.dtype) for a, g in zip(acc, _leaves(gi))]
                loss = loss + li
            loss = loss / microbatches
            grads = _rebuild(params, iter(a / microbatches for a in acc))
        shards = sources = None
        if dist is not None:
            key = tuple(tuple(p.shape) for p in _leaves(params))
            if key not in layout:
                layout[key] = (dist.grad_shards(params, cfg),
                               dist.grad_sources(params, cfg)
                               if fleet else None)
            shards, sources = layout[key]
        if fleet:
            grads = _rebuild(params, iter(dist.comm.fold_leaves(
                _leaves(grads), sources)))
            loss = dist.comm.fold(loss)
        new_params, new_state, metrics = adamw_update(
            opt_cfg, params, grads, opt_state, shards, donate=donate)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, dist: Optional[DistContext]):
    def prefill_step(params, batch):
        with torch.no_grad():
            return forward(params, cfg, dist,
                           to_device(batch, _device_of(params)))

    return prefill_step


def make_decode_step(cfg: ModelConfig, dist: Optional[DistContext]):
    def serve_step(params, token, cache):
        with torch.no_grad():
            return decode_step(params, cfg, dist, token, cache)

    return serve_step
