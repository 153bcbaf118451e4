"""AdamW + schedules + global-norm clipping over lists / dicts of tensors.

Port of ``repro/optim/adamw.py``: the same update, schedules and clipping,
step for step in float32, so three steps here and there agree within
float32 rounding. A parameter "tree" is a tensor or a list, tuple or dict
of them (nested; dict leaves in sorted key order, as ``jax.tree_util``
flattens them). Optimizer state is kept in float32 whatever the
parameters' dtype: ``{'m': tree, 'v': tree, 'step': int32 scalar}``.

``torch.optim.AdamW`` is not a substitute: it clips nothing, has no
schedule of its own and folds the weight decay in before the moment
update, so its steps differ from the reference's.

    state = adamw_init(params)
    new_params, state, metrics = adamw_update(cfg, params, grads, state)
    params, state, metrics = adamw_update(cfg, params, grads, state,
                                          donate=True)  # in place
    state, metrics = adamw_step(cfg, list(model.parameters()), state)  # in place

``donate=True`` is the counterpart of the reference's donated buffers
(``jax.jit(step, donate_argnums=(0, 1))``): the new parameters, m and v
are written into the tensors of ``params`` and ``state``, leaf by leaf,
with the same bits as the functional form (both run ``_leaf_update``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Sequence, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_step",
           "cosine_schedule", "linear_warmup", "clip_by_global_norm",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


def _leaves(tree: Any, is_leaf: Callable[[Any], bool] = None) -> List[Any]:
    """The leaves of ``tree`` in flattening order; a node for which
    ``is_leaf`` holds is one leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t, is_leaf)]
    return [tree]


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure around the next values of the iterator
    ``leaves`` (taken in ``_leaves`` order)."""
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), in ``tree``'s structure."""
    out = [fn(*a) for a in zip(_leaves(tree), *map(_leaves, rest))]
    return _rebuild(tree, iter(out))


def _device(tree: Any) -> torch.device:
    leaves = _leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw_init(params: Any) -> dict:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                device=p.device)
    return {"m": _map(f32, params), "v": _map(f32, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def global_norm(tree: Any, shards=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (leaf sums
    added in flattening order).

    ``shards`` (``distributed.context.GradShards``, from a grid's
    ``dist.grad_shards(params, cfg)``) sums the MoE experts' squares
    chunk by chunk over the model ranks, ascending, and on a fleet
    gathers the chunks other processes hold: each leaf of the global
    model counted once, in the same order on the emulated grid and on
    every process of a fleet."""
    if shards is not None:
        return torch.sqrt(shards.sum_squares(_leaves(tree)))
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float, shards=None
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads, shards)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cos if cfg.schedule == "cosine" else 1.0)


def linear_warmup(cfg: AdamWConfig, step) -> torch.Tensor:
    warm = torch.clamp(torch.as_tensor(step) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def _leaf_update(cfg: AdamWConfig, lr, b1c, b2c, scale, p, g, m, v,
                 out) -> None:
    """One leaf's step, written into ``out`` = (new p, new m, new v):
    fresh tensors in the functional form, ``(p, m, v)`` themselves when
    donating. The reference's float32 chain op for op — the clip's
    product in the gradient's dtype, then b1·m + (1 − b1)·g, b2·v +
    (1 − b2)·g², m̂ / (√v̂ + eps) + wd·p, p − lr·delta — each product and
    sum its own op and rounding (no ``alpha=`` or ``addcmul``, which may
    fuse a multiply and an add), so both forms give the same bits. Two
    float32 temporaries of the leaf's size (and the clipped gradient, and
    its float32 copy for a bfloat16 gradient), freed before the next
    leaf."""
    p_out, m_out, v_out = out
    if scale is not None:
        g = g * scale.to(g.dtype)
    gf = g.float()
    t = gf * (1 - cfg.b1)
    torch.mul(m, cfg.b1, out=m_out).add_(t)
    torch.square(gf, out=t).mul_(1 - cfg.b2)
    torch.mul(v, cfg.b2, out=v_out).add_(t)
    del g, gf
    torch.div(v_out, b2c, out=t).sqrt_().add_(cfg.eps)
    d = torch.div(m_out, b1c).div_(t)
    d.add_(t.copy_(p).mul_(cfg.weight_decay)).mul_(lr)
    p_out.copy_(t.copy_(p).sub_(d))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 shards=None, donate: bool = False) -> tuple:
    """Returns (new_params, new_state, metrics) — the reference's update:
    clip by the global norm (``global_norm``'s ``shards`` on a grid),
    bias-corrected moments in float32, decoupled weight decay, the
    schedule's learning rate at the new step.

    ``donate``: the update consumes ``params`` and ``state`` — every
    parameter, m and v takes its new value in place and the step counter
    too, and the same trees come back, as the reference's donated
    buffers. The bits are the functional form's."""
    gnorm = global_norm(grads, shards)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state["step"] + 1
    if cfg.schedule == "cosine":
        lr = cosine_schedule(cfg, step)
    elif cfg.schedule == "linear":
        lr = linear_warmup(cfg, step)
    else:
        lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device), stepf)
    metrics = {"grad_norm": gnorm, "lr": lr}
    outs = []
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state["m"]), _leaves(state["v"])):
        out = (p, m, v) if donate else tuple(map(torch.empty_like,
                                                 (p, m, v)))
        _leaf_update(cfg, lr, b1c, b2c, scale, p, g, m, v, out)
        outs.append(out)
    if donate:
        state["step"].copy_(step)
        return params, state, metrics
    pick = lambda i: _rebuild(params, iter([o[i] for o in outs]))  # noqa: E731,E501
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, metrics


def adamw_step(cfg: AdamWConfig, params: Sequence[torch.Tensor],
               state: dict) -> Tuple[dict, dict]:
    """``adamw_update`` in place on tensors that carry their ``.grad``
    (e.g. ``list(model.parameters())`` after ``loss.backward()``): each
    parameter takes its new value and its grad is cleared. Returns
    (new_state, metrics)."""
    params = list(params)
    missing = [i for i, p in enumerate(params) if p.grad is None]
    if missing:
        raise ValueError(f"parameters {missing} have no grad; run backward "
                         f"first")
    new, state, metrics = adamw_update(
        cfg, [p.detach() for p in params], [p.grad for p in params], state)
    with torch.no_grad():
        for p, q in zip(params, new):
            p.copy_(q)
            p.grad = None
    return state, metrics
