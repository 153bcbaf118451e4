"""Parameter / cache / batch sharding rules for the (pod, data, model) grid.

Port of ``repro/distributed/sharding.py``: the same name-based rules
over the paths of a parameter tree (nested dicts, ``"/"``-joined keys),
the same fallback to replication where a dim does not divide its axis.
A spec is a plain tuple with one entry per dim — an axis name, a tuple of
two or more axis names, or None (the reference's ``PartitionSpec``
entries, which write a one-axis tuple as its name).

The port runs every rank of an ``EmulatedMesh`` on one device, so
nothing moves: ``as_shardings`` pairs each spec with its context, and a
``Sharding``'s ``place`` is ``distributed.context.shard``'s divisibility
check of a tensor against its spec (``place_tree`` over a tree).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from ..models.config import ModelConfig
from .context import DistContext, shard

__all__ = ["param_specs", "param_shardings", "batch_specs", "cache_specs",
           "opt_state_specs", "as_shardings", "Sharding", "place_tree"]

Spec = Tuple[Any, ...]


def _maybe(dist: DistContext, axis: Optional[str], dim: int) -> Optional[str]:
    """axis if it divides dim, else None (replicate)."""
    if axis is None:
        return None
    return axis if dim % dist.axis_size(axis) == 0 else None


def _leaf_spec(path: str, shape, dist: DistContext) -> Spec:
    """Spec for one (unstacked) parameter leaf."""
    m, f = dist.model_axis, dist.fsdp_axis
    nd = len(shape)

    def ok(axis, d):
        return _maybe(dist, axis, shape[d])

    if nd == 0:
        return ()
    last = path.split("/")[-1]
    if last in ("router",):
        return (ok(f, 0), None)
    if last in ("w1", "w3") and nd == 3:  # moe experts [E, D, F]
        return (ok(m, 0), ok(f, 1), None)
    if last == "w2" and nd == 3:  # [E, F, D]
        return (ok(m, 0), None, ok(f, 2))
    if last == "embed":
        return (ok(m, 0), ok(f, 1))
    if last == "lm_head":
        return (ok(f, 0), ok(m, 1))
    if last in ("wq", "wk", "wv", "w1", "w3", "in_proj",
                "in_proj_x", "in_proj_z", "adapter"):
        return (ok(f, 0), ok(m, 1))
    if last in ("wo", "w2", "out_proj"):
        return (ok(m, 0), ok(f, 1))
    if last in ("bq", "bk", "bv"):
        return (ok(m, 0),)
    if last in ("conv_w",):
        return (None, ok(m, 1))
    if last in ("conv_b", "D", "dt_bias") and nd == 1:
        return (ok(m, 0),)
    if last in ("x_dbl", "A_log") and nd == 2:  # [di, *]
        return (ok(m, 0), None)
    if last == "dt_proj":  # [dtr, di]
        return (None, ok(m, 1))
    if last in ("bc_proj", "dt_proj2"):  # [D, *]
        return (ok(f, 0), None)
    # norms, scalar vectors, mamba2 A_log [nh]
    return (None,) * nd


def _map_paths(tree: Any, fn, keys=()) -> Any:
    """``fn(keys, leaf)`` over a tree of nested dicts, lists and tuples,
    in its structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(v, fn, keys + (i,))
                          for i, v in enumerate(tree))
    return fn(keys, tree)


def param_specs(params_shapes: Any, cfg: ModelConfig,
                dist: DistContext) -> Any:
    """Tree of specs matching ``params_shapes`` (tensors, arrays or
    shapes). Stacked layer params ([L, ...] leaves under 'layers') get a
    leading None (layers are looped over, never sharded)."""
    def spec(keys, leaf):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else \
            tuple(np.shape(leaf))
        path = "/".join(str(k) for k in keys)
        if "layers" in keys:
            return (None,) + _leaf_spec(path, shape[1:], dist)
        return _leaf_spec(path, shape, dist)

    return _map_paths(params_shapes, spec)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a context's grid (the reference's ``NamedSharding``)."""

    dist: DistContext
    spec: Spec

    def place(self, t):
        """``t`` itself, after the check that each sharded dim divides by
        its axes' size: one device holds every rank's slice."""
        return shard(t, self.dist, self.spec)


def _is_spec(x: Any) -> bool:
    """A spec: a tuple of None, axis names and tuples of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def as_shardings(specs: Any, dist: DistContext) -> Any:
    def walk(t):
        if _is_spec(t):
            return Sharding(dist, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return type(t)(walk(v) for v in t)

    return walk(specs)


def place_tree(tree: Any, shardings: Any) -> Any:
    """``Sharding.place`` of every leaf of ``tree`` (the reference's
    ``device_put`` onto shardings): the same tree, each leaf checked."""
    if isinstance(shardings, Sharding):
        return shardings.place(tree)
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(place_tree(v, s) for v, s in zip(tree, shardings))


def param_shardings(params_shapes: Any, cfg: ModelConfig,
                    dist: DistContext) -> Any:
    return as_shardings(param_specs(params_shapes, cfg, dist), dist)


def opt_state_specs(pspecs: Any) -> dict:
    """Adam m/v mirror the param sharding; step is replicated."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def _batch_axes(dist: DistContext, batch_size: int):
    b_ax = dist.batch_axes if batch_size % dist.batch_size_divisor == 0 \
        else None
    # fall back to sharding over 'data' only, then fully replicated
    if b_ax is None and batch_size % dist.axis_size("data") == 0:
        b_ax = ("data",)
    # one axis is written as its name, as a PartitionSpec entry is
    return b_ax[0] if b_ax is not None and len(b_ax) == 1 else b_ax


def batch_specs(cfg: ModelConfig, dist: DistContext, batch_size: int) -> dict:
    """Specs for a train/prefill batch dict."""
    b_ax = _batch_axes(dist, batch_size)
    out = {"tokens": (b_ax, None)}
    if cfg.family == "encdec":
        out["enc_embeds"] = (b_ax, None, None)
    elif cfg.frontend is not None:
        out["prefix_embeds"] = (b_ax, None, None)
    return out


def cache_specs(cfg: ModelConfig, dist: DistContext, batch_size: int) -> dict:
    """Specs for the decode cache's fields (fields a family does not have
    get no entry)."""
    b_ax = _batch_axes(dist, batch_size)
    kv_m = _maybe(dist, dist.model_axis, cfg.n_kv_heads)
    di_m = _maybe(dist, dist.model_axis, cfg.d_inner)
    out = {}
    if cfg.family in ("dense", "moe", "vlm", "audio", "encdec"):
        if cfg.kv_seq_shard and kv_m is None:
            # flash-decoding: heads don't shard, so the cache LENGTH
            # shards over the model axis instead
            out["k"] = (None, b_ax, None, dist.model_axis, None)
            out["v"] = (None, b_ax, None, dist.model_axis, None)
            return {**out, "length": ()}
        out["k"] = (None, b_ax, kv_m, None, None)
        out["v"] = (None, b_ax, kv_m, None, None)
    if cfg.is_ssm:
        if cfg.ssm_version == 1:
            out["ssm_h"] = (None, b_ax, di_m, None)
        else:
            nh = cfg.ssm_heads or max(cfg.d_inner // 64, 1)
            out["ssm_h"] = (None, b_ax, _maybe(dist, dist.model_axis, nh),
                            None, None)
        out["ssm_conv"] = (None, b_ax, None, di_m)
    if cfg.family == "hybrid":
        out["shared_k"] = (None, b_ax, kv_m, None, None)
        out["shared_v"] = (None, b_ax, kv_m, None, None)
    out["length"] = ()
    return out
