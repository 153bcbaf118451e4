"""LM assembly for the dense, MoE and SSM families: prefill and decode.

Port of ``repro/models/transformer.py``. Params are nested dicts with the
reference's names and its stacked ``[L, ...]`` layer tensors, so a tree
of the reference's ``init_params`` carries over as it is
(``transformer_from_numpy``); a Python loop over the layers replaces
``lax.scan``. Every RMSNorm — ln1 and ln2 of each block and the final
norm, 2·L + 1 per forward and per decode step — launches K6 on the card.

The decode cache is written IN PLACE (``DecodeCache.k`` / ``.v``,
``[L, B, kvh, Smax, hd]``); ``decode_step`` returns the same tensors in a
cache one token longer.

``forward``, ``lm_loss`` and ``decode_step`` take a ``DistContext``
(``distributed.context``): the reference's sharding constraints become
``shard``'s divisibility checks, MoE blocks run ``moe_layer(..., dist)``
— the expert-parallel path over the grid's model axis — and
``cfg.kv_seq_shard`` decodes against a cache split along its length
over the model axis (``attention_decode_seqshard``). Over a fleet's grid
(``Topology.multiprocess(mesh=...)``) each process runs its rows of the
batch on its ranks, the grid's collectives cross processes, and
``transformer_from_numpy(..., dist=)`` / ``shard_experts`` keep only the
experts of its model ranks.

Training: ``lm_loss`` differentiates on both devices — every RMSNorm's
backward is K6's backward kernel pair, the embedding's K2 (``_embed``),
the EP MoE's backward runs K1 / K2 over device maps — and with
``cfg.remat`` each block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``), its activations recomputed in the
backward.

The ``ssm`` family (falcon-mamba) runs ``ln1`` → K6 → ``ssm.mamba_block``
with a residual in each block, and decodes from the recurrent state
(``DecodeCache.ssm_h`` / ``.ssm_conv``, written in place like k / v).

What waits: the ``hybrid``, ``encdec``, ``vlm`` and ``audio`` families
for ROADMAP item 17; each raises ``NotImplementedError`` naming the item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.context import check_dist, shard
from ..kernels.ops import pack_rows_op
from ..kernels.scatter_add_rows import sorted_scatter_maps
from .config import ModelConfig
from .layers import (
    KVCache, attention, attention_decode, init_attn_params, init_mlp_params,
    mlp, normal, rms_norm,
)
from .moe import init_moe_params, local_experts, moe_layer
from .ssm import (
    SSMState, init_mamba_params, init_ssm_state, mamba_block,
    mamba_block_decode,
)

__all__ = [
    "init_params", "forward", "lm_loss", "DecodeCache", "init_decode_cache",
    "decode_step", "transformer_from_numpy", "shard_experts",
]

FAMILIES = ("dense", "moe", "ssm")


def _check(cfg: ModelConfig, dist=None) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) waits for ROADMAP item 17; "
            f"the port runs {FAMILIES}")
    check_dist(dist)


def _bspec(dist):
    return None if dist is None else (dist.batch_axes, None, None)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(layers: dict, i: int) -> dict:
    """Layer i's params from the stacked ``[L, ...]`` tree (views)."""
    return _tree_map(lambda a: a[i], layers)


def _unstack(layers: dict, n: int) -> list:
    """Every layer's params from the stacked ``[L, ...]`` tree, as views
    made by one ``unbind`` per leaf: under grad each leaf's backward is
    one ``stack`` of its layers' grads (indexing layer by layer would
    build a zero ``[L, ...]`` gradient per layer and add them)."""
    per = _tree_map(torch.unbind, layers)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    return [pick(per, i) for i in range(n)]


def _needs_grad(lp: dict, x: torch.Tensor) -> bool:
    """Whether a block's output takes part in a gradient: grad mode on,
    and x or one of the block's params requiring grad."""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    leaves = [lp]
    while leaves:
        t = leaves.pop()
        if isinstance(t, dict):
            leaves.extend(t.values())
        elif t.requires_grad:
            return True
    return False


class _Pick(torch.autograd.Function):
    """``take_along_dim(lg, tgt[..., None], -1)[..., 0]`` whose backward
    writes each row's one gradient into zeros (``scatter``: one target a
    row, so nothing accumulates; ``gather``'s own backward is a
    ``scatter_add``)."""

    @staticmethod
    def forward(ctx, lg, tgt):
        ctx.save_for_backward(tgt)
        ctx.like = (lg.shape, lg.dtype)
        return torch.take_along_dim(lg, tgt[..., None], dim=-1)[..., 0]

    @staticmethod
    def backward(ctx, g):
        (tgt,) = ctx.saved_tensors
        shape, dtype = ctx.like
        out = torch.zeros(shape, dtype=dtype, device=g.device)
        return out.scatter_(-1, tgt[..., None], g[..., None].to(dtype)), None


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """``embed[tokens]`` in the model's dtype. Under grad the lookup is
    K1's pack and its backward K2's fold of the rows into their tokens
    over sorted maps made on the device — the embedding's gradient in a
    fixed order, no atomics."""
    emb = params["embed"]
    if not (torch.is_grad_enabled() and emb.requires_grad):
        return emb[tokens.long()].to(_dtype(cfg))
    idx = tokens.reshape(1, -1).to(torch.int32)
    rows = pack_rows_op(emb[None], idx, maps=sorted_scatter_maps(idx))
    return rows.reshape(tuple(tokens.shape) + (emb.shape[1],)).to(_dtype(cfg))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": torch.ones((d,), dtype=dt, device=device),
                "ssm": init_mamba_params(gen, cfg, dt, device)}
    blk = {
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "attn": init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, cfg.qkv_bias, dt, device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
    }
    if cfg.family == "moe":
        blk["moe"] = init_moe_params(gen, cfg, dt, device)
    else:
        blk["mlp"] = init_mlp_params(gen, d, cfg.d_ff, cfg.mlp, dt, device)
    return blk


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random weights with the reference's shapes, dtypes and scales.

    ``generator`` lives on ``device``. The layers are drawn one at a time
    into the stacked tensors, so the peak is the model plus one layer.
    """
    _check(cfg)
    dt = _dtype(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    params: Dict[str, Any] = {
        "embed": normal(generator, (v, d), 0.02, dt, device),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (d, v), 0.02, dt, device)
    first = _init_block(generator, cfg, device)
    layers = _tree_map(lambda a: a.new_empty((cfg.n_layers,) + a.shape),
                       first)
    for i in range(cfg.n_layers):
        _set_layer(layers, i, first if i == 0 else
                   _init_block(generator, cfg, device))
    params["layers"] = layers
    return params


def _set_layer(layers: dict, i: int, blk: dict) -> None:
    for k, v in blk.items():
        if isinstance(v, dict):
            _set_layer(layers[k], i, v)
        else:
            layers[k][i].copy_(v)


def transformer_from_numpy(params: dict, cfg: ModelConfig,
                           device="cuda", dist=None) -> Dict[str, Any]:
    """The reference ``init_params`` tree, as numpy arrays, in the port.

    bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    rejects) go through a ``uint16`` view and ``.view(torch.bfloat16)``,
    so the bits carry over exactly. With a fleet's ``dist`` only the
    experts of this process's model ranks go to the device (the dense
    weights whole), as the reference's expert sharding holds them.
    """
    _check(cfg, dist)
    params = shard_experts(params, cfg, dist)

    def leaf(a) -> torch.Tensor:
        a = np.array(a)  # a writable copy: torch.from_numpy shares memory
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device)

    return _tree_map(leaf, params)


def shard_experts(params: dict, cfg: ModelConfig, dist) -> dict:
    """``params`` (numpy or tensors) with each MoE block's stacked expert
    weights ``[L, E, ...]`` cut to the experts of the model ranks this
    process runs on a fleet's grid; every other leaf as it is."""
    if cfg.family != "moe" or dist is None or not dist.is_fleet:
        return params
    moe = {k: (local_experts(v, cfg, dist, dim=1)
               if k in ("w1", "w3", "w2") else v)
           for k, v in params["layers"]["moe"].items()}
    return {**params, "layers": {**params["layers"], "moe": moe}}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _block_apply(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                 dist) -> torch.Tensor:
    """One causal decoder block: pre-norm attention, then pre-norm MLP/MoE;
    an SSM block: pre-norm Mamba."""
    if "ssm" in lp:
        x = x + mamba_block(lp["ssm"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                            cfg)
        return shard(x, dist, _bspec(dist))
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attention(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                      rope_theta=cfg.rope_theta)
    x = shard(x, dist, _bspec(dist))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        x = x + moe_layer(lp["moe"], h, cfg, dist)
    else:
        x = x + mlp(lp["mlp"], h, cfg.mlp)
    return shard(x, dist, _bspec(dist))


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params: dict, cfg: ModelConfig, dist,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Returns logits [B, S, V]; ``batch["tokens"]`` is [B, S] (int). On
    a fleet's grid the batch is whole and the logits are this process's
    rows of it (``dist.local_rows``)."""
    _check(cfg, dist)
    tokens = batch["tokens"] if dist is None else \
        dist.local_batch(batch["tokens"])
    x = _embed(params, tokens, cfg)
    x = shard(x, dist, _bspec(dist))
    for lp in _unstack(params["layers"], cfg.n_layers):
        if cfg.remat and _needs_grad(lp, x):
            # the reference's jax.checkpoint around each block; a block
            # draws no random numbers, so no RNG state is kept for it
            x = checkpoint(_block_apply, lp, x, cfg, dist,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_apply(lp, x, cfg, dist)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    return shard(logits, dist, None if dist is None else
                 (dist.batch_axes, None, "model"))


def lm_loss(params: dict, cfg: ModelConfig, dist,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy over 'tokens'.

    With a grid the mean is a left fold over the data groups, ascending,
    of each group's sum of token terms over the global token count (each
    group's sum one reduction of its rows). On a fleet's grid this
    process returns its share of that: its data groups' terms if it
    counts their rows (``dist.counts_rows``), else zero times them (the
    same graph, so its backward runs every exchange). The shares summed
    over the processes in ascending order are the emulated grid's loss
    bit for bit wherever each group's terms are."""
    logits = forward(params, cfg, dist, batch)
    whole = batch["tokens"]
    tokens = (whole if dist is None else dist.local_batch(whole)).long()
    s = tokens.shape[1]
    logits = logits[:, -s:, :]
    tgt = tokens[:, 1:]
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    terms = logz - _Pick.apply(lg, tgt)
    if dist is None:
        return terms.mean()
    n = whole.shape[0] * (s - 1)  # the global token count
    ng = dist.local_grid[0]
    loss = None
    for part in terms.reshape(ng, -1).unbind(0):
        share = part.clone().sum() / n
        loss = share if loss is None else loss + share
    return loss if not dist.is_fleet or dist.counts_rows else loss * 0.0


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeCache:
    """Decode state; the fields a family does not use are None. Dense /
    MoE: k, v [L, B, kvh, Smax, hd]; SSM: ssm_h [L, B, ...] (float32) and
    ssm_conv [L, B, cw - 1, di]; the shared clock ``length`` (a host
    integer)."""

    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    length: int = 0
    ssm_h: Optional[torch.Tensor] = None
    ssm_conv: Optional[torch.Tensor] = None


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> DecodeCache:
    _check(cfg)
    dt = _dtype(cfg)
    if cfg.family == "ssm":
        st = init_ssm_state(cfg, batch, dt, device)
        return DecodeCache(
            ssm_h=st.h.new_zeros((cfg.n_layers,) + tuple(st.h.shape)),
            ssm_conv=st.conv.new_zeros((cfg.n_layers,)
                                       + tuple(st.conv.shape)))
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return DecodeCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device))


def decode_step(params: dict, cfg: ModelConfig, dist,
                token: torch.Tensor, cache: DecodeCache,
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """One new token: token [B, 1] -> (logits [B, 1, V], updated cache).

    Writes the token's K/V (SSM: the new recurrent and conv state) into
    the cache's tensors in place. On a fleet's grid ``token`` and the
    cache are the whole batch's, and the step runs (and writes, and
    returns the logits of) this process's rows of it.
    """
    _check(cfg, dist)
    if cfg.family == "ssm":
        return _decode_ssm(params, cfg, dist, token, cache)
    ck, cv = cache.k, cache.v
    if dist is not None and dist.is_fleet:
        lo, hi = dist.local_rows(token.shape[0])
        token, ck, cv = token[lo:hi], ck[:, lo:hi], cv[:, lo:hi]
    h = params["embed"][token.long()].to(_dtype(cfg))
    h = shard(h, dist, _bspec(dist))
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        att, _ = attention_decode(
            lp["attn"], hn, KVCache(ck[i], cv[i], cache.length),
            cfg.n_heads, cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            dist=dist, seq_shard=cfg.kv_seq_shard)
        h = h + att
        hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            h = h + moe_layer(lp["moe"], hn, cfg, dist)
        else:
            h = h + mlp(lp["mlp"], hn, cfg.mlp)
    x = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), dataclasses.replace(
        cache, length=cache.length + 1)


def _decode_ssm(params: dict, cfg: ModelConfig, dist, token: torch.Tensor,
                cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
    """The SSM family's step: each layer's ``mamba_block_decode`` from its
    state, the new state copied into ``cache.ssm_h`` / ``.ssm_conv``."""
    sh, sc = cache.ssm_h, cache.ssm_conv
    if dist is not None and dist.is_fleet:
        lo, hi = dist.local_rows(token.shape[0])
        token, sh, sc = token[lo:hi], sh[:, lo:hi], sc[:, lo:hi]
    h = params["embed"][token.long()].to(_dtype(cfg))
    h = shard(h, dist, _bspec(dist))
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        out, new = mamba_block_decode(lp["ssm"], hn, SSMState(sh[i], sc[i]),
                                      cfg)
        sh[i].copy_(new.h)
        sc[i].copy_(new.conv)
        h = h + out
    x = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), dataclasses.replace(
        cache, length=cache.length + 1)
