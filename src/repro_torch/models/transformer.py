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

The ``hybrid`` family (zamba2) runs ``n_layers // attn_every`` groups,
each a run of SSM blocks followed by ``shared_attn``: ONE dense block
whose weights every group applies (its gradient sums the uses; it runs
outside remat, as the reference's ``jax.checkpoint`` wraps only the
scanned blocks; layers past the last whole group are not run). Its
decode cache holds the SSM state and ``shared_k`` / ``shared_v``
``[n_groups, B, kvh, Smax, hd]``. The ``encdec`` family (seamless)
encodes ``enc_embeds @ adapter`` with non-causal blocks and a final norm
(``_encode``); its decoder blocks add cross-attention on ``ln3`` over
the encoder's output when it is given (``forward`` always; ``decode_step``
when its ``enc_out`` is passed — the reference's ``ContinuousBatcher``
passes none). ``vlm`` / ``audio`` (llava) put ``prefix_embeds @ adapter``
before the token embeddings, so the logits are ``[B, P + S, V]``; they
decode as the dense family, the prefix never entering the cache. Every
config with a ``frontend`` has the ``adapter`` ``[d, d]``. On a fleet's
grid every family runs this process's rows: ``forward`` cuts
``enc_embeds`` and ``prefix_embeds`` as it cuts the tokens (so
``_encode`` runs on those rows), ``decode_step`` cuts ``enc_out`` and
each cache it writes (the hybrid's SSM state and ``shared_k`` /
``shared_v`` too). ``shared_attn``, ``encoder`` and ``adapter`` are whole
leaves: autograd sums the shared block's uses on each process, and
``fold_leaves`` sums each leaf over the data groups, as for any whole
leaf.

``init_params(cfg, None, device="meta")`` and ``init_decode_cache(...,
device="meta")`` build the trees without drawing or allocating
(``launch/specs.py``).
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

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio")
# the block kind of each family's stacked layers
_LAYER_KIND = {"dense": "dense", "vlm": "dense", "audio": "dense",
               "moe": "moe", "ssm": "ssm", "hybrid": "ssm",
               "encdec": "cross"}


def _check(cfg: ModelConfig, dist=None) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
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


def _init_block(gen: torch.Generator, cfg: ModelConfig, device,
                kind: str) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    if kind == "ssm":
        return {"ln1": torch.ones((d,), dtype=dt, device=device),
                "ssm": init_mamba_params(gen, cfg, dt, device)}
    blk = {
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "attn": init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, cfg.qkv_bias, dt, device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
    }
    if kind == "moe":
        blk["moe"] = init_moe_params(gen, cfg, dt, device)
    else:
        blk["mlp"] = init_mlp_params(gen, d, cfg.d_ff, cfg.mlp, dt, device)
    if kind == "cross":
        blk["ln3"] = torch.ones((d,), dtype=dt, device=device)
        blk["cross"] = init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, cfg.qkv_bias, dt,
                                        device)
    return blk


def _init_stack(gen: torch.Generator, cfg: ModelConfig, device, kind: str,
                n: int) -> dict:
    """n blocks drawn one at a time into stacked ``[n, ...]`` tensors."""
    first = _init_block(gen, cfg, device, kind)
    layers = _tree_map(lambda a: a.new_empty((n,) + a.shape), first)
    for i in range(n):
        _set_layer(layers, i, first if i == 0 else
                   _init_block(gen, cfg, device, kind))
    return layers


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda") -> Dict[str, Any]:
    """Random weights with the reference's shapes, dtypes and scales.

    ``generator`` lives on ``device``. The layers are drawn one at a time
    into the stacked tensors, so the peak is the model plus one layer.
    On ``device="meta"`` nothing is drawn or allocated (``generator`` may
    be None): the tree's shapes and dtypes alone.
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
    params["layers"] = _init_stack(generator, cfg, device,
                                   _LAYER_KIND[cfg.family], cfg.n_layers)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_block(generator, cfg, device, "dense")
    if cfg.family == "encdec":
        params["encoder"] = {
            "layers": _init_stack(generator, cfg, device, "dense",
                                  cfg.n_enc_layers),
            "norm": torch.ones((d,), dtype=dt, device=device),
        }
    if cfg.frontend is not None:
        params["adapter"] = normal(generator, (d, d), d ** -0.5, dt, device)
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


def _block_apply(lp: dict, x: torch.Tensor, cfg: ModelConfig, dist,
                 kind: str = "dense",
                 enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder block: pre-norm attention (causal unless ``kind`` is
    "enc", the encoder's), pre-norm cross-attention over ``enc_out`` (a
    "cross" block given one), then pre-norm MLP/MoE; an SSM block:
    pre-norm Mamba."""
    if "ssm" in lp:
        x = x + mamba_block(lp["ssm"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                            cfg)
        return shard(x, dist, _bspec(dist))
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attention(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                      causal=(kind != "enc"), rope_theta=cfg.rope_theta)
    x = shard(x, dist, _bspec(dist))
    if kind == "cross" and enc_out is not None:
        h = rms_norm(x, lp["ln3"], cfg.norm_eps)
        x = x + attention(lp["cross"], h, cfg.n_heads, cfg.n_kv_heads,
                          kv_input=enc_out, causal=False)
        x = shard(x, dist, _bspec(dist))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        x = x + moe_layer(lp["moe"], h, cfg, dist)
    else:
        x = x + mlp(lp["mlp"], h, cfg.mlp)
    return shard(x, dist, _bspec(dist))


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _run_blocks(blocks: list, x: torch.Tensor, cfg: ModelConfig, dist,
                kind: str, enc_out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``blocks`` in order (the reference's ``_scan_layers``), each under
    ``torch.utils.checkpoint`` with ``cfg.remat`` when it takes part in a
    gradient."""
    for lp in blocks:
        if cfg.remat and _needs_grad(lp, x):
            # the reference's jax.checkpoint around each block; a block
            # draws no random numbers, so no RNG state is kept for it
            x = checkpoint(_block_apply, lp, x, cfg, dist, kind, enc_out,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_apply(lp, x, cfg, dist, kind, enc_out)
    return x


def _encode(params: dict, cfg: ModelConfig, dist,
            enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encdec family's encoder: ``enc_embeds`` [B, Se, D] through the
    adapter, the non-causal blocks (RoPE on) and the encoder's norm —
    what ``forward`` attends to, and what a caller hands ``decode_step``
    as ``enc_out``."""
    _check(cfg, dist)
    adapter = params["adapter"]
    e = torch.as_tensor(enc_embeds, device=adapter.device).to(_dtype(cfg)) \
        @ adapter
    e = shard(e, dist, _bspec(dist))
    enc = params["encoder"]
    e = _run_blocks(_unstack(enc["layers"], cfg.n_enc_layers), e, cfg, dist,
                    "enc")
    return rms_norm(e, enc["norm"], cfg.norm_eps)


def forward(params: dict, cfg: ModelConfig, dist,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Returns logits [B, S_total, V]; ``batch["tokens"]`` is [B, S]
    (int). A frontend arch's ``batch["prefix_embeds"]`` [B, P, D] goes
    before the tokens (S_total = P + S); the encdec family's
    ``batch["enc_embeds"]`` [B, Se, D] feeds its encoder. On a fleet's
    grid the batch is whole, each input is cut to this process's rows
    and the logits are those rows' (``dist.local_rows``)."""
    _check(cfg, dist)

    def rows(x):
        return x if dist is None else dist.local_batch(x)

    x = _embed(params, rows(batch["tokens"]), cfg)
    x = shard(x, dist, _bspec(dist))
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, dist, rows(batch["enc_embeds"]))
    elif cfg.frontend is not None and "prefix_embeds" in batch:
        adapter = params["adapter"]
        pre = torch.as_tensor(rows(batch["prefix_embeds"]),
                              device=adapter.device).to(_dtype(cfg)) @ adapter
        x = shard(torch.cat([pre, x], dim=1), dist, _bspec(dist))
    blocks = _unstack(params["layers"], cfg.n_layers)
    if cfg.family == "hybrid":
        per = cfg.attn_every
        for g in range(cfg.n_layers // per):
            x = _run_blocks(blocks[g * per:(g + 1) * per], x, cfg, dist,
                            "ssm")
            # the one shared block, outside remat as in the reference
            x = _block_apply(params["shared_attn"], x, cfg, dist)
    else:
        x = _run_blocks(blocks, x, cfg, dist, _LAYER_KIND[cfg.family],
                        enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    # the vocabulary over the model axis where it divides, else whole, as
    # the head's own spec (distributed/sharding.py); the reference's
    # jitted constraint pads it (seamless's 256,206 over 8 or 16 ranks)
    return shard(logits, dist, None if dist is None else
                 (dist.batch_axes, None,
                  dist.model_axis_if_divisible(cfg.vocab_size)))


def lm_loss(params: dict, cfg: ModelConfig, dist,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy over 'tokens'.

    With a grid the mean is a left fold over the data groups, ascending,
    of each group's sum of token terms over the global token count (each
    group's sum one reduction of its rows). On a fleet's grid this
    process returns its share of that: a term per data group it touches,
    ascending, that group's sum if it counts the group's rows
    (``dist.counted_groups``: it holds the group's model rank 0), else
    zero times it (the same graph, so its backward runs every exchange).
    The shares summed over the processes in ascending order are the
    emulated grid's loss bit for bit wherever each group's terms are: a
    process's uncounted groups precede its counted ones, so each
    process's share is the fold of the groups it counts."""
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
    groups = dist.local_span.groups
    counted = set(dist.counted_groups)
    loss = None
    for g, part in zip(groups, terms.reshape(len(groups), -1).unbind(0)):
        share = part.clone().sum() / n
        if g not in counted:
            share = share * 0.0
        loss = share if loss is None else loss + share
    return loss


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeCache:
    """Decode state; the fields a family does not use are None. Dense /
    MoE / encdec / vlm / audio: k, v [L, B, kvh, Smax, hd]; SSM and
    hybrid: ssm_h [L, B, ...] (float32) and ssm_conv [L, B, cw - 1, di];
    hybrid: shared_k, shared_v [n_groups, B, kvh, Smax, hd], the shared
    block's cache of each group; cross_k / cross_v: the reference's
    fields for the encdec's cross K / V, which it never fills (each step
    recomputes them from ``enc_out``); the shared clock ``length`` (a host
    integer)."""

    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    length: int = 0
    ssm_h: Optional[torch.Tensor] = None
    ssm_conv: Optional[torch.Tensor] = None
    shared_k: Optional[torch.Tensor] = None
    shared_v: Optional[torch.Tensor] = None
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> DecodeCache:
    _check(cfg)
    dt = _dtype(cfg)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    c = DecodeCache()
    if cfg.family in ("dense", "moe", "vlm", "audio", "encdec"):
        shape = (cfg.n_layers, batch, kvh, max_len, hd)
        c.k = torch.zeros(shape, dtype=dt, device=device)
        c.v = torch.zeros(shape, dtype=dt, device=device)
    if cfg.is_ssm:
        st = init_ssm_state(cfg, batch, dt, device)
        c.ssm_h = st.h.new_zeros((cfg.n_layers,) + tuple(st.h.shape))
        c.ssm_conv = st.conv.new_zeros((cfg.n_layers,)
                                       + tuple(st.conv.shape))
    if cfg.family == "hybrid":
        shape = (cfg.n_layers // cfg.attn_every, batch, kvh, max_len, hd)
        c.shared_k = torch.zeros(shape, dtype=dt, device=device)
        c.shared_v = torch.zeros(shape, dtype=dt, device=device)
    return c


def decode_step(params: dict, cfg: ModelConfig, dist,
                token: torch.Tensor, cache: DecodeCache,
                enc_out: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """One new token: token [B, 1] -> (logits [B, 1, V], updated cache).

    Writes the token's K/V (SSM: the new recurrent and conv state) into
    the cache's tensors in place. The encdec family attends to
    ``enc_out`` [B, Se, D] (``_encode``'s output) in every decoder block,
    its K / V recomputed each step; without it the decoder runs with no
    cross-attention, as the reference's does. On a fleet's grid
    ``token``, the cache and ``enc_out`` are the whole batch's, and the
    step runs (and writes, and returns the logits of) this process's rows
    of it.
    """
    _check(cfg, dist)
    if cfg.family == "ssm":
        return _decode_ssm(params, cfg, dist, token, cache)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, cfg, dist, token, cache)
    ck, cv = cache.k, cache.v
    if dist is not None and dist.is_fleet:
        lo, hi = dist.local_rows(token.shape[0])
        token, ck, cv = token[lo:hi], ck[:, lo:hi], cv[:, lo:hi]
        if enc_out is not None:
            enc_out = enc_out[lo:hi]
    h = params["embed"][token.long()].to(_dtype(cfg))
    h = shard(h, dist, _bspec(dist))
    if cfg.family != "encdec":
        enc_out = None
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = _dense_decode_block(lp, h, ck[i], cv[i], cache.length, cfg, dist,
                                cfg.kv_seq_shard, enc_out)
    x = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), dataclasses.replace(
        cache, length=cache.length + 1)


def _dense_decode_block(lp: dict, h: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, length: int, cfg: ModelConfig,
                        dist=None, seq_shard: bool = False,
                        enc_out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """One attention block's step against its cache (k, v), which it
    writes in place at ``length``: self-attention, cross-attention on
    ``ln3`` over ``enc_out`` when given, then the MLP (or MoE layer)."""
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    att, _ = attention_decode(
        lp["attn"], hn, KVCache(k, v, length), cfg.n_heads, cfg.n_kv_heads,
        rope_theta=cfg.rope_theta, dist=dist, seq_shard=seq_shard)
    h = h + att
    if enc_out is not None:
        hn = rms_norm(h, lp["ln3"], cfg.norm_eps)
        h = h + attention(lp["cross"], hn, cfg.n_heads, cfg.n_kv_heads,
                          kv_input=enc_out, causal=False)
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return h + moe_layer(lp["moe"], hn, cfg, dist)
    return h + mlp(lp["mlp"], hn, cfg.mlp)


def _ssm_decode_block(lp: dict, h: torch.Tensor, sh: torch.Tensor,
                      sc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One SSM block's step from its state (sh, sc), which it overwrites
    with the new state; returns the block's output."""
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    out, new = mamba_block_decode(lp["ssm"], hn, SSMState(sh, sc), cfg)
    sh.copy_(new.h)
    sc.copy_(new.conv)
    return h + out


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
        h = _ssm_decode_block(lp, h, sh[i], sc[i], cfg)
    x = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), dataclasses.replace(
        cache, length=cache.length + 1)


def _decode_hybrid(params: dict, cfg: ModelConfig, dist,
                   token: torch.Tensor, cache: DecodeCache
                   ) -> Tuple[torch.Tensor, DecodeCache]:
    """The hybrid family's step: each group's SSM layers from their state,
    then the shared block against the group's ``shared_k`` / ``shared_v``
    (both written in place). The shared attention takes no ``dist`` and
    no sequence sharding, as in the reference. On a fleet's grid each of
    the four caches is cut to this process's rows, as ``_decode_ssm``
    cuts its own: views, so the step writes into the whole cache."""
    sh, sc, kk, vv = (cache.ssm_h, cache.ssm_conv, cache.shared_k,
                      cache.shared_v)
    if dist is not None and dist.is_fleet:
        lo, hi = dist.local_rows(token.shape[0])
        token = token[lo:hi]
        sh, sc, kk, vv = (c[:, lo:hi] for c in (sh, sc, kk, vv))
    h = params["embed"][token.long()].to(_dtype(cfg))
    h = shard(h, dist, _bspec(dist))
    layers = _unstack(params["layers"], cfg.n_layers)
    sp, per = params["shared_attn"], cfg.attn_every
    for g in range(cfg.n_layers // per):
        for i in range(g * per, (g + 1) * per):
            h = _ssm_decode_block(layers[i], h, sh[i], sc[i], cfg)
        h = _dense_decode_block(sp, h, kk[g], vv[g], cache.length, cfg)
    x = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), dataclasses.replace(
        cache, length=cache.length + 1)
