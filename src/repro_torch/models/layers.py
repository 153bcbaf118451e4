"""Common transformer layers: RMSNorm (K6), RoPE, GQA attention, MLP.

Port of ``repro/models/layers.py`` for the dense and MoE families: plain
functions on tensors, params in dicts with the reference's names and
layouts (weights ``[in, out]``, activations ``[B, S, D]``, heads
``[B, H, S, hd]``). The numerics follow the reference step by step:

* ``rms_norm`` launches K6 with ``round_before_gain=True`` — the
  reference rounds to x's dtype before the gain;
* ``rope`` computes in float32 and casts back;
* attention scales its logits in their own dtype by a Python float,
  masks with that dtype's most negative value, takes the softmax in
  float32 and casts back; from 1024 tokens it runs ``flash_attention``,
  the same chunked online softmax (q chunks of 512, kv chunks of 1024,
  float32 m / l / acc);
* ``attention_decode`` writes the new token's K/V IN PLACE into the
  caller's cache at ``cache.length`` (the reference's
  ``dynamic_update_slice``, which clamps the write into the cache);
  with ``seq_shard`` and a ``DistContext`` whose model axis is larger
  than 1 it runs ``attention_decode_seqshard``, flash-decoding over the
  cache's length split into M contiguous slices, one per model rank,
  combined by the grid's ``pmax`` / ``psum``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ops import rmsnorm_op

__all__ = [
    "rms_norm", "layer_norm", "rope", "flash_attention", "attention",
    "attention_decode", "attention_decode_seqshard", "mlp",
    "init_attn_params", "init_mlp_params", "KVCache",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``(x · rsqrt(mean(x²) + eps)).astype(x.dtype) · scale`` through K6."""
    return rmsnorm_op(x, scale, eps, round_before_gain=True)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``((x - mean) · rsqrt(var + eps)).astype(x.dtype) · scale + bias``,
    the statistics in float32 (plain torch: no TPU kernel backs it)."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings. x: [..., S, H, hd], positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Static-length KV cache for decode. k/v: [B, kv_heads, S_max, hd].

    ``length`` (tokens currently valid) is a host integer: the clock every
    row of the batch shares.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: int


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)  # [B,H,S,hd]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, kvh, s, hd = k.shape
    return k[:, :, None].expand(b, kvh, groups, s, hd).reshape(
        b, kvh * groups, s, hd)


def _rope_heads(x: torch.Tensor, pos: torch.Tensor,
                theta: float) -> torch.Tensor:
    """``rope`` on a [B, H, S, hd] tensor (the reference transposes to
    [B, S, H, hd] and back)."""
    return rope(x.transpose(1, 2), pos, theta).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Chunked attention with an online softmax (the reference's
    ``flash_attention``: the same chunks, the same float32 m / l / acc).

    q: [B, H, S, hd]; k, v: [B, KVH, Skv, hd] (GQA: KVH divides H; the
    queries are grouped, KV is never repeated). The live set per step is
    B·H·q_chunk·kv_chunk logits.
    """
    b, h, s, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qc = min(q_chunk, s)
    kc = min(kv_chunk, skv)
    if s % qc or skv % kc:
        qc, kc = s, skv  # odd smoke shapes: single chunk
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, kvh, g, s, hd)
    neg = -0.7 * torch.finfo(torch.float32).max
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for qi in range(s // qc):
        qblk = qg[:, :, :, qi * qc:(qi + 1) * qc]  # [B,KVH,G,qc,hd]
        m = torch.full((b, kvh, g, qc), neg, **f32)
        l = torch.zeros((b, kvh, g, qc), **f32)  # noqa: E741
        acc = torch.zeros((b, kvh, g, qc, hd), **f32)
        for ki in range(skv // kc):
            kblk = k[:, :, None, ki * kc:(ki + 1) * kc]  # [B,KVH,1,kc,hd]
            vblk = v[:, :, None, ki * kc:(ki + 1) * kc]
            logit = (qblk @ kblk.transpose(-1, -2)) * scale
            logit = logit.to(torch.float32)
            if causal:
                qpos = qi * qc + torch.arange(qc, device=q.device) + (skv - s)
                kpos = ki * kc + torch.arange(kc, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                logit = torch.where(mask, logit,
                                    torch.tensor(neg, **f32))
            m_new = torch.maximum(m, logit.amax(-1))
            p = torch.exp(logit - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)  # noqa: E741
            acc = acc * corr[..., None] + (
                p.to(v.dtype) @ vblk).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, h, s, hd)


def _project_qkv(params: dict, x: torch.Tensor, src: torch.Tensor):
    q = x @ params["wq"]
    k = src @ params["wk"]
    v = src @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def attention(
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    n_heads: int,
    n_kv_heads: int,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    kv_input: Optional[torch.Tensor] = None,  # cross-attention [B, Se, D]
    rope_theta: float = 10000.0,
    use_rope: bool = True,
) -> torch.Tensor:
    """Full (prefill / cross) GQA attention."""
    b, s, d = x.shape
    q, k, v = _project_qkv(params, x, kv_input if kv_input is not None else x)
    q = _split_heads(q, n_heads)
    k = _split_heads(k, n_kv_heads)
    v = _split_heads(v, n_kv_heads)
    if use_rope and kv_input is None:
        pos = positions if positions is not None else \
            torch.arange(s, device=x.device)[None, :]
        q = _rope_heads(q, pos, rope_theta)
        k = _rope_heads(k, pos, rope_theta)
    if s >= 1024:  # memory-safe path for long sequences (always correct)
        out = flash_attention(q, k, v, causal=(causal and kv_input is None))
        return _merge_heads(out) @ params["wo"]
    groups = n_heads // n_kv_heads
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = params["wq"].shape[-1] // n_heads
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(float(scale))
    if causal and kv_input is None:
        sk = k.shape[2]
        mask = torch.ones((s, sk), dtype=torch.bool,
                          device=x.device).tril(sk - s)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
    return _merge_heads(probs @ v) @ params["wo"]


def attention_decode(
    params: dict,
    x: torch.Tensor,  # [B, 1, D] — single new token
    cache: KVCache,
    n_heads: int,
    n_kv_heads: int,
    *,
    rope_theta: float = 10000.0,
    dist=None,
    seq_shard: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step against a static-length KV cache.

    Writes the new K/V into ``cache.k`` / ``cache.v`` IN PLACE at
    ``cache.length`` and returns them in a cache one token longer.
    """
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one token, got S={s}")
    q, k, v = _project_qkv(params, x, x)
    pos = torch.full((1, 1), cache.length, device=x.device)
    q = _rope_heads(_split_heads(q, n_heads), pos, rope_theta)
    kn = _rope_heads(_split_heads(k, n_kv_heads), pos, rope_theta)
    vn = _split_heads(v, n_kv_heads)
    if seq_shard and dist is not None and dist.model_size > 1:
        out, new_cache = attention_decode_seqshard(
            q, kn, vn, cache, dist=dist, n_heads=n_heads,
            n_kv_heads=n_kv_heads)
        return _merge_heads(out) @ params["wo"], new_cache
    smax = cache.k.shape[2]
    at = min(max(cache.length, 0), smax - 1)  # dynamic_update_slice clamps
    cache.k[:, :, at] = kn[:, :, 0].to(cache.k.dtype)
    cache.v[:, :, at] = vn[:, :, 0].to(cache.v.dtype)
    groups = n_heads // n_kv_heads
    kk = _repeat_kv(cache.k, groups)
    vv = _repeat_kv(cache.v, groups)
    scale = params["wq"].shape[-1] // n_heads
    logits = (q @ kk.transpose(-1, -2)) / math.sqrt(float(scale))
    valid = torch.arange(smax, device=x.device) <= cache.length
    logits = logits.masked_fill(~valid, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
    y = _merge_heads(probs @ vv) @ params["wo"]
    return y, KVCache(cache.k, cache.v, cache.length + 1)


def attention_decode_seqshard(
    q: torch.Tensor,  # [B, H, 1, hd]
    kn: torch.Tensor,  # [B, kvh, 1, hd] new-token K
    vn: torch.Tensor,
    cache: KVCache,  # k/v [B, kvh, Smax, hd], LENGTH split over model
    *,
    dist,
    n_heads: int,
    n_kv_heads: int,
) -> Tuple[torch.Tensor, KVCache]:
    """Flash-decoding: the KV cache split along LENGTH over the model axis.

    The reference's shard_map body on every rank this process runs at
    once: model rank r owns the contiguous slice [r·s_loc, (r+1)·s_loc)
    of the cache (a view of the caller's cache, written IN PLACE), writes
    the new K/V only if ``cache.length`` falls in its range, computes
    PARTIAL softmax statistics (m, l, acc) over its slice, and the
    partials combine with ``pmax`` / ``psum`` over the model axis. The
    ranks stack as the grid's ``[data groups, model ranks, B/Dsz, ...]``
    (on a fleet, this process's block of them, over its batch rows, with
    the combine across processes); every model rank ends with the same
    output, and the first one's is returned.
    """
    M = dist.model_size
    b, kvh, smax, hd = cache.k.shape
    if smax % M:
        raise ValueError(f"the cache length {smax} is not divisible by the "
                         f"model axis ({M} ranks)")
    span = dist.local_span
    ng = len(span.groups)
    if b % ng:
        raise ValueError(f"batch {b} is not divisible by the batch axes "
                         f"{dist.batch_axes} ({ng} groups on these ranks)")
    s_loc = smax // M
    length = int(cache.length)
    groups = n_heads // n_kv_heads
    # the write lands on the one rank whose slice holds ``length`` (on
    # none past the end: the reference gates it by ``in_range``)
    if 0 <= length < smax:
        cache.k[:, :, length] = kn[:, :, 0].to(cache.k.dtype)
        cache.v[:, :, length] = vn[:, :, 0].to(cache.v.dtype)

    bl = b // ng
    if span.is_block:  # [ng, nm, ...]: one broadcast query per group
        nm, m_lo = len(span.models), span.models[0]
        lead_ranks, by_rank = (ng, nm), (1, nm)
        q_ = q.reshape((ng, 1, bl) + tuple(q.shape[1:]))
        rank_m = m_lo + torch.arange(nm, device=q.device)
    else:  # [w, ...]: each rank its group's rows and its model rank's slice
        lead_ranks = by_rank = (len(span.ranks),)
        g_idx = [i for i, (_, _, n, _) in enumerate(span.runs())
                 for _ in range(n)]
        q_ = q.reshape((ng, bl) + tuple(q.shape[1:]))[g_idx]
        rank_m = torch.tensor([m for _, m in span.ranks], device=q.device)

    def ranks(c):  # [B, kvh, Smax, hd] -> [*lead_ranks, B/ng, kvh, s_loc, hd]
        v = c.reshape((ng, bl, kvh, M, s_loc, hd))
        if span.is_block:
            return v[:, :, :, m_lo:m_lo + nm].permute(0, 3, 1, 2, 4, 5)
        return torch.stack([v[i, :, :, m] for i, (_, m)
                            in zip(g_idx, span.ranks)])

    kk = _repeat_kv_ranks(ranks(cache.k), groups)
    vv = _repeat_kv_ranks(ranks(cache.v), groups)
    logits = (q_ @ kk.transpose(-1, -2)) / math.sqrt(float(hd))
    logits = logits.to(torch.float32)  # [*lead_ranks, B/ng, H, 1, s_loc]
    rank_start = (rank_m * s_loc).reshape(by_rank + (1, 1, 1, 1))
    pos = rank_start + torch.arange(s_loc, device=q.device)
    neg = torch.tensor(-0.7 * torch.finfo(torch.float32).max,
                       device=q.device)
    logits = torch.where(pos <= length, logits, neg)
    m_loc = logits.amax(-1)  # [*lead_ranks, B/ng, H, 1]
    p = torch.exp(logits - m_loc[..., None])
    l_loc = p.sum(-1)
    acc_loc = p.to(vv.dtype) @ vv
    # combine partials across the model axis (flash-decoding reduction),
    # the ranks stacked as the grid's communicator takes them
    comm, layout, m_ax, lead = dist.comm, dist.layout, dist.model_axis, \
        dist.lead

    def combine(reduce, t):
        out = reduce(t.reshape(lead + tuple(t.shape[len(lead_ranks):])),
                     layout, m_ax)
        return out.reshape(t.shape)

    m_glob = combine(comm.pmax, m_loc)
    corr = torch.exp(m_loc - m_glob)
    l_glob = combine(comm.psum, l_loc * corr)
    acc_glob = combine(comm.psum, acc_loc * corr[..., None].to(acc_loc.dtype))
    out = acc_glob / torch.clamp_min(l_glob[..., None], 1e-30).to(
        acc_glob.dtype)
    out = out.to(q.dtype)  # the first rank of each group
    out = out[:, 0] if span.is_block else out[[r0 for _, r0, _, _
                                               in span.runs()]]
    return out.reshape(q.shape), KVCache(cache.k, cache.v, cache.length + 1)


def _repeat_kv_ranks(k: torch.Tensor, groups: int) -> torch.Tensor:
    """``_repeat_kv`` on the trailing [B, kvh, S, hd] dims."""
    if groups == 1:
        return k
    *lead, kvh, s, hd = k.shape
    return k.unsqueeze(-3).expand(*lead, kvh, groups, s, hd).reshape(
        *lead, kvh * groups, s, hd)


def mlp(params: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ params["w1"], approximate="tanh") @ params["w2"]


# ---------------------------------------------------------------------------
# initializers: the reference's shapes and scales, drawn from a torch.Generator
# ---------------------------------------------------------------------------


def normal(gen: Optional[torch.Generator], shape, scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, 1)·scale drawn in float32 on ``device``, cast to ``dtype``; on
    the ``meta`` device nothing is drawn (``gen`` may be None)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def init_attn_params(gen: torch.Generator, d_model: int, n_heads: int,
                     n_kv_heads: int, head_dim: int, qkv_bias: bool,
                     dtype: torch.dtype, device="cuda") -> dict:
    sc = d_model ** -0.5
    p = {
        "wq": normal(gen, (d_model, n_heads * head_dim), sc, dtype, device),
        "wk": normal(gen, (d_model, n_kv_heads * head_dim), sc, dtype, device),
        "wv": normal(gen, (d_model, n_kv_heads * head_dim), sc, dtype, device),
        "wo": normal(gen, (n_heads * head_dim, d_model), sc, dtype, device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
                    dtype: torch.dtype, device="cuda") -> dict:
    sc = d_model ** -0.5
    p = {
        "w1": normal(gen, (d_model, d_ff), sc, dtype, device),
        "w2": normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype, device),
    }
    if kind == "swiglu":
        p["w3"] = normal(gen, (d_model, d_ff), sc, dtype, device)
    return p
