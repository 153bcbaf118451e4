"""Mixture-of-Experts layer and the SHIRO-planned MoE dispatch.

Port of ``repro/models/moe.py``. The token→expert exchange of expert
parallelism is a distributed SpMM: the dispatch matrix (expert slots ×
tokens) is sparse, the activations are the dense operand, and SHIRO's
joint vertex cover fetches each (token, rank) column once — the MoE
dedup, recovered from the sparsity pattern alone (``dispatch_matrix``,
``compile_dispatch`` through the port's ``compile_spmm``).

``moe_layer`` runs the reference's single-device path ``_moe_dense``:
every expert over every token as batched products over the stacked
``[E, D, F]`` weights, combined by the top-k gates. The router is
float32, so the logits are taken in float32 as JAX's type promotion
does. What waits: the expert-parallel path (``_moe_ep``, shard_map
all_to_all) for ROADMAP item 15 — a ``dist`` whose model axis is larger
than 1 raises — and ``dispatch_session`` for item 16.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal

__all__ = ["init_moe_params", "moe_layer", "moe_comm_rows",
           "dispatch_matrix", "compile_dispatch"]


def init_moe_params(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, device="cuda") -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    sc = d ** -0.5
    return {
        "router": normal(gen, (d, e), sc, torch.float32, device),
        "w1": normal(gen, (e, d, f), sc, dtype, device),
        "w3": normal(gen, (e, d, f), sc, dtype, device),
        "w2": normal(gen, (e, f, d), f ** -0.5, dtype, device),
    }


def _top_k_gates(logits: torch.Tensor, k: int):
    """Renormalized top-k gates. logits [T, E] -> (gates [T,k], ids [T,k]).

    ``torch.topk`` returns the values in descending order, as
    ``lax.top_k`` does.
    """
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, ids = torch.topk(probs, k, dim=-1)
    gates = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return gates, ids


def _expert_ffn(w1, w3, w2, x):
    """SwiGLU expert FFN; with stacked ``[E, ...]`` weights and x [T, D]
    it runs every expert on every token: [E, T, D]."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def moe_layer(params: dict, x: torch.Tensor, cfg: ModelConfig,
              dist=None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    model_size = 1 if dist is None else dist.model_size
    if model_size > 1 and cfg.n_experts % model_size == 0:
        raise NotImplementedError(
            "moe_layer's expert-parallel path (_moe_ep, all_to_all over the "
            "model axis) waits for ROADMAP item 15 (multi-process)")
    return _moe_dense(params, x, cfg)


def _moe_dense(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Reference path (single device): all experts, dense."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    router = params["router"]
    wide = torch.promote_types(xt.dtype, router.dtype)
    gates, ids = _top_k_gates(xt.to(wide) @ router.to(wide), cfg.top_k)
    # the top-k ids of a token are distinct: a scatter is the reference's
    # .at[].add, exactly
    dense_gates = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                              device=x.device).scatter_(1, ids, gates)
    outs = _expert_ffn(params["w1"], params["w3"], params["w2"], xt)  # [E,T,D]
    y = torch.einsum("te,etd->td", dense_gates.to(x.dtype), outs)
    return y.reshape(b, s, d)


def _routing(cfg: ModelConfig, tokens: int, seed: int) -> np.ndarray:
    """A uniform router's expert ids [T, top_k] (distinct per token)."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.choice(cfg.n_experts, size=cfg.top_k, replace=False)
        for _ in range(tokens)
    ])


def dispatch_matrix(cfg: ModelConfig, tokens: int, M: int, seed: int = 0):
    """The token→expert-slot dispatch as SHIRO's sparse operand.

    Rows are expert slots (rank r owns rows [r·cap, (r+1)·cap)), columns
    are tokens (rank q owns its T/M contiguous tokens); entry (s, t) = 1
    means slot s consumes token t's activation, so ``C = A @ X`` is
    exactly the dispatched activation buffer. A token routed to two
    experts on the SAME rank contributes two slot rows but one column —
    the joint MWVC cover fetches that column once. Returns the port's
    ``CSRMatrix``, ready for ``compile_dispatch`` / ``compile_spmm``.
    """
    from ..core.sparse import COOMatrix, csr_from_coo

    if tokens % M:
        raise ValueError(f"tokens={tokens} must be divisible by M={M}")
    if M < 1 or cfg.n_experts % M:
        raise ValueError(
            f"M={M} must divide n_experts={cfg.n_experts} (experts are "
            f"uniformly partitioned over the expert-parallel ranks)")
    e_loc = cfg.n_experts // M
    dst = _routing(cfg, tokens, seed) // e_loc  # [T, top_k] destination rank
    rows, cols = [], []
    slot_rows = [[] for _ in range(M)]
    for t in range(tokens):
        for r in dst[t]:
            slot_rows[int(r)].append(t)
    cap = max(max((len(s) for s in slot_rows), default=1), 1)
    for r in range(M):
        for s, t in enumerate(slot_rows[r]):
            rows.append(r * cap + s)
            cols.append(t)
    return csr_from_coo(COOMatrix(
        (M * cap, tokens),
        np.asarray(rows, np.int32), np.asarray(cols, np.int32),
        np.ones(len(rows), np.float32)))


def compile_dispatch(cfg: ModelConfig, tokens: int, M: int, where=None,
                     config=None, seed: int = 0, *, device="cuda"):
    """Front-door handle for the MoE dispatch SpMM (the port's
    ``compile_spmm``, P = M ranks emulated on ``device``).

    ``where`` defaults to M ranks; ``config`` to the joint strategy with
    the model-picked schedule. The handle's ``stats()`` report the dedup
    (analytic volume vs the per-assignment row count) and the schedule
    and backend decisions for this routing snapshot; ``h(x)`` with x
    [tokens, D] returns the dispatched buffer [M·cap, D].
    """
    from ..core.api import SpmmConfig, compile_spmm

    a = dispatch_matrix(cfg, tokens, M, seed=seed)
    return compile_spmm(a, M if where is None else where,
                        config or SpmmConfig(strategy="joint",
                                             schedule="auto"),
                        device=device)


def moe_comm_rows(cfg: ModelConfig, tokens: int, M: int, seed: int = 0):
    """Analytic dispatch-volume comparison (rows sent) classic vs SHIRO.

    Monte-Carlo over a uniform router: classic sends top_k rows/token;
    SHIRO sends |unique ranks|/token. Returns (classic, shiro) row counts.
    """
    dst = _routing(cfg, tokens, seed) // (cfg.n_experts // M)
    classic = dst.size
    shiro = sum(len(np.unique(row)) for row in dst)
    return classic, shiro
