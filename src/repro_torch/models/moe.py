"""Mixture-of-Experts layer with SHIRO-planned expert-parallel dispatch.

Port of ``repro/models/moe.py``. The token→expert exchange of expert
parallelism is a distributed SpMM: the dispatch matrix (expert slots ×
tokens) is sparse, the activations are the dense operand. SHIRO's two
ideas map directly:

* column-based redundancy — a token routed to two experts on the SAME
  expert-parallel rank is classically sent twice; ``shiro_dispatch``
  sends one activation row per (token, rank) with per-expert index and
  gate lists;
* row-based pre-aggregation — the expert outputs for one token are
  weighted and summed on the expert rank into one partial row before the
  return exchange, so the combine also moves one row per (token, rank).

``moe_layer`` runs ``_moe_dense`` (every expert over every token, the
single-device path) when there is no model axis to spread the experts
over, and ``_moe_ep`` — the reference's shard_map body — otherwise. The
port runs the ranks of the ``DistContext``'s grid on one device: x is
viewed as ``[Dsz, 1, B/Dsz, S, D]`` and expanded over the M model ranks,
every rank's routing, buffers and expert FFN run as batched tensor
operations over the stacked ``[Dsz·M, ...]`` ranks (on a fleet's grid,
``Topology.multiprocess(mesh=...)``, over this process's span of them,
with x its batch rows and the experts of its model ranks), and the four
all_to_alls on the model axis go through the grid's ``MeshComm`` (the
activations as ``all_to_all@model``, the index and gate lists as
``all_to_all@model:meta``). The dispatch buffer is packed by K1 from the
token map, every local expert's rows are gathered by one K1 launch and
run as one batched FFN, and both folds — the pre-aggregated combine and
the return ``y[tok_map] += recv`` — are K2 over sorted maps made on the
device: each row's partials fold in a fixed order (ascending expert;
ascending (rank, slot)), no atomics. Under grad the same device maps
serve the backward (each K1 pack's is a K2 fold over its index's sorted
maps, each K2 fold's a K1 pack by its targets), so a training step
builds no map on the host; the router learns through the gates, each
model rank's experts through their rows. The reference's output is
replicated over the model axis; model rank 0's is returned
(``all_ranks=True`` returns every rank's).
Inside ``record_dispatch()`` each expert-parallel call also records its
capacities, the dispatch rows it fills and the assignments it drops.

``dispatch_matrix`` / ``compile_dispatch`` / ``dispatch_session`` give
the same exchange as SHIRO's sparse operand: its joint vertex cover
fetches each (token, rank) column once — the MoE dedup, recovered from
the sparsity pattern alone — through the port's ``compile_spmm`` and
``SpmmSession``.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ops import pack_rows_op, scatter_add_rows_exec_op
from ..kernels.scatter_add_rows import sorted_scatter_maps
from .config import ModelConfig
from .layers import normal

__all__ = ["init_moe_params", "moe_layer", "moe_comm_rows", "local_experts",
           "dispatch_matrix", "compile_dispatch", "dispatch_session",
           "record_dispatch"]


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
    if dist is None or dist.model_size == 1 or \
            cfg.n_experts % dist.model_size:
        return _moe_dense(params, x, cfg)
    return _moe_ep(params, x, cfg, dist, shiro=cfg.shiro_dispatch)


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


# ---------------------------------------------------------------------------
# the expert-parallel path, every rank of the grid on one device
# ---------------------------------------------------------------------------


def _moe_ep(params: dict, x: torch.Tensor, cfg: ModelConfig, dist,
            shiro: bool, all_ranks: bool = False) -> torch.Tensor:
    """The reference's shard_map over the grid: batch over the batch
    axes, experts over the model axis, on the ranks this process runs
    (all of the grid on one device; its span on a fleet, whose ``x`` is
    this process's batch rows, ``dist.local_batch``: every row of each
    data group it touches). Returns model rank 0's y [B, S, D] — on a
    fleet the first rank it holds of each data group — or, with
    ``all_ranks``, every model rank's it runs: [M', B, S, D] where the
    span is a block, else each rank's rows of its group, [w, B/G', S, D]
    (G' groups touched)."""
    M = dist.model_size
    e_loc = cfg.n_experts // M
    b, s, d = x.shape
    span = dist.local_span
    ng = len(span.groups)
    if b % ng:
        raise ValueError(f"batch {b} is not divisible by the batch axes "
                         f"{dist.batch_axes} ({ng} groups on these ranks)")
    t_loc = (b // ng) * s
    # capacity per (src rank, dst rank) activation buffer
    rows_per_token = cfg.top_k
    if shiro and cfg.shiro_capacity:
        # expected unique destination ranks per token under dedup:
        # E[unique] = M*(1 - (1 - 1/M)^k) < k — SHIRO's dominance bound
        # applied to buffer sizing. capacity_factor absorbs the variance;
        # overflow falls back to token dropping.
        rows_per_token = M * (1.0 - (1.0 - 1.0 / M) ** cfg.top_k)
    cap = max(8, int(t_loc * rows_per_token / M * cfg.capacity_factor))
    # per-expert index capacity
    cap_e = max(8, int(t_loc * cfg.top_k / cfg.n_experts
                       * cfg.capacity_factor))

    # every rank of a data group holds that group's tokens (the batch is
    # replicated over the model axis): [w, t_loc, D], rank by rank
    xg = x.reshape(ng, t_loc, d)
    xs = torch.cat([xg[i].expand(n, t_loc, d) for i, (_, _, n, _)
                    in enumerate(span.runs())])
    w1, w3, w2 = (local_experts(params[k], cfg, dist) for k in
                  ("w1", "w3", "w2"))
    y = _moe_ep_body(xs, params["router"], w1, w3, w2, cfg=cfg, span=span,
                     comm=dist.comm, layout=dist.layout,
                     m_ax=dist.model_axis, lead=dist.lead, M=M,
                     e_loc=e_loc, cap=cap, cap_e=cap_e, shiro=shiro)
    y = y.reshape((len(span.ranks), b // ng, s, d))
    if not all_ranks:  # each group's first rank here
        return torch.cat([y[r0] for _, r0, _, _ in span.runs()])
    if not span.is_block:
        return y
    nm = len(span.models)
    return y.reshape(ng, nm, b // ng, s, d).transpose(0, 1).reshape(
        nm, b, s, d)


def local_experts(w, cfg: ModelConfig, dist, dim: int = 0):
    """The experts of the model ranks this process runs, along ``dim`` of
    ``w`` (a tensor or a numpy array), in ascending model rank: all of
    them on one device; on a fleet those of ``dist.local_span.models`` —
    a run, or not ({0, 1, 3} of M = 4) — cut from a whole ``w``, or ``w``
    itself when it holds just those (``transformer.shard_experts``)."""
    models = dist.local_span.models
    e_loc = cfg.n_experts // dist.model_size
    if w.shape[dim] == len(models) * e_loc:
        return w
    if w.shape[dim] != cfg.n_experts:
        raise ValueError(f"expert weights hold {w.shape[dim]} experts: "
                         f"neither all {cfg.n_experts} nor the "
                         f"{len(models) * e_loc} of model ranks {models}")
    runs = []  # (first, last + 1) runs of consecutive model ranks
    for m in models:
        if runs and runs[-1][1] == m:
            runs[-1][1] = m + 1
        else:
            runs.append([m, m + 1])
    cuts = [w[tuple([slice(None)] * dim + [slice(lo * e_loc, hi * e_loc)])]
            for lo, hi in runs]
    if len(cuts) == 1:
        return cuts[0]
    if isinstance(w, torch.Tensor):
        return torch.cat(cuts, dim)
    return np.concatenate(cuts, dim)


def to_dispatch_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as the reference computes it. For
    ``float8_e4m3fn`` a magnitude past the largest finite value's rounding
    range (> 464), an infinity or a NaN gives NaN with x's sign (NaN for
    a NaN), as XLA and ml_dtypes convert; torch's own cast may saturate
    to ±448 instead, so those elements are set here."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    over = ~(x.float().abs() <= 464.0)
    nan = torch.where(x.float() < 0, 0xFF, 0x7F).to(torch.uint8)
    return torch.where(over, nan, y.view(torch.uint8)).view(dtype)


_RECORD: Optional[List[dict]] = None


@contextlib.contextmanager
def record_dispatch():
    """Within the block, every expert-parallel MoE call appends one dict
    to the list it yields: ``cap`` / ``cap_e`` (the buffer and per-expert
    capacities), ``sent`` (dispatch rows filled: the (token, rank) pairs
    under SHIRO's dedup, the assignments under the classic exchange) and
    ``dropped`` (assignments no expert computes: over a buffer's or an
    expert's capacity), both counted once per data group (model rank 0)
    and kept on the device as 0-d tensors until read, so recording adds
    no sync."""
    global _RECORD
    saved, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = saved


def _rank_in_key(key: torch.Tensor, ok: torch.Tensor,
                 n_keys: int) -> torch.Tensor:
    """For each entry j of ``key`` [R, N] (values in [0, n_keys)) with
    ``ok[j]``: how many ``ok`` entries of the same key come before it —
    the reference's ``cumsum(one_hot(key) & ok) - 1`` read at the entry's
    own key, without the [R, N, n_keys] one-hot. The value at an entry
    that is not ``ok`` is unspecified (the callers never read it).

    A stable sort groups the entries by key in their order (the not-ok
    ones under a key of their own, past the rest); an entry's rank is its
    sorted position less its key's first."""
    R, N = key.shape
    pos = torch.arange(N, device=key.device).expand(R, N)
    sk, order = torch.sort(torch.where(ok, key, n_keys), dim=1, stable=True)
    first = torch.ones_like(ok)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    return torch.empty_like(key).scatter_(1, order, pos - start)


def _scatter_drop(size: int, tgt: torch.Tensor, ok: torch.Tensor,
                  src: torch.Tensor, fill) -> torch.Tensor:
    """``out [R, size] = fill``, then ``out[r, tgt[r, j]] = src[r, j]``
    where ``ok`` — the reference's ``.at[].max`` / ``.at[].add(mode=
    "drop")`` into a fresh buffer, whose kept targets are distinct, so
    the one value a target receives is its result. Dropped entries land
    in a slot of their own past ``size``, so no two writes ever meet."""
    R, n = tgt.shape
    spill = size + torch.arange(n, device=tgt.device)
    idx = torch.where(ok, tgt, spill[None, :])
    out = torch.full((R, size + n), fill, dtype=src.dtype, device=src.device)
    return out.scatter(1, idx, src)[:, :size]


def _moe_ep_body(xs, router, w1, w3, w2, *, cfg, span, comm, layout, m_ax,
                 lead, M, e_loc, cap, cap_e, shiro):
    """The reference's ``_moe_ep_body`` on every rank this process runs
    at once.

    xs [R, T, D] holds the R ranks of ``span`` (``dist.local_span``: the
    whole grid on one device) in rank order, each with its data group's
    tokens, and w1 / w3 / w2 the experts of the span's model ranks,
    [nm·e_loc, ...] in ascending rank -> y [R, T, D]."""
    R, t, d = xs.shape
    dev = xs.device
    k = cfg.top_k
    xt = xs.reshape(R, t, d)
    wide = torch.promote_types(xt.dtype, router.dtype)
    # one [T, D] @ [D, E] product a rank: the same shapes however many
    # ranks this process runs, so a fleet's logits are the emulated
    # grid's bit for bit (one product over all ranks' rows may take
    # another kernel, and so another order, on the card)
    rw = router.to(wide)
    gates, ids = _top_k_gates(torch.stack([x_r.to(wide) @ rw
                                           for x_r in xt.unbind(0)]),
                              k)  # [R, T, K]
    dst = ids // e_loc  # destination EP rank per assignment
    le = ids % e_loc  # local expert on that rank

    if shiro:
        # --- column-based dedup: send each (token, rank) pair once -----
        # first[i]: the first assignment of the token with i's rank (the
        # first True of the row, argmax's documented tie-break)
        first = (dst[..., :, None] == dst[..., None, :]).to(
            torch.uint8).argmax(-1)  # [R, T, K]
        dup = first != torch.arange(k, device=dev)
        send_mask = ~dup  # the de-duplicated (token, rank) pairs
    else:
        send_mask = torch.ones((R, t, k), dtype=torch.bool, device=dev)

    flat_dst = dst.reshape(R, t * k)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    flat_tok = flat_tok[None, :].expand(R, t * k)
    flat_send = send_mask.reshape(R, t * k)

    # slot of each SENT pair within its destination-rank buffer
    send_slot = _rank_in_key(flat_dst, flat_send, M)
    send_ok = flat_send & (send_slot < cap)

    # the token map [R, M·cap] (-1 where no token), then the activation
    # send buffer [R, M·cap, D] packed from it by K1 — each slot holds at
    # most one token, so the gather is the reference's scatter-add into
    # zeros. Optional fp8 dispatch (cfg.moe_dispatch_dtype): expert
    # compute casts back to x.dtype.
    tok_map = _scatter_drop(M * cap, flat_dst * cap + send_slot, send_ok,
                            flat_tok, -1).to(torch.int32)
    # its sorted maps serve the return fold below and, under grad, the
    # pack's backward: made here on the device, so a training step sends
    # no map to the host
    tok_maps = sorted_scatter_maps(tok_map)
    buf = pack_rows_op(xt, tok_map, maps=tok_maps)
    if cfg.moe_dispatch_dtype != "none":
        buf = to_dispatch_dtype(buf, getattr(torch, cfg.moe_dispatch_dtype))

    # per-assignment: the slot its token occupies for its destination rank
    # (for dups, the slot of the FIRST assignment with the same dst — what
    # the reference's pairwise loop leaves, since every earlier match
    # already holds that slot)
    pair_slot = send_slot.reshape(R, t, k)
    if shiro:
        pair_slot = torch.take_along_dim(pair_slot, first, -1)
    assign_slot = pair_slot.reshape(R, t * k)
    assign_ok = assign_slot < cap
    if not shiro:
        assign_ok = assign_ok & flat_send

    # per-(dst, local-expert) index/gate lists [R, M, e_loc, cap_e]
    flat_le = le.reshape(R, t * k)
    pair_key = flat_dst * e_loc + flat_le
    exp_slot = _rank_in_key(pair_key, assign_ok, M * e_loc)
    exp_ok = assign_ok & (exp_slot < cap_e)
    ewid = pair_key * cap_e + exp_slot
    size = M * e_loc * cap_e
    exp_idx = _scatter_drop(size, ewid, exp_ok, assign_slot, -1)
    exp_gate = _scatter_drop(size, ewid, exp_ok, gates.reshape(R, t * k),
                             0.0)
    if _RECORD is not None:
        # model rank 0 of each data group (on a fleet, on the process
        # that holds it: the others count nothing)
        rank0 = [r for r, (_, m) in enumerate(span.ranks) if m == 0]
        _RECORD.append(dict(cap=cap, cap_e=cap_e,
                            sent=send_ok[rank0].sum(),
                            dropped=(~exp_ok[rank0]).sum()))

    # ---- all_to_all on the model axis: activations + metadata ----------
    def a2a(v, *rest, meta=False):
        out = comm.all_to_all(v.reshape(lead + (M,) + rest), layout, m_ax,
                              meta=meta)
        return out.reshape((R, M) + rest)

    recv_buf = a2a(buf, cap, d)  # [R, M(src), cap, D]
    recv_idx = a2a(exp_idx, e_loc, cap_e, meta=True)  # [R, M, e_loc, cap_e]
    recv_gate = a2a(exp_gate, e_loc, cap_e, meta=True)

    # ---- expert compute + row-based pre-aggregated combine -------------
    # every local expert of every rank at once: the index lists in
    # (expert, source, slot) order, K1 gathers their rows, the FFN runs
    # batched over the [n, e_loc] experts of each data group's n ranks
    # here with each model rank's own weights, one group at a time (each
    # expert's product is [n_e, D] @ [D, F] on any grid and any span),
    # and K2 folds each buffer row's partials in ascending expert order —
    # the reference's loop of combine adds (pre-aggregation: partials for
    # the same token row sum HERE, before the return transfer)
    flat_recv = recv_buf.reshape(R, M * cap, d).to(xs.dtype)
    idx = recv_idx.transpose(1, 2)  # [R, e_loc, M(src), cap_e]
    gate = recv_gate.transpose(1, 2)
    src_base = (torch.arange(M, device=dev) * cap)[:, None]
    tgt = torch.where(idx >= 0, src_base + idx, -1).reshape(R, -1).to(
        torch.int32)
    tgt_maps = sorted_scatter_maps(tgt)
    n_e = M * cap_e
    xin = pack_rows_op(flat_recv, tgt, maps=tgt_maps)  # [R, e_loc·n_e, D]
    xe = xin.reshape(R, e_loc, n_e, d)
    nm = len(span.models)
    w1r, w3r, w2r = (w.reshape((nm, e_loc) + tuple(w.shape[1:]))
                     for w in (w1, w3, w2))
    ye = []
    for _, r0, n, i0 in span.runs():
        xg, ws = xe[r0:r0 + n], (w1r[i0:i0 + n], w3r[i0:i0 + n],
                                 w2r[i0:i0 + n])
        ye.append((F.silu(xg @ ws[0]) * (xg @ ws[1])) @ ws[2])
    yout = (torch.cat(ye) if len(ye) > 1 else ye[0]).reshape(
        R, e_loc * n_e, d)
    # a pad's row joins no fold (K2 stops at the valid slots)
    yout = yout * gate.reshape(R, -1, 1).to(xs.dtype)
    combine = torch.zeros((R, M * cap, d), dtype=xs.dtype, device=dev)
    combine = scatter_add_rows_exec_op(combine, yout, *tgt_maps,
                                       targets=tgt)

    # ---- return all_to_all + the fold into token order (K2) ------------
    recv_comb = a2a(combine, cap, d).reshape(R, M * cap, d)
    y = torch.zeros((R, t, d), dtype=xs.dtype, device=dev)
    return scatter_add_rows_exec_op(y, recv_comb, *tok_maps, targets=tok_map)


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

    ``where`` defaults to M ranks; any substrate of M ranks serves, a
    fleet of processes too (``Topology.multiprocess()``: each process
    holds its span of the expert ranks, takes the whole x or its own
    tokens' rows, and returns its slot rows, ``h.row_blocks()``).
    ``config`` defaults to the joint strategy with the model-picked
    schedule. The handle's ``stats()`` report the dedup (analytic volume
    vs the per-assignment row count) and the schedule and backend
    decisions for this routing snapshot; ``h(x)`` with x [tokens, D]
    returns the dispatched buffer [M·cap, D] (on a fleet, this process's
    rows of it).
    """
    from ..core.api import SpmmConfig, compile_spmm

    a = dispatch_matrix(cfg, tokens, M, seed=seed)
    return compile_spmm(a, M if where is None else where,
                        config or SpmmConfig(strategy="joint",
                                             schedule="auto"),
                        device=device)


def dispatch_session(cfg: ModelConfig, tokens: int, M: int, where=None,
                     config=None, seed: int = 0, *, device="cuda"):
    """A drift-aware ``SpmmSession`` over the MoE dispatch SpMM.

    MoE routing is the canonical drifting pattern: the dispatch matrix
    is a function of the router's live decisions, so a distribution
    shift strands the planned cover. Serve through the session and feed
    each fresh routing snapshot to ``maybe_replan`` — below
    ``drift_threshold`` the planned schedule keeps serving, past it MWVC
    + the model's schedule choice re-run and the handle hot-swaps
    between waves:

        s = dispatch_session(cfg, T, M, device="cpu")
        drift, swapped = s.maybe_replan(dispatch_matrix(cfg, T, M, seed=k))
        y = s.handle()(x)

    On a fleet of processes (``where=Topology.multiprocess()``) every
    process feeds the same routing snapshot, so ``maybe_replan`` takes
    the same branch everywhere (drift and values digests are host
    computations) and the swap happens on every process between waves.
    """
    from ..core.api import SpmmConfig
    from ..core.session import SpmmSession

    a = dispatch_matrix(cfg, tokens, M, seed=seed)
    return SpmmSession.build(a, M if where is None else where,
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
