"""Plain torch oracles for the kernels, ported from ``repro.kernels.ref``.

They compute the same functions as the reference's jnp oracles and take
the same single-rank shapes; every function also accepts leading rank
axes (``[P, ...]``), the stacked layout the port's executors use. The
tests hold them against the jnp oracles, and the kernels' plain versions
against them.
"""
from __future__ import annotations

import torch

__all__ = ["bsr_spmm_ref", "gather_rows_ref", "scatter_add_rows_ref"]


def bsr_spmm_ref(block_cols: torch.Tensor, blocks: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Block-sparse (ELL-style BSR) matmul oracle.

    block_cols: [..., mb, t] int32, block-column id of each stored block, -1 = pad
    blocks:     [..., mb, t, bm, bk] float, stored dense blocks (pads are zero)
    b:          [..., kb*bk, n] dense
    returns     [..., mb*bm, n] in b's dtype, accumulated in float32
    """
    *lead, mb, t, bm, bk = blocks.shape
    n = b.shape[-1]
    bt = b.reshape(*lead, -1, bk * n)  # [..., kb, bk*n]
    safe = block_cols.clamp(min=0).long().reshape(*lead, mb * t, 1)
    gathered = torch.take_along_dim(bt, safe, dim=-2)
    gathered = gathered.reshape(*lead, mb, t, bk, n)
    gathered = torch.where((block_cols >= 0)[..., None, None], gathered,
                           torch.zeros((), dtype=gathered.dtype))
    out = torch.einsum("...mtik,...mtkn->...min", blocks.float(),
                       gathered.float())
    return out.reshape(*lead, mb * bm, n).to(b.dtype)


def gather_rows_ref(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Comm-buffer pack oracle: out[s] = b[idx[s]], zeros where idx < 0."""
    rows = torch.take_along_dim(b, idx.clamp(min=0).long()[..., None],
                                dim=-2)
    return torch.where((idx >= 0)[..., None], rows,
                       torch.zeros((), dtype=b.dtype))


def scatter_add_rows_ref(c: torch.Tensor, partials: torch.Tensor,
                         tgt: torch.Tensor) -> torch.Tensor:
    """Result-aggregation oracle: c[tgt[s]] += partials[s]; tgt < 0 dropped.

    Out of place, like the jnp oracle. Contributions to one row are added
    in slot order.
    """
    *lead, m, n = c.shape
    ranks = 1
    for d in lead:
        ranks *= d
    s = tgt.shape[-1]
    tgt = tgt.reshape(ranks, s).long()
    valid = tgt >= 0
    offs = torch.arange(ranks, device=c.device)[:, None] * m
    flat_tgt = (tgt.clamp(min=0) + offs)[valid]
    vals = partials.reshape(ranks, s, n)[valid].to(c.dtype)
    out = c.reshape(ranks * m, n).clone()
    out.index_add_(0, flat_tgt, vals)
    return out.reshape(c.shape)
