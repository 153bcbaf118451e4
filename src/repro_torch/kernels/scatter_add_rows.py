"""K2 — sorted result aggregation: ``C[p, tgt[s], :] += partials[p, s, :]``, in place.

Port of ``repro/kernels/scatter_add_rows.py::scatter_add_rows_sorted_pallas``:
stage ④ of every flat executor body. The planner sorts each rank's
receive slots by target row on the host (``prepare_sorted_scatter``, a
copy of the reference's), which turns the scatter into a segmented
reduction: the CUDA kernel (``csrc/scatter_add_rows.cu``) folds each
segment in slot order and writes C once — a warp per short segment, a
thread block per hub row, loads issued ahead of the adds — deterministic,
no atomics.

Both versions UPDATE ``c`` IN PLACE and return it (the reference donates
and aliases C the same way). ``c`` must be contiguous.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

__all__ = ["LAUNCHES", "prepare_sorted_scatter", "stack_sorted_scatter",
           "sorted_scatter_maps", "scatter_add_rows_cuda",
           "scatter_add_rows_plain"]

LAUNCHES = {"scatter_add_rows": 0}


def prepare_sorted_scatter(tgt: np.ndarray):
    """Host-side slot preparation. Returns (perm, meta).

    Slots are sorted by target row with pads (-1) last; pads are then
    re-pointed at the LAST real target so at kernel time they join its
    segment as zero contributions instead of opening a fresh segment (a
    fresh segment would re-initialize that row from the pre-kernel C and
    lose earlier accumulation). ``meta`` = [tgt_sorted..., n_valid].
    """
    tgt = np.asarray(tgt)
    key = np.where(tgt < 0, np.iinfo(np.int32).max, tgt)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    tgt_sorted = tgt[perm].astype(np.int32)
    n_valid = int((tgt_sorted >= 0).sum())
    fill = tgt_sorted[n_valid - 1] if n_valid > 0 else 0
    tgt_sorted[n_valid:] = fill
    meta = np.concatenate([tgt_sorted, np.asarray([n_valid], np.int32)])
    return perm, meta


def stack_sorted_scatter(tgt: np.ndarray):
    """``prepare_sorted_scatter`` of every rank's row of ``tgt`` [P, S]
    (-1 pads), stacked: (perm [P, S], meta [P, S+1]), both int32."""
    maps = [prepare_sorted_scatter(t) for t in np.asarray(tgt)]
    return (np.stack([m[0] for m in maps]).astype(np.int32),
            np.stack([m[1] for m in maps]).astype(np.int32))


def sorted_scatter_maps(tgt: torch.Tensor):
    """``stack_sorted_scatter`` of a target map that lives on the device,
    computed there: tgt [P, S] (-1 pads) -> (perm [P, S], meta [P, S+1]),
    both int32, equal to the host version's. For a map the device makes
    per call (the MoE combine's token map), with no trip to the host. On
    meta (a dry run's trace) the maps are empty tensors of their sizes.
    """
    P, S = tgt.shape
    if tgt.is_meta:
        return (tgt.new_empty((P, S), dtype=torch.int32),
                tgt.new_empty((P, S + 1), dtype=torch.int32))
    tgt = tgt.long()
    key = torch.where(tgt < 0, torch.iinfo(torch.int32).max, tgt)
    perm = torch.sort(key, dim=1, stable=True).indices
    tgt_sorted = torch.take_along_dim(tgt, perm, 1)
    n_valid = (tgt >= 0).sum(1, keepdim=True)
    last = torch.take_along_dim(tgt_sorted, (n_valid - 1).clamp(min=0), 1)
    fill = torch.where(n_valid > 0, last, 0)
    pads = torch.arange(S, device=tgt.device)[None, :] >= n_valid
    tgt_sorted = torch.where(pads, fill, tgt_sorted)
    meta = torch.cat([tgt_sorted, n_valid], 1).to(torch.int32)
    return perm.to(torch.int32), meta


def _check_shapes(c, partials, perm, meta) -> None:
    if c.dim() != 3 or partials.dim() != 3 or perm.dim() != 2 \
            or meta.dim() != 2:
        raise ValueError("scatter_add_rows takes c [P, M, n], partials "
                         "[P, S, n], perm [P, S], meta [P, S+1]")
    P, S, n = partials.shape
    if (c.shape[0] != P or c.shape[2] != n or tuple(perm.shape) != (P, S)
            or tuple(meta.shape) != (P, S + 1)):
        raise ValueError(
            f"scatter_add_rows shapes disagree: c {tuple(c.shape)}, partials "
            f"{tuple(partials.shape)}, perm {tuple(perm.shape)}, meta "
            f"{tuple(meta.shape)}")
    if not c.is_contiguous():
        raise ValueError("scatter_add_rows updates c in place; c must be "
                         "contiguous")


def scatter_add_rows_plain(c: torch.Tensor, partials: torch.Tensor,
                           perm: torch.Tensor, meta: torch.Tensor
                           ) -> torch.Tensor:
    """The same in-place update in plain torch, with the kernel's chain.

    Each segment is seeded from C in float32 and folded in slot order,
    then written once — the kernel's arithmetic, so the two agree bit for
    bit on every device. The fold runs depth by depth: step k adds the
    k-th slot of every segment that long, and no segment appears twice in
    one step, so no two adds ever race (no atomics on CUDA either).
    """
    _check_shapes(c, partials, perm, meta)
    P, S, n = partials.shape
    M = c.shape[1]
    dev = c.device
    valid = torch.arange(S, device=dev)[None, :] < meta[:, S:].long()
    tgt = meta[:, :S].long()
    # a malformed map reads nothing, as in the kernel
    src = perm.long()
    valid &= (tgt >= 0) & (tgt < M) & (src >= 0) & (src < S)
    ranks = torch.arange(P, device=dev)[:, None]
    flat_tgt = (tgt + ranks * M)[valid]  # ascending: ranks, then sorted rows
    flat_src = (src + ranks * S)[valid]
    if flat_tgt.numel() == 0:
        return c
    start = torch.ones_like(flat_tgt, dtype=torch.bool)
    start[1:] = flat_tgt[1:] != flat_tgt[:-1]
    seg = torch.cumsum(start.long(), 0) - 1
    first = torch.nonzero(start).squeeze(1)
    depth = torch.arange(flat_tgt.numel(), device=dev) - first[seg]
    order = torch.argsort(depth, stable=True)
    per_depth = torch.bincount(depth).tolist()
    c_flat = c.view(P * M, n)
    acc = c_flat[flat_tgt[first]].float()
    rows = partials.reshape(P * S, n)
    lo = 0
    for count in per_depth:
        idx = order[lo:lo + count]
        lo += count
        s = seg[idx]
        acc[s] = acc[s] + rows[flat_src[idx]].float()
    c_flat[flat_tgt[first]] = acc.to(c.dtype)
    return c


def scatter_add_rows_cuda(c: torch.Tensor, partials: torch.Tensor,
                          perm: torch.Tensor, meta: torch.Tensor
                          ) -> torch.Tensor:
    """The K2 kernel on the card; updates ``c`` in place and returns it."""
    if not all(t.is_cuda and t.device == c.device
               for t in (c, partials, perm, meta)):
        raise ValueError("scatter_add_rows_cuda needs every operand on one "
                         "CUDA device")
    _check_shapes(c, partials, perm, meta)
    if perm.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError("scatter_add_rows perm and meta must be int32")
    if partials.dtype != c.dtype:
        raise TypeError(f"scatter_add_rows partials dtype {partials.dtype} "
                        f"!= c dtype {c.dtype}")
    code = build.dtype_code(c.dtype, "scatter_add_rows")
    partials, perm, meta = (partials.contiguous(), perm.contiguous(),
                            meta.contiguous())
    P, S, n = partials.shape
    if P * S * n == 0:
        return c
    rc = build.library().repro_scatter_add_rows(
        c.data_ptr(), partials.data_ptr(), perm.data_ptr(), meta.data_ptr(),
        P, c.shape[1], S, n, code, build.stream_of(c))
    build.check(rc, "scatter_add_rows")
    LAUNCHES["scatter_add_rows"] += 1
    return c
