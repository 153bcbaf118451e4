"""K5 — block-sparse SDDMM: ``vals = blocks ⊙ (X_blk · Y_blkᵀ)`` per stored block.

Port of ``repro/kernels/sddmm.py::bsr_sddmm_pallas``: the bsr backend's
``sddmm``, which the SDDMM and FusedMM executors run on every piece. Per
rank p, ``block_cols[p, i, t]`` names the block column of block-row i's
t-th stored (bm × bk) block (-1 = pad) and ``blocks[p, i, t]`` holds its
stored values; ``x3[p, i]`` is the (bm × F) tile of X rows of block-row i
and ``y3[p, kb]`` the (bk × F) tile of Y rows of block column kb. The
result is float32 ``[P, mb, t, bm, bk]``.

The CUDA kernel (``csrc/bsr_sddmm.cu``) gives 8×8 blocks, the backend's
default, one warp per block-row: the X tile sits in shared memory, each
stored block is read once, ballots find its nonzero entries and the lanes
share them, so only the dots of stored nonzeros are formed, each with one
Y row. Other block shapes take a generic instance (one thread per block
element). Either way a nonzero entry's dot is the FMA chain over f in
ascending order, then one float32 multiply by the stored value; a stored
zero and a pad slot give +0.0 without a dot (so where X or Y holds an
inf or a NaN, a zero entry stays +0.0 where the dense product gives NaN).
The plain version repeats that arithmetic, so kernel and plain version
agree bit for bit. An empty piece (``t == 0``) returns zeros without a
launch, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

__all__ = ["LAUNCHES", "bsr_sddmm_cuda", "bsr_sddmm_plain", "transpose_ell"]

LAUNCHES = {"bsr_sddmm": 0}

_SMEM_LIMIT = 232_448  # bytes a block may use on Hopper
_GROUP_VALS = 8 * 64  # the 8x8 instance's dots per group of 8 slots


def _smem_bytes(bm: int, bk: int, f: int) -> int:
    """Shared memory the kernel needs at the least: for 8×8 blocks one
    warp's dots and entry list (4 + 2 bytes each) and its X tile (8 rows,
    a stride that keeps them in distinct banks); for other blocks the X and
    Y tiles of one block-row, rows padded to an odd stride."""
    if (bm, bk) == (8, 8):
        stride = f + 4 if f % 4 == 0 else (f if f % 2 else f + 1)
        return _GROUP_VALS * 6 + 8 * stride * 4
    stride = f + 1 if f % 2 == 0 else f
    return (bm + bk) * stride * 4


def _fma(x: torch.Tensor, y: torch.Tensor,
         acc: torch.Tensor) -> torch.Tensor:
    """``__fmaf_rn(x, y, acc)`` elementwise: x·y + acc rounded ONCE to
    float32. The product of two float32 values is exact in float64; the
    float64 sum is made round-to-odd from its exact error (TwoSum), and a
    round-to-odd value with 29 bits to spare rounds to float32 as the
    exact sum does (plain float64 rounding would tie now and then)."""
    p = x.double() * y.double()
    a = acc.double()
    s = p + a
    bp = s - a
    err = (p - bp) + (a - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def _check_shapes(cols, blocks, x3, y3) -> None:
    if cols.dim() != 3 or blocks.dim() != 5 or x3.dim() != 4 \
            or y3.dim() != 4:
        raise ValueError("bsr_sddmm takes block_cols [P, mb, t], blocks "
                         "[P, mb, t, bm, bk], x3 [P, mb, bm, F] and y3 "
                         "[P, kb, bk, F]")
    P, mb, t, bm, bk = blocks.shape
    if (tuple(cols.shape) != (P, mb, t) or tuple(x3.shape[:3]) != (P, mb, bm)
            or y3.shape[0] != P or y3.shape[2] != bk
            or y3.shape[3] != x3.shape[3]):
        raise ValueError(
            f"bsr_sddmm shapes disagree: block_cols {tuple(cols.shape)}, "
            f"blocks {tuple(blocks.shape)}, x3 {tuple(x3.shape)}, y3 "
            f"{tuple(y3.shape)}")


def bsr_sddmm_plain(cols: torch.Tensor, blocks: torch.Tensor,
                    x3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: float32 [P, mb, t, bm, bk]."""
    _check_shapes(cols, blocks, x3, y3)
    P, mb, t, bm, bk = blocks.shape
    kb, f = y3.shape[1], y3.shape[3]
    out = torch.zeros((P, mb, t, bm, bk), dtype=torch.float32,
                      device=blocks.device)
    if out.numel() == 0 or kb == 0:
        return out
    valid = (cols >= 0) & (cols < kb)
    ranks = torch.arange(P, device=cols.device)[:, None, None]
    y_g = y3[ranks, torch.where(valid, cols, 0).long()]  # [P, mb, t, bk, F]
    # the kernel's FMA chain, each step rounded once to float32 (_fma)
    x = x3.double()
    acc = out
    for k in range(f):  # ascending f
        acc = _fma(x[:, :, None, :, None, k], y_g[:, :, :, None, :, k], acc)
    # a stored zero gives +0.0 without its dot, as in the kernel
    keep = valid[..., None, None] & (blocks != 0)
    return torch.where(keep, blocks.float() * acc,
                       torch.zeros((), device=acc.device))


def bsr_sddmm_cuda(cols: torch.Tensor, blocks: torch.Tensor,
                   x3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """The K5 kernel on the card: float32 [P, mb, t, bm, bk]."""
    if not all(t.is_cuda and t.device == x3.device
               for t in (cols, blocks, x3, y3)):
        raise ValueError("bsr_sddmm_cuda needs every operand on one CUDA "
                         "device")
    _check_shapes(cols, blocks, x3, y3)
    if cols.dtype != torch.int32:
        raise TypeError(f"bsr_sddmm block_cols must be int32, got "
                        f"{cols.dtype}")
    if x3.dtype != y3.dtype:
        raise TypeError(f"bsr_sddmm x3 dtype {x3.dtype} != y3 dtype "
                        f"{y3.dtype}")
    code = build.dtype_code(x3.dtype, "bsr_sddmm")
    P, mb, t, bm, bk = blocks.shape
    kb, f = y3.shape[1], y3.shape[3]
    if bm * bk > 1024:
        raise ValueError(f"bsr_sddmm runs one thread per block element; "
                         f"{bm}x{bk} blocks exceed 1024 threads")
    if _smem_bytes(bm, bk, f) > _SMEM_LIMIT:
        raise ValueError(f"bsr_sddmm's shared memory for {bm}x{bk} blocks "
                         f"at F={f} exceeds {_SMEM_LIMIT} bytes")
    out = torch.empty((P, mb, t, bm, bk), dtype=torch.float32,
                      device=x3.device)
    if t == 0 or P * mb == 0 or kb == 0:  # nothing stored, nothing sampled
        return out.zero_()
    blocks = blocks.float().contiguous()
    if blocks.data_ptr() % 8:  # the kernel reads a float2 per lane
        blocks = blocks.clone()
    cols, x3, y3 = cols.contiguous(), x3.contiguous(), y3.contiguous()
    rc = build.library().repro_bsr_sddmm(
        cols.data_ptr(), blocks.data_ptr(), x3.data_ptr(), y3.data_ptr(),
        out.data_ptr(), P, mb, t, bm, bk, kb, f, code, build.stream_of(x3))
    build.check(rc, "bsr_sddmm")
    LAUNCHES["bsr_sddmm"] += 1
    return out


def transpose_ell(cols: np.ndarray, kb: int):
    """The transposed ELL layout of stacked pieces, for K5's backward.

    ``cols`` [P, mb, t] names each stored block's block column (-1 pads,
    and ids past ``kb`` read nothing). Returns (cols_t [P, kb, t_t],
    slot [P, kb, t_t]), both int32: block column c's j-th entry is the
    block of block-row ``cols_t[p, c, j]`` stored at flat slot
    ``slot[p, c, j]`` (= i·t + s) of the forward layout, entries in
    ascending block-row order; -1 pads both. The blocks themselves are
    transposed where the layout is applied.
    """
    cols = np.asarray(cols)
    P_, mb, t = cols.shape
    flat = cols.reshape(P_, mb * t)
    per = []
    for p in range(P_):
        slots = np.flatnonzero((flat[p] >= 0) & (flat[p] < kb))
        c = flat[p, slots]
        order = np.argsort(c, kind="stable")  # block rows stay ascending
        slots, c = slots[order], c[order]
        counts = np.bincount(c, minlength=kb)
        j = np.arange(c.size) - np.repeat(np.cumsum(counts) - counts, counts)
        per.append((c, j, slots))
    t_t = max([int(j.max()) + 1 for _, j, _ in per if j.size] + [0])
    cols_t = np.full((P_, kb, t_t), -1, np.int32)
    slot = np.full((P_, kb, t_t), -1, np.int32)
    for p, (c, j, slots) in enumerate(per):
        cols_t[p, c, j] = slots // t
        slot[p, c, j] = slots
    return cols_t, slot
