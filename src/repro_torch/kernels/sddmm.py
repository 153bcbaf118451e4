"""K5 — block-sparse SDDMM: ``vals = blocks ⊙ (X_blk · Y_blkᵀ)`` per stored block.

Port of ``repro/kernels/sddmm.py::bsr_sddmm_pallas``: the bsr backend's
``sddmm``, which the SDDMM and FusedMM executors run on every piece. Per
rank p, ``block_cols[p, i, t]`` names the block column of block-row i's
t-th stored (bm × bk) block (-1 = pad) and ``blocks[p, i, t]`` holds its
stored values; ``x3[p, i]`` is the (bm × F) tile of X rows of block-row i
and ``y3[p, kb]`` the (bk × F) tile of Y rows of block column kb. The
result is float32 ``[P, mb, t, bm, bk]``.

The CUDA kernel (``csrc/bsr_sddmm.cu``) takes one block-row of one rank
per thread block, keeps its X tile in shared memory and stages the Y tile
of each stored block; each thread forms one dot in ascending f with
FMAs. The plain version repeats that arithmetic (the FMA chain over f in
ascending order, then the float32 multiply by the stored value; pads give
exact zeros). An empty piece (``t == 0``) returns zeros without a launch,
as the reference does.
"""
from __future__ import annotations

import torch

from . import build

__all__ = ["LAUNCHES", "bsr_sddmm_cuda", "bsr_sddmm_plain"]

LAUNCHES = {"bsr_sddmm": 0}

# the kernel's shared memory: X and Y tiles, rows padded to an odd stride
_SMEM_LIMIT = 232_448  # bytes a block may use on Hopper


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
    # the kernel's FMA chain: a product of two float32 values is exact in
    # float64, so each step rounds once to float64 and once to float32
    # (one ulp from a true FMA only where that double rounding ties)
    x = x3.double()
    acc = out
    for k in range(f):  # ascending f
        acc = (x[:, :, None, :, None, k] * y_g[:, :, :, None, :, k].double()
               + acc.double()).float()
    out = blocks.float() * acc
    return torch.where(valid[..., None, None], out,
                       torch.zeros((), device=out.device))


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
    stride = f + 1 if f % 2 == 0 else f
    if (bm + bk) * stride * 4 > _SMEM_LIMIT:
        raise ValueError(f"bsr_sddmm keeps the X and Y tiles in shared "
                         f"memory; F={f} needs more than {_SMEM_LIMIT} bytes")
    out = torch.empty((P, mb, t, bm, bk), dtype=torch.float32,
                      device=x3.device)
    if t == 0 or P * mb == 0 or kb == 0:  # nothing stored, nothing sampled
        return out.zero_()
    blocks = blocks.float().contiguous()
    cols, x3, y3 = cols.contiguous(), x3.contiguous(), y3.contiguous()
    rc = build.library().repro_bsr_sddmm(
        cols.data_ptr(), blocks.data_ptr(), x3.data_ptr(), y3.data_ptr(),
        out.data_ptr(), P, mb, t, bm, bk, kb, f, code, build.stream_of(x3))
    build.check(rc, "bsr_sddmm")
    LAUNCHES["bsr_sddmm"] += 1
    return out
