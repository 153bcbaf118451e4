"""K1 — comm-buffer pack: ``out[p, s, :] = b[p, idx[p, s], :]`` (zeros where idx < 0).

Port of ``repro/kernels/gather_rows.py::gather_rows_pallas``: the
stage-① send-buffer pack of every flat executor body. The CUDA kernel
(``csrc/gather_rows.cu``) takes the stacked rank axis as a grid
dimension, so one launch packs the send buffers of all P ranks.

``gather_rows_cuda`` launches the kernel (CUDA tensors only) and counts
the launch in ``LAUNCHES``; ``gather_rows_plain`` is the same function in
plain torch, used on the CPU and as the kernel's reference on the card.
"""
from __future__ import annotations

import torch

from . import build
from .ref import gather_rows_ref

__all__ = ["LAUNCHES", "gather_rows_cuda", "gather_rows_plain"]

LAUNCHES = {"gather_rows": 0}


def gather_rows_plain(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """b [P, K, n], idx [P, S] int32 (-1 pad) -> [P, S, n]."""
    return gather_rows_ref(b, idx)


def gather_rows_cuda(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The K1 kernel on the card: b [P, K, n], idx [P, S] int32 -> [P, S, n]."""
    if not (b.is_cuda and idx.is_cuda and b.device == idx.device):
        raise ValueError("gather_rows_cuda needs b and idx on one CUDA device")
    if b.dim() != 3 or idx.dim() != 2 or idx.shape[0] != b.shape[0]:
        raise ValueError(f"gather_rows takes b [P, K, n] and idx [P, S]; got "
                         f"{tuple(b.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows idx must be int32, got {idx.dtype}")
    if b.element_size() not in (2, 4):
        raise TypeError(f"gather_rows copies 2- or 4-byte elements, got "
                        f"{b.dtype}")
    b, idx = b.contiguous(), idx.contiguous()
    P, K, n = b.shape
    S = idx.shape[1]
    out = torch.empty((P, S, n), dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    rc = build.library().repro_gather_rows(
        b.data_ptr(), idx.data_ptr(), out.data_ptr(), P, K, S, n,
        b.element_size(), build.stream_of(b))
    build.check(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out
