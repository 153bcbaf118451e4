"""K1 — row gather in two forms: the comm-buffer pack and the coo gather.

* pack: ``out[p, s, :] = b[p, idx[p, s], :]`` (zeros where idx < 0).
  Port of ``repro/kernels/gather_rows.py::gather_rows_pallas``: the
  stage-① send-buffer pack of every flat executor body.
* scaled: ``out[p, s, :] = (b[p, idx[p, s], :] * val[p, s]).to(out_dtype)``,
  exactly torch's ``(gather(b, idx) * val[..., None]).to(out_dtype)`` with
  a float32 ``val``: bfloat16 widens to float32, one float32 multiply, one
  rounding to ``out_dtype``. Where idx < 0 the zero row is multiplied too
  (a negative val gives -0.0). It is the coo compute's gather and multiply
  (``ops.coo_accumulate_rows_op``), which the reference leaves to one XLA
  fusion: one pass over the products instead of a gather and a multiply.

Both are instances of one CUDA kernel (``csrc/gather_rows.cu``) that
takes the stacked rank axis into a one-dimensional grid, so one launch
covers all P ranks. ``gather_rows_cuda`` / ``gather_rows_scaled_cuda``
launch it (CUDA tensors only) and count their launches in ``LAUNCHES``
under their own keys. The path runs many small launches, so the wrappers
keep their host time down as K6's does: one pass of checks that need no
device sync, no copy of contiguous operands, one allocation, and the lean
launch path of ``kernels.build``. ``gather_rows_plain`` /
``gather_rows_scaled_plain`` are the same functions in plain torch, used
on the CPU and as the kernel's reference on the card.
"""
from __future__ import annotations

import torch

from . import build
from .ref import gather_rows_ref

__all__ = ["LAUNCHES", "gather_rows_cuda", "gather_rows_plain",
           "gather_rows_scaled_cuda", "gather_rows_scaled_plain"]

LAUNCHES = {"gather_rows": 0, "gather_rows_scaled": 0}


def gather_rows_plain(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """b [P, K, n], idx [P, S] int32 (-1 pad) -> [P, S, n]."""
    return gather_rows_ref(b, idx)


def gather_rows_scaled_plain(b: torch.Tensor, idx: torch.Tensor,
                             val: torch.Tensor, out_dtype: torch.dtype
                             ) -> torch.Tensor:
    """b [P, K, n], idx [P, S] int32 (-1 pad), val [P, S] -> [P, S, n] of
    ``out_dtype``: each gathered row times its value."""
    return (gather_rows_ref(b, idx) * val[..., None]).to(out_dtype)


def _check(kernel: str, b: torch.Tensor, idx: torch.Tensor) -> None:
    if not (b.is_cuda and idx.device == b.device):
        raise ValueError(f"{kernel}_cuda needs b and idx on one CUDA device")
    if b.dim() != 3 or idx.dim() != 2 or idx.shape[0] != b.shape[0]:
        raise ValueError(f"{kernel} takes b [P, K, n] and idx [P, S]; got "
                         f"{tuple(b.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{kernel} idx must be int32, got {idx.dtype}")


def gather_rows_cuda(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The K1 kernel, pack form: b [P, K, n], idx [P, S] int32 -> [P, S, n]."""
    _check("gather_rows", b, idx)
    es = b.element_size()
    if es not in (2, 4):
        raise TypeError(f"gather_rows copies 2- or 4-byte elements, got "
                        f"{b.dtype}")
    if not b.is_contiguous():
        b = b.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    P, K, n = b.shape
    S = idx.shape[1]
    out = torch.empty((P, S, n), dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    rc = build.library().repro_gather_rows(
        b.data_ptr(), idx.data_ptr(), out.data_ptr(), P, K, S, n, es,
        build.stream_of(b))
    build.check(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_rows_scaled_cuda(b: torch.Tensor, idx: torch.Tensor,
                            val: torch.Tensor, out_dtype: torch.dtype
                            ) -> torch.Tensor:
    """The K1 kernel, scaled form: b [P, K, n] (float32 or bfloat16), idx
    [P, S] int32, val [P, S] float32 -> [P, S, n] of ``out_dtype`` (float32
    or bfloat16)."""
    _check("gather_rows_scaled", b, idx)
    if val.device != b.device or val.shape != idx.shape:
        raise ValueError(f"gather_rows_scaled val must be {tuple(idx.shape)} "
                         f"on {b.device}; got {tuple(val.shape)} on "
                         f"{val.device}")
    if val.dtype != torch.float32:
        raise TypeError(f"gather_rows_scaled val must be float32, got "
                        f"{val.dtype}")
    b_code = build.dtype_code(b.dtype, "gather_rows_scaled")
    out_code = build.dtype_code(out_dtype, "gather_rows_scaled")
    if not b.is_contiguous():
        b = b.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if not val.is_contiguous():
        val = val.contiguous()
    P, K, n = b.shape
    S = idx.shape[1]
    out = torch.empty((P, S, n), dtype=out_dtype, device=b.device)
    if out.numel() == 0:
        return out
    rc = build.library().repro_gather_rows_scaled(
        b.data_ptr(), idx.data_ptr(), val.data_ptr(), out.data_ptr(), P, K,
        S, n, b_code, out_code, build.stream_of(b))
    build.check(rc, "gather_rows_scaled")
    LAUNCHES["gather_rows_scaled"] += 1
    return out
