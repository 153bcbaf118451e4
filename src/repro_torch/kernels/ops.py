"""Executor-facing kernel ops, dispatched by the tensor's device.

Port of ``repro/kernels/ops.py``. Every op takes the stacked rank layout
(leading [P, ...] axis) and dispatches on where its operands live:

* a CUDA tensor launches the hand-written kernel — or raises; there is no
  fallback that hides the device or the kernel;
* a CPU tensor takes the kernel's plain torch version.

There is no environment switch. Each kernel launch is counted by its
wrapper (``launch_counts``), so a run can show that it went through the
kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import bsr_spmm as _bsr
from . import gather_rows as _gather
from . import rmsnorm as _rms
from . import scatter_add_rows as _scatter
from . import sddmm as _sddmm
from .scatter_add_rows import prepare_sorted_scatter

__all__ = [
    "on_card",
    "pack_rows_op",
    "scatter_add_rows_exec_op",
    "coo_accumulate_rows_op",
    "bsr_spmm_op",
    "bsr_spmm_acc_op",
    "bsr_sddmm_op",
    "rmsnorm_op",
    "prepare_sorted_scatter",
    "launch_counts",
    "reset_launch_counts",
]

_COUNTERS = (_gather.LAUNCHES, _scatter.LAUNCHES, _bsr.LAUNCHES,
             _sddmm.LAUNCHES, _rms.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    out: Dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for k in counter:
            counter[k] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def pack_rows_op(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Comm-buffer pack: ``out[p, ..., s, :] = b[p, idx[p, ..., s]]``.

    ``b`` is [P, K, n]; ``idx`` [P, ...] may carry layout axes after the
    rank (e.g. [P, P, max_b] in the single-round schedule); the gather
    runs on the flattened slot axis and the result is reshaped back.
    Slots with ``idx < 0`` (plan padding) come back zeroed.
    """
    flat = idx.reshape(idx.shape[0], -1)
    # every executor body packs here, so a CUDA idx goes straight to the
    # wrapper, which checks b's device itself (looked up on its module at
    # call time, so a recorder that replaces it sees the call)
    if idx.is_cuda:
        out = _gather.gather_rows_cuda(b, flat)
    else:
        on_card(b, idx)  # raises unless b is on the CPU too
        out = _gather.gather_rows_plain(b, flat)
    return out.reshape(idx.shape + (b.shape[-1],))


def scatter_add_rows_exec_op(c: torch.Tensor, partials: torch.Tensor,
                             perm: torch.Tensor, meta: torch.Tensor
                             ) -> torch.Tensor:
    """Result aggregation ``c[p, tgt[p, s]] += partials[p, s]``, IN PLACE.

    ``perm`` / ``meta`` are the host-prepared sorted-scatter maps
    (``prepare_sorted_scatter``, once per plan). Returns ``c``.
    """
    fn = _scatter.scatter_add_rows_cuda if on_card(c, partials, perm, meta) \
        else _scatter.scatter_add_rows_plain
    return fn(c, partials, perm, meta)


def coo_accumulate_rows_op(acc: torch.Tensor, col: torch.Tensor,
                           val: torch.Tensor, perm: torch.Tensor,
                           meta: torch.Tensor, b: torch.Tensor
                           ) -> torch.Tensor:
    """Padded-COO scatter-add ``acc[p, row[p, e]] += val[p, e]·b[p, col[p, e]]``.

    IN PLACE on ``acc`` [P, m, n] (contiguous), which is returned.
    ``perm`` / ``meta`` are the sorted-scatter maps of the piece's ``row``
    array (``prepare_sorted_scatter``, pads at -1). Two launches, no
    atomics: K1's scaled form gathers ``b[col]`` and multiplies by ``val``
    on the way to its output, ``(b[col] * val).to(acc.dtype)`` with one
    rounding, then K2 folds the products into ``acc`` in slot order. The
    piece's entries are in CSR order, so each row's chain is
    ``acc + e1 + e2 + …`` in ascending column order — the chain
    segment-by-segment accumulation replays, which keeps overlapped coo C
    bit-identical to staged C, and every run equal to the last.
    """
    if on_card(b, col, val):
        prods = _gather.gather_rows_scaled_cuda(b, col, val, acc.dtype)
    else:
        prods = _gather.gather_rows_scaled_plain(b, col, val, acc.dtype)
    return scatter_add_rows_exec_op(acc, prods, perm, meta)


def bsr_spmm_op(block_cols: torch.Tensor, blocks: torch.Tensor,
                b: torch.Tensor, m_out: int, *, bn: int = 128
                ) -> torch.Tensor:
    """``C [P, m_out, n] = A @ B`` for stacked ELL-BSR pieces (K3)."""
    if on_card(block_cols, blocks, b):
        return _bsr.bsr_spmm_cuda(block_cols, blocks, b, m_out, bn=bn)
    return _bsr.bsr_spmm_plain(block_cols, blocks, b, m_out)


def bsr_spmm_acc_op(block_cols: torch.Tensor, blocks: torch.Tensor,
                    b: torch.Tensor, acc: torch.Tensor, *, bn: int = 128
                    ) -> torch.Tensor:
    """``acc += A @ B`` IN PLACE, folding stored blocks in ascending t (K4).

    Resumes the staged kernel's per-element addition chain, so a piece's
    column segments fed here one after another give the bits of one
    ``bsr_spmm_op`` over the whole piece.
    """
    if on_card(block_cols, blocks, b, acc):
        return _bsr.bsr_spmm_acc_cuda(block_cols, blocks, b, acc, bn=bn)
    return _bsr.bsr_spmm_acc_plain(block_cols, blocks, b, acc)


def bsr_sddmm_op(block_cols: torch.Tensor, blocks: torch.Tensor,
                 x3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """Sampled ``blocks ⊙ (X_blk · Y_blkᵀ)`` per stored block, float32 (K5).

    ``x3`` [P, mb, bm, F] / ``y3`` [P, kb, bk, F] are the dense rows in
    block-row view; the result has ``blocks``' shape [P, mb, t, bm, bk].
    """
    if on_card(block_cols, blocks, x3, y3):
        return _sddmm.bsr_sddmm_cuda(block_cols, blocks, x3, y3)
    return _sddmm.bsr_sddmm_plain(block_cols, blocks, x3, y3)


def rmsnorm_op(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5, *,
               round_before_gain: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim, ``x · rsqrt(mean(x²) + eps) · g`` (K6).

    ``round_before_gain`` says where the rounding to x's dtype falls (see
    ``kernels.rmsnorm``): ``False`` as ``rmsnorm_pallas``, ``True`` as the
    model's ``rms_norm``.
    """
    # the LM runs this 2·L + 1 times a step, so a CUDA x goes straight to
    # the wrapper, which checks g's device itself. The wrapper is looked up
    # on its module at call time, so a recorder that replaces it sees the
    # call.
    if x.is_cuda:
        return _rms.rmsnorm_cuda(x, g, eps,
                                 round_before_gain=round_before_gain)
    on_card(x, g)  # raises unless g is on the CPU too
    return _rms.rmsnorm_plain(x, g, eps,
                              round_before_gain=round_before_gain)
