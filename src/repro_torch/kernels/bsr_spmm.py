"""K3/K4 — ELL-BSR SpMM: ``C = A @ B`` and its accumulator form ``acc += A @ B``.

Ports of ``repro/kernels/bsr_spmm.py::bsr_spmm_pallas`` (K3, the bsr
backend's local compute) and ``::bsr_spmm_acc_pallas`` (K4, its
per-round segment compute in the overlapped flat body). Per rank p,
``block_cols[p, i, t]`` names the block column of block-row i's t-th
stored (bm × bk) block (-1 = pad, an all-zero block) and
``blocks[p, i, t]`` holds it; ``b[p]`` is [K, n], with rows past K
reading as zero. Outputs keep the first ``m_out`` rows of the block grid.

Both CUDA kernels (``csrc/bsr_spmm.cu``) are instances of one template
that folds one stored block per t step, in ascending t (reading only the
B rows of a block's nonzero A columns), so feeding a piece's column
segments to K4 one after another gives the same bits as one K3 call over
the whole piece. The plain versions repeat that fold (per t:
``d_t = Σ_k a·b`` in ascending k, then ``acc + d_t``), so on the CPU too
the overlapped executor's C equals the staged one bit for bit.
Accumulation is float32; the output takes ``b``'s dtype.

Both skip what the kernels skip: a column k of a stored block adds to
the rows of an 8-row slice only where some entry of that slice's
column is nonzero (NaN counts as nonzero), and a slot whose slice has no
such column (a pad, or stored zeros) adds nothing. For finite B that is
exact (``0·b`` adds ±0); for a B row holding an inf or a NaN it means
the row reaches C only through nonzero A columns, as in scipy and the
coo path, where the reference's dense block product gives NaN.
"""
from __future__ import annotations

import torch

from . import build

__all__ = ["LAUNCHES", "bsr_spmm_cuda", "bsr_spmm_acc_cuda",
           "bsr_spmm_plain", "bsr_spmm_acc_plain"]

LAUNCHES = {"bsr_spmm": 0, "bsr_spmm_acc": 0}


def _check_shapes(cols, blocks, b, m_out: int) -> None:
    if cols.dim() != 3 or blocks.dim() != 5 or b.dim() != 3:
        raise ValueError("bsr_spmm takes block_cols [P, mb, t], blocks "
                         "[P, mb, t, bm, bk] and b [P, K, n]")
    P, mb, t, bm, _ = blocks.shape
    if tuple(cols.shape) != (P, mb, t) or b.shape[0] != P:
        raise ValueError(f"bsr_spmm shapes disagree: block_cols "
                         f"{tuple(cols.shape)}, blocks {tuple(blocks.shape)}, "
                         f"b {tuple(b.shape)}")
    if not 0 <= m_out <= mb * bm:
        raise ValueError(f"m_out={m_out} outside the block grid's "
                         f"{mb}x{bm} rows")


def _fold(cols, blocks, b, acc):
    """acc [P, mb*bm, n] f32 + A @ B, folding one t step at a time."""
    P, mb, t_steps, bm, bk = blocks.shape
    K, n = b.shape[1], b.shape[2]
    kb = max(-(-K // bk), 1)
    b_pad = torch.zeros((P, kb * bk, n), dtype=torch.float32, device=b.device)
    b_pad[:, :K] = b
    b_blk = b_pad.view(P, kb, bk, n)
    acc = acc.view(P, mb, bm, n)
    ranks = torch.arange(P, device=b.device)[:, None]
    slices = -(-bm // 8)
    for t in range(t_steps):
        c = cols[:, :, t].long()  # [P, mb]
        gathered = b_blk[ranks, c.clamp(min=0)]  # [P, mb, bk, n]
        a = blocks[:, :, t].float()  # [P, mb, bm, bk]
        # the kernel's column mask: per 8-row slice of the block, the
        # columns with a nonzero entry (NaN counts) whose B row exists
        nz = a.new_zeros((P, mb, slices * 8, bk), dtype=torch.bool)
        nz[:, :, :bm] = a != 0
        used = nz.view(P, mb, slices, 8, bk).any(3)
        in_b = c[..., None] * bk + torch.arange(bk, device=b.device) < K
        used &= (in_b & (c >= 0)[..., None])[:, :, None]
        used = used.repeat_interleave(8, dim=2)[:, :, :bm]  # [P, mb, bm, bk]
        d = torch.zeros_like(acc)
        for k in range(bk):
            d = torch.where(used[..., k:k + 1],
                            d + a[..., k:k + 1] * gathered[:, :, k:k + 1, :],
                            d)
        acc = torch.where(used.any(-1, keepdim=True), acc + d, acc)
    return acc.view(P, mb * bm, n)


def bsr_spmm_plain(cols, blocks, b, m_out: int) -> torch.Tensor:
    """C [P, m_out, n] = A @ B in plain torch."""
    _check_shapes(cols, blocks, b, m_out)
    P, mb, _, bm, _ = blocks.shape
    acc = torch.zeros((P, mb * bm, b.shape[2]), dtype=torch.float32,
                      device=b.device)
    return _fold(cols, blocks, b, acc)[:, :m_out].to(b.dtype)


def bsr_spmm_acc_plain(cols, blocks, b, acc) -> torch.Tensor:
    """``acc += A @ B`` in plain torch; updates ``acc`` in place."""
    m_out = acc.shape[1]
    _check_shapes(cols, blocks, b, m_out)
    P, mb, _, bm, _ = blocks.shape
    acc_f = torch.zeros((P, mb * bm, b.shape[2]), dtype=torch.float32,
                        device=b.device)
    acc_f[:, :m_out] = acc
    acc.copy_(_fold(cols, blocks, b, acc_f)[:, :m_out])
    return acc


def _launch(fn_name, kernel, cols, blocks, b, out, bn):
    if not all(t.is_cuda and t.device == b.device
               for t in (cols, blocks, b, out)):
        raise ValueError(f"{kernel}_cuda needs every operand on one CUDA "
                         f"device")
    if cols.dtype != torch.int32:
        raise TypeError(f"{kernel} block_cols must be int32")
    if out.dtype != b.dtype or not out.is_contiguous():
        raise ValueError(f"{kernel} output must be contiguous with b's dtype")
    code = build.dtype_code(b.dtype, kernel)
    blocks = blocks.float().contiguous()
    cols, b = cols.contiguous(), b.contiguous()
    P, mb, t_steps, bm, bk = blocks.shape
    K, n = b.shape[1], b.shape[2]
    m_out = out.shape[1]
    if P * m_out * n == 0:
        return out
    rc = getattr(build.library(), fn_name)(
        cols.data_ptr(), blocks.data_ptr(), b.data_ptr(), out.data_ptr(),
        P, mb, t_steps, bm, bk, K, n, m_out, int(bn), code,
        build.stream_of(b))
    build.check(rc, kernel)
    LAUNCHES[kernel] += 1
    return out


def bsr_spmm_cuda(cols, blocks, b, m_out: int, bn: int = 128) -> torch.Tensor:
    """The K3 kernel: C [P, m_out, n] = A @ B. ``bn`` is the reference's
    column tile: checked, while the card's tile follows from n."""
    _check_shapes(cols, blocks, b, m_out)
    out = torch.empty((b.shape[0], m_out, b.shape[2]), dtype=b.dtype,
                      device=b.device)
    return _launch("repro_bsr_spmm", "bsr_spmm", cols, blocks, b, out, bn)


def bsr_spmm_acc_cuda(cols, blocks, b, acc, bn: int = 128) -> torch.Tensor:
    """The K4 kernel: ``acc += A @ B`` in place (acc [P, m_out, n])."""
    _check_shapes(cols, blocks, b, acc.shape[1])
    return _launch("repro_bsr_spmm_acc", "bsr_spmm_acc", cols, blocks, b, acc,
                   bn)
