"""Shape and numerical guardrails for the serving path.

Port of the parts of ``repro/robustness/guards.py`` that
``SpmmConfig(check="auto")`` runs on every call and at plan time: the
dense operands' shapes/dtypes (B; X and Y of the SDDMM and fused calls)
are validated with an actionable error before any kernel sees them, the
sparse operand's values must be finite, and each served output gets a
cheap SAMPLED ``isfinite`` sweep (corner + strided rows of every rank's
block; every piece of an SDDMM result) that raises ``NumericalFault``
naming the first bad element.
``"full"``/``True`` sweeps every row; ``False`` disables all of it.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "NumericalFault",
    "check_mode",
    "validate_dense_operand",
    "validate_sddmm_operands",
    "validate_sparse_values",
    "sampled_finite_check",
    "sampled_finite_check_tree",
]

# rows sampled per rank block under check="auto"
_SAMPLE_ROWS = 32


class NumericalFault(FloatingPointError):
    """A non-finite value crossed a guarded boundary (C sweep or operand
    validation). Carries enough context to find the producer."""


def check_mode(config) -> Any:
    """The effective ``check`` mode of a config."""
    mode = getattr(config, "check", "auto")
    return "full" if mode is True else mode


def validate_dense_operand(
    b, *, k_expected: int, context: str, name: str = "B",
    rows_label: str = "K", cols_label: str = "N",
    rows_reason: str = "the plan contracts over",
) -> None:
    """Shape/dtype validation of a dense operand, naming the caller's
    objects, before any kernel sees the mismatch. ``name`` /
    ``rows_label`` retarget the messages at the two-dense-operand entry
    points (X, Y of SDDMM/fused)."""
    shape = tuple(getattr(b, "shape", np.shape(b)))
    if len(shape) != 2:
        raise ValueError(
            f"{context}: {name} must be 2-D [{rows_label}, {cols_label}]; "
            f"got shape {shape}. Reshape a vector operand to "
            f"({rows_label}, 1).")
    if int(shape[0]) != int(k_expected):
        raise ValueError(
            f"{context}: {name} has {shape[0]} rows but {rows_reason} "
            f"{rows_label}={k_expected} (C = A @ B with A's shape fixed at "
            f"plan time); pass a [{k_expected}, {cols_label}] operand or "
            f"re-plan for the new A.")
    if isinstance(b, torch.Tensor):
        dtype, floating = b.dtype, b.is_floating_point() or b.is_complex()
    else:
        dtype = np.asarray(b).dtype
        floating = dtype.kind in "fc"
    if not floating:
        raise TypeError(
            f"{context}: {name} has dtype {dtype} but the kernels accumulate "
            f"in floating point; cast to float32 (or another inexact dtype) "
            f"before the call.")


def validate_sddmm_operands(x, y, *, m_expected: int, k_expected: int,
                            context: str) -> None:
    """X/Y validation for the SDDMM and fused entry points.

    X samples the pattern's ROW side (partitioned like C) and Y its
    COLUMN side (partitioned like B); their feature widths must agree
    since every stored nonzero contracts ``x_i · y_j``. Each error names
    the offending operand.
    """
    validate_dense_operand(x, k_expected=m_expected, context=context,
                           name="X", rows_label="M", cols_label="F",
                           rows_reason="the plan's row partition fixes")
    validate_dense_operand(y, k_expected=k_expected, context=context,
                           name="Y", rows_label="K", cols_label="F",
                           rows_reason="the plan's column partition fixes")
    fx = int(tuple(getattr(x, "shape", np.shape(x)))[1])
    fy = int(tuple(getattr(y, "shape", np.shape(y)))[1])
    if fx != fy:
        raise ValueError(
            f"{context}: X has F={fx} feature columns but Y has F={fy}; "
            f"SDDMM contracts x_i · y_j per stored nonzero, so the two "
            f"dense operands must share one feature width.")


def validate_sparse_values(a, *, context: str) -> None:
    """Finite-values validation of the sparse operand's nonzeros (plan time)."""
    data = np.asarray(a.data)
    bad = np.flatnonzero(~np.isfinite(data))
    if bad.size:
        i = int(bad[0])
        raise NumericalFault(
            f"{context}: sparse operand carries {bad.size} non-finite "
            f"nonzero value(s); first at data[{i}] = {data[i]!r} of "
            f"nnz={data.size}. Sanitize the operand (or set check=False "
            f"to plan anyway — every dependent C row will be poisoned).")


def _sample_rows(c: torch.Tensor, ranks: int, mode: Any):
    """The row-sampled slice of ``c`` [M, n] (row-partitioned into
    ``ranks`` equal blocks): (global rows, sampled [len(rows), n]), or
    None when there is nothing to sweep."""
    m, n = c.shape
    m_local = m // ranks if ranks else 0
    if m_local == 0 or n == 0:
        return None
    if mode in ("full", True) or m_local <= _SAMPLE_ROWS:
        local = np.arange(m_local)
    else:
        local = np.unique(np.linspace(0, m_local - 1, _SAMPLE_ROWS,
                                      dtype=np.int64))
    rows = (np.arange(ranks)[:, None] * m_local + local[None, :]).reshape(-1)
    return rows, c[torch.from_numpy(rows).to(c.device)]


def _raise_first_non_finite(rows, sampled: torch.Tensor, *, name: str,
                            mode: Any, context: str,
                            call_index: Optional[int]) -> None:
    where = torch.nonzero(~torch.isfinite(sampled))[0].tolist()
    r, col = int(rows[where[0]]), int(where[1])
    val = sampled[where[0], where[1]].item()
    at = f" on call #{call_index}" if call_index is not None else ""
    raise NumericalFault(
        f"{context}: non-finite {name}[{r}, {col}] = {val!r}{at} "
        f"(check={'full' if mode in ('full', True) else 'auto'} isfinite "
        f"sweep). The producer is upstream — a poisoned operand value or a "
        f"broken backend kernel; set check=False to serve unchecked.")


def sampled_finite_check(c: torch.Tensor, *, ranks: int, mode: Any = "auto",
                         context: str = "DistSpmm",
                         call_index: Optional[int] = None) -> None:
    """The post-call C sweep: raise ``NumericalFault`` naming the first
    non-finite element (global row, col) among the sampled rows.

    ``c`` is [M, N], row-partitioned into ``ranks`` equal blocks. ``"auto"``
    samples the corner and strided rows of every block (all rows when a
    block is small); ``"full"`` checks every row. Only the sampled rows
    leave the device.
    """
    sample = _sample_rows(c, ranks, mode)
    if sample is None or bool(torch.isfinite(sample[1]).all()):
        return
    _raise_first_non_finite(*sample, name="C", mode=mode, context=context,
                            call_index=call_index)


def sampled_finite_check_tree(values, *, mode: Any = "auto",
                              context: str = "DistSpmm",
                              call_index: Optional[int] = None) -> None:
    """The post-call sweep over an SDDMM result: a dict of stacked pieces
    ``[P, rows, ...]`` in the backend's native layout.

    Each rank's block of each piece is row-sampled as C is (the trailing
    axes flattened, so the BSR block layout sweeps too), and all pieces
    are tested at once; only the sampled rows leave the device. The
    fault names the piece, its row (rank-major) and flattened column.
    """
    samples = []
    for label, leaf in values.items():
        if leaf.dim() < 2 or leaf.numel() == 0:
            continue
        P_, n_rows = leaf.shape[0], leaf.shape[1]
        sample = _sample_rows(leaf.reshape(P_ * n_rows, -1), P_, mode)
        if sample is not None:
            samples.append((label, *sample))
    if not samples or bool(torch.isfinite(torch.cat(
            [s.reshape(-1) for _, _, s in samples])).all()):
        return
    for label, rows, sampled in samples:
        if not bool(torch.isfinite(sampled).all()):
            _raise_first_non_finite(
                rows, sampled, name=f"output leaf {label!r}", mode=mode,
                context=context, call_index=call_index)
