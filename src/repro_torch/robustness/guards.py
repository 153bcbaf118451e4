"""Shape and numerical guardrails for the serving path.

Port of the parts of ``repro/robustness/guards.py`` that
``SpmmConfig(check="auto")`` runs on every call and at plan time: B's
shape/dtype is validated with an actionable error before any kernel sees
it, the sparse operand's values must be finite, and each served C gets a
cheap SAMPLED ``isfinite`` sweep (corner + strided rows of every rank's
block) that raises ``NumericalFault`` naming the first bad element.
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
    "validate_sparse_values",
    "sampled_finite_check",
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


def validate_dense_operand(b, *, k_expected: int, context: str,
                           name: str = "B") -> None:
    """Shape/dtype validation of the dense operand, naming the caller's
    objects, before any kernel sees the mismatch."""
    shape = tuple(getattr(b, "shape", np.shape(b)))
    if len(shape) != 2:
        raise ValueError(
            f"{context}: {name} must be 2-D [K, N]; got shape {shape}. "
            f"Reshape a vector operand to (K, 1).")
    if int(shape[0]) != int(k_expected):
        raise ValueError(
            f"{context}: {name} has {shape[0]} rows but the plan contracts "
            f"over K={k_expected} (C = A @ B with A's shape fixed at plan "
            f"time); pass a [{k_expected}, N] operand or re-plan for the "
            f"new A.")
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
    m, n = c.shape
    m_local = m // ranks if ranks else 0
    if m_local == 0 or n == 0:
        return
    if mode in ("full", True) or m_local <= _SAMPLE_ROWS:
        local = np.arange(m_local)
    else:
        local = np.unique(np.linspace(0, m_local - 1, _SAMPLE_ROWS,
                                      dtype=np.int64))
    rows = (np.arange(ranks)[:, None] * m_local + local[None, :]).reshape(-1)
    sampled = c[torch.from_numpy(rows).to(c.device)]
    finite = torch.isfinite(sampled)
    if bool(finite.all()):
        return
    where = torch.nonzero(~finite)[0].tolist()
    r, col = int(rows[where[0]]), int(where[1])
    val = sampled[where[0], where[1]].item()
    at = f" on call #{call_index}" if call_index is not None else ""
    raise NumericalFault(
        f"{context}: non-finite C[{r}, {col}] = {val!r}{at} "
        f"(check={'full' if mode in ('full', True) else 'auto'} isfinite "
        f"sweep). The producer is upstream — a poisoned operand value or a "
        f"broken backend kernel; set check=False to serve unchecked.")
