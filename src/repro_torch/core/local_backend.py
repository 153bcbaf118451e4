"""Pluggable local-compute backends for the flat executor.

Port of ``repro/core/local_backend.py`` (the SpMM half; the SDDMM
contract waits for the SDDMM slice). The executor (core.dist_spmm) fixes
the collectives, and a backend fixes how each padded sparse piece
(diagonal block, column-covered part, row-covered part) is multiplied
against its dense operand:

* ``prepare(csrs)`` — host side, once per plan: the planner's
  per-process CSR pieces become stacked tensors in the backend's native
  layout (leading axis = rank).
* ``compute(piece, b, m_out)`` — ``C [P, m_out, N] = piece @ b`` for all
  ranks at once, ``b`` being [P, K, N].

Swapping backends changes local FLOPs only — the collectives never see
the piece layout, so the collective log is identical across backends.

Built-ins:

* ``CooBackend`` — padded COO gather + ``index_add_`` (plain torch on
  every device, as the reference computes it outside Pallas).
* ``BsrBackend`` — ELL block layout feeding the BSR kernels
  (kernels.bsr_spmm: K3 for ``compute``, K4 for ``compute_segment``).
"""
from __future__ import annotations

import dataclasses
from typing import (
    ClassVar, Dict, List, Protocol, Sequence, Tuple, Union, runtime_checkable,
)

import numpy as np
import torch

from ..kernels.ops import (
    bsr_spmm_acc_op, bsr_spmm_op, coo_accumulate_rows_op,
)
from .sparse import CSRMatrix, ell_from_csr

__all__ = [
    "LocalSpmmBackend",
    "CooBackend",
    "BsrBackend",
    "coo_spmm_local",
    "get_backend",
    "register_backend",
    "available_backends",
    "backend_prepare_segments",
    "backend_compute_segment",
]

Piece = Dict[str, torch.Tensor]


@runtime_checkable
class LocalSpmmBackend(Protocol):
    """Local sparse-times-dense substrate used inside the executor.

    Beyond ``prepare``/``compute``, a backend MAY implement the
    round-pipelined pair ``prepare_segments``/``compute_segment`` (see
    ``backend_prepare_segments`` / ``backend_compute_segment`` for the
    contract and the generic fallbacks the executor uses otherwise).
    """

    name: str

    def prepare(self, csrs: List[CSRMatrix]) -> Piece:
        """Stack per-process CSR pieces into tensors [P, ...]."""

    def compute(self, piece: Piece, b: torch.Tensor, m_out: int
                ) -> torch.Tensor:
        """C [P, m_out, N] = piece @ b for every rank's piece."""


# ---------------------------------------------------------------------------
# per-round segment compute (overlapped executor)
# ---------------------------------------------------------------------------
#
# The overlapped executor (overlap=True) consumes a piece one
# communication round at a time. The contract is CUMULATIVE-PREFIX:
#
# * ``prepare_segments(csrs, cuts)`` — host side. ``cuts`` are ascending
#   column cut points over the piece's flat receive space (one per round,
#   the last equal to the covered width). Segment ``i`` owns the nonzeros
#   the backend assigns to rounds ``(prev_cut, cuts[i]]`` — column indices
#   stay ABSOLUTE, so a backend may move a nonzero to a LATER segment
#   (e.g. a BSR block straddling a cut waits for the next round) but
#   never to an earlier one.
# * ``compute_segment(piece, b_prefix, acc)`` — device side.
#   ``b_prefix`` is the concatenation of every received segment so far
#   (rows ``[0, cuts[i])`` of the staged receive space), and the return
#   value is ``acc`` plus this segment's contributions.
#
# Accumulating segment-by-segment in ascending-cut order replays the
# staged compute's per-element addition chain exactly, which is what
# makes overlapped and staged execution bit-identical rather than merely
# allclose.


def _cut_cols(csrs: List[CSRMatrix], lo: int, hi: int) -> List[CSRMatrix]:
    """Keep only nonzeros with column in [lo, hi); shape/indices unchanged."""
    return [c.select_nonzeros((c.indices >= lo) & (c.indices < hi))
            for c in csrs]


def backend_prepare_segments(be: "LocalSpmmBackend", csrs: List[CSRMatrix],
                             cuts: Sequence[int]) -> List[Piece]:
    """Per-round piece layouts (backend override or the generic cut)."""
    fn = getattr(be, "prepare_segments", None)
    if fn is not None:
        return fn(csrs, cuts)
    out, lo = [], 0
    for hi in cuts:
        out.append(be.prepare(_cut_cols(csrs, lo, hi)))
        lo = hi
    return out


def backend_compute_segment(be: "LocalSpmmBackend", piece: Piece,
                            b_prefix: torch.Tensor, acc: torch.Tensor
                            ) -> torch.Tensor:
    """acc + (segment piece @ b_prefix) — override or generic fallback."""
    fn = getattr(be, "compute_segment", None)
    if fn is not None:
        return fn(piece, b_prefix, acc)
    return acc + be.compute(piece, b_prefix, acc.shape[1])


# ---------------------------------------------------------------------------
# COO backend (portable default)
# ---------------------------------------------------------------------------


def coo_spmm_local(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   b: torch.Tensor, m_out: int) -> torch.Tensor:
    """C[p, m_out, N] = scatter-add_e val[p, e] * b[p, col[p, e]] into row[p, e].

    Padded entries carry val == 0 so they contribute nothing.
    """
    acc = torch.zeros((b.shape[0], m_out, b.shape[2]), dtype=b.dtype,
                      device=b.device)
    return coo_accumulate_rows_op(acc, row, col, val, b)


def _stack_coo(csrs: List[CSRMatrix]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-process CSR pieces into padded COO [P, nnz_max] arrays."""
    coos = [c.to_coo() for c in csrs]
    nnz = max((c.nnz for c in coos), default=0)
    nnz = max(nnz, 1)
    P_ = len(csrs)
    row = np.zeros((P_, nnz), np.int32)
    col = np.zeros((P_, nnz), np.int32)
    val = np.zeros((P_, nnz), np.float32)
    for i, c in enumerate(coos):
        row[i, : c.nnz] = c.row
        col[i, : c.nnz] = c.col
        val[i, : c.nnz] = c.val
    return row, col, val


@dataclasses.dataclass(frozen=True)
class CooBackend:
    """Padded-COO gather + segment scatter-add."""

    name: ClassVar[str] = "coo"

    def prepare(self, csrs: List[CSRMatrix]) -> Piece:
        row, col, val = _stack_coo(csrs)
        return {"row": torch.from_numpy(row), "col": torch.from_numpy(col),
                "val": torch.from_numpy(val)}

    def compute(self, piece: Piece, b: torch.Tensor, m_out: int
                ) -> torch.Tensor:
        return coo_spmm_local(piece["row"], piece["col"], piece["val"],
                              b, m_out)

    def compute_segment(self, piece: Piece, b_prefix: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
        # scatter straight into the running accumulator (in place) — the
        # same gather/scatter-add chain the staged compute runs, resumed
        return coo_accumulate_rows_op(acc, piece["row"], piece["col"],
                                      piece["val"], b_prefix)


# ---------------------------------------------------------------------------
# BSR/ELL backend (hand-written CUDA kernels K3/K4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BsrBackend:
    """ELL block layout feeding the BSR kernels.

    ``block``: (bm, bk) dense-block shape of the layout.
    ``bn``: column tile one thread block of the kernel covers.
    """

    name: ClassVar[str] = "bsr"

    block: Tuple[int, int] = (8, 8)
    bn: int = 128

    def prepare(self, csrs: List[CSRMatrix]) -> Piece:
        per = [ell_from_csr(c, self.block) for c in csrs]
        t = max(bc.shape[1] for bc, _ in per)
        bm, bk = self.block
        P_ = len(per)
        mb = per[0][0].shape[0]
        cols = np.full((P_, mb, t), -1, np.int32)
        blocks = np.zeros((P_, mb, t, bm, bk), np.float32)
        for i, (bc, blk) in enumerate(per):
            cols[i, :, : bc.shape[1]] = bc
            blocks[i, :, : bc.shape[1]] = blk
        return {"block_cols": torch.from_numpy(cols),
                "blocks": torch.from_numpy(blocks)}

    def compute(self, piece: Piece, b: torch.Tensor, m_out: int
                ) -> torch.Tensor:
        return bsr_spmm_op(piece["block_cols"], piece["blocks"], b, m_out,
                           bn=self.bn)

    def prepare_segments(self, csrs: List[CSRMatrix],
                         cuts: Sequence[int]) -> List[Piece]:
        """Block-aligned rounds: interior cuts floor to the bk grid.

        A (bm × bk) block straddling a cut would mix two rounds' received
        columns inside one block step, so it is deferred to the first
        round whose prefix covers it whole — the cumulative-prefix
        contract allows exactly this. Block-column ids stay absolute, so
        every segment's blocks index the same K grid the staged kernel
        uses and the per-element accumulation chains coincide.
        """
        bk = self.block[1]
        out, lo = [], 0
        for i, hi in enumerate(cuts):
            hi_b = hi if i == len(cuts) - 1 else (hi // bk) * bk
            hi_b = max(hi_b, lo)
            out.append(self.prepare(_cut_cols(csrs, lo, hi_b)))
            lo = hi_b
        return out

    def compute_segment(self, piece: Piece, b_prefix: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
        """Resume the staged kernel's t-step chain: ``acc`` += segment
        (K4, in place). Summing a segment before adding it to ``acc``
        would regroup the chain and drift by an ulp."""
        return bsr_spmm_acc_op(piece["block_cols"], piece["blocks"],
                               b_prefix, acc, bn=self.bn)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, LocalSpmmBackend] = {
    CooBackend.name: CooBackend(),
    BsrBackend.name: BsrBackend(),
}


def register_backend(backend: LocalSpmmBackend) -> None:
    """Install (or override) the default instance used for ``backend.name``."""
    _BACKENDS[backend.name] = backend


def available_backends() -> Tuple[str, ...]:
    return tuple(_BACKENDS)


def get_backend(spec: Union[str, LocalSpmmBackend]) -> LocalSpmmBackend:
    """Resolve a backend name or pass an instance through."""
    if isinstance(spec, str):
        try:
            return _BACKENDS[spec]
        except KeyError:
            raise ValueError(
                f"unknown backend {spec!r}; available: {available_backends()}"
            ) from None
    return spec
