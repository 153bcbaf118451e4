"""Pluggable local-compute backends for the flat executor.

Port of ``repro/core/local_backend.py``. The executors (core.dist_spmm,
core.dist_sddmm) fix the collectives, and a backend fixes how each padded
sparse piece (diagonal block, column-covered part, row-covered part) is
multiplied against its dense operand:

* ``prepare(csrs)`` — host side, once per plan: the planner's
  per-process CSR pieces become stacked tensors in the backend's native
  layout (leading axis = rank).
* ``compute(piece, b, m_out)`` — ``C [P, m_out, N] = piece @ b`` for all
  ranks at once, ``b`` being [P, K, N].

Swapping backends changes local FLOPs only — the collectives never see
the piece layout, so the collective log is identical across backends.

Built-ins:

* ``CooBackend`` — padded COO: gather (K1), scale, sorted fold (K2);
  no atomics, so its C is the same from run to run.
* ``BsrBackend`` — ELL block layout feeding the BSR kernels
  (kernels.bsr_spmm: K3 for ``compute``, K4 for ``compute_segment``;
  kernels.sddmm: K5 for ``sddmm``).

Both also implement the SDDMM contract (``sddmm`` / ``with_values``)
that the SDDMM and FusedMM executors use.
"""
from __future__ import annotations

import dataclasses
from typing import (
    ClassVar, Dict, List, Protocol, Sequence, Tuple, Union, runtime_checkable,
)

import numpy as np
import torch

from ..kernels.ops import (
    bsr_sddmm_op, bsr_spmm_acc_op, bsr_spmm_op, coo_accumulate_rows_op,
    prepare_sorted_scatter,
)
from .sparse import CSRMatrix, ell_from_csr

__all__ = [
    "LocalSpmmBackend",
    "CooBackend",
    "BsrBackend",
    "coo_spmm_local",
    "coo_sddmm_local",
    "coo_scatter_maps",
    "coo_piece_with_maps",
    "backend_sddmm",
    "backend_with_values",
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
# SDDMM contract (core.dist_sddmm executors)
# ---------------------------------------------------------------------------
#
# The SDDMM kernel family reuses a piece's native layout with the
# dataflow reversed: instead of folding stored values against dense ROWS
# of B, every stored nonzero (i, j) SAMPLES the dot product x_i · y_j and
# scales it by its stored value. Two methods close the loop:
#
# * ``sddmm(piece, x, y)`` — device side. ``x`` [P, rows, F] indexes the
#   piece's ROW space and ``y`` [P, cols, F] its COLUMN space (the
#   executors hand each piece exactly the buffers its index spaces refer
#   to — local rows for the diagonal, exchanged rows for the covered
#   parts). Returns the sampled values in the backend's NATIVE value
#   layout (the shape ``prepare`` stored them in), padding slots zero
#   because their stored values are zero.
# * ``with_values(piece, vals)`` — swap a piece's stored values for
#   ``vals`` (a ``sddmm`` result), leaving the index structure (and any
#   host-prepared maps) untouched. This is what lets FusedMM chain
#   SDDMM→SpMM without re-laying out anything: the sampled values drop
#   straight into the SpMM kernels.


def backend_sddmm(be: "LocalSpmmBackend", piece: Piece, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Sampled values for one stacked piece — backend method required."""
    fn = getattr(be, "sddmm", None)
    if fn is None:
        raise NotImplementedError(
            f"backend {be.name!r} implements no sddmm(piece, x, y); the "
            f"kernel='sddmm'/'fused' family needs it (see CooBackend / "
            f"BsrBackend for the contract).")
    return fn(piece, x, y)


def backend_with_values(be: "LocalSpmmBackend", piece: Piece,
                        vals: torch.Tensor) -> Piece:
    """Piece with stored values swapped for ``vals`` — method required."""
    fn = getattr(be, "with_values", None)
    if fn is None:
        raise NotImplementedError(
            f"backend {be.name!r} implements no with_values(piece, vals); "
            f"the kernel='fused' executor needs it to feed sampled values "
            f"back into the SpMM phase.")
    return fn(piece, vals)


# ---------------------------------------------------------------------------
# COO backend (portable default)
# ---------------------------------------------------------------------------


def coo_spmm_local(piece: Piece, b: torch.Tensor, m_out: int
                   ) -> torch.Tensor:
    """C[p, m_out, N] = Σ_e val[p, e] · b[p, col[p, e]] folded into row[p, e].

    ``piece`` carries ``col``, ``val`` and the sorted-scatter maps of
    ``row`` (``perm`` / ``meta``); padded entries join no row.
    """
    acc = torch.zeros((b.shape[0], m_out, b.shape[2]), dtype=b.dtype,
                      device=b.device)
    return coo_accumulate_rows_op(acc, piece["col"], piece["val"],
                                  piece["perm"], piece["meta"], b)


def coo_sddmm_local(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                    x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """vals[p, e] = val[p, e] · (x[p, row[p, e]] · y[p, col[p, e]]).

    Padded entries carry val == 0 (and row == col == 0, which gather
    real but ignored rows), so they sample to exactly zero for finite
    operands. Plain torch, as the reference computes coo outside Pallas.
    """
    xr = torch.take_along_dim(x, row.long()[..., None], dim=1)
    yc = torch.take_along_dim(y, col.long()[..., None], dim=1)
    return val * (xr * yc).sum(dim=-1)


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


def coo_scatter_maps(row: np.ndarray, nnz: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The sorted-scatter maps of a stacked coo ``row`` array [P, S].

    ``nnz[p]`` counts rank p's real entries; the pads after them get
    target -1 so they join no row. Returns (perm [P, S], meta [P, S+1]).
    """
    tgt = np.where(np.arange(row.shape[1])[None, :] < np.asarray(nnz)[:, None],
                   row, -1)
    maps = [prepare_sorted_scatter(t) for t in tgt]
    return (np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps]))


def coo_piece_with_maps(piece: Piece) -> Piece:
    """A coo piece made elsewhere (the reference's exec arrays carry only
    ``row`` / ``col`` / ``val``) with its sorted-scatter maps added.

    The arrays do not say which entries are padding, so every entry joins
    its row, as in the reference's scatter-add: a pad (val 0.0) adds
    0 · b[col] to its row.
    """
    if "perm" in piece:
        return piece
    row = np.asarray(piece["row"])
    perm, meta = coo_scatter_maps(row, [row.shape[1]] * row.shape[0])
    return dict(piece, perm=torch.from_numpy(perm),
                meta=torch.from_numpy(meta))


@dataclasses.dataclass(frozen=True)
class CooBackend:
    """Padded COO: gather, scale, sorted fold (no atomics).

    ``prepare`` stacks each rank's piece in CSR order (rows ascend,
    columns ascend within a row) and adds the host-side sorted-scatter
    maps of its ``row`` array, so the fold adds each row's entries in
    ascending column order on every device.
    """

    name: ClassVar[str] = "coo"

    def prepare(self, csrs: List[CSRMatrix]) -> Piece:
        row, col, val = _stack_coo(csrs)
        perm, meta = coo_scatter_maps(row, [c.nnz for c in csrs])
        return {"row": torch.from_numpy(row), "col": torch.from_numpy(col),
                "val": torch.from_numpy(val), "perm": torch.from_numpy(perm),
                "meta": torch.from_numpy(meta)}

    def compute(self, piece: Piece, b: torch.Tensor, m_out: int
                ) -> torch.Tensor:
        return coo_spmm_local(piece, b, m_out)

    def compute_segment(self, piece: Piece, b_prefix: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
        # fold straight into the running accumulator (in place) — the
        # same gather/fold chain the staged compute runs, resumed
        return coo_accumulate_rows_op(acc, piece["col"], piece["val"],
                                      piece["perm"], piece["meta"], b_prefix)

    def sddmm(self, piece: Piece, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
        return coo_sddmm_local(piece["row"], piece["col"], piece["val"],
                               x, y)

    def with_values(self, piece: Piece, vals: torch.Tensor) -> Piece:
        return dict(piece, val=vals)


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

    def sddmm(self, piece: Piece, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
        """Sampled [P, mb, t, bm, bk] block values = blocks ⊙ (X · Yᵀ) (K5).

        X/Y row counts are padded up to the block grid with zero rows,
        which land only on padding slots. The reference also pads F to a
        multiple of 128 for the TPU's lanes; the card has no such tiling
        and zero feature columns add exact zeros, so F stays as it is.
        """
        cols, blocks = piece["block_cols"], piece["blocks"]
        P_, mb, _, bm, bk = blocks.shape
        kb = max(-(-y.shape[1] // bk), 1)
        f = x.shape[2]
        dt = torch.promote_types(x.dtype, y.dtype)
        x3 = _pad_rows(x.to(dt), mb * bm).view(P_, mb, bm, f)
        y3 = _pad_rows(y.to(dt), kb * bk).view(P_, kb, bk, f)
        return bsr_sddmm_op(cols, blocks, x3, y3).to(x.dtype)

    def with_values(self, piece: Piece, vals: torch.Tensor) -> Piece:
        return dict(piece, blocks=vals)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` [P, r, F] with zero rows appended up to ``rows`` (contiguous)."""
    if x.shape[1] > rows:
        raise ValueError(f"operand has {x.shape[1]} rows, the block grid "
                         f"{rows}")
    out = x.new_zeros((x.shape[0], rows, x.shape[2]))
    out[:, :x.shape[1]] = x
    return out


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
