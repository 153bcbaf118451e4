"""Collectives over P ranks emulated on one device.

The reference runs its P processes as mesh devices under ``shard_map``
and exchanges data with ``jax.lax`` collectives (``repro/compat.py``).
The port runs all P ranks in one process on one card: every per-rank
tensor is a slice of a stacked ``[P, ...]`` tensor, and a collective is a
tensor operation on that rank axis — a device copy. ``LocalComm`` logs
each one as ``(op, pairs, rows)``: ``pairs`` are the (src, dst) rank
pairs it connects and ``rows`` the rows all ranks place in its operand
(the count ``SpmmPlan.volume_rows_padded`` predicts). The log stands in
for the reference's pins on lowered HLO.

``psum_scatter`` and ``all_gather`` come with the hierarchical executor;
a ``torch.distributed`` communicator with this API comes with the
multi-process slice.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["LocalComm"]

Pairs = Tuple[Tuple[int, int], ...]


class LocalComm:
    """Collectives on the leading rank axis of stacked ``[P, ...]`` tensors."""

    def __init__(self, P: int):
        self.P = int(P)
        self.log: List[Tuple[str, Pairs, int]] = []

    def _record(self, op: str, pairs: Pairs, x: torch.Tensor) -> None:
        rows = x.numel() // x.shape[-1] if x.dim() and x.shape[-1] else 0
        self.log.append((op, pairs, int(rows)))

    def rows(self) -> int:
        """Rows placed in collective operands since the last ``reset``."""
        return sum(r for _, _, r in self.log)

    def reset(self) -> None:
        self.log.clear()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Untiled all_to_all, split and concat on the first per-rank axis.

        ``x`` is [P(src), P(dst), ...]: rank q's operand holds one slab per
        destination. The result is [P(dst), P(src), ...], i.e.
        ``out[p][q] = x[q][p]`` — ``jax.lax.all_to_all(x, axis, 0, 0,
        tiled=False)`` on every rank.
        """
        if x.shape[0] != self.P or x.shape[1] != self.P:
            raise ValueError(f"all_to_all operand must lead with "
                             f"[{self.P}, {self.P}], got {tuple(x.shape)}")
        pairs = tuple((q, p) for q in range(self.P) for p in range(self.P))
        self._record("all_to_all", pairs, x)
        return x.transpose(0, 1).contiguous()

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: rank ``src`` sends its slice to ``dst``.

        Ranks that no pair sends to receive zeros. A full shift
        ``[(q, (q + d) % P) for q]`` is ``torch.roll(x, d, 0)``.
        """
        perm = tuple((int(s), int(d)) for s, d in perm)
        if x.shape[0] != self.P:
            raise ValueError(f"ppermute operand must lead with [{self.P}], "
                             f"got {tuple(x.shape)}")
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"ppermute needs a partial permutation, got "
                             f"{perm}")
        self._record("ppermute", perm, x)
        shifts = {(d - s) % self.P for s, d in perm}
        if len(perm) == self.P and len(shifts) == 1:
            return torch.roll(x, shifts.pop(), 0)
        out = torch.zeros_like(x)
        if perm:
            out[dsts] = x[srcs]
        return out

    def shift(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """ppermute over the shift-``d`` matching ``q -> (q + d) % P``."""
        return self.ppermute(x, [(q, (q + d) % self.P)
                                 for q in range(self.P)])
