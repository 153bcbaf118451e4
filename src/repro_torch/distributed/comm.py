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

``LocalComm(P, groups=G)`` also lays the ranks out as the reference's
two-axis (G, L) mesh (``make_spmm_mesh(P, groups=G)``): rank p is
(g, l) = (p // L, p % L), and the hierarchical executor runs its
collectives over either axis — ``group_all_to_all`` / ``group_shift``
over the group axis (slow tier, op names ending ``@g``),
``local_psum_scatter`` / ``local_all_gather`` over the local axis (fast
tier, ``@l``). ``rows(axis)`` counts one axis.

``LocalComm(P, replicas=c)`` lays the ranks out as the reference's
``Topology.replicated_mesh(c, s)``, a (c, s) replica × shard mesh with
s = P // c, lane-major: rank p = r·s + g is lane r, shard g. The
replicated executor broadcasts B's s-way shards to every lane
(``replicate``, op ``broadcast@r``), exchanges inside each lane with
every lane on its own shift (``lane_shift``, op ``ppermute@s``), and
sums the lanes' C blocks into their chunks over the replica axis
(``replica_psum_scatter``, op ``psum_scatter@r``).

``ProcessComm`` has LocalComm's API over a ``torch.distributed`` process
group: this process runs the contiguous span [lo, hi) of the P ranks,
its operands lead with ``[hi - lo]`` (its ranks only), and every
collective is its list of (src, dst) pairs over the global ranks. A pair
inside the span is a tensor copy; the pairs that cross processes go in
ONE ``all_to_all_single`` per collective (uneven splits, slabs in
(src, dst) order), staged through pinned host memory when the operands
live on a card. Reductions fold in LocalComm's order, so a fleet's C is
the emulated run's bit for bit. ``rows`` counts this process's operand
rows under LocalComm's axis names, ``fleet_rows`` sums them over the
processes, and ``rows_crossing`` counts the rows that left this process.
Under autograd the exchange is one ``torch.autograd.Function``
(``_Exchange``) whose backward sends every received slab's gradient back
to its source in one reversed exchange, so the fleet's input gradients
are the emulated run's too; ``reduce_grads`` / ``fold`` sum a replicated
parameter's gradients (or a loss) over the processes in process order.
``ProcessMeshComm`` runs MeshComm's collectives the same way, over a
named grid spread across the processes.

``MeshComm`` runs the collectives of a NAMED grid — the reference's
``make_mesh((2, 4), ("data", "model"))`` that ``DistContext`` wraps
(``launch.mesh.EmulatedMesh``). A model's per-rank tensors stack as
``[*lead, ...]`` with one dim per axis of a ``layout`` (the batch axes,
then the model axis: ``[Dsz, M, ...]``), and a collective runs over one
named axis of it: ``all_to_all`` (op ``all_to_all@<axis>``), ``pmax``
and ``psum`` (ops ``pmax@<axis>`` / ``psum@<axis>``). ``rows(axis)``
counts one axis; an exchange logged with ``meta=True`` (index and gate
lists beside the activations) goes under ``<op>@<axis>:meta``, which
``rows(axis)`` leaves out and ``rows(axis + ":meta")`` counts.

Under autograd each collective's backward is its transpose — the
all_to_all transposes back, a shift rolls back, a reduce-scatter's is an
all_gather and the other way round, B's copy sums over its lanes — which
torch derives from the same tensor operations. When the gradient of a
collective's result arrives, the comm logs that backward too, as
``("bwd:" + op, the pairs reversed, rows)``: the rows of the gradient of
the forward's operand, the count the forward logged, so ``rows(axis,
"bwd")`` holds the backward to the forward's volume axis by axis. The
entries join the log when the backward runs, after the call's own.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

__all__ = ["LocalComm", "MeshComm", "ProcessComm", "ProcessMeshComm",
           "ChunkSources"]

Pairs = Tuple[Tuple[int, int], ...]


class _CommLog:
    """The log every emulated communicator keeps: ``(op, pairs, rows)``
    per collective, and the backward's entries as its gradients arrive.
    ``nbytes`` runs beside ``log``, one entry each: the bytes of the rows
    (rows × the operand's row width × its element size), which
    ``launch.hlo_analysis.collective_bytes`` reads; a backward entry
    carries its forward's."""

    def __init__(self):
        self.log: List[Tuple[str, Pairs, int]] = []
        self.nbytes: List[int] = []

    def _record(self, op: str, pairs: Pairs, x: torch.Tensor,
                out: torch.Tensor, rows: Optional[int] = None) -> None:
        """Log ``op`` with ``rows`` (default: the rows of its operand
        ``x``), and its backward when the gradient of ``out`` arrives."""
        if rows is None:
            rows = x.numel() // x.shape[-1] if x.dim() and x.shape[-1] else 0
        width = x.shape[-1] if x.dim() else 1
        nbytes = int(rows) * int(width) * x.element_size()
        self._append((op, pairs, int(rows)), nbytes)
        if out.requires_grad:
            back = ("bwd:" + op, tuple((d, s) for s, d in pairs), int(rows))
            out.register_hook(lambda g: self._append(back, nbytes))

    def _append(self, entry: Tuple[str, Pairs, int], nbytes: int) -> None:
        self.log.append(entry)
        self.nbytes.append(nbytes)

    def _rows(self, on_axis, direction: str) -> int:
        """The rows of the forward (``"fwd"``) or backward (``"bwd"``)
        entries whose op (without its ``bwd:``) ``on_axis`` accepts."""
        if direction not in ("fwd", "bwd"):
            raise ValueError(f"direction must be 'fwd' or 'bwd', got "
                             f"{direction!r}")
        back = direction == "bwd"
        return sum(r for op, _, r in self.log
                   if op.startswith("bwd:") == back
                   and on_axis(op[4:] if back else op))

    def reset(self) -> None:
        self.log.clear()
        self.nbytes.clear()


def _layout(comm, P: int, groups: int, replicas: int) -> None:
    """Set a communicator's rank layouts: P ranks as a (G, L) grid and as
    a (c, s) replica × shard layout."""
    comm.P = int(P)
    comm.G = int(groups)
    if comm.G < 1 or comm.P % comm.G:
        raise ValueError(f"groups={groups} does not divide P={P}")
    comm.L = comm.P // comm.G
    comm.C = int(replicas)
    if comm.C < 1 or comm.P % comm.C:
        raise ValueError(f"replicas={replicas} does not divide P={P}")
    comm.S = comm.P // comm.C


def _on_axis(axis: Optional[str]) -> Callable[[str], bool]:
    """Whether an op of LocalComm's log belongs to ``axis`` (None: all)."""
    def on(op: str) -> bool:
        if axis is None:
            return True
        return op.endswith("@" + axis) if axis in ("g", "l", "s", "r") \
            else "@" not in op
    return on


class LocalComm(_CommLog):
    """Collectives on the leading rank axis of stacked ``[P, ...]`` tensors.

    ``groups`` is the group count G of the (G, L) grid the grid
    collectives run over (L = P // G); ``replicas`` is the lane count c
    of the (c, s) replica × shard layout the replica collectives run over
    (s = P // c). The flat collectives ignore both.
    """

    def __init__(self, P: int, groups: int = 1, replicas: int = 1):
        _layout(self, P, groups, replicas)
        super().__init__()

    @property
    def span(self) -> Tuple[int, int]:
        """The ranks this communicator's operands hold: all P."""
        return 0, self.P

    def rows(self, axis: Optional[str] = None, direction: str = "fwd") -> int:
        """Rows placed in collective operands since the last ``reset``:
        all of them, or those of one axis — ``"x"`` (the flat
        collectives), ``"g"`` (group axis), ``"l"`` (local axis), ``"s"``
        (inside the lanes) or ``"r"`` (replica axis) — by the forward
        collectives (``direction="fwd"``) or by their backward
        (``"bwd"``)."""
        return self._rows(_on_axis(axis), direction)

    def _check_lead(self, x: torch.Tensor, what: str) -> None:
        if x.shape[0] != self.P:
            raise ValueError(f"{what} operand must lead with [{self.P}], "
                             f"got {tuple(x.shape)}")

    # ----- the flat axis ------------------------------------------------

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
        out = x.transpose(0, 1).contiguous()
        self._record("all_to_all", pairs, x, out)
        return out

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]],
                 op: str = "ppermute") -> torch.Tensor:
        """``jax.lax.ppermute``: rank ``src`` sends its slice to ``dst``.

        Ranks that no pair sends to receive zeros. A full shift
        ``[(q, (q + d) % P) for q]`` is ``torch.roll(x, d, 0)``.
        """
        perm = tuple((int(s), int(d)) for s, d in perm)
        self._check_lead(x, "ppermute")
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"ppermute needs a partial permutation, got "
                             f"{perm}")
        shifts = {(d - s) % self.P for s, d in perm}
        if len(perm) == self.P and len(shifts) == 1:
            out = torch.roll(x, shifts.pop(), 0)
        else:
            out = torch.zeros_like(x)
            if perm:
                out[dsts] = x[srcs]
        self._record(op, perm, x, out)
        return out

    def shift(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """ppermute over the shift-``d`` matching ``q -> (q + d) % P``."""
        return self.ppermute(x, [(q, (q + d) % self.P)
                                 for q in range(self.P)])

    # ----- the (G, L) grid ----------------------------------------------

    def group_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """all_to_all over the group axis: ``jax.lax.all_to_all(x, "g", 0,
        0, tiled=False)`` on every rank.

        ``x`` is [P, G(dst), ...]; rank (g, l) receives
        ``out[(g', l)][g] = x[(g, l)][g']`` — a transpose of dims 0 and 2
        of the [G, L, G, ...] view. Each rank pairs only with the ranks of
        its own local index.
        """
        G, L = self.G, self.L
        self._check_lead(x, "group all_to_all")
        if x.dim() < 2 or x.shape[1] != G:
            raise ValueError(f"group all_to_all operand must be "
                             f"[{self.P}, {G}, ...], got {tuple(x.shape)}")
        pairs = tuple((g * L + l, h * L + l) for g in range(G)
                      for l in range(L) for h in range(G))
        rest = tuple(x.shape[2:])
        v = x.reshape((G, L, G) + rest)
        out = v.transpose(0, 2).contiguous().reshape((self.P, G) + rest)
        self._record("all_to_all@g", pairs, x, out)
        return out

    def group_shift(self, x: torch.Tensor, dg: int) -> torch.Tensor:
        """ppermute over the group axis by shift ``dg``: (g, l) sends to
        ((g + dg) % G, l) — the global shift by ``dg·L`` ranks."""
        return self.ppermute(
            x, [(q, (q + dg * self.L) % self.P) for q in range(self.P)],
            op="ppermute@g")

    def _local_pairs(self) -> Pairs:
        L = self.L
        return tuple((g * L + a, g * L + b) for g in range(self.G)
                     for a in range(L) for b in range(L))

    def local_psum_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Reduce-scatter over the local axis: ``jax.lax.psum_scatter(x,
        "l", scatter_dimension=dim, tiled=True)`` on every rank.

        ``dim`` indexes the per-rank dims of ``x`` [P, ...]. Rank (g, l)
        gets chunk l (along ``dim``) of the sum over l' of x[(g, l')].
        The sum is a left fold in ascending l', whatever the shape: every
        element's chain is x[(g, 0)] + x[(g, 1)] + … + x[(g, L-1)], so a
        staged reduce-scatter of a whole operand and one per slice of it
        give the same bits.
        """
        G, L = self.G, self.L
        self._check_lead(x, "local psum_scatter")
        rest = tuple(x.shape[1:])
        if not 0 <= dim < len(rest) or rest[dim] % L:
            raise ValueError(f"psum_scatter dim {dim} of per-rank shape "
                             f"{rest} is not divisible by L={L}")
        v = x.reshape((G, L) + rest)
        acc = v[:, 0]
        for l in range(1, L):
            acc = acc + v[:, l]
        # acc [G, *rest] -> chunk l along dim -> [G, L, *rest/L]
        split = (G,) + rest[:dim] + (L, rest[dim] // L) + rest[dim + 1:]
        out = acc.reshape(split).movedim(dim + 1, 1).reshape(
            (self.P,) + rest[:dim] + (rest[dim] // L,) + rest[dim + 1:])
        self._record("psum_scatter@l", self._local_pairs(), x, out)
        return out

    def local_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather over the local axis: ``jax.lax.all_gather(x, "l",
        axis=0, tiled=False)`` on every rank — rank (g, l) gets
        ``stack_l'(x[(g, l')])``, [P, L, ...]."""
        G, L = self.G, self.L
        self._check_lead(x, "local all_gather")
        rest = tuple(x.shape[1:])
        v = x.reshape((G, 1, L) + rest).expand((G, L, L) + rest)
        out = v.reshape((self.P, L) + rest)
        self._record("all_gather@l", self._local_pairs(), x, out)
        return out

    # ----- the (c, s) replica x shard layout ------------------------------

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """B's c-fold copy: ``x`` is [s, ...] (shard g's rows at x[g]);
        every lane gets the whole of it, [P, ...] with rank (r, g) holding
        x[g] — the reference's operand sharded over the shard axis and
        replicated over the replica axis. One device copy, logged with
        the rows it writes (c·s·rows per shard)."""
        C, S = self.C, self.S
        if x.shape[0] != S:
            raise ValueError(f"replicate operand must lead with [{S}], got "
                             f"{tuple(x.shape)}")
        out = x.unsqueeze(0).expand((C,) + tuple(x.shape)).reshape(
            (self.P,) + tuple(x.shape[1:]))
        self._record("broadcast@r", tuple((g, r * S + g) for r in range(C)
                                          for g in range(S)), out, out)
        return out

    def lane_shift(self, x: torch.Tensor, shifts: Sequence[int],
                   lanes: Sequence[int]) -> torch.Tensor:
        """One round of lane exchanges: lane r in ``lanes`` shifts by its
        own ``shifts[r]`` inside its s ranks, (r, g) -> (r, (g + d) % s);
        the reference's one ppermute over the joint (replica, shard) axes
        with ``_lane_perm``. Ranks of the other lanes receive zeros. The
        log counts the rows of the sending ranks only (s · |lanes| · rows
        a rank), the count ``ReplicatedSchedule.volume_rows_padded``
        makes."""
        C, S = self.C, self.S
        self._check_lead(x, "lane shift")
        lanes = tuple(int(r) for r in lanes)
        if len(shifts) != C or len(set(lanes)) != len(lanes) or \
                not all(0 <= r < C for r in lanes):
            raise ValueError(f"lane shift needs one shift per lane ({C}) "
                             f"and distinct lanes, got {tuple(shifts)} "
                             f"over {lanes}")
        pairs = tuple((r * S + g, r * S + (g + int(shifts[r])) % S)
                      for r in lanes for g in range(S))
        per_rank = x[0].numel() // x.shape[-1] if x.shape[-1] else 0
        # each lane's roll as two slice copies straight into the result:
        # every element is written once
        v = x.reshape((C, S) + tuple(x.shape[1:]))
        out = torch.empty_like(v)
        for r in range(C):
            if r not in lanes:
                out[r].zero_()
                continue
            d = int(shifts[r]) % S
            out[r, d:].copy_(v[r, :S - d])
            out[r, :d].copy_(v[r, S - d:])
        out = out.reshape(x.shape)
        self._record("ppermute@s", pairs, x, out, per_rank * len(pairs))
        return out

    def replica_psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce-scatter over the replica axis: ``psum_scatter(x, "r",
        scatter_dimension=0, tiled=True)`` on every rank.

        ``x`` is [P, rows, ...]; rank (r, g) gets chunk r (rows / c of
        them) of the sum over r' of x[(r', g)]. The sum is a left fold in
        ascending r', one fixed chain x[(0, g)] + x[(1, g)] + … The result
        is [s, c, rows / c, ...] in (g, r) order — rank (r, g)'s chunk at
        out[g, r], the order of the reference's output spec ``P((shard,
        replica))`` — so its reshape to [s·rows, ...] is the global row
        order.
        """
        C, S = self.C, self.S
        self._check_lead(x, "replica psum_scatter")
        rest = tuple(x.shape[1:])
        if not rest or rest[0] % C:
            raise ValueError(f"replica psum_scatter needs c={C} | rows, got "
                             f"per-rank shape {rest}")
        v = x.reshape((C, S) + rest)
        acc = v[0]
        for r in range(1, C):
            acc = acc + v[r]
        out = acc.reshape((S, C, rest[0] // C) + rest[1:])
        self._record("psum_scatter@r", tuple(
            (r * S + g, q * S + g) for g in range(S) for r in range(C)
            for q in range(C)), x, out)
        return out


class MeshComm(_CommLog):
    """Collectives over the named axes of an emulated grid.

    ``shape`` maps each axis name to its size, in the grid's order. The
    operands stack the ranks as ``[*lead, ...]``, one leading dim per axis
    of ``layout`` (a tuple of axis names, each of the grid); a collective
    over ``axis`` runs inside every combination of the other leading
    indices, which is what the reference's collective over one mesh axis
    does on every rank.
    """

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in dict(shape).items()}
        super().__init__()

    def rows(self, axis: Optional[str] = None, direction: str = "fwd") -> int:
        """Rows placed in collective operands since the last ``reset``:
        all of them, or those of one axis (``"model"``; ``"model:meta"``
        for the metadata exchanges logged apart), forward or backward."""
        return self._rows(self._axis_filter(axis), direction)

    @staticmethod
    def _axis_filter(axis: Optional[str]) -> Callable[[str], bool]:
        return lambda op: axis is None or op.endswith("@" + axis)

    def _axis_dim(self, x: torch.Tensor, layout: Sequence[str],
                  axis: str) -> int:
        lead = tuple(self.shape[a] for a in layout)
        if tuple(x.shape[:len(lead)]) != lead:
            raise ValueError(f"operand must lead with {lead} "
                             f"({tuple(layout)}), got {tuple(x.shape)}")
        return list(layout).index(axis)

    def _pairs(self, layout: Sequence[str], axis: str) -> Pairs:
        """The (src, dst) pairs of ranks (numbered in ``layout`` order)
        that differ only in ``axis``."""
        lead = tuple(self.shape[a] for a in layout)
        ranks = np.arange(math.prod(lead)).reshape(lead)
        groups = np.moveaxis(ranks, list(layout).index(axis), -1).reshape(
            -1, self.shape[axis])
        return tuple((int(s), int(d)) for g in groups for s in g for d in g)

    def all_to_all(self, x: torch.Tensor, layout: Sequence[str], axis: str,
                   meta: bool = False) -> torch.Tensor:
        """Untiled all_to_all over ``axis``: ``jax.lax.all_to_all(x, axis,
        0, 0, tiled=False)`` on every rank.

        ``x`` is ``[*lead, A(dst), ...]``: each rank's operand holds one
        slab per destination along ``axis`` (size A). Rank a receives
        ``out[.., a, .., q] = x[.., q, .., a]`` — the source and destination
        dims swapped."""
        i = self._axis_dim(x, layout, axis)
        n = len(layout)
        if x.dim() <= n or x.shape[n] != self.shape[axis]:
            raise ValueError(f"all_to_all over {axis!r} needs [{x.shape[:n]}"
                             f", {self.shape[axis]}, ...], got "
                             f"{tuple(x.shape)}")
        out = x.transpose(i, n).contiguous()
        op = f"all_to_all@{axis}" + (":meta" if meta else "")
        self._record(op, self._pairs(layout, axis), x, out)
        return out

    def _reduce(self, x, layout, axis, op, fold):
        i = self._axis_dim(x, layout, axis)
        acc = x.select(i, 0)
        for r in range(1, x.shape[i]):
            acc = fold(acc, x.select(i, r))
        out = acc.unsqueeze(i).expand(x.shape)
        self._record(f"{op}@{axis}", self._pairs(layout, axis), x, out)
        return out

    def pmax(self, x: torch.Tensor, layout: Sequence[str],
             axis: str) -> torch.Tensor:
        """``jax.lax.pmax(x, axis)`` on every rank (exact in any order)."""
        return self._reduce(x, layout, axis, "pmax", torch.maximum)

    def psum(self, x: torch.Tensor, layout: Sequence[str],
             axis: str) -> torch.Tensor:
        """``jax.lax.psum(x, axis)`` on every rank: a left fold in
        ascending rank along ``axis``, x[0] + x[1] + … — one fixed chain,
        as the port's reduce-scatters fold."""
        return self._reduce(x, layout, axis, "psum", torch.add)



class ChunkSources(NamedTuple):
    """A sharded leaf's fold sources on one process
    (``ProcessMeshComm.fold_leaves``): the leaf is cut along ``dim`` into
    one chunk per model rank the process holds, and ``chunks[j]`` lists
    the (process, chunk index there) pieces that chunk j sums, in fold
    order."""

    dim: int
    chunks: Tuple[Tuple[Tuple[int, int], ...], ...]


def _keeps(srcs: Any, q: int) -> bool:
    """Whether process q's fold sources leave its leaf as it is."""
    if isinstance(srcs, ChunkSources):
        return all(tuple(c) == ((q, j),) for j, c in enumerate(srcs.chunks))
    return list(srcs) == [q]


_SEQ = itertools.count()  # this process's cross-process exchanges, in order


class _Route(NamedTuple):
    """One collective's crossing traffic as this process sees it: bytes
    to (``in_splits``) and from (``out_splits``) each process, the rows
    it receives, the slabs' dtype, and the exchange's forward number."""

    in_splits: Tuple[int, ...]
    out_splits: Tuple[int, ...]
    recv_rows: int
    dtype: torch.dtype
    seq: int


def _stacked(outs: List[torch.Tensor], like: torch.Tensor,
             shape: Tuple[int, ...]) -> torch.Tensor:
    """A reduction's per-rank results stacked, [w, *shape]; [0, *shape]
    on a process that holds no rank."""
    return torch.stack(outs) if outs else like.new_empty((0,) + shape)


def _tie(out: torch.Tensor, token: torch.Tensor) -> None:
    """Make ``out`` depend on the empty ``token`` under autograd at no
    cost: an in-place copy of zero elements, which joins the token's node
    to ``out``'s graph."""
    out.narrow(0, 0, 0).copy_(token.reshape((0,) + (1,) * (out.dim() - 1)))


class _Exchange(torch.autograd.Function):
    """A collective's crossing slabs through the process group, and back.

    Forward: ``buf`` (this process's outgoing slabs, in buffer order)
    goes out in one exchange and the received slabs come back, in the
    forward's receive order. Backward: the gradient of every received
    slab goes back to the slab's source over the reversed pairs, in one
    exchange staged the same way, and lands in ``buf``'s layout. ``like``
    (the collective's operand) makes the node exist on a process that
    sends nothing. The second output, an empty token, is tied into the
    collective's result (``_tie``), so a process that receives nothing
    still reaches the backward exchange: every process enters every one,
    and each first checks that all are at the same exchange."""

    @staticmethod
    def forward(ctx, comm, op, route, like, buf):
        ctx.comm, ctx.op, ctx.route = comm, op, route
        vals = comm._exchange(buf, route)
        return vals, vals.new_empty(0)

    @staticmethod
    def backward(ctx, g, _token):
        comm, route = ctx.comm, ctx.route
        comm._check_order(route, ctx.op)
        dbuf = comm._exchange(g.contiguous(), route, back=True)
        comm.crossing.append(("bwd:" + ctx.op, route.recv_rows))
        return (None, None, None, None,
                dbuf if ctx.needs_input_grad[4] else None)


class _FanOut(torch.autograd.Function):
    """``n`` uses of one slab whose gradients sum as the emulated
    communicators' broadcasts sum theirs: an ``expand``'s backward is a
    ``sum`` over the copies' dim, so the uses' gradients are stacked in
    use order and summed over that dim — the same reduction, the same
    bits (a left fold up to four copies, torch's blocked sum past it)."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        return torch.stack(gs).sum(0), None


class _Fleet:
    """The exchange every communicator over a ``torch.distributed``
    process group shares: this process's span of the ranks, the one
    ``all_to_all_single`` per collective (staged through pinned host
    memory on a card), its autograd (``_Exchange``) and its counters.
    Each process of the default group holds a run of the ranks in
    process order, its entry of ``spans``: an equal run by default
    (process i the ranks [i·w, (i+1)·w)), or any contiguous table — a
    narrowed or carved fleet's, where a run may be shorter or empty. A
    process with an empty span holds no rank but still enters every
    exchange, with nothing to send or receive."""

    def _join(self, P: int, span: Tuple[int, int],
              spans: Optional[Sequence[Tuple[int, int]]] = None) -> None:
        import torch.distributed as dist

        self.n_proc = dist.get_world_size()
        self.proc = dist.get_rank()
        if spans is None:
            w = P // self.n_proc
            spans = [(i * w, (i + 1) * w) for i in range(self.n_proc)]
        spans = tuple((int(lo), int(hi)) for lo, hi in spans)
        ok = (len(spans) == self.n_proc and spans[0][0] == 0
              and spans[-1][1] == P
              and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
              and all(lo <= hi for lo, hi in spans)
              and spans[self.proc] == (int(span[0]), int(span[1])))
        if not ok:
            raise ValueError(
                f"span {span} of process {self.proc} and the table {spans} "
                f"are not contiguous runs of P={P} ranks over "
                f"{self.n_proc} processes in process order")
        self.spans = spans
        self.span = spans[self.proc]
        self.width = self.span[1] - self.span[0]
        # each rank's process
        self._owners = np.repeat(np.arange(self.n_proc),
                                 [hi - lo for lo, hi in spans])
        self._pinned: Dict[str, torch.Tensor] = {}

    def reset(self) -> None:
        super().reset()
        self.crossing: List[Tuple[str, int]] = []
        self.staged_bytes = 0
        self.stage_s = 0.0
        self.gloo_s = 0.0
        self.exchanges = 0
        self.bwd_exchanges = 0
        self.fold_bytes = 0
        self._token: Optional[torch.Tensor] = None

    # ----- counters ------------------------------------------------------

    def rows_crossing(self, axis: Optional[str] = None,
                      direction: str = "fwd") -> int:
        """Rows this process sent to ranks of other processes, by the
        forward collectives (``"fwd"``) or by their backward (``"bwd"``:
        the gradients of the slabs this process received)."""
        if direction not in ("fwd", "bwd"):
            raise ValueError(f"direction must be 'fwd' or 'bwd', got "
                             f"{direction!r}")
        on, back = self._axis_filter(axis), direction == "bwd"
        return sum(r for op, r in self.crossing
                   if op.startswith("bwd:") == back
                   and on(op[4:] if back else op))

    def fleet_rows(self, axis: Optional[str] = None, crossing: bool = False,
                   direction: str = "fwd") -> int:
        """``rows(axis, direction)`` (or ``rows_crossing``) summed over
        the processes: a collective call every process makes."""
        import torch.distributed as dist

        n = (self.rows_crossing(axis, direction) if crossing
             else self.rows(axis, direction))
        t = torch.tensor([n], dtype=torch.int64)
        dist.all_reduce(t)
        return int(t.item())

    def transport(self) -> Dict[str, float]:
        """Since the last ``reset``: the cross-process exchanges (forward
        and backward; ``bwd_exchanges`` the backward's), the bytes staged
        between the card and the host (both ways), the host seconds of
        the staging copies and of the exchanges, and the bytes this
        process sent to ``fold_leaves``."""
        return {"exchanges": self.exchanges,
                "bwd_exchanges": self.bwd_exchanges,
                "staged_bytes": self.staged_bytes,
                "stage_s": self.stage_s, "gloo_s": self.gloo_s,
                "fold_bytes": self.fold_bytes}

    # ----- the one exchange ----------------------------------------------

    @property
    def owners(self) -> Tuple[int, ...]:
        """Each rank's process, rank by rank (the span table's)."""
        return tuple(int(q) for q in self._owners)

    def _owner(self, rank: int) -> int:
        return int(self._owners[rank])

    def _mine(self, rank: int) -> bool:
        return self.span[0] <= rank < self.span[1]

    def _mine_pairs(self, pairs) -> Pairs:
        return tuple(p for p in pairs if self._mine(p[0]))

    def _check_lead(self, x: torch.Tensor, what: str) -> None:
        if x.shape[0] != self.width:
            raise ValueError(f"{what} operand must lead with this process's "
                             f"[{self.width}] ranks, got {tuple(x.shape)}")

    def _host_buffer(self, kind: str, nbytes: int) -> torch.Tensor:
        buf = self._pinned.get(kind)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[kind] = buf
        return buf[:nbytes]

    def _exchange(self, data: torch.Tensor, route: _Route,
                  back: bool = False) -> torch.Tensor:
        """``data`` (contiguous, slabs in buffer order) through one
        ``all_to_all_single``; the bytes received, as ``route.dtype``,
        1-D. ``back`` runs the reversed exchange. On a card the bytes go
        device → pinned host → exchange → device; the forward and the
        backward each stage through host buffers of their own."""
        import torch.distributed as dist

        in_splits, out_splits = route.in_splits, route.out_splits
        if back:
            in_splits, out_splits = out_splits, in_splits
        n_in = sum(out_splits)
        raw = data.reshape(-1).view(torch.uint8)
        kind = "bwd" if back else "fwd"
        if raw.is_cuda:
            torch.cuda.synchronize(raw.device)
            t0 = time.perf_counter()
            host_in = self._host_buffer("send:" + kind, raw.numel())
            host_in.copy_(raw)
            host_out = self._host_buffer("recv:" + kind, n_in)
            t1 = time.perf_counter()
            dist.all_to_all_single(host_out, host_in, list(out_splits),
                                   list(in_splits))
            t2 = time.perf_counter()
            out = torch.empty(n_in, dtype=torch.uint8, device=raw.device)
            out.copy_(host_out)
            t3 = time.perf_counter()
            self.stage_s += (t1 - t0) + (t3 - t2)
            self.gloo_s += t2 - t1
            self.staged_bytes += raw.numel() + n_in
        else:
            out = torch.empty(n_in, dtype=torch.uint8)
            t1 = time.perf_counter()
            dist.all_to_all_single(out, raw, list(out_splits),
                                   list(in_splits))
            self.gloo_s += time.perf_counter() - t1
        self.exchanges += 1
        self.bwd_exchanges += int(back)
        return out.view(route.dtype)

    def _check_order(self, route: _Route, op: str) -> None:
        """Before a backward exchange: every process must be reversing
        the same forward exchange. Raises on a mismatch (instead of
        pairing the wrong exchanges or waiting for one that never
        comes)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        mine = torch.tensor([route.seq], dtype=torch.int64)
        seqs = [torch.zeros_like(mine) for _ in range(self.n_proc)]
        dist.all_gather(seqs, mine)
        self.gloo_s += time.perf_counter() - t0
        seen = [int(s) for s in seqs]
        if any(s != route.seq for s in seen):
            raise RuntimeError(
                f"backward exchanges out of order across processes: "
                f"process {self.proc} reverses forward exchange "
                f"{route.seq} ({op}), the processes are at {seen}")

    def _route(self, op: str, pairs: Sequence[Tuple[int, int]],
               take: Callable[[int, int], torch.Tensor],
               slab_shape: Tuple[int, ...], like: torch.Tensor
               ) -> Dict[Tuple[int, int], torch.Tensor]:
        """Every slab a pair of ``pairs`` brings to this process's ranks:
        {(src, dst): slab} for each dst in the span. ``take(src, dst)``
        gives the slab a source of this process sends (every slab has
        ``slab_shape``, the same on every process). Logs the rows sent
        across processes under ``op``. Under autograd (``like`` requires
        grad) the crossing slabs go through ``_Exchange``, whose token the
        collective's ``_record`` ties into its result."""
        got = {(s, d): take(s, d) for s, d in pairs
               if self._mine(s) and self._mine(d)}
        cross = [(s, d) for s, d in pairs
                 if self._owner(s) != self._owner(d)]
        numel = math.prod(slab_shape)
        per_row = slab_shape[-1] if slab_shape and slab_shape[-1] else 0
        rows = numel // per_row if per_row else 0
        send = sorted((p for p in cross if self._mine(p[0])),
                      key=lambda p: (self._owner(p[1]), p))
        self.crossing.append((op, len(send) * rows))
        if not cross or not numel:  # the same on every process
            return got
        recv = sorted((p for p in cross if self._mine(p[1])),
                      key=lambda p: (self._owner(p[0]), p))
        nbytes = numel * like.element_size()
        in_splits = [0] * self.n_proc
        for _, d in send:
            in_splits[self._owner(d)] += nbytes
        out_splits = [0] * self.n_proc
        for s, _ in recv:
            out_splits[self._owner(s)] += nbytes
        route = _Route(tuple(in_splits), tuple(out_splits),
                       len(recv) * rows, like.dtype, next(_SEQ))
        slabs = [take(s, d).reshape(-1) for s, d in send]
        buf = torch.cat(slabs) if slabs else like.new_empty(0)
        if torch.is_grad_enabled() and like.requires_grad:
            vals, self._token = _Exchange.apply(self, op, route, like, buf)
        else:
            vals = self._exchange(buf, route)
        vals = vals.view((len(recv),) + tuple(slab_shape))
        got.update(zip(recv, vals.unbind(0)))
        return got

    def _fanned(self, pairs: Sequence[Tuple[int, int]],
                slab: Callable[[int], torch.Tensor], like: torch.Tensor
                ) -> Callable[[int, int], torch.Tensor]:
        """``take(src, dst)`` for a collective that sends the same slab of
        a source to several destinations: under autograd each use is an
        output of ``_FanOut``, so the uses' gradients sum in ascending
        destination order, as the emulated broadcast sums them."""
        if not (torch.is_grad_enabled() and like.requires_grad):
            return lambda s, d: slab(s)
        dests: Dict[int, List[int]] = {}
        for s, d in pairs:
            if self._mine(s):
                dests.setdefault(s, []).append(d)
        uses = {}
        for s, ds in dests.items():
            ds = sorted(ds)
            views = _FanOut.apply(slab(s), len(ds)) if len(ds) > 1 \
                else (slab(s),)
            uses.update(((s, d), v) for d, v in zip(ds, views))
        return lambda s, d: uses[(s, d)]

    def _record(self, op: str, pairs: Pairs, x: torch.Tensor,
                out: torch.Tensor, rows: Optional[int] = None) -> None:
        if self._token is not None:
            _tie(out, self._token)
            self._token = None
        super()._record(op, pairs, x, out, rows)

    def fold(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes in ascending process order,
        the left fold t₀ + t₁ + … — the same bits on every process — on
        ``t``'s device. One all_gather through the host."""
        import torch.distributed as dist

        host = t.detach().to("cpu", copy=True).contiguous()
        parts = [torch.empty_like(host) for _ in range(self.n_proc)]
        t0 = time.perf_counter()
        dist.all_gather(parts, host)
        self.gloo_s += time.perf_counter() - t0
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc.to(t.device)

    def fold_host(self, value: int) -> int:
        """A host integer summed over the processes (ascending process
        order), the same on every process: a stop flag any process
        raised (> 0), or a value only the lead gives (the others give
        0). One all_gather of one int64."""
        import torch.distributed as dist

        mine = torch.tensor([int(value)], dtype=torch.int64)
        parts = [torch.empty_like(mine) for _ in range(self.n_proc)]
        t0 = time.perf_counter()
        dist.all_gather(parts, mine)
        self.gloo_s += time.perf_counter() - t0
        return sum(int(t) for t in parts)

    def fold_first(self, obj: Any) -> Any:
        """The first host object that is not None over the processes
        (ascending process order), the same on every process; None where
        every process gives None. One all_gather_object."""
        import torch.distributed as dist

        every: List[Any] = [None] * self.n_proc
        t0 = time.perf_counter()
        dist.all_gather_object(every, obj)
        self.gloo_s += time.perf_counter() - t0
        return next((o for o in every if o is not None), None)

    def exchange_bytes(self, data: torch.Tensor, in_splits: Sequence[int],
                       out_splits: Sequence[int],
                       dtype: torch.dtype) -> torch.Tensor:
        """``data`` (this process's outgoing slabs, contiguous, grouped by
        destination process) through the one exchange every collective
        uses (``_exchange``: pinned host staging on a card, its counters):
        ``in_splits[p]`` bytes go to process p and ``out_splits[p]``
        come from it. The bytes received, as ``dtype``, 1-D. A collective
        every process makes."""
        route = _Route(tuple(int(n) for n in in_splits),
                       tuple(int(n) for n in out_splits), 0, dtype,
                       next(_SEQ))
        return self._exchange(data.contiguous(), route)

    def barrier(self) -> None:
        """Wait until every process of the group gets here."""
        import torch.distributed as dist

        dist.barrier()

    def fold_leaves(self, leaves: Sequence[torch.Tensor],
                    sources: Sequence[Sequence[Any]]) -> List[torch.Tensor]:
        """A functional gradient tree's leaves summed over processes:
        leaf i becomes the left fold, in the order of ``sources[i][q]``
        for this process q, of those processes' leaf i (a process's own
        list may name another process alone: its leaf is then that one's
        copy) — or, where ``sources[i][q]`` is a ``ChunkSources``, each
        of its chunks along ``dim`` the left fold of the named
        (process, chunk) pieces, joined in chunk order. ``sources[i]``
        holds every process's entry, so every process knows which leaves
        cross: those go, per dtype, through one all_gather on the host; a
        leaf that every process keeps as it is stays on its device
        untouched. Every process that sums the same list gets the same
        bits."""
        import torch.distributed as dist

        out = list(leaves)
        cross = [i for i, per in enumerate(sources)
                 if any(not _keeps(srcs, q) for q, srcs in enumerate(per))]
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i in cross:
            by_dtype.setdefault(leaves[i].dtype, []).append(i)
        for idx in by_dtype.values():
            host = torch.empty(sum(leaves[i].numel() for i in idx),
                               dtype=leaves[idx[0]].dtype)
            off = 0
            for i in idx:  # each leaf straight into its slice
                n = leaves[i].numel()
                host[off:off + n].copy_(leaves[i].detach().reshape(-1))
                off += n
            parts = [torch.empty_like(host) for _ in range(self.n_proc)]
            t0 = time.perf_counter()
            dist.all_gather(parts, host)
            self.gloo_s += time.perf_counter() - t0
            self.fold_bytes += host.numel() * host.element_size()
            off = 0
            for i in idx:
                n, shape = leaves[i].numel(), leaves[i].shape
                srcs = sources[i][self.proc]
                leaf = [p[off:off + n].view(shape) for p in parts]
                if isinstance(srcs, ChunkSources):
                    size = shape[srcs.dim] // len(srcs.chunks)

                    def piece(q, j):
                        return leaf[q].narrow(srcs.dim, j * size, size)

                    accs = []
                    for chunk in srcs.chunks:
                        acc = piece(*chunk[0])
                        for q, j in chunk[1:]:
                            acc = acc + piece(q, j)
                        accs.append(acc)
                    acc = torch.cat(accs, srcs.dim)
                else:
                    acc = leaf[srcs[0]]
                    for q in srcs[1:]:
                        acc = acc + leaf[q]
                out[i] = acc.reshape(shape).to(leaves[i].device)
                off += n
        return out

    def reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Replace every parameter's ``.grad`` by its sum over the
        processes (``fold_leaves`` with every process a source:
        ascending process order, so every process holds the same bits
        and a replicated parameter stays bit-identical after the
        optimizer step). One exchange per gradient dtype."""
        params = [p for p in params if p.grad is not None]
        every = [list(range(self.n_proc))] * self.n_proc
        summed = self.fold_leaves([p.grad for p in params],
                                  [every] * len(params))
        for p, g in zip(params, summed):
            p.grad = g


class ProcessComm(_Fleet, _CommLog):
    """LocalComm's collectives over a ``torch.distributed`` process group.

    ``P``, ``groups`` and ``replicas`` lay the global ranks out as
    LocalComm's do. ``span`` = (lo, hi) is the run of ranks this process
    holds and ``spans`` every process's, in process order (default: an
    equal run each, process i the ranks [i·w, (i+1)·w)); a narrowed or
    carved fleet's runs may differ in length, and one may be empty.
    Operands lead with [w = hi - lo] (this process's ranks) where
    LocalComm's lead with [P]; results too, with one exception named at
    ``replica_psum_scatter``.

    Each collective is its (src, dst) pair list over the global ranks. A
    pair inside the span is a tensor copy; the pairs that cross processes
    go in ONE ``dist.all_to_all_single`` per collective, as bytes, with
    uneven splits and the slabs in (src, dst) order on both sides. On a
    card the buffer is staged explicitly: device → a pinned host buffer
    (``copy_``), the exchange on the host (gloo: NCCL refuses two ranks
    on one device), host → device (``copy_``). Reductions fold the
    received slabs in LocalComm's order (ascending l, ascending r), so
    every result equals the emulated one bit for bit.

    Every collective differentiates: the in-span copies and the folds
    through torch, the crossing slabs through ``_Exchange``, whose
    backward sends each received slab's gradient back to its source in
    one reversed exchange. The log keeps LocalComm's entries for this
    process's ranks, the backward's ``bwd:`` entries included: ``rows``
    counts their operand rows and ``fleet_rows`` sums that over the
    processes (the emulated LocalComm's count). ``rows_crossing`` counts
    the rows this process sent to other processes, forward or backward;
    ``transport()`` the exchanges, the bytes staged through the host and
    the host seconds spent staging and exchanging.
    """

    def __init__(self, P: int, groups: int = 1, replicas: int = 1, *,
                 span: Tuple[int, int],
                 spans: Optional[Sequence[Tuple[int, int]]] = None):
        _layout(self, P, groups, replicas)
        self._join(self.P, span, spans)
        super().__init__()
        self.reset()

    _axis_filter = staticmethod(_on_axis)

    def rows(self, axis: Optional[str] = None, direction: str = "fwd") -> int:
        """Operand rows of this process's ranks since the last ``reset``,
        all or one axis's, under LocalComm's axis names."""
        return self._rows(_on_axis(axis), direction)

    # ----- the flat axis ------------------------------------------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``LocalComm.all_to_all`` for this process's ranks: ``x`` is
        [w(src), P(dst), ...], the result [w(dst), P(src), ...]."""
        lo = self.span[0]
        if x.shape[0] != self.width or x.dim() < 2 or x.shape[1] != self.P:
            raise ValueError(f"all_to_all operand must lead with "
                             f"[{self.width}, {self.P}], got "
                             f"{tuple(x.shape)}")
        pairs = [(q, p) for q in range(self.P) for p in range(self.P)]
        got = self._route("all_to_all", pairs, lambda q, p: x[q - lo, p],
                          tuple(x.shape[2:]), x)
        out = torch.empty_like(x)
        for (q, p), slab in got.items():
            out[p - lo, q] = slab
        self._record("all_to_all", self._mine_pairs(pairs), x, out)
        return out

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]],
                 op: str = "ppermute") -> torch.Tensor:
        """``LocalComm.ppermute``: rank ``src`` sends its slice to ``dst``;
        ranks that no pair sends to receive zeros."""
        perm = tuple((int(s), int(d)) for s, d in perm)
        self._check_lead(x, "ppermute")
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"ppermute needs a partial permutation, got "
                             f"{perm}")
        lo = self.span[0]
        got = self._route(op, perm, lambda s, d: x[s - lo],
                          tuple(x.shape[1:]), x)
        out = torch.zeros_like(x)
        for (_, d), slab in got.items():
            out[d - lo] = slab
        self._record(op, self._mine_pairs(perm), x, out)
        return out

    def shift(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """ppermute over the shift-``d`` matching ``q -> (q + d) % P``."""
        return self.ppermute(x, [(q, (q + d) % self.P)
                                 for q in range(self.P)])

    # ----- the (G, L) grid ----------------------------------------------

    def group_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``LocalComm.group_all_to_all``: ``x`` is [w, G(dst), ...]; rank
        (g', l) receives ``out[(g', l)][g] = x[(g, l)][g']``."""
        G, L, lo = self.G, self.L, self.span[0]
        self._check_lead(x, "group all_to_all")
        if x.dim() < 2 or x.shape[1] != G:
            raise ValueError(f"group all_to_all operand must be "
                             f"[{self.width}, {G}, ...], got "
                             f"{tuple(x.shape)}")
        pairs = [(g * L + l, h * L + l) for g in range(G)
                 for l in range(L) for h in range(G)]
        got = self._route("all_to_all@g", pairs,
                          lambda s, d: x[s - lo, d // L],
                          tuple(x.shape[2:]), x)
        out = torch.empty_like(x)
        for (s, d), slab in got.items():
            out[d - lo, s // L] = slab
        self._record("all_to_all@g", self._mine_pairs(pairs), x, out)
        return out

    def group_shift(self, x: torch.Tensor, dg: int) -> torch.Tensor:
        """ppermute over the group axis by shift ``dg``."""
        return self.ppermute(
            x, [(q, (q + dg * self.L) % self.P) for q in range(self.P)],
            op="ppermute@g")

    def _local_pairs(self) -> List[Tuple[int, int]]:
        L = self.L
        return [(g * L + a, g * L + b) for g in range(self.G)
                for a in range(L) for b in range(L)]

    def local_psum_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``LocalComm.local_psum_scatter``: rank (g, l) gets chunk l
        (along per-rank dim ``dim``) of x[(g, 0)] + x[(g, 1)] + … , the
        left fold in ascending l'."""
        L, lo = self.L, self.span[0]
        self._check_lead(x, "local psum_scatter")
        rest = tuple(x.shape[1:])
        if not 0 <= dim < len(rest) or rest[dim] % L:
            raise ValueError(f"psum_scatter dim {dim} of per-rank shape "
                             f"{rest} is not divisible by L={L}")
        chunk = rest[dim] // L
        pairs = self._local_pairs()
        got = self._route(
            "psum_scatter@l", pairs,
            lambda s, d: x[s - lo].narrow(dim, (d % L) * chunk, chunk),
            rest[:dim] + (chunk,) + rest[dim + 1:], x)
        outs = []
        for d in range(*self.span):
            base = d - d % L
            acc = got[(base, d)]
            for a in range(1, L):
                acc = acc + got[(base + a, d)]
            outs.append(acc)
        out = _stacked(outs, x, rest[:dim] + (chunk,) + rest[dim + 1:])
        self._record("psum_scatter@l", self._mine_pairs(pairs), x, out)
        return out

    def local_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``LocalComm.local_all_gather``: rank (g, l) gets
        ``stack_l'(x[(g, l')])``, [w, L, ...]."""
        L, lo = self.L, self.span[0]
        self._check_lead(x, "local all_gather")
        rest = tuple(x.shape[1:])
        pairs = self._local_pairs()
        got = self._route("all_gather@l", pairs,
                          self._fanned(pairs, lambda s: x[s - lo], x),
                          rest, x)
        out = x.new_empty((self.width, L) + rest)
        for (s, d), slab in got.items():
            out[d - lo, s % L] = slab
        self._record("all_gather@l", self._mine_pairs(pairs), x, out)
        return out

    # ----- the (c, s) replica x shard layout ------------------------------

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """B's c-fold copy from its P-way row blocks: ``x`` is [w, K/P,
        ...] (rank p's block at x[p - lo]); rank (r, g) gets shard g, the
        blocks g·c … g·c + c − 1 joined, [w, c·K/P, ...] — what
        ``LocalComm.replicate`` hands rank (r, g) from the s-way split.
        Logged with the rows it writes, as LocalComm's."""
        C, S, lo = self.C, self.S, self.span[0]
        self._check_lead(x, "replicate")
        rows = x.shape[1]
        pairs = [(g * C + j, r * S + g) for r in range(C) for g in range(S)
                 for j in range(C)]
        got = self._route("broadcast@r", pairs,
                          self._fanned(pairs, lambda s: x[s - lo], x),
                          tuple(x.shape[1:]), x)
        out = x.new_empty((self.width, C * rows) + tuple(x.shape[2:]))
        for (s, d), slab in got.items():
            j = s - (d % S) * C
            out[d - lo, j * rows:(j + 1) * rows] = slab
        self._record("broadcast@r", self._mine_pairs(pairs), out, out)
        return out

    def lane_shift(self, x: torch.Tensor, shifts: Sequence[int],
                   lanes: Sequence[int]) -> torch.Tensor:
        """``LocalComm.lane_shift``: lane r in ``lanes`` shifts by
        ``shifts[r]`` inside its s ranks; other lanes receive zeros. The
        log counts the rows of this process's sending ranks."""
        C, S, lo = self.C, self.S, self.span[0]
        self._check_lead(x, "lane shift")
        lanes = tuple(int(r) for r in lanes)
        if len(shifts) != C or len(set(lanes)) != len(lanes) or \
                not all(0 <= r < C for r in lanes):
            raise ValueError(f"lane shift needs one shift per lane ({C}) "
                             f"and distinct lanes, got {tuple(shifts)} "
                             f"over {lanes}")
        pairs = [(r * S + g, r * S + (g + int(shifts[r])) % S)
                 for r in lanes for g in range(S)]
        got = self._route("ppermute@s", pairs, lambda s, d: x[s - lo],
                          tuple(x.shape[1:]), x)
        out = torch.zeros_like(x)
        for (_, d), slab in got.items():
            out[d - lo] = slab
        mine = self._mine_pairs(pairs)
        per_rank = math.prod(x.shape[1:-1]) if x.shape[-1] else 0
        self._record("ppermute@s", mine, x, out, per_rank * len(mine))
        return out

    def replica_psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce-scatter over the replica axis: rank (r, g) gets chunk r
        (rows / c of them) of x[(0, g)] + x[(1, g)] + … , the left fold in
        ascending r'. Unlike LocalComm's [s, c, rows / c, ...] in (g, r)
        order, the result is this process's ranks in rank order, [w,
        rows / c, ...]: rank (r, g)'s chunk holds global rows
        g·rows + r·rows / c onward."""
        C, S, lo = self.C, self.S, self.span[0]
        self._check_lead(x, "replica psum_scatter")
        rest = tuple(x.shape[1:])
        if not rest or rest[0] % C:
            raise ValueError(f"replica psum_scatter needs c={C} | rows, got "
                             f"per-rank shape {rest}")
        chunk = rest[0] // C
        pairs = [(r * S + g, q * S + g) for g in range(S) for r in range(C)
                 for q in range(C)]
        got = self._route(
            "psum_scatter@r", pairs,
            lambda s, d: x[s - lo, (d // S) * chunk:(d // S + 1) * chunk],
            (chunk,) + rest[1:], x)
        outs = []
        for d in range(*self.span):
            g = d % S
            acc = got[(g, d)]
            for r in range(1, C):
                acc = acc + got[(r * S + g, d)]
            outs.append(acc)
        out = _stacked(outs, x, (chunk,) + rest[1:])
        self._record("psum_scatter@r", self._mine_pairs(pairs), x, out)
        return out


class ProcessMeshComm(_Fleet, MeshComm):
    """``MeshComm``'s collectives over a ``torch.distributed`` process
    group.

    The grid's ranks are numbered row-major in its axis order (the
    reference's process-major device order), and this process runs the
    contiguous ``span`` [lo, hi) of them, process i the ranks [i·w,
    (i+1)·w). Operands lead with this process's [w] ranks where
    MeshComm's lead with ``[*lead]``; ``layout`` must name the grid's
    axes in its order. A pair of ranks inside the span is a tensor copy,
    the pairs that cross processes go through ProcessComm's one exchange
    (``_Fleet._route``), and ``pmax`` / ``psum`` fold in ascending rank
    along the axis, as MeshComm's ``_reduce`` does, so every result is
    the emulated one bit for bit. The log holds MeshComm's entries for
    this process's ranks (``rows("model")``, ``rows("model:meta")``);
    ``fleet_rows`` sums them over the processes. Every collective
    differentiates, as ProcessComm's do.
    """

    def __init__(self, shape: Dict[str, int], *, span: Tuple[int, int]):
        MeshComm.__init__(self, shape)
        self._join(math.prod(self.shape.values()), span)
        self.reset()

    def _coord(self, layout: Sequence[str], axis: str
               ) -> Callable[[int], int]:
        """A global rank's index along ``axis``; ``layout`` must be the
        grid's axis order (the ranks' numbering)."""
        if tuple(layout) != tuple(self.shape):
            raise ValueError(f"a fleet grid's operands stack its ranks in "
                             f"its axis order {tuple(self.shape)}, got "
                             f"layout {tuple(layout)}")
        stride = math.prod(list(self.shape.values())[
            list(self.shape).index(axis) + 1:])
        size = self.shape[axis]
        return lambda r: (r // stride) % size

    def all_to_all(self, x: torch.Tensor, layout: Sequence[str], axis: str,
                   meta: bool = False) -> torch.Tensor:
        """``MeshComm.all_to_all`` for this process's ranks: ``x`` is
        [w, A(dst), ...]; rank d receives ``out[d][a_s] = x[s][a_d]`` from
        every rank s of its group along ``axis``."""
        coord, lo = self._coord(layout, axis), self.span[0]
        self._check_lead(x, "all_to_all")
        if x.dim() < 2 or x.shape[1] != self.shape[axis]:
            raise ValueError(f"all_to_all over {axis!r} needs [{self.width}, "
                             f"{self.shape[axis]}, ...], got "
                             f"{tuple(x.shape)}")
        op = f"all_to_all@{axis}" + (":meta" if meta else "")
        pairs = self._pairs(layout, axis)
        got = self._route(op, pairs, lambda s, d: x[s - lo, coord(d)],
                          tuple(x.shape[2:]), x)
        out = torch.empty_like(x)
        for (s, d), slab in got.items():
            out[d - lo, coord(s)] = slab
        self._record(op, self._mine_pairs(pairs), x, out)
        return out

    def _reduce(self, x, layout, axis, op, fold):
        coord, lo = self._coord(layout, axis), self.span[0]
        self._check_lead(x, op)
        pairs = self._pairs(layout, axis)
        got = self._route(f"{op}@{axis}", pairs,
                          self._fanned(pairs, lambda s: x[s - lo], x),
                          tuple(x.shape[1:]), x)
        members: Dict[int, List[int]] = {}
        for s, d in pairs:  # d's group, in ascending rank along the axis
            members.setdefault(d, []).append(s)
        outs = []
        for d in range(*self.span):
            srcs = sorted(members[d], key=coord)
            acc = got[(srcs[0], d)]
            for s in srcs[1:]:
                acc = fold(acc, got[(s, d)])
            outs.append(acc)
        out = torch.stack(outs)
        self._record(f"{op}@{axis}", self._mine_pairs(pairs), x, out)
        return out
