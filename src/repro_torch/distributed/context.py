"""Distribution context: an emulated grid + axis-name conventions.

Port of ``repro/distributed/context.py``. The reference's context wraps a
device mesh; the port's wraps an ``EmulatedMesh`` (``launch.mesh``): the
named (pod, data, model) grid whose ranks run on one card as the stacked
leading dims of a model's per-rank tensors, ``[*batch_axes, M, ...]``.
Model code never hard-codes axis names; it consults a DistContext, and
``dist=None`` runs unsharded.

Axis roles:
  pod    — slow tier. Batch parallel + the OUTER group axis of SHIRO's
           hierarchical schedules.
  data   — fast tier. Batch parallel, FSDP parameter sharding, and
           SHIRO's intra-group axis.
  model  — tensor/expert parallel (heads, ffn, experts, vocab).

``shard`` is the identity — one card needs no layout — but it checks
what the reference's sharding constraint would: every sharded dim
divides by its axes' size. ``logical_to_spec`` returns a plain tuple of
axis names (there is no ``PartitionSpec``).

A context over a fleet's grid (``Topology.multiprocess(mesh=...)``)
runs this process's ``span`` of the ranks: per-rank tensors lead with
its [w] ranks (``lead``), a batch holds its data groups' rows
(``local_batch``, ``local_rows``; ``gather_batch`` rebuilds the whole
batch on every process), and the grid's collectives cross processes
(``comm.ProcessMeshComm``).

What a train step needs of the grid: which processes hold each data
group (``group_processes``), whether this process counts its rows in the
loss (``counts_rows``: it holds model rank 0 of its data groups, the
rank whose output the emulated grid returns), which slice of each
parameter it holds (``leaf_shards``: the MoE experts are split over the
model ranks, every other leaf is whole) and whose gradients make each
leaf's sum (``grad_sources``); ``GradShards`` sums a gradient tree's
squares in one order on the emulated grid and on a fleet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..launch.mesh import EmulatedMesh
from .comm import MeshComm

__all__ = ["DistContext", "make_context", "shard", "logical_to_spec",
           "check_dist", "GradShards"]


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: EmulatedMesh
    batch_axes: Tuple[str, ...]  # e.g. ("pod", "data") or ("data",)
    model_axis: str = "model"
    pod_axis: Optional[str] = None  # set when a slow tier exists
    fsdp_axis: Optional[str] = None  # axis params are additionally sharded on

    @property
    def batch_size_divisor(self) -> int:
        return int(math.prod(self.mesh.shape[a] for a in self.batch_axes))

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape[self.model_axis])

    def axis_size(self, name: str) -> int:
        return int(self.mesh.shape[name])

    def divisible(self, n: int, axis: str) -> bool:
        return n % self.axis_size(axis) == 0

    def model_axis_if_divisible(self, n: int):
        """'model' when n shards evenly, else None (replicate)."""
        return self.model_axis if self.divisible(n, self.model_axis) else None

    @property
    def layout(self) -> Tuple[str, ...]:
        """The leading dims of the stacked per-rank tensors: the batch
        axes, then the model axis."""
        return tuple(self.batch_axes) + (self.model_axis,)

    @property
    def comm(self) -> MeshComm:
        """The grid's communicator (its log counts the collectives)."""
        return self.mesh.comm

    # ----- the ranks this process runs ----------------------------------

    @property
    def is_fleet(self) -> bool:
        """Whether the grid runs over a process group (``Topology.
        multiprocess(mesh=...)``): this process then runs ``span``."""
        return self.mesh.is_fleet

    @property
    def span(self) -> Tuple[int, int]:
        """The grid's ranks this process runs, row-major in the layout:
        all of them on one device, a contiguous run on a fleet."""
        return self.mesh.span

    @property
    def lead(self) -> Tuple[int, ...]:
        """The leading dims of the per-rank tensors this process stacks:
        one per layout axis on one device, this process's [w] ranks on a
        fleet."""
        if self.is_fleet:
            return (self.span[1] - self.span[0],)
        return tuple(self.axis_size(a) for a in self.layout)

    @property
    def local_grid(self) -> Tuple[int, int, int, int]:
        """This process's ranks as a block of the (batch groups, model)
        grid: (groups, model ranks per group, first group, first model
        rank). All of it on one device; on a fleet the span must hold
        whole groups or a run inside one."""
        lo, hi = self.span
        return _block(lo, hi - lo, self.model_size)

    def local_rows(self, n: int) -> Tuple[int, int]:
        """The rows [start, stop) of an n-row batch that this process's
        data groups hold (all n on one device)."""
        dsz = self.batch_size_divisor
        if n % dsz:
            raise ValueError(f"batch {n} is not divisible by the batch axes "
                             f"{self.batch_axes} ({dsz} ranks)")
        ng, _, g_lo, _ = self.local_grid
        per = n // dsz
        return g_lo * per, (g_lo + ng) * per

    def local_batch(self, x):
        """``x``'s batch rows (dim 0) that this process holds."""
        if not self.is_fleet:
            return x
        lo, hi = self.local_rows(x.shape[0])
        return x[lo:hi]

    def gather_batch(self, local: np.ndarray, n: int) -> np.ndarray:
        """The whole n-row batch from every process's ``local`` rows
        (``local_batch`` of it): each data group's rows as the processes
        holding it give them (the same bits on each), the same result on
        every process. The identity on one device."""
        if not self.is_fleet:
            return local
        import torch.distributed as dist

        local = np.ascontiguousarray(local)
        t = torch.from_numpy(local)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        out = np.empty((n,) + local.shape[1:], local.dtype)
        w, per = self.span[1] - self.span[0], n // self.batch_size_divisor
        for proc, part in enumerate(parts):
            ng, _, g_lo, _ = _block(proc * w, w, self.model_size)
            out[g_lo * per:(g_lo + ng) * per] = part.numpy()
        return out


    # ----- what a train step needs of the grid ---------------------------

    @property
    def n_processes(self) -> int:
        """The processes the grid runs over (1 on one device)."""
        return self.comm.n_proc if self.is_fleet else 1

    def process_grid(self, q: int) -> Tuple[int, int, int, int]:
        """Process q's ``local_grid``: (groups, model ranks per group,
        first group, first model rank)."""
        w = self.span[1] - self.span[0]
        return _block(q * w, w, self.model_size)

    def group_processes(self) -> List[List[int]]:
        """For each data group (the batch axes' ranks, ascending), the
        processes that hold its rows, ascending: one on one device or
        when a process holds whole groups, several when a group's model
        ranks are split over processes."""
        out: List[List[int]] = [[] for _ in range(self.batch_size_divisor)]
        for q in range(self.n_processes):
            ng, _, g_lo, _ = self.process_grid(q)
            for g in range(g_lo, g_lo + ng):
                out[g].append(q)
        return out

    @property
    def counts_rows(self) -> bool:
        """Whether this process's rows count in the loss: each data
        group's once, by the process holding its model rank 0. The other
        processes of the group run the same forward and backward with a
        zero share (their exchanges pair up with the counting process's;
        their expert shards receive its gradients)."""
        return self.local_grid[3] == 0

    def leaf_shards(self, params: Any, cfg
                    ) -> List[Optional[Tuple[int, int]]]:
        """For each leaf of ``params`` (``optim.adamw._leaves`` order):
        None where every process holds it whole, else (dim, M) — the MoE
        experts, split along ``dim`` over the M model ranks; this process
        holds the model ranks of ``local_grid``."""
        return list(self.leaf_splits(params, cfg).values())

    def leaf_splits(self, tree: Any, cfg
                    ) -> Dict[str, Optional[Tuple[int, int]]]:
        """``leaf_shards`` keyed by each leaf's path (``"a/b/c"``, the
        checkpoint's keys). ``tree`` may also hold parameter trees (a
        checkpoint's ``{"params", "opt": {"m", "v", "step"}}``): a leaf
        at ``.../layers/moe/w1`` (``w3``, ``w2``) is an expert leaf
        wherever it sits."""
        out = {}
        for path in _leaf_paths(tree):
            expert = (cfg.family == "moe" and len(path) >= 3
                      and path[-3:-1] == ("layers", "moe")
                      and path[-1] in ("w1", "w3", "w2"))
            out["/".join(path)] = (1, self.model_size) if expert else None
        return out

    def grad_sources(self, params: Any, cfg) -> List[List[List[int]]]:
        """For each leaf, and for each process q, the processes whose
        gradient of that leaf q sums: in ascending data group, the first
        process of the group that holds q's slice of the leaf (for a
        whole leaf, the group's counting process), each process once.
        Every process computes every process's lists."""
        groups = self.group_processes()

        def m_range(q):
            _, nm, _, m_lo = self.process_grid(q)
            return m_lo, m_lo + nm

        out = []
        for split in self.leaf_shards(params, cfg):
            per = []
            for q in range(self.n_processes):
                srcs: List[int] = []
                for members in groups:
                    hold = [r for r in members
                            if split is None or m_range(r) == m_range(q)]
                    if not hold:
                        raise ValueError(
                            f"no process of a data group holds process "
                            f"{q}'s slice {m_range(q)} of a sharded leaf")
                    if hold[0] not in srcs:
                        srcs.append(hold[0])
                per.append(srcs)
            out.append(per)
        return out

    def grad_shards(self, params: Any, cfg) -> "GradShards":
        return GradShards(self, self.leaf_shards(params, cfg))

    def gather_to_lead(self, x: torch.Tensor, dim: int
                       ) -> Optional[torch.Tensor]:
        """A sharded leaf made whole on the lead (process 0): ``x`` holds
        this process's model ranks' chunks along ``dim`` (``leaf_shards``'
        split); the lead gets every model rank's chunk in ascending rank,
        each from the first process that holds it (its own where it holds
        it), joined on the host; every other process gets None. A
        collective every process makes: each process that is first to
        hold a chunk the lead lacks sends its chunks once, as bytes. On
        one device (or the emulated grid) ``x`` is whole already and comes
        back as it is."""
        if not self.is_fleet:
            return x
        import torch.distributed as tdist

        _, nm, _, m_lo = self.local_grid
        size = x.shape[dim] // nm  # one model rank's chunk
        owner = {}  # model rank -> the first process that holds it
        for q in range(self.n_processes):
            _, nq, _, lo = self.process_grid(q)
            for m in range(lo, lo + nq):
                owner.setdefault(m, q)
        senders = sorted(set(owner.values()) - {0})
        me = self.comm.proc
        if me != 0 and me not in senders:
            return None
        host = x.detach().to("cpu").contiguous()
        if me != 0:
            tdist.send(host.reshape(-1).view(torch.uint8), dst=0)
            return None
        chunks = {m: host.narrow(dim, (m - m_lo) * size, size)
                  for m in range(m_lo, m_lo + nm)}
        for q in senders:
            buf = torch.empty_like(host)
            tdist.recv(buf.reshape(-1).view(torch.uint8), src=q)
            _, nq, _, lo = self.process_grid(q)
            chunks.update((m, buf.narrow(dim, (m - lo) * size, size))
                          for m in range(lo, lo + nq) if owner[m] == q)
        return torch.cat([chunks[m] for m in range(self.model_size)], dim)


class GradShards:
    """The sum of a gradient tree's squares in one order wherever the
    tree lives: every whole leaf's sum of squares, and a sharded leaf's
    as a left fold of its M model-rank chunks' sums in ascending rank;
    the leaves' sums then folded in flattening order. On the emulated
    grid every chunk is here; on a fleet each process sums the chunks of
    its model ranks, and one all_gather brings the others' (any holder
    of a chunk has the same folded gradient). So the norm is the same
    bits on the emulated grid and on every process of a fleet whose
    folded gradients are the emulated ones."""

    def __init__(self, dist: DistContext,
                 shards: Sequence[Optional[Tuple[int, int]]]):
        self.dist = dist
        self.shards = list(shards)

    @staticmethod
    def _sq(t: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.square(t.contiguous().float()))

    def sum_squares(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(leaves) != len(self.shards):
            raise ValueError(f"{len(leaves)} leaves for {len(self.shards)} "
                             f"shard entries")
        _, nm, _, m_lo = self.dist.local_grid
        sums: List[Any] = []
        local = []  # this process's chunk sums, leaf by leaf
        for x, split in zip(leaves, self.shards):
            if split is None:
                sums.append(self._sq(x))
                continue
            dim, M = split
            size = x.shape[dim] // nm
            chunks = [self._sq(x.narrow(dim, i * size, size))
                      for i in range(nm)]
            local.extend(chunks)
            sums.append(None)
        if local:
            every = self._all_chunks(torch.stack(local))
            k = 0
            for i, split in enumerate(self.shards):
                if split is None:
                    continue
                acc = every[k][0]
                for c in every[k][1:]:
                    acc = acc + c
                sums[i] = acc
                k += 1
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        return total

    def _all_chunks(self, local: torch.Tensor) -> List[List[torch.Tensor]]:
        """Every sharded leaf's M chunk sums in model-rank order, from
        ``local`` (this process's [n_sharded · nm] sums)."""
        n_leaves = sum(s is not None for s in self.shards)
        M = self.dist.model_size
        if not self.dist.is_fleet:
            v = local.reshape(n_leaves, M)
            return [list(v[i].unbind()) for i in range(n_leaves)]
        import torch.distributed as tdist

        host = local.detach().to("cpu", copy=True)
        parts = [torch.empty_like(host) for _ in range(self.dist.n_processes)]
        tdist.all_gather(parts, host)
        nm = self.dist.local_grid[1]
        owner = {}  # model rank -> (process, its index there)
        for q in range(self.dist.n_processes):
            _, _, _, m_lo = self.dist.process_grid(q)
            for j in range(nm):
                owner.setdefault(m_lo + j, (q, j))
        every = torch.stack([torch.stack([
            parts[owner[m][0]].reshape(n_leaves, nm)[i, owner[m][1]]
            for m in range(M)]) for i in range(n_leaves)]).to(local.device)
        return [list(every[i].unbind()) for i in range(n_leaves)]


def _leaf_paths(tree: Any, keys: Tuple[str, ...] = ()
                ) -> List[Tuple[str, ...]]:
    """The key paths of ``tree``'s leaves in ``optim.adamw._leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k],
                                                             keys + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, keys + (str(i),))]
    return [keys]

def _block(lo: int, w: int, M: int) -> Tuple[int, int, int, int]:
    """Ranks [lo, lo + w) of a (groups, M) grid as (groups, model ranks
    per group, first group, first model rank)."""
    if w % M and M % w:
        raise ValueError(
            f"a span of {w} ranks neither holds whole model groups nor "
            f"falls inside one ({M} model ranks); pick a grid whose model "
            f"axis and ranks per process divide one another")
    if w >= M:
        return w // M, M, lo // M, 0
    return 1, w, lo // M, lo % M


def make_context(mesh, fsdp: bool = False) -> DistContext:
    """Build a DistContext from an ``EmulatedMesh`` or a Topology.

    A Topology built from a mesh (``Topology.from_mesh``, or a fleet's
    ``Topology.multiprocess(mesh=...)``, whose grid runs across the
    processes) gives its mesh, as the reference's does; one without
    (``Topology.local``, a fleet with no grid) has no named axes to give
    a model its batch / model axes, and raises.
    """
    from .topology import Topology, TopologyError

    if isinstance(mesh, Topology):
        if mesh.mesh is None:
            hint = ("Topology.multiprocess(mesh=make_mesh((1, P), "
                    "('data', 'model')))" if mesh.is_multiprocess else
                    "Topology.from_mesh(make_production_mesh())")
            raise TopologyError(
                f"make_context needs named (data/model[/pod]) axes; this "
                f"{mesh.kind!r} topology has none: build it over a grid, "
                f"{hint}")
        mesh = mesh.mesh
    names = mesh.axis_names
    if "pod" in names:
        batch = ("pod", "data")
        pod = "pod"
    else:
        batch = ("data",)
        pod = None
    return DistContext(
        mesh=mesh,
        batch_axes=batch,
        model_axis="model",
        pod_axis=pod,
        fsdp_axis="data" if fsdp else None,
    )


def check_dist(dist) -> None:
    """Raise unless ``dist`` is None or a DistContext."""
    if dist is not None and not isinstance(dist, DistContext):
        raise TypeError(f"dist must be a DistContext or None, got "
                        f"{type(dist).__name__}")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard(x, dist: Optional[DistContext], spec):
    """The identity (one device holds every rank's slice), after the
    check the reference's sharding constraint makes: each dim that
    ``spec`` shards divides by the size of its axes."""
    check_dist(dist)
    if dist is None or spec is None:
        return x
    for dim, entry in enumerate(spec):
        n = math.prod(dist.axis_size(a) for a in _axes(entry))
        if dist.is_fleet and _axes(entry) == tuple(dist.batch_axes):
            n = dist.local_grid[0]  # this process's data groups
        if x.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of shape {tuple(x.shape)} is not divisible by "
                f"{n} (axes {_axes(entry)} of {dict(dist.mesh.shape)})")
    return x


def logical_to_spec(dist: Optional[DistContext], *roles: Optional[str]):
    """Map logical dim roles to a spec: a tuple with one entry per dim.

    Roles: 'batch' | 'model' | 'fsdp' | 'vocab' | None (replicated).
    Returns None when dist is None (unsharded execution).
    """
    if dist is None:
        return None
    out = []
    for r in roles:
        if r == "batch":
            out.append(dist.batch_axes)
        elif r in ("model", "vocab"):
            out.append(dist.model_axis)
        elif r == "fsdp":
            out.append(dist.fsdp_axis)
        else:
            out.append(None)
    return tuple(out)
