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
(``comm.ProcessMeshComm``). Any grid of processes × local ranks runs: a
span is a ``Span`` of (data group, model rank) pairs — in general a
partial head group, whole middle groups and a partial tail group — and
holds the experts of its distinct model ranks (``local_span.models``,
not always a run).

What a train step needs of the grid: which processes hold each data
group (``group_processes``), which groups' rows this process counts in
the loss (``counted_groups``: those whose model rank 0 it holds, the
rank whose output the emulated grid returns), which slice of each
parameter it holds (``leaf_shards``: the MoE experts are split over the
model ranks, every other leaf is whole) and whose gradients make each
leaf's sum (``grad_sources``: an expert leaf's per model-rank chunk);
``GradShards`` sums a gradient tree's squares in one order on the
emulated grid and on a fleet.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..launch.mesh import EmulatedMesh
from .comm import ChunkSources, MeshComm

__all__ = ["DistContext", "Span", "make_context", "shard",
           "logical_to_spec", "check_dist", "GradShards"]


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
    def local_span(self) -> "Span":
        """This process's ranks as (data group, model rank) pairs: all of
        the grid on one device, its span on a fleet (``span_of``)."""
        return self.span_of(self.comm.proc if self.is_fleet else 0)

    def span_of(self, q: int) -> "Span":
        """Process q's ranks as a ``Span`` of the (batch groups, model)
        grid (the whole grid on one device)."""
        if not self.is_fleet:
            return Span.of(0, self.mesh.size, self.model_size)
        lo, hi = self.comm.spans[q]
        return Span.of(lo, hi, self.model_size)

    @property
    def local_grid(self) -> Tuple[int, int, int, int]:
        """The block of the (batch groups, model) grid this process runs,
        as (data groups, model ranks per group, first group, first model
        rank): all of the grid on one device; whole groups, or a run
        inside one, on a fleet. A block accessor, which the model paths
        do not use: they read ``local_span``, which names the ranks of
        any span. A span that cuts across groups is no block, and this
        raises there."""
        span = self.local_span
        if not span.is_block:
            raise ValueError(
                f"the span {self.span} of ranks is no block of the grid "
                f"(ranks {span.ranks}): read local_span")
        if not span.ranks:
            return 0, 0, 0, 0
        return (len(span.groups), len(span.models), span.groups[0],
                span.models[0])

    def local_rows(self, n: int) -> Tuple[int, int]:
        """The rows [start, stop) of an n-row batch that this process's
        data groups hold (all n on one device): every row of each group
        it touches, the groups a contiguous run."""
        dsz = self.batch_size_divisor
        if n % dsz:
            raise ValueError(f"batch {n} is not divisible by the batch axes "
                             f"{self.batch_axes} ({dsz} ranks)")
        groups, per = self.local_span.groups, n // dsz
        return groups[0] * per, (groups[-1] + 1) * per

    def local_batch(self, x):
        """``x``'s batch rows (dim 0) that this process holds."""
        if not self.is_fleet:
            return x
        lo, hi = self.local_rows(x.shape[0])
        return x[lo:hi]

    def gather_batch(self, local: np.ndarray, n: int) -> np.ndarray:
        """The whole n-row batch from every process's ``local`` rows
        (``local_batch`` of it): each data group's rows from the first
        process holding them (every holder has the same bits), the same
        result on every process. One all_gather, each process's rows
        padded to the most any process holds. The identity on one
        device."""
        if not self.is_fleet:
            return local
        import torch.distributed as dist

        per = n // self.batch_size_divisor
        spans = [self.span_of(q) for q in range(self.n_processes)]
        most = max(len(s.groups) for s in spans) * per
        local = np.ascontiguousarray(local)
        t = torch.from_numpy(local)
        if t.shape[0] < most:
            t = torch.cat([t, t.new_zeros((most - t.shape[0],)
                                          + tuple(t.shape[1:]))])
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        out = np.empty((n,) + local.shape[1:], local.dtype)
        done = set()
        for s, part in zip(spans, parts):
            for i, g in enumerate(s.groups):
                if g not in done:
                    done.add(g)
                    out[g * per:(g + 1) * per] = \
                        part[i * per:(i + 1) * per].numpy()
        return out

    # ----- what a train step needs of the grid ---------------------------

    @property
    def n_processes(self) -> int:
        """The processes the grid runs over (1 on one device)."""
        return self.comm.n_proc if self.is_fleet else 1

    def group_processes(self) -> List[List[int]]:
        """For each data group (the batch axes' ranks, ascending), the
        processes that hold any rank of it, ascending: one on one device
        or when a process holds whole groups, several when a group's
        model ranks are split over processes."""
        out: List[List[int]] = [[] for _ in range(self.batch_size_divisor)]
        for q in range(self.n_processes):
            for g in self.span_of(q).groups:
                out[g].append(q)
        return out

    @property
    def counted_groups(self) -> Tuple[int, ...]:
        """The data groups whose rows this process counts in the loss:
        each group once, by the process holding its model rank 0 (the
        rank whose output the emulated grid returns). The other
        processes of a group run the same forward and backward with a
        zero share for it (their exchanges pair up with the counting
        process's; their expert shards receive its gradients)."""
        return self.local_span.counted

    @property
    def counts_rows(self) -> bool:
        """Whether this process counts the rows of any data group
        (``counted_groups``): on a block span, whether it holds model
        rank 0 of its groups. A block accessor, as ``local_grid``: the
        loss reads ``counted_groups``."""
        return bool(self.counted_groups)

    def leaf_shards(self, params: Any, cfg
                    ) -> List[Optional[Tuple[int, int]]]:
        """For each leaf of ``params`` (``optim.adamw._leaves`` order):
        None where every process holds it whole, else (dim, M) — the MoE
        experts, split along ``dim`` over the M model ranks; this process
        holds the chunks of its model ranks (``local_span.models``, in
        ascending rank)."""
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

    def grad_sources(self, params: Any, cfg) -> List[List[Any]]:
        """For each leaf, and for each process q, whose gradients q's copy
        of the leaf sums. A whole leaf: the processes, in ascending data
        group, that count each group (its first process), each once. An
        expert leaf (``ChunkSources``): for each model rank m that q
        holds, in q's chunk order, every process that holds any rank
        (g, m), ascending, each once with the index of m's chunk there —
        its own autograd has summed the groups it holds. Every process
        computes every process's lists."""
        spans = [self.span_of(q) for q in range(self.n_processes)]
        firsts: List[int] = []
        for members in self.group_processes():
            if members[0] not in firsts:
                firsts.append(members[0])
        out = []
        for split in self.leaf_shards(params, cfg):
            if split is None:
                out.append([list(firsts) for _ in spans])
                continue
            out.append([ChunkSources(split[0], tuple(
                tuple((r, s.models.index(m)) for r, s in enumerate(spans)
                      if m in s.models)
                for m in mine.models)) for mine in spans])
        return out

    def grad_shards(self, params: Any, cfg) -> "GradShards":
        return GradShards(self, self.leaf_shards(params, cfg))

    def chunk_owners(self) -> Dict[int, Tuple[int, int]]:
        """Each model rank's first holder: {m: (process, the index of
        m's chunk in that process's expert leaves)}."""
        owner: Dict[int, Tuple[int, int]] = {}
        for q in range(self.n_processes):
            for j, m in enumerate(self.span_of(q).models):
                owner.setdefault(m, (q, j))
        return owner

    def gather_to_lead(self, x: torch.Tensor, dim: int
                       ) -> Optional[torch.Tensor]:
        """A sharded leaf made whole on the lead (process 0): ``x`` holds
        this process's model ranks' chunks along ``dim`` (``leaf_shards``'
        split, ascending rank); the lead gets every model rank's chunk in
        ascending rank, each from the first process that holds it (its
        own where it holds it), placed by the index of that rank in the
        holder's ranks, joined on the host; every other process gets
        None. A collective every process makes: each process that is
        first to hold a chunk the lead lacks sends its chunks once, as
        bytes. On one device (or the emulated grid) ``x`` is whole
        already and comes back as it is."""
        if not self.is_fleet:
            return x
        import torch.distributed as tdist

        mine = self.local_span.models
        size = x.shape[dim] // len(mine)  # one model rank's chunk
        owner = self.chunk_owners()
        senders = sorted({q for q, _ in owner.values()} - {0})
        me = self.comm.proc
        if me != 0 and me not in senders:
            return None
        host = x.detach().to("cpu").contiguous()
        if me != 0:
            tdist.send(host.reshape(-1).view(torch.uint8), dst=0)
            return None
        chunks = {m: host.narrow(dim, j * size, size)
                  for j, m in enumerate(mine)}
        for q in senders:
            buf = torch.empty_like(host)
            tdist.recv(buf.reshape(-1).view(torch.uint8), src=q)
            chunks.update((m, buf.narrow(dim, j * size, size))
                          for m, (o, j) in owner.items() if o == q)
        return torch.cat([chunks[m] for m in range(self.model_size)], dim)


@dataclasses.dataclass(frozen=True)
class Span:
    """A run of ranks of the row-major (batch groups, M) grid, as its
    (data group, model rank) pairs in rank order. In general a partial
    head group, whole middle groups and a partial tail group: ranks
    [3, 6) of M = 4 are (0, 3), (1, 0), (1, 1)."""

    ranks: Tuple[Tuple[int, int], ...]
    M: int

    @classmethod
    @functools.lru_cache(maxsize=None)
    def of(cls, lo: int, hi: int, M: int) -> "Span":
        return cls(tuple(divmod(r, M) for r in range(lo, hi)), int(M))

    @functools.cached_property
    def groups(self) -> Tuple[int, ...]:
        """The data groups it touches, ascending (a contiguous run)."""
        return tuple(sorted({g for g, _ in self.ranks}))

    @functools.cached_property
    def models(self) -> Tuple[int, ...]:
        """The distinct model ranks it holds, ascending: the order of its
        expert leaves' chunks. Not always a run: {0, 1, 3} above."""
        return tuple(sorted({m for _, m in self.ranks}))

    @property
    def counted(self) -> Tuple[int, ...]:
        """The groups whose model rank 0 it holds."""
        return tuple(g for g, m in self.ranks if m == 0)

    def runs(self) -> List[Tuple[int, int, int, int]]:
        """Per group it touches, ascending: (group, first rank index in
        the span, ranks of the group in it, index of the group's first
        model rank in ``models``). A group's model ranks are a run of M,
        so their chunks are a run of ``models`` too."""
        return list(self._runs)

    @functools.cached_property
    def _runs(self) -> Tuple[Tuple[int, int, int, int], ...]:
        out = []
        for g in self.groups:
            idx = [i for i, (h, _) in enumerate(self.ranks) if h == g]
            out.append((g, idx[0], len(idx),
                        self.models.index(self.ranks[idx[0]][1])))
        return tuple(out)

    @property
    def is_block(self) -> bool:
        """Whether it is a block of the grid: every group it touches
        holds the same model ranks (whole groups, or a run inside one)."""
        return len(self.ranks) == len(self.groups) * len(self.models)


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
        nm = len(self.dist.local_span.models)
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
        ``local`` (this process's [n_sharded · nm] sums; every process of
        a fleet holds min(w, M) model ranks, so as many sums)."""
        n_leaves = sum(s is not None for s in self.shards)
        M = self.dist.model_size
        if not self.dist.is_fleet:
            v = local.reshape(n_leaves, M)
            return [list(v[i].unbind()) for i in range(n_leaves)]
        import torch.distributed as tdist

        host = local.detach().to("cpu", copy=True)
        parts = [torch.empty_like(host) for _ in range(self.dist.n_processes)]
        tdist.all_gather(parts, host)
        nm = len(self.dist.local_span.models)
        owner = self.dist.chunk_owners()
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
            n = len(dist.local_span.groups)  # this process's data groups
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
