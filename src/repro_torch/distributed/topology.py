"""Topology: the execution substrate a handle runs on.

Port of ``repro/distributed/topology.py``. Three kinds of substrate:

* ``Topology.local(P, device)``: P ranks emulated on ONE device. It has
  no tiers, so ``network()`` returns the model network unchanged (the
  paper's TSUBAME-like one by default) and ``SpmmConfig(net="auto")``
  decides exactly as the reference does on a flat substrate; for the
  same reason ``hier="auto"`` groups the ranks by ``fallback_grouping``,
  the reference's guess for a substrate with no intrinsic (G, L)
  structure.
* ``Topology.from_mesh(mesh, device)``: the ranks of an ``EmulatedMesh``
  (``launch.mesh``), still on one device; a two-axis mesh with both axes
  >= 2 contributes its shape as intrinsic tiers, and ``make_context``
  takes the topology for the mesh's named axes.
* ``Topology.multiprocess(device=...)``: a ``torch.distributed`` fleet
  (``launch.multiprocess.initialize``). Each process owns a contiguous
  span of the P = processes × local ranks (``span``; every process's in
  ``spans``), runs the executors on that span's exec arrays and
  exchanges rows with the other processes through ``comm.ProcessComm``;
  the processes × local grid is the intrinsic (G, L) structure, the
  process boundary its slow tier. With ``mesh=`` the fleet's ranks also
  form a named grid, which ``make_context`` takes for a model's batch /
  model axes.

With tiers, ``network()`` derives the reference's two-tier
``NetworkSpec`` (``derived-{gpu,cpu}-GxL``, platform from the device)
and ``auto_grouping`` returns the tiers. ``replicated_mesh(c, s)`` lays
the ranks out as the replicated tier's (c, s) replica × shard mesh,
``comm(groups, replicas)`` gives the communicator of a layout (a
``LocalComm``, or a ``ProcessComm`` over this process's span), and
``put_global(b)`` places an operand: on a fleet, only this process's
rows. ``narrow(P)`` serves a smaller ladder rung on the first P ranks,
and ``fingerprint()`` names the substrate in the measured autotuner's
cache keys (the device's name included, so an entry timed on another
card misses).

``subtopology(slice)`` / ``split(sizes)`` carve the ranks into GROUPS for
the fleet (``serving.fleet``): a group is a contiguous span of the
ranks, served by its own communicator of the group's width, and
``group`` records its absolute (start, stop) span.

On a fleet of processes both keep the processes: ``spans`` is clipped to
the narrowed or carved ranks and rebased to the group's own rank
indices, so a process may hold fewer ranks than ``local_device_count``,
or none (an empty span, ``(lo, lo)``). Such a process still enters every
collective of a call, and returns no C rows.

Entry points default to ``device="cuda"`` and raise when no CUDA device
is present; pass ``device="cpu"`` to run the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .comm import LocalComm, ProcessComm

__all__ = ["Topology", "TopologyError", "fallback_grouping",
           "resolve_device"]


class TopologyError(ValueError):
    """A topology cannot satisfy the requested execution substrate."""


def fallback_grouping(P: int, group_size: int) -> Optional[Tuple[int, int]]:
    """Largest fast-tier group size L | P with 2 <= L <= ``group_size``,
    as (G, L) = (P // L, L); None when no such L leaves G >= 2."""
    for L in range(min(int(group_size), P - 1), 1, -1):
        if P % L == 0 and P // L >= 2:
            return P // L, L
    return None


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` as a torch.device; CUDA must really be there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run the kernels' plain "
                "versions instead")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


# the reference's bandwidths of a derived two-tier network, by platform:
# (fast tier, slow tier, name) in bytes/s — constants of the α-β model
_DERIVED_NETS = {"gpu": (450e9, 25e9, "derived-gpu"),
                 "cpu": (50e9, 10e9, "derived-cpu")}


@dataclasses.dataclass(frozen=True)
class Topology:
    """P ranks and the substrate they run on.

    ``kind``    'local' (P ranks on one device), 'mesh' (the ranks of an
                ``EmulatedMesh``, on one device) or 'multiprocess' (a
                ``torch.distributed`` fleet; this process runs ``span``).
    ``P``       number of ranks.
    ``device``  the torch device this process's ranks' tensors live on.
    ``group``   for a sub-topology carved out of a parent substrate, its
                absolute (start, stop) rank span: it names a GROUP, not
                the whole fleet, so the elastic grow path must not
                silently escape it. None for a whole substrate.
    ``tiers``   intrinsic (G, L) two-tier structure when the substrate
                has one (a two-axis mesh's shape; processes × local
                ranks); None for flat substrates.
    ``n_hosts`` process count (1 unless 'multiprocess').
    ``process_index``       this process's index in the fleet.
    ``local_device_count``  ranks this process runs (a fleet's ranks
                per process; None on one device, which runs all P).
    ``spans``   on a fleet, the (start, stop) run of ranks each process
                holds, in process order: contiguous, covering [0, P);
                a run may be shorter than ``local_device_count`` or
                empty once the fleet is narrowed or carved. None on one
                device.
    ``mesh``    the adopted ``EmulatedMesh`` ('mesh'; on a fleet, the
                grid ``multiprocess(mesh=...)`` names, over the processes).
    """

    kind: str
    P: int
    device: torch.device
    group: Optional[Tuple[int, int]] = None
    tiers: Optional[Tuple[int, int]] = None
    n_hosts: int = 1
    process_index: int = 0
    local_device_count: Optional[int] = None
    mesh: Any = dataclasses.field(default=None, repr=False, compare=False)
    spans: Optional[Tuple[Tuple[int, int], ...]] = None

    def __post_init__(self):
        if self.is_multiprocess and self.spans is None:
            w = int(self.local_device_count)
            object.__setattr__(self, "spans", tuple(
                (i * w, (i + 1) * w) for i in range(self.n_hosts)))

    @classmethod
    def local(cls, P: int, device: Union[str, torch.device, None] = "cuda"
              ) -> "Topology":
        """``P`` ranks on ``device``."""
        P = int(P)
        if P < 1:
            raise TopologyError(f"topology needs at least 1 rank, got {P}")
        return cls(kind="local", P=P, device=resolve_device(device))

    @classmethod
    def from_mesh(cls, mesh, device: Union[str, torch.device, None] = "cuda"
                  ) -> "Topology":
        """Adopt an ``EmulatedMesh``: its ranks, and its shape as structure.

        A two-axis mesh with both axes >= 2 contributes its (G, L) shape
        as intrinsic tiers — ``hier="auto"`` then groups along the mesh's
        own axes instead of sweeping divisors of ``net.group_size``.
        """
        shape = tuple(int(n) for n in mesh.shape.values())
        tiers = None
        if len(shape) == 2 and shape[0] >= 2 and shape[1] >= 2:
            tiers = shape
        return cls(kind="mesh", P=int(mesh.size),
                   device=resolve_device(device), tiers=tiers, mesh=mesh)

    @classmethod
    def multiprocess(cls, device: Union[str, torch.device, None] = "cuda",
                     mesh=None) -> "Topology":
        """The ``torch.distributed`` fleet (call after
        ``launch.multiprocess.initialize``).

        Each process runs ``local`` ranks (``REPRO_MP_LOCAL_DEVICES``,
        which the launcher sets; 1 without it); P = processes × local,
        process i running the ranks
        [i·local, (i+1)·local). The processes × local grid is the
        intrinsic (G, L) structure (the process boundary = slow tier)
        when local >= 2. A CUDA fleet runs process i on
        ``cuda:{i % torch.cuda.device_count()}`` — every process on
        ``cuda:0`` of a one-card machine.

        ``mesh`` (an ``EmulatedMesh`` of P ranks, e.g. ``make_mesh((1, 8),
        ("data", "model"))``) names the fleet's ranks as a grid: its ranks
        are the grid's row-major indices, process i holding [i·local,
        (i+1)·local), and ``make_context`` takes the topology for the
        grid's named axes, whose collectives then run across the
        processes (``comm.ProcessMeshComm``).
        """
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() < 2:
            raise TopologyError(
                "Topology.multiprocess() needs an initialized "
                "torch.distributed fleet with >= 2 processes; run under "
                "repro_torch.launch.multiprocess (or call its initialize "
                "yourself). For one process use Topology.local(P).")
        n_proc, rank = int(dist.get_world_size()), int(dist.get_rank())
        local = int(os.environ.get("REPRO_MP_LOCAL_DEVICES", "1"))
        if local < 1:
            raise TopologyError(f"a fleet needs >= 1 rank per process, "
                                f"got {local}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)  # raises without a card
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        fleet_mesh = None
        if mesh is not None:
            from ..launch.mesh import EmulatedMesh

            if int(mesh.size) != n_proc * local:
                raise TopologyError(
                    f"mesh {dict(mesh.shape)} has {mesh.size} ranks; the "
                    f"fleet has {n_proc} processes x {local} = "
                    f"{n_proc * local}")
            fleet_mesh = EmulatedMesh(
                tuple(mesh.shape.values()), mesh.axis_names,
                span=(rank * local, (rank + 1) * local))
        return cls(kind="multiprocess", P=n_proc * local,
                   device=resolve_device(dev),
                   tiers=(n_proc, local) if local >= 2 else None,
                   n_hosts=n_proc, process_index=rank,
                   local_device_count=local, mesh=fleet_mesh)

    @classmethod
    def resolve(cls, where: Union["Topology", int, None],
                device: Union[str, torch.device, None] = "cuda",
                expect_p: Optional[int] = None) -> "Topology":
        """Normalize every accepted substrate spelling to a Topology.

        A ``Topology`` passes through; an int P becomes ``local(P,
        device)``. ``None`` is the reference's "every local device": one
        device emulates any number of ranks, so here it means the ranks
        the caller needs, ``local(expect_p, device)``, and it needs
        ``expect_p``.

        ``expect_p``: the rank count the plan requires; a mismatch raises
        a ``TopologyError`` naming the expected and resolved counts and
        the accepted coercions.
        """
        if isinstance(where, Topology):
            topo = where
        elif where is None:
            if expect_p is None:
                raise TopologyError(
                    "Topology.resolve(None) needs expect_p: one device "
                    "emulates any number of ranks, so pass the int P or a "
                    "Topology")
            topo = cls.local(int(expect_p), device)
        elif isinstance(where, (int, np.integer)) and not isinstance(
                where, bool):
            topo = cls.local(int(where), device)
        else:
            raise TypeError(
                f"cannot resolve a Topology from {type(where).__name__!r}; "
                f"pass a Topology, an int P (the number of ranks to "
                f"emulate on the device), or None")
        if expect_p is not None and topo.P != int(expect_p):
            want = int(expect_p)
            raise TopologyError(
                f"this plan needs a topology with exactly {want} rank(s) "
                f"(P={want}), but the given {topo.kind!r} topology with "
                f"{topo.P} rank(s) was resolved; accepted coercions: a "
                f"Topology over {want} ranks, the int {want}, or None "
                f"({want} ranks on the device)")
        return topo

    # ----- structure ---------------------------------------------------

    @property
    def is_multiprocess(self) -> bool:
        return self.kind == "multiprocess"

    @property
    def span(self) -> Tuple[int, int]:
        """The (start, stop) ranks this process runs: all P of them on
        one device, its entry of ``spans`` on a fleet."""
        if not self.is_multiprocess:
            return 0, self.P
        return self.spans[self.process_index]

    def comm(self, groups: int = 1, replicas: int = 1):
        """The communicator of a rank layout on this substrate: a
        ``LocalComm(P, groups, replicas)`` on one device, a
        ``ProcessComm`` over this process's span on a fleet."""
        if self.is_multiprocess:
            return ProcessComm(self.P, groups, replicas, span=self.span,
                               spans=self.spans)
        return LocalComm(self.P, groups, replicas)

    def replicated_mesh(self, c: int, s: int):
        """The (c, s) replica × shard layout of the ranks, as the
        communicator ``comm(replicas=c)``: lane-major, lane r is the
        contiguous rank range [r·s, (r+1)·s) and the replica axis strides
        s (the reference's ``Topology.replicated_mesh``)."""
        c, s = int(c), int(s)
        if c < 1 or s < 1 or self.P != c * s:
            raise TopologyError(
                f"topology has {self.P} ranks, need c*s={c * s}")
        return self.comm(replicas=c)

    def auto_grouping(self, net) -> Optional[Tuple[int, int]]:
        """The (G, L) grouping ``hier="auto"`` evaluates: intrinsic tiers
        win (a two-axis mesh, a fleet of processes); otherwise the largest
        L | P with 2 <= L <= ``net.group_size``."""
        if self.tiers is not None:
            G, L = self.tiers
            if G >= 2 and L >= 2 and G * L == self.P:
                return G, L
        return fallback_grouping(self.P, int(net.group_size))

    def network(self, default=None):
        """The NetworkSpec ``net="auto"`` scores against.

        With tiers, the reference's derived two-tier spec: the outer axis
        (between processes, between a mesh's groups) is the slow tier,
        ``group_size`` the inner width, bandwidths by the device's
        platform. A flat substrate carries no structural information, so
        ``default`` (the TSUBAME-like model network unless a caller
        overrides) comes back unchanged.
        """
        from ..core.comm_model import TSUBAME_LIKE, NetworkSpec

        if self.tiers is None:
            return TSUBAME_LIKE if default is None else default
        G, L = self.tiers
        bw_intra, bw_inter, name = _DERIVED_NETS[self.platform]
        return NetworkSpec(f"{name}-{G}x{L}", bw_intra, bw_inter,
                           group_size=L)

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else "cpu"

    def narrow(self, P: int) -> "Topology":
        """The same substrate over the first ``P`` ranks: the elastic
        path, where a ladder rung smaller than the fleet serves (the
        reference's ``narrow``: no tiers). On a fleet every process
        stays, its span clipped to the first P ranks: 2 × 4 narrowed to
        6 holds [(0, 4), (4, 6)], to 4 [(0, 4), (4, 4)]."""
        P = int(P)
        if P == self.P:
            return self
        if P > self.P:
            raise TopologyError(
                f"cannot narrow a {self.P}-rank topology to P={P}; grow "
                f"events need a topology over the new fleet "
                f"(Topology.local / Topology.multiprocess)")
        if P < 1:
            raise TopologyError(f"topology needs at least 1 rank, got {P}")
        return self._carved(0, P, group=self.group)

    def subtopology(self, rank_slice: slice) -> "Topology":
        """A same-kind topology over a contiguous span of the ranks.

        The fleet-carving primitive: the result names a GROUP of the
        parent substrate — ``group`` records the absolute (start, stop)
        span, so sessions placed on it cannot silently escape back onto
        the full fleet, and ``fingerprint()`` is the carved span's, not
        the parent's. On a fleet each process's span is cut to the
        group and rebased to its ranks: [2, 6) of 2 × 4 holds [(0, 2),
        (2, 4)].
        """
        start, stop, step = rank_slice.indices(self.P)
        if step != 1:
            raise TopologyError(
                f"subtopology needs a contiguous device span, got "
                f"step={step}; carve with slice(start, stop)")
        if stop - start < 1:
            raise TopologyError(
                f"subtopology span [{start}:{stop}] of a {self.P}-device "
                f"topology is empty")
        base = self.group[0] if self.group is not None else 0
        return self._carved(start, stop, group=(base + start, base + stop))

    def _carved(self, start: int, stop: int, group) -> "Topology":
        """The ranks [start, stop), renumbered from 0, with no tiers and
        no grid; on a fleet the spans intersected with them."""
        spans = None
        if self.is_multiprocess:
            cut = lambda r: min(max(r, start), stop) - start  # noqa: E731
            spans = tuple((cut(lo), cut(hi)) for lo, hi in self.spans)
        return dataclasses.replace(self, P=stop - start, tiers=None,
                                   mesh=None, group=group, spans=spans)

    def split(self, sizes: Tuple[int, ...]) -> Tuple["Topology", ...]:
        """Carve the substrate into disjoint contiguous sub-topologies.

        ``sizes`` are the per-group rank counts, in rank order; they must
        each be >= 1 and sum to at most P (a trailing remainder of the
        fleet is simply left uncarved).
        """
        sizes = tuple(int(s) for s in sizes)
        if not sizes:
            raise TopologyError("split needs at least one group size")
        if any(s < 1 for s in sizes):
            raise TopologyError(f"split sizes must each be >= 1, got {sizes}")
        if sum(sizes) > self.P:
            raise TopologyError(
                f"split sizes {sizes} sum to {sum(sizes)}, but the "
                f"topology has only {self.P} devices")
        groups, off = [], 0
        for size in sizes:
            groups.append(self.subtopology(slice(off, off + size)))
            off += size
        return tuple(groups)

    def describe(self) -> dict:
        """Stable summary for ``h.stats()``; ``group`` only when carved,
        so a whole substrate's ``describe()`` / ``fingerprint()`` stay
        byte-stable (autotune cache keys)."""
        d = {"kind": self.kind, "P": self.P, "tiers": self.tiers,
             "n_hosts": self.n_hosts, "platform": self.platform}
        if self.group is not None:
            d["group"] = self.group
        return d

    def device_kind(self) -> str:
        """The card's name on CUDA (``torch.cuda.get_device_name``),
        ``"cpu"`` otherwise."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def fingerprint(self) -> str:
        """Stable identity of the execution substrate (autotune cache
        key): ``describe()`` plus the device kind, so measured timings
        from another card never replay here."""
        d = self.describe()
        d["device_kind"] = self.device_kind()
        blob = json.dumps(d, sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()

    # ----- data placement ----------------------------------------------

    def put_global(self, b, rows: Optional[int] = None) -> torch.Tensor:
        """Place a dense operand [rows, N], row-partitioned over the P
        ranks, on this substrate.

        One device: the whole operand on ``device`` (a tensor already
        there and contiguous passes through). A fleet: only this
        process's rows, [span · rows / P, N], on its device — the full
        operand is never placed on the device; a process with an empty
        span gets [0, N]. A tensor that already is
        this process's slab passes through (moved to the device if need
        be), so one handle's output feeds the next; a full operand (a
        numpy array or a tensor with ``rows`` rows) is cut on the host
        side of its device and copied, so the result never shares memory
        with the caller's. ``rows`` is the operand's global row count
        (default: ``b``'s own).
        """
        if not self.is_multiprocess:
            if not isinstance(b, torch.Tensor):
                b = torch.from_numpy(np.ascontiguousarray(b))
            return b.to(self.device).contiguous()
        lo, hi = self.span
        n_rows = int(b.shape[0])
        rows = n_rows if rows is None else int(rows)
        if rows % self.P:
            raise TopologyError(f"{rows} rows do not split over P={self.P} "
                                f"ranks")
        per = rows // self.P
        if isinstance(b, torch.Tensor) and n_rows == (hi - lo) * per \
                and n_rows != rows:
            return b.to(self.device).contiguous()
        if n_rows != rows:
            raise TopologyError(
                f"operand has {n_rows} rows: neither the whole [{rows}, N] "
                f"nor this process's [{(hi - lo) * per}, N] slab")
        if isinstance(b, torch.Tensor):
            return b[lo * per:hi * per].to(self.device, copy=True
                                            ).contiguous()
        return torch.from_numpy(np.array(b[lo * per:hi * per])).to(
            self.device).contiguous()
