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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from ..launch.mesh import EmulatedMesh
from .comm import MeshComm

__all__ = ["DistContext", "make_context", "shard", "logical_to_spec",
           "check_dist"]


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


def make_context(mesh, fsdp: bool = False) -> DistContext:
    """Build a DistContext from an ``EmulatedMesh`` or a Topology.

    A Topology built from a mesh (``Topology.from_mesh``) gives its mesh,
    as the reference's does; one without (``Topology.local``, a fleet of
    processes) has no named axes to give a model its batch / model axes,
    and raises.
    """
    from .topology import Topology, TopologyError

    if isinstance(mesh, Topology):
        if mesh.mesh is None:
            raise TopologyError(
                "make_context needs named (data/model[/pod]) axes; build "
                "the Topology from a mesh (Topology.from_mesh(make_"
                "production_mesh())) instead of a bare device count")
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
