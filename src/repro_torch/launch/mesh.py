"""Mesh construction: named grids of ranks emulated on one device.

Port of ``repro/launch/mesh.py``. The reference builds a ``jax`` device
mesh; the port runs every rank on one card, so a mesh here is an
``EmulatedMesh``: the grid's axis names and sizes, and the ``MeshComm``
whose log records the collectives that run over its axes. It holds no
devices — a model stacks its per-rank tensors with one leading dim per
axis and runs the ranks as batched tensor operations.

Axis semantics (the reference's):
  pod   — slow tier (between pods). SHIRO's inter-group axis.
  data  — fast tier (inside a pod). Batch + FSDP + SHIRO intra-group.
  model — tensor / expert parallelism.

``make_production_mesh`` is a descriptor of the reference's production
grid: nothing runs its 256 or 512 ranks.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from ..distributed.comm import MeshComm, ProcessMeshComm

__all__ = ["EmulatedMesh", "make_production_mesh", "make_mesh",
           "make_spmm_mesh"]


class EmulatedMesh:
    """A named grid of ranks on one device.

    ``shape`` maps each axis name to its size in the grid's order (as
    ``jax.sharding.Mesh.shape`` does), ``axis_names`` lists the names and
    ``size`` is the number of ranks. ``comm`` runs and logs the
    collectives over the named axes. With ``span`` the grid runs over the
    ``torch.distributed`` fleet (``Topology.multiprocess(mesh=...)``):
    its ranks are numbered row-major in the axis order, this process
    holds the ranks [lo, hi) of ``span``, and ``comm`` is a
    ``ProcessMeshComm``.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 span: Optional[Tuple[int, int]] = None):
        shape = tuple(int(n) for n in shape)
        axes = tuple(str(a) for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh needs one distinct name per axis, got "
                             f"shape {shape} and axes {axes}")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        self.axis_names: Tuple[str, ...] = axes
        self.shape = dict(zip(axes, shape))
        self.span = (0, self.size) if span is None else \
            (int(span[0]), int(span[1]))
        self.comm = MeshComm(self.shape) if span is None else \
            ProcessMeshComm(self.shape, span=self.span)

    @property
    def is_fleet(self) -> bool:
        """Whether the grid runs over a process group (this process holds
        ``span`` of its ranks)."""
        return isinstance(self.comm, ProcessMeshComm)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        if self.is_fleet:
            return f"EmulatedMesh({self.shape}, span={self.span})"
        return f"EmulatedMesh({self.shape})"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> EmulatedMesh:
    """The grid ``shape`` with axis names ``axes``, emulated on one device."""
    return EmulatedMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> EmulatedMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_spmm_mesh(P: int, groups: Optional[int] = None) -> EmulatedMesh:
    """The SHIRO SpMM executors' grid: flat (x,) or two-tier (g, l).

    The executors themselves take a ``Topology`` or a rank count; this is
    the reference's spelling of their mesh, for code that wants the grid.
    """
    if groups is None:
        return make_mesh((P,), ("x",))
    if P % groups:
        raise ValueError(f"P={P} not divisible by groups={groups}")
    return make_mesh((groups, P // groups), ("g", "l"))
