"""Topology: the execution substrate a handle runs on.

Port of ``repro/distributed/topology.py`` for this slice: P ranks
emulated on ONE device (``Topology.local(P, device)``). The substrate has
no tiers, so ``network()`` returns the model network unchanged (the
paper's TSUBAME-like one by default) and ``SpmmConfig(net="auto")``
decides exactly as the reference does on a flat substrate. For the same
reason ``hier="auto"`` groups the ranks by ``fallback_grouping``, the
reference's guess for a substrate with no intrinsic (G, L) structure.
``replicated_mesh(c, s)`` lays the ranks out as the replicated tier's
(c, s) replica × shard mesh. ``narrow(P)`` serves a smaller ladder rung
on the same device, and ``fingerprint()`` names the substrate in the
measured autotuner's cache keys (the device's name included, so an entry
timed on another card misses).

``subtopology(slice)`` / ``split(sizes)`` carve the ranks into GROUPS for
the fleet (``serving.fleet``): a group is a contiguous span of the
emulated ranks, served by its own ``LocalComm`` of the group's width on
the same device, and ``group`` records its absolute (start, stop) span.

Entry points default to ``device="cuda"`` and raise when no CUDA device
is present; pass ``device="cpu"`` to run the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .comm import LocalComm

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


@dataclasses.dataclass(frozen=True)
class Topology:
    """P ranks emulated on one device.

    ``kind``    'local' (the only kind in this slice).
    ``P``       number of ranks.
    ``device``  the torch device every rank's tensors live on.
    ``group``   for a sub-topology carved out of a parent substrate, its
                absolute (start, stop) rank span: it names a GROUP, not
                the whole fleet, so the elastic grow path must not
                silently escape it. None for a whole substrate.
    """

    kind: str
    P: int
    device: torch.device
    group: Optional[Tuple[int, int]] = None

    @classmethod
    def local(cls, P: int, device: Union[str, torch.device, None] = "cuda"
              ) -> "Topology":
        """``P`` ranks on ``device``."""
        P = int(P)
        if P < 1:
            raise TopologyError(f"topology needs at least 1 rank, got {P}")
        return cls(kind="local", P=P, device=resolve_device(device))

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

    def replicated_mesh(self, c: int, s: int) -> LocalComm:
        """The (c, s) replica × shard layout of the ranks, as a
        ``LocalComm(P, replicas=c)``: lane-major, lane r is the
        contiguous rank range [r·s, (r+1)·s) and the replica axis strides
        s (the reference's ``Topology.replicated_mesh``)."""
        c, s = int(c), int(s)
        if c < 1 or s < 1 or self.P != c * s:
            raise TopologyError(
                f"topology has {self.P} ranks, need c*s={c * s}")
        return LocalComm(self.P, replicas=c)

    def auto_grouping(self, net) -> Optional[Tuple[int, int]]:
        """The (G, L) grouping ``hier="auto"`` evaluates: one device has no
        tiers, so the largest L | P with 2 <= L <= ``net.group_size``."""
        return fallback_grouping(self.P, int(net.group_size))

    def network(self, default=None):
        """The NetworkSpec ``net="auto"`` scores against: ``default`` (the
        TSUBAME-like model network unless a caller overrides), since a
        flat substrate carries no tiers."""
        from ..core.comm_model import TSUBAME_LIKE

        return TSUBAME_LIKE if default is None else default

    def narrow(self, P: int) -> "Topology":
        """The same substrate over the first ``P`` ranks: the elastic
        path, where a ladder rung smaller than the fleet serves."""
        P = int(P)
        if P == self.P:
            return self
        if P > self.P:
            raise TopologyError(
                f"cannot narrow a {self.P}-rank topology to P={P}; grow "
                f"events need a topology over the new fleet "
                f"(Topology.local)")
        if P < 1:
            raise TopologyError(f"topology needs at least 1 rank, got {P}")
        return dataclasses.replace(self, P=P)

    def subtopology(self, rank_slice: slice) -> "Topology":
        """A same-kind topology over a contiguous span of the ranks.

        The fleet-carving primitive: the result names a GROUP of the
        parent substrate — ``group`` records the absolute (start, stop)
        span, so sessions placed on it cannot silently escape back onto
        the full fleet, and ``fingerprint()`` is the carved span's, not
        the parent's.
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
        return dataclasses.replace(self, P=stop - start,
                                   group=(base + start, base + stop))

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
        d = {"kind": self.kind, "P": self.P, "tiers": None, "n_hosts": 1,
             "platform": "gpu" if self.device.type == "cuda" else "cpu"}
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
