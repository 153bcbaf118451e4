"""Collective bytes and roofline terms from a step's collective log.

Port of ``repro/launch/hlo_analysis.py``, under its name so that a reader
finds the counterpart. The reference parses a compiled program's HLO text
for the operand bytes of every collective; the port has no compiled
program and no HLO, so ``collective_bytes`` reads the communicator's own
log instead (``distributed/comm.py``: each entry's rows beside their
bytes, rows × row width × element size). The reference's collective kinds
are kept as keys:

  all-to-all          ``all_to_all``, ``all_to_all@<axis>`` (and ``:meta``)
  collective-permute  ``ppermute``, ``ppermute@g`` / ``@s`` (the shifts)
  all-reduce          ``psum@<axis>``, ``pmax@<axis>``
  reduce-scatter      ``psum_scatter@l`` / ``@r``
  all-gather          ``all_gather@l``, ``broadcast@r`` (B's lane copy)

A compiled train step holds its backward's collectives too, so the
``bwd:`` entries count beside the forward's. ``parse_shape_bytes`` is not
carried: there is no HLO text to parse.

``roofline`` keeps the reference's formula and fields. ``HW`` holds the
reference's four keys with NVIDIA H100 SXM5 80GB **datasheet** figures,
not measurements: bf16 dense 989e12 FLOP/s, HBM3 3.35e12 B/s, NVLink
450e9 B/s per direction as ``ici_bw``, and one NDR 400 Gb/s NIC, 50e9
B/s, as ``dcn_bw``. The production grid's 16-wide model axis spans two
8-GPU NVLink nodes, so the ``collective`` term over ``ici_bw`` is a lower
bound; the record adds ``collective_slow`` (the same bytes over
``dcn_bw``) beside it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .memory import executable_memory

__all__ = ["DTYPE_BYTES", "collective_bytes", "collective_rows",
           "roofline", "executable_memory", "HW"]

HW = {
    "peak_flops": 989e12,  # bf16 dense FLOP/s per card (datasheet)
    "hbm_bw": 3.35e12,  # HBM3 bytes/s per card (datasheet)
    "ici_bw": 450e9,  # NVLink bytes/s per direction (datasheet)
    "dcn_bw": 50e9,  # one NDR 400 Gb/s NIC, bytes/s (datasheet)
}

DTYPE_BYTES = {
    dt: torch.empty((), dtype=dt).element_size() for dt in (
        torch.bool, torch.int8, torch.uint8, torch.float8_e4m3fn,
        torch.float8_e5m2, torch.int16, torch.float16, torch.bfloat16,
        torch.int32, torch.float32, torch.int64, torch.float64,
        torch.complex64, torch.complex128)
}

# the reference's collective kinds, by the port's op name (before "@")
_KINDS = {
    "all_to_all": "all-to-all",
    "ppermute": "collective-permute",
    "psum": "all-reduce",
    "pmax": "all-reduce",
    "psum_scatter": "reduce-scatter",
    "all_gather": "all-gather",
    "broadcast": "all-gather",
}


def _kind(op: str) -> str:
    name = op[4:] if op.startswith("bwd:") else op
    base = name.split("@")[0]
    if base not in _KINDS:
        raise ValueError(f"collective {op!r} has no HLO kind")
    return _KINDS[base]


def _ranks(comm) -> int:
    """The ranks whose collectives ``comm`` logs: its span on a fleet,
    every rank of its grid on one device."""
    span = getattr(comm, "span", None)
    if span is not None:
        return span[1] - span[0]
    return math.prod(comm.shape.values())


def collective_bytes(comm, per_rank: bool = True) -> Dict[str, float]:
    """Bytes by collective kind, plus ``"total"``, of every entry in
    ``comm``'s log (forward and ``bwd:``): all ranks' operand bytes, or
    (``per_rank``) those divided by the ranks that ran them — a device's
    share, the reference's per-device figure."""
    out: Dict[str, float] = {}
    for (op, _, _), nbytes in zip(comm.log, comm.nbytes):
        key = _kind(op)
        out[key] = out.get(key, 0) + nbytes
    if per_rank:
        n = _ranks(comm)
        out = {k: v / n for k, v in out.items()}
    out["total"] = sum(out.values())
    return out


def collective_rows(coll: Dict[str, float], n_dense: int,
                    sz_dt: int = 4) -> float:
    """Per-device collective bytes as buffer rows.

    The SHIRO executors only move [rows, n_dense] payloads through their
    collectives, so ``total / (n_dense · sz)`` is the per-device padded
    row count — directly comparable to
    ``SpmmPlan.volume_rows_padded(schedule) / P``.
    """
    return coll.get("total", 0) / float(n_dense * sz_dt)


def roofline(cost: dict, coll: Dict[str, float], *, chips: int,
             model_flops: Optional[float] = None, steps_per_call: int = 1,
             hw: Optional[dict] = None) -> dict:
    """Three roofline terms (seconds) + bottleneck + useful-flops ratio.

    ``cost`` holds per-chip ``flops`` and ``bytes accessed``; ``coll``
    per-chip collective bytes (``"total"``); ``model_flops`` the global
    useful flops of the call (6·N·D style), if known. ``hw`` defaults to
    ``HW``. The reference's fields, plus ``collective_slow``: the
    collective bytes over ``dcn_bw``.
    """
    hw = HW if hw is None else hw
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.get("total", 0))
    terms = {"compute": flops / hw["peak_flops"],
             "memory": bytes_acc / hw["hbm_bw"],
             "collective": cbytes / hw["ici_bw"]}
    bottleneck = max(terms, key=terms.get)
    out = {
        **terms,
        "bottleneck": bottleneck,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": cbytes,
        "bound_time": max(terms.values()),
        "collective_slow": cbytes / hw["dcn_bw"],
    }
    if model_flops:
        total_hlo = flops * chips
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = (model_flops / total_hlo
                                     if total_hlo else 0.0)
        # roofline fraction: useful work / (what the dominant term costs)
        t_ideal = model_flops / (chips * hw["peak_flops"])
        out["roofline_fraction"] = (t_ideal / out["bound_time"]
                                    if out["bound_time"] else 0.0)
    return out
