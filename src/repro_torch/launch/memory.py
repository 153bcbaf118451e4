"""Per-executable device memory: the port of
``repro/launch/hlo_analysis.py::executable_memory``.

XLA reports what a compiled executable pins per device (arguments,
outputs, temporaries, minus donated aliases). An eager torch handle has
no compiled program to ask, so the port measures instead:
``executable_memory(call, device)`` runs ``call()`` once and reports the
peak bytes the call's tensors requested above those requested before it
(torch's ``requested_bytes`` statistic) — ``total_allocation_size`` here
is "what this call allocates", its private operand copies included;
other handles' tensors that were already alive are not counted. Like
XLA's figure it counts the program's own bytes: the caching allocator's
rounding, and the spare bytes of a cached block it hands out whole,
depend on what earlier calls freed, and are left out. A donated operand
copy, reused for C after its last read, lowers this figure.

Measuring resets torch's peak statistic (``reset_peak_memory_stats``);
``peak_allocated`` / ``reset_peak`` carry the peak across those resets,
so a caller that reports its own peak over a stretch of work reads the
same number as without them. On the CPU there are no allocator stats:
``executable_memory`` returns ``{}``, as the reference does on a backend
without memory stats.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Tuple

import torch

__all__ = ["executable_memory", "peak_allocated", "reset_peak"]

# device index -> the highest peak seen before executable_memory reset it
_carried: Dict[int, int] = {}


def _index(device) -> int:
    device = torch.device(device) if device is not None else \
        torch.device("cuda", torch.cuda.current_device())
    return torch.cuda.current_device() if device.index is None \
        else device.index


def executable_memory(call: Callable[[], Any], device
                      ) -> Tuple[Any, Dict[str, int]]:
    """``(call(), profile)``: the peak bytes ``call``'s tensors request on
    ``device`` above those requested before it (``total_allocation_size``),
    with that peak and the bytes requested before it
    (``peak_requested_bytes``, ``requested_before_bytes``); ``profile``
    is ``{}`` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return call(), {}
    idx = _index(device)
    # earlier work's cyclic garbage, freed mid-call, would offset the
    # call's own bytes: collect it first
    gc.collect()
    key = "requested_bytes.all."
    before = torch.cuda.memory_stats(idx)[key + "current"]
    _carried[idx] = max(_carried.get(idx, 0),
                        torch.cuda.max_memory_allocated(idx))
    torch.cuda.reset_peak_memory_stats(idx)
    out = call()
    peak = torch.cuda.memory_stats(idx)[key + "peak"]
    return out, {"total_allocation_size": int(peak - before),
                 "peak_requested_bytes": int(peak),
                 "requested_before_bytes": int(before)}


def peak_allocated(device=None) -> int:
    """``torch.cuda.max_memory_allocated`` since the last ``reset_peak``,
    including the peaks ``executable_memory`` reset away."""
    idx = _index(device)
    return max(_carried.get(idx, 0), torch.cuda.max_memory_allocated(idx))


def reset_peak(device=None) -> None:
    """``torch.cuda.reset_peak_memory_stats`` and the carried peak too."""
    idx = _index(device)
    _carried.pop(idx, None)
    torch.cuda.reset_peak_memory_stats(idx)
