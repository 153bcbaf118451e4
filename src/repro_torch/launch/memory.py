"""Per-executable device memory: the port of
``repro/launch/hlo_analysis.py::executable_memory``.

XLA reports what a compiled executable pins per device (arguments,
outputs, temporaries, minus donated aliases). An eager torch handle has
no compiled program to ask, so the port measures instead:
``executable_memory(call, device)`` runs ``call()`` once and reports the
peak bytes the caching allocator held during the call above what it held
before — ``total_allocation_size`` here is "what this call allocates",
its private operand copies included; other handles' tensors that were
already alive are not counted. A donated operand copy that the executor
releases after its last read lowers this figure.

Measuring resets torch's peak statistic (``reset_peak_memory_stats``);
``peak_allocated`` / ``reset_peak`` carry the peak across those resets,
so a caller that reports its own peak over a stretch of work reads the
same number as without them. On the CPU there are no allocator stats:
``executable_memory`` returns ``{}``, as the reference does on a backend
without memory stats.
"""
from __future__ import annotations

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
    """``(call(), profile)``: the peak bytes ``call`` allocates on
    ``device`` (``total_allocation_size``), with the allocator's peak and
    the bytes already allocated before it (``peak_allocated_bytes``,
    ``allocated_before_bytes``); ``profile`` is ``{}`` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return call(), {}
    idx = _index(device)
    before = torch.cuda.memory_allocated(idx)
    _carried[idx] = max(_carried.get(idx, 0),
                        torch.cuda.max_memory_allocated(idx))
    torch.cuda.reset_peak_memory_stats(idx)
    out = call()
    peak = torch.cuda.max_memory_allocated(idx)
    return out, {"total_allocation_size": int(peak - before),
                 "peak_allocated_bytes": int(peak),
                 "allocated_before_bytes": int(before)}


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
