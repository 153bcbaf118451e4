"""repro_torch: SHIRO's distributed SpMM on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro``, slice by slice (see ROADMAP.md). It
imports ``torch`` and never ``jax`` or ``repro``: the host-side planner is
its own copy, the P ranks are emulated on one device, and every TPU
kernel on the path is a hand-written CUDA kernel (``csrc/``) with a plain
torch version beside it.

    from repro_torch import SpmmConfig, compile_spmm
    h = compile_spmm(a, 8, SpmmConfig(backends=("coo", "bsr")))
    c = h(b)          # on the card; device="cpu" runs the plain versions

    hf = compile_fused(adj, 8, edge="leaky_relu")   # FusedMM (GAT layers)
    c = hf(q, k, v)   # leaky_relu(A ⊙ (q kᵀ)) @ v through one comm phase
"""
from .core.api import (
    DistSpmm, SpmmConfig, compile_fused, compile_sddmm, compile_spmm,
)
from .distributed.topology import Topology, TopologyError

__all__ = ["DistSpmm", "SpmmConfig", "compile_spmm", "compile_sddmm",
           "compile_fused", "Topology", "TopologyError"]
