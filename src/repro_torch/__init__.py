"""repro_torch: SHIRO's distributed SpMM on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro``, slice by slice (see ROADMAP.md). It
imports ``torch`` and never ``jax`` or ``repro``: the host-side planner is
its own copy, the P ranks are emulated on one device, and every TPU
kernel on the path is a hand-written CUDA kernel (``csrc/``) with a plain
torch version beside it.

    from repro_torch import SpmmConfig, compile_spmm
    h = compile_spmm(a, 8, SpmmConfig(backends=("coo", "bsr")))
    c = h(b)          # on the card; device="cpu" runs the plain versions

    hh = compile_spmm(a, 8, SpmmConfig(hier="auto"))   # two-tier (G, L)
    hr = compile_spmm(a, 8, SpmmConfig(replicate="auto"))  # 1.5D (c, s)

    hf = compile_fused(adj, 8, edge="leaky_relu")   # FusedMM (GAT layers)
    c = hf(q, k, v)   # leaky_relu(A ⊙ (q kᵀ)) @ v through one comm phase

    hm = compile_spmm(a, 8, measure=True)   # timed candidates, cached
    s = SpmmSession.build(a, 8, p_ladder=(4, 8))   # ladder + lifecycle
    s.on_resize(4); s.maybe_replan(a_new)

    server = SpmmWaveServer(s, max_batch=2)   # waves across swaps
    fleet = SpmmFleet(Topology.local(8), group_sizes=(4, 4))  # tenants

Across processes (one worker each, ``torch.distributed`` over gloo):

    python -m repro_torch.launch.multiprocess --nproc 2 --local-devices 4
    topo = repro_torch.launch.multiprocess.initialize()  # in a worker
    h = compile_spmm(a, topo, hier="auto")   # tiers (processes, local)
    c = h(b)          # this process's rows of C: h.row_blocks()
"""
from .core.api import (
    DistSpmm, SpmmConfig, compile_fused, compile_sddmm, compile_spmm,
)
from .core.session import SpmmSession
from .distributed.comm import ProcessComm
from .distributed.topology import Topology, TopologyError
from .robustness import (
    Fault, FaultPlan, InjectedFault, NumericalFault,
)
from .serving import (
    ReshardSpec, SpmmFleet, SpmmRequest, SpmmWaveServer, SpmmWaveStats,
)
from .train import ElasticController, MeshPlan, propose_mesh

# stamped into autotune cache keys (core.autotune)
__version__ = "0.1.0"

__all__ = ["DistSpmm", "SpmmConfig", "compile_spmm", "compile_sddmm",
           "compile_fused", "SpmmSession", "Topology", "TopologyError",
           "Fault", "FaultPlan", "InjectedFault", "NumericalFault",
           "SpmmRequest", "SpmmWaveServer", "SpmmWaveStats", "SpmmFleet",
           "ReshardSpec", "ElasticController", "MeshPlan", "propose_mesh",
           "ProcessComm", "launch_local", "Supervisor", "SupervisorPolicy"]

# the launcher's names load on first use: ``python -m
# repro_torch.launch.multiprocess`` imports this package first, and the
# module it runs must not be imported before it
_LAUNCH = ("launch_local", "Supervisor", "SupervisorPolicy")


def __getattr__(name):
    if name in _LAUNCH:
        from .launch import multiprocess

        return getattr(multiprocess, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
