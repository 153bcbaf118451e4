"""SHIRO core for the port: host-side planning (copies of the reference's
NumPy modules), the local backends, the flat SpMM / SDDMM / FusedMM
executors and the front door."""
from .api import (
    DistSpmm, SpmmConfig, compile_fused, compile_sddmm, compile_spmm,
)
from .comm_model import (
    NetworkSpec, TSUBAME_LIKE, choose_fused_schedule, choose_schedule,
    modeled_time, strategy_volumes,
)
from .comm_schedule import (
    CommRound, CommSchedule, build_comm_schedule, single_round_schedule,
)
from .dist_sddmm import (
    EDGE_FNS, flat_fused, flat_sddmm, flat_spmm_values, fused_sddmm_spmm,
)
from .dist_spmm import (
    FlatExecPlan, flat_exec_arrays, flat_exec_from_numpy, flat_spmm,
)
from .local_backend import (
    BsrBackend, CooBackend, available_backends, get_backend,
    register_backend,
)
from .planner import SpmmPlan, build_plan, local_piece_csrs, plan_build_count
from .sparse import (
    COOMatrix, CSRMatrix, csr_from_coo, ell_from_csr, pattern_snapshot,
    power_law_sparse, random_sparse,
)

__all__ = [
    "DistSpmm", "SpmmConfig", "compile_spmm", "compile_sddmm",
    "compile_fused",
    "NetworkSpec", "TSUBAME_LIKE", "choose_fused_schedule",
    "choose_schedule", "modeled_time", "strategy_volumes",
    "CommRound", "CommSchedule", "build_comm_schedule",
    "single_round_schedule",
    "EDGE_FNS", "flat_fused", "flat_sddmm", "flat_spmm_values",
    "fused_sddmm_spmm",
    "FlatExecPlan", "flat_exec_arrays", "flat_exec_from_numpy", "flat_spmm",
    "BsrBackend", "CooBackend", "available_backends", "get_backend",
    "register_backend",
    "SpmmPlan", "build_plan", "local_piece_csrs", "plan_build_count",
    "COOMatrix", "CSRMatrix", "csr_from_coo", "ell_from_csr",
    "pattern_snapshot", "power_law_sparse", "random_sparse",
]
