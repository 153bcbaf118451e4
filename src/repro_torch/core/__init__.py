"""SHIRO core for the port: host-side planning (copies of the reference's
NumPy modules), the local backends, the flat and hierarchical SpMM /
SDDMM / FusedMM executors, the replicated (1.5D) SpMM executor, the
front door, measured autotuning and the session lifecycle. It exports
every name of the reference's ``repro.core`` that the port holds."""
from ..distributed.topology import Topology, TopologyError
from .api import (
    DistSpmm, SpmmConfig, compile_fused, compile_sddmm, compile_spmm,
    make_spmm_fn, register_lowering_hook, unregister_lowering_hook,
)
from .autotune import (
    AutotuneCache, cache_key, decision_modeled_time, estimate_device_bytes,
    get_cache, measured_decide, measurement_enabled, profile_candidate,
    register_profile_hook, rung_device_bytes, unregister_profile_hook,
)
from .session import LadderRung, SpmmSession, StagedTopology
from .comm_model import (
    AURORA_LIKE, NetworkSpec, TPU_POD, TSUBAME_LIKE, balance_stats,
    choose_fused_schedule, choose_hier_fused_schedule, choose_hier_schedule,
    choose_schedule, modeled_time, modeled_time_fused_schedule,
    modeled_time_hier, modeled_time_hier_fused_schedule,
    modeled_time_hier_overlap, modeled_time_hier_schedule,
    modeled_time_hier_staged, modeled_time_overlap, modeled_time_replicated,
    modeled_time_schedule, modeled_time_staged, replicated_device_bytes,
    strategy_volumes,
)
from .comm_schedule import (
    CommRound, CommSchedule, ReplicatedSchedule, ReplRound,
    build_comm_schedule, build_hier_comm_schedule, build_replicated_schedule,
    single_round_hier_schedule, single_round_schedule,
)
from .dist_sddmm import (
    EDGE_FNS, flat_fused, flat_sddmm, flat_spmm_values, fused_sddmm_spmm,
    hier_fused, hier_sddmm, hier_spmm_values,
)
from .dist_spmm import (
    BackendSpec, FlatExecPlan, HierExecPlan, ReplicatedExecPlan,
    flat_exec_arrays, flat_exec_from_numpy, flat_spmm, hier_exec_arrays,
    hier_exec_from_numpy, hier_spmm, replicated_exec_arrays,
    replicated_spmm,
)
from .hierarchy import HierPlan, build_hier_plan, hier_piece_csrs
from .local_backend import (
    BsrBackend, CooBackend, LocalSpmmBackend, available_backends,
    coo_spmm_local, get_backend, register_backend,
)
from .mwvc import (
    cover_is_valid, hopcroft_karp, min_vertex_cover_unweighted,
    min_vertex_cover_weighted,
)
from .planner import (
    PairPlan, ReplicatedPlan, SpmmPlan, Strategy, build_pair_plan,
    build_plan, local_piece_csrs, plan_build_count, replicate_plan,
)
from .sparse import (
    BSRMatrix, COOMatrix, CSRMatrix, PatternSnapshot, block_rows,
    bsr_from_csr, coo_from_arrays, csr_from_coo, csr_from_dense,
    ell_from_csr, hub_sparse, pattern_snapshot, power_law_sparse,
    random_sparse,
)

__all__ = [
    "Topology", "TopologyError",
    "DistSpmm", "SpmmConfig", "compile_spmm", "compile_sddmm",
    "compile_fused", "make_spmm_fn", "register_lowering_hook",
    "unregister_lowering_hook",
    "AutotuneCache", "cache_key", "decision_modeled_time",
    "estimate_device_bytes", "get_cache", "measured_decide",
    "measurement_enabled", "profile_candidate", "register_profile_hook",
    "rung_device_bytes", "unregister_profile_hook",
    "LadderRung", "SpmmSession", "StagedTopology",
    "NetworkSpec", "TSUBAME_LIKE", "TPU_POD", "AURORA_LIKE",
    "balance_stats", "choose_fused_schedule",
    "choose_hier_fused_schedule", "choose_hier_schedule",
    "choose_schedule", "modeled_time", "modeled_time_hier",
    "modeled_time_schedule", "modeled_time_staged", "modeled_time_overlap",
    "modeled_time_fused_schedule",
    "modeled_time_hier_fused_schedule", "modeled_time_hier_overlap",
    "modeled_time_hier_schedule", "modeled_time_hier_staged",
    "modeled_time_replicated", "replicated_device_bytes",
    "strategy_volumes",
    "CommRound", "CommSchedule", "ReplicatedSchedule", "ReplRound",
    "build_comm_schedule", "build_hier_comm_schedule",
    "build_replicated_schedule", "single_round_hier_schedule",
    "single_round_schedule",
    "EDGE_FNS", "flat_fused", "flat_sddmm", "flat_spmm_values",
    "fused_sddmm_spmm", "hier_fused", "hier_sddmm", "hier_spmm_values",
    "BackendSpec", "FlatExecPlan", "HierExecPlan", "ReplicatedExecPlan",
    "flat_exec_arrays", "flat_exec_from_numpy", "flat_spmm",
    "hier_exec_arrays", "hier_exec_from_numpy", "hier_spmm",
    "replicated_exec_arrays", "replicated_spmm",
    "HierPlan", "build_hier_plan", "hier_piece_csrs",
    "BsrBackend", "CooBackend", "LocalSpmmBackend", "available_backends",
    "coo_spmm_local", "get_backend", "register_backend",
    "cover_is_valid", "hopcroft_karp", "min_vertex_cover_unweighted",
    "min_vertex_cover_weighted",
    "PairPlan", "ReplicatedPlan", "SpmmPlan", "Strategy", "build_pair_plan",
    "build_plan", "local_piece_csrs", "plan_build_count", "replicate_plan",
    "BSRMatrix", "COOMatrix", "CSRMatrix", "PatternSnapshot", "block_rows",
    "bsr_from_csr", "coo_from_arrays", "csr_from_coo", "csr_from_dense",
    "ell_from_csr", "hub_sparse", "pattern_snapshot", "power_law_sparse",
    "random_sparse",
]
