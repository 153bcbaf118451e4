"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060].

16L, d_model=2048, 16H (kv=16), per-expert d_ff=1024, vocab=50304.
SHIRO applicability: FIRST-CLASS — expert-parallel dispatch/combine run
through the SHIRO-planned dedup + pre-aggregation path (DESIGN.md §4).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab_size=50304, n_experts=64, top_k=8, shiro_dispatch=True,
    fsdp=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=128, n_experts=8, top_k=2, shiro_dispatch=True,
        dtype="float32", remat=False,
    )
