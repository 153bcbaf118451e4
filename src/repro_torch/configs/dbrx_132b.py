"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base].

40L, d_model=6144, 48H (kv=8), per-expert d_ff=10752, vocab=100352.
SHIRO applicability: FIRST-CLASS (EP dispatch/combine planning).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, n_experts=16, top_k=4, shiro_dispatch=True,
    fsdp=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=128, n_experts=4, top_k=2, shiro_dispatch=True,
        dtype="float32", remat=False,
    )
