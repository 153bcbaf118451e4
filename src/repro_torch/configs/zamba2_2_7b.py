"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers (d_model=2560, ssm_state=64) with ONE shared attention
block (32H, kv=32, d_ff=10240) applied every 6 SSM blocks.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, ssm_state=64, ssm_version=2, ssm_heads=80,
    ssm_chunk=128, attn_every=6,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=128, ssm_state=8, ssm_version=2, ssm_heads=4,
        ssm_chunk=8, attn_every=2, dtype="float32", remat=False,
    )
