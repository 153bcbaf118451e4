"""qwen2-1.5b — GQA + QKV-bias llama-style LM [arXiv:2407.10671].

28L, d_model=1536, 12H (kv=2), d_ff=8960, vocab=151936, tied embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=128, qkv_bias=True, tie_embeddings=True,
        dtype="float32", remat=False,
    )
