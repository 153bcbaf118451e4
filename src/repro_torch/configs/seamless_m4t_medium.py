"""seamless-m4t-medium — speech/text enc-dec backbone [arXiv:2308.11596].

12 encoder + 12 decoder layers, d_model=1024, 16H (kv=16), d_ff=4096,
vocab=256206. The audio frontend is a STUB: input_specs supplies
precomputed frame embeddings (assignment contract).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, mlp="gelu",
    frontend="audio", frontend_len=1024,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=128, mlp="gelu",
        frontend="audio", frontend_len=16, dtype="float32", remat=False,
    )
