"""deepseek-67b — deep llama-arch LM [arXiv:2401.02954].

95L, d_model=8192, 64H (kv=8), d_ff=22016, vocab=102400.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=102400, fsdp=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab_size=128, dtype="float32", remat=False,
    )
