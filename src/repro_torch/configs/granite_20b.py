"""granite-20b — code LLM, gpt-bigcode lineage (MQA) [arXiv:2405.04324].

52L, d_model=6144, 48H with a SINGLE kv head (kv=1), d_ff=24576 (gelu),
vocab=49152, qkv biases.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, qkv_bias=True, mlp="gelu", fsdp=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=128, qkv_bias=True, mlp="gelu",
        dtype="float32", remat=False,
    )
