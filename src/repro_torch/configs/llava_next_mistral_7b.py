"""llava-next-mistral-7b — VLM (mistral backbone, anyres tiling)
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

32L, d_model=4096, 32H (kv=8), d_ff=14336, vocab=32000. The vision tower
is a STUB: input_specs supplies 576 precomputed patch embeddings per
image (one base image; anyres adds tiles — same contract).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, frontend="vision", frontend_len=576, fsdp=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, frontend="vision", frontend_len=8,
        dtype="float32", remat=False,
    )
