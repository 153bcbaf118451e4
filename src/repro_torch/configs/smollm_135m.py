"""smollm-135m — small llama-arch LM [hf:HuggingFaceTB/SmolLM-135M].

30L, d_model=576, 9H (kv=3), d_ff=1536, vocab=49152, tied embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49152, tie_embeddings=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, tie_embeddings=True, dtype="float32", remat=False,
    )
