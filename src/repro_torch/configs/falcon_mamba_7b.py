"""falcon-mamba-7b — attention-free Mamba1 LM [arXiv:2410.05355].

64L, d_model=4096, d_inner=8192 (expand 2), ssm_state=16, vocab=65024.
SHIRO applicability: none at the model layer (no sparse exchange in a
dense SSM); see DESIGN.md §Arch-applicability.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=65024, ssm_state=16, ssm_conv=4, ssm_expand=2,
    ssm_version=1, ssm_chunk=128, fsdp=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=128, ssm_state=4, ssm_conv=4, ssm_expand=2,
        ssm_version=1, ssm_chunk=8, dtype="float32", remat=False,
    )
