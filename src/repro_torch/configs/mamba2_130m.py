"""mamba2-130m — SSD (state-space duality)  [arXiv:2405.21060].

24L d_model=768, attention-free (d_ff=0), vocab=50280, ssm_state=128.
Pure-SSM: runs all four shapes including long_500k (O(1) decode state).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        layer_pattern="M",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        ssm_conv=4,
        norm="rmsnorm",
        tie_embeddings=True,
        pos="none",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=503,
        layer_pattern="M",
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=16,
        pos="none",
        dtype="float32",
        remat=False,
    )
