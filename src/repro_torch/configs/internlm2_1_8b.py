"""internlm2-1.8b — dense GQA  [arXiv:2403.17297].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
Full attention only => long_500k skipped (see DESIGN.md §long-context).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        layer_pattern="G",
        act="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=503,
        layer_pattern="G",
        tie_embeddings=False,
        dtype="float32",
        remat=False,
    )
