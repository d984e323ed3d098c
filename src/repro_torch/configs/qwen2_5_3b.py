"""qwen2.5-3b — dense GQA with QKV bias  [hf:Qwen/Qwen2.5-0.5B family].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
Full attention only => long_500k skipped.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab_size=151_936,
        layer_pattern="G",
        qkv_bias=True,
        act="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=503,
        layer_pattern="G",
        qkv_bias=True,
        dtype="float32",
        remat=False,
    )
