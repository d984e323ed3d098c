"""starcoder2-7b — dense GQA with RoPE  [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
StarCoder2 uses LayerNorm + GELU MLP (non-gated).  Full attention only
=> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        layer_pattern="G",
        qkv_bias=True,
        act="gelu",
        norm="layernorm",
        rope_theta=100_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        family="dense",
        n_layers=2,
        d_model=144,
        n_heads=4,
        n_kv_heads=2,
        d_ff=288,
        vocab_size=503,
        layer_pattern="G",
        qkv_bias=True,
        act="gelu",
        norm="layernorm",
        dtype="float32",
        remat=False,
    )
