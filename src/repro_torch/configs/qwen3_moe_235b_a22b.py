"""qwen3-moe-235b-a22b — MoE, 128 experts top-8  [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4, head_dim=128, QK-norm) per-expert
d_ff=1536 vocab=151936.  Full attention only => long_500k skipped.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151_936,
        layer_pattern="G",
        use_qk_norm=True,
        n_experts=128,
        top_k=8,
        moe_d_ff=1536,
        capacity_factor=1.25,
        act="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        # >100B: pure-bf16 parameter storage, as the reference's config
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=64,
        vocab_size=503,
        layer_pattern="G",
        use_qk_norm=True,
        n_experts=4,
        top_k=2,
        moe_d_ff=64,
        capacity_factor=2.0,
        tie_embeddings=False,
        dtype="float32",
        remat=False,
    )
