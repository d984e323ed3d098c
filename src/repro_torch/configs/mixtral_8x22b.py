"""mixtral-8x22b — MoE, 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
Per the assignment, SWA on all layers => qualifies for long_500k
(window-bounded KV cache).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        layer_pattern="L",
        sliding_window=4096,
        n_experts=8,
        top_k=2,
        moe_d_ff=16384,
        capacity_factor=1.25,
        act="swiglu",
        norm="rmsnorm",
        tie_embeddings=False,
        # >100B: pure-bf16 parameter storage, as the reference's config
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=503,
        layer_pattern="L",
        sliding_window=16,
        n_experts=4,
        top_k=2,
        moe_d_ff=256,
        capacity_factor=2.0,
        tie_embeddings=False,
        dtype="float32",
        remat=False,
    )
