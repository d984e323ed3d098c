"""gemma3-27b — dense GQA, 5 local : 1 global layers, 128k context
[hf:google/gemma-3-1b-pt family].

62L d_model=5376 32H (GQA kv=16, head_dim=128) d_ff=21504 vocab=262144.
Sliding-window (1024) on local layers => runs long_500k: local caches are
window-bounded; the ~10 global layers keep full-length caches, sharded
along the sequence axis.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262_144,
        layer_pattern="LLLLLG",
        sliding_window=1024,
        use_qk_norm=True,
        logit_softcap=0.0,
        act="geglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        n_layers=7,  # 6-layer unit + 1 tail layer: exercises grouped scan
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=503,
        layer_pattern="LLLLLG",
        sliding_window=16,
        use_qk_norm=True,
        act="geglu",
        dtype="float32",
        remat=False,
    )
