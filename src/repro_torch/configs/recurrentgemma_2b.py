"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2
[arXiv:2402.19427].

26L d_model=2560 10H (GQA kv=1 = MQA) d_ff=7680 vocab=256000.
Pattern unit RRL: two recurrent blocks per local-attention block.
Hybrid recurrence => runs long_500k (O(1) recurrent state + 2k window).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        layer_pattern="RRL",
        sliding_window=2048,
        rglru_expand=1.5,
        rglru_conv=4,
        act="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=3,
        d_model=128,
        n_heads=2,
        n_kv_heads=1,
        head_dim=64,
        d_ff=256,
        vocab_size=503,
        layer_pattern="RRL",
        sliding_window=16,
        act="geglu",
        dtype="float32",
        remat=False,
    )
