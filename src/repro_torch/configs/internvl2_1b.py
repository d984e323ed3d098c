"""internvl2-1b — VLM: InternViT vision encoder + InternLM2 LM
[arXiv:2404.16821].

LM backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The ViT + projector front-end is a stub: ``batch["prefix"]`` carries 256
precomputed patch embeddings of width d_model, placed before the text
(``models.model.forward_features``).  The serving engine is text-only, as
the reference's is.  Its attention is 14 heads of 64 over 2 KV heads:
K3 and K4 are built for (64, 7).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151_655,
        layer_pattern="G",
        act="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        prefix_len=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=503,
        layer_pattern="G",
        prefix_len=8,
        dtype="float32",
        remat=False,
    )
