"""BERT-1.5B — the paper's §5.2 runtime model  [Habana 2023 DeepSpeed blog].

48L d_model=1600 25H d_ff=6400 vocab=30522 (~1.5B params), trained with
LANS + ZeRO-1, local batch 192, 12 accumulations, seq 128 — the exact
setting of the paper's runtime experiments (appendix B.1).
Encoder-only => no decode shapes.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="bert-1.5b",
        family="dense",
        n_layers=48,
        d_model=1600,
        n_heads=25,
        n_kv_heads=25,
        d_ff=6400,
        vocab_size=30522,
        layer_pattern="B",
        act="gelu",
        norm="layernorm",
        pos="learned",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="bert-1.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=160,
        n_heads=5,
        n_kv_heads=5,
        d_ff=320,
        vocab_size=503,
        layer_pattern="B",
        act="gelu",
        norm="layernorm",
        pos="learned",
        dtype="float32",
        remat=False,
    )
