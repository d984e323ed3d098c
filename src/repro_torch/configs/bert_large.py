"""BERT-Large — the paper's §5.1 generalization model  [Devlin et al. 2018].

24L d_model=1024 16H d_ff=4096 vocab=30522, bidirectional encoder.
Modelled here as a decoder-free stack of 'B' blocks with an LM head
(our synthetic-data CE objective stands in for MLM; the stochastic-batch
mechanics under study are identical).  Encoder-only => no decode shapes.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="bert-large",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=30522,
        layer_pattern="B",
        act="gelu",
        norm="layernorm",
        pos="learned",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="bert-large-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=503,
        layer_pattern="B",
        act="gelu",
        norm="layernorm",
        pos="learned",
        dtype="float32",
        remat=False,
    )
