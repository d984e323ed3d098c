"""whisper-tiny — encoder-decoder audio model  [arXiv:2212.04356].

4L (enc) + 4L (dec) d_model=384 6H (kv=6, MHA) d_ff=1536 vocab=51865.
The mel-spectrogram + conv front-end is a stub: the encoder takes 1500
precomputed frame embeddings (``batch["frames"]``).  The decoder serves
through ``decode_step`` with self- and cross-attention caches; its
published text context is 448 tokens.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        enc_layers=4,
        enc_seq=1500,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        layer_pattern="G",
        act="gelu",
        norm="layernorm",
        pos="learned",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2,
        enc_layers=2,
        enc_seq=16,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=503,
        layer_pattern="G",
        act="gelu",
        norm="layernorm",
        pos="learned",
        dtype="float32",
        remat=False,
    )
