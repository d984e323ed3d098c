"""hybrid-tiny — CPU-sized RG-LRU + attention hybrid for the parity matrix.

A griffin-style interleaving ('RRG' repeated) small enough for the CPU
parity suite: the engine must thread *heterogeneous* per-layer state —
slot-indexed recurrent rows beside (dense or paged) attention KV — through
one step program, which is exactly the LayerState protocol
(``serve.kv.KVState``) this config exists to exercise.

Not in ``ARCHITECTURES`` (``recurrentgemma_2b`` is the published
architecture); tests and benchmarks import it directly via
``get_config("hybrid_tiny")``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hybrid-tiny",
        family="recurrent",
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=211,
        layer_pattern="RRG",
        rglru_expand=1.0,
        rglru_conv=4,
        dtype="float32",
        remat=False,
    )


def smoke_config() -> ModelConfig:
    return config()
