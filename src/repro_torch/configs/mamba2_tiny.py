"""mamba2-tiny — CPU-sized pure-SSD config for the serving parity matrix.

A two-layer 'M' pattern small enough that the chunked-prefill /
token-packed / decode-oracle parity suite runs in seconds on CPU, with a
chunk size (``ssm_chunk=8``) small enough that realistic prompts span
several scan chunks — the case the carried-state chunk scan
(``kernels.ssd_chunk`` + ``models.recurrent``) must get right.

Not in ``ARCHITECTURES`` (``mamba2_130m`` is the published architecture);
tests and benchmarks import it directly via ``get_config("mamba2_tiny")``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-tiny",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=211,
        layer_pattern="M",
        ssm_state=8,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_chunk=8,
        pos="none",
        dtype="float32",
        remat=False,
    )


def smoke_config() -> ModelConfig:
    return config()
