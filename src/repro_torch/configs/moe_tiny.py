"""moe-tiny — CPU-sized mixture-of-experts config for the serving parity matrix.

Small enough that the full engine parity suite (dense / packed / paged x
token-budget x capacity-factor dispatch) runs in seconds on CPU, while
still exercising the MoE-specific machinery: the router, top-k dispatch,
and the capacity-factor serving path (``models.moe.apply_moe_capacity``)
whose per-expert buffers are the serving analogue of the paper's
per-worker compute threshold tau.

Not in ``ARCHITECTURES`` (it reproduces no published model); tests and
benchmarks import it directly via ``get_config("moe_tiny")``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moe-tiny",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=211,
        layer_pattern="G",
        n_experts=4,
        top_k=2,
        moe_d_ff=64,
        dtype="float32",
        remat=False,
    )


def smoke_config() -> ModelConfig:
    return config()
