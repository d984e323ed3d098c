"""Model definitions for the port's training and serving paths ('G'/'L' decoder stacks)."""
from .config import ModelConfig
from .model import (
    UnsupportedPatternError,
    compute_params,
    init_decode_cache,
    init_params,
    packed_prefill,
    prefill_chunk,
)

__all__ = [
    "ModelConfig",
    "UnsupportedPatternError",
    "compute_params",
    "init_decode_cache",
    "init_params",
    "packed_prefill",
    "prefill_chunk",
]
