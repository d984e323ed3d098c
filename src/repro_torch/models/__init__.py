"""Model definitions for the port's training and serving paths ('G'/'L'/'R'/'M'
decoder and 'B' encoder stacks, and the enc-dec family)."""
from .config import InputShape, ModelConfig
from .model import (
    UnsupportedPatternError,
    compute_params,
    decode_step,
    encode,
    init_decode_cache,
    init_params,
    packed_prefill,
    prefill_chunk,
    verify_step,
)

__all__ = [
    "InputShape",
    "ModelConfig",
    "UnsupportedPatternError",
    "compute_params",
    "decode_step",
    "encode",
    "init_decode_cache",
    "init_params",
    "packed_prefill",
    "prefill_chunk",
    "verify_step",
]
