"""Serving: paged KV cache, token packing and the continuous-batching engine."""
from ..models.model import UnsupportedPatternError
from .block_table import OutOfPages, PagedTables, PageError
from .kv import DenseSlots, KVCache, KVCacheSpec, KVState, Paged
from .packing import PackedLayout, pack_step, packed_capacity
from .sampling import GREEDY, SamplingParams, greedy_tokens
from .scheduler import (
    AdmissionError,
    ContinuousBatcher,
    EngineStateError,
    InvalidRequestError,
    Request,
    StepStats,
    UnsupportedDistError,
    UnsupportedSamplingError,
)

__all__ = [
    "AdmissionError",
    "ContinuousBatcher",
    "DenseSlots",
    "EngineStateError",
    "GREEDY",
    "InvalidRequestError",
    "KVCache",
    "KVCacheSpec",
    "KVState",
    "OutOfPages",
    "PackedLayout",
    "Paged",
    "PagedTables",
    "PageError",
    "Request",
    "SamplingParams",
    "StepStats",
    "UnsupportedDistError",
    "UnsupportedPatternError",
    "UnsupportedSamplingError",
    "greedy_tokens",
    "pack_step",
    "packed_capacity",
]
