"""Serving: paged KV cache, token packing, sampling, speculative decoding, the
continuous-batching engine and its asyncio front-end."""
from ..models.model import UnsupportedPatternError
from .block_table import OutOfPages, PagedTables, PageError
from .frontend import AsyncEngine, RequestStream, StreamEvent
from .kv import DenseSlots, KVCache, KVCacheSpec, KVState, Paged
from .packing import PackedLayout, pack_step, packed_capacity
from .sampling import (
    GREEDY,
    SamplingParams,
    greedy_tokens,
    residual_sample,
    sample_one,
    sample_tokens,
)
from .scheduler import (
    AdmissionError,
    ContinuousBatcher,
    EngineStateError,
    InvalidRequestError,
    Request,
    StepStats,
    UnsupportedDistError,
)
from .spec import (
    DraftModelProposer,
    NGramProposer,
    Proposer,
    SpecConfig,
    accept_greedy,
    accept_sampled,
)

__all__ = [
    "AdmissionError",
    "AsyncEngine",
    "ContinuousBatcher",
    "DenseSlots",
    "DraftModelProposer",
    "EngineStateError",
    "GREEDY",
    "InvalidRequestError",
    "KVCache",
    "KVCacheSpec",
    "KVState",
    "NGramProposer",
    "OutOfPages",
    "PackedLayout",
    "Paged",
    "PagedTables",
    "PageError",
    "Proposer",
    "Request",
    "RequestStream",
    "SamplingParams",
    "SpecConfig",
    "StepStats",
    "StreamEvent",
    "UnsupportedDistError",
    "UnsupportedPatternError",
    "accept_greedy",
    "accept_sampled",
    "greedy_tokens",
    "pack_step",
    "packed_capacity",
    "residual_sample",
    "sample_one",
    "sample_tokens",
]
