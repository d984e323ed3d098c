"""Serving: paged KV cache, token packing, sampling, speculative decoding and
the continuous-batching engine."""
from ..models.model import UnsupportedPatternError
from .block_table import OutOfPages, PagedTables, PageError
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
    "SamplingParams",
    "SpecConfig",
    "StepStats",
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
