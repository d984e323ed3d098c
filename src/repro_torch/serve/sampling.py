"""Per-request sampling parameters and the greedy sampler (port of the
greedy half of ``repro.serve.sampling``).

:class:`SamplingParams` keeps the reference's fields and validation.  The
port samples greedily only: f32 argmax per row, as the reference does for
``temperature == 0`` (``sampling.py:210-215``).  Stochastic sampling needs
JAX's threefry bits to replay the reference's streams; until it is ported
the engine refuses ``temperature > 0`` at submit
(``ContinuousBatcher.validate_request``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode knobs (same fields and checks as the reference):
    ``temperature`` (0 = greedy), ``top_k`` (0 = off), ``top_p`` (1 = off),
    ``seed``."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        # raised, never assert-ed (asserts vanish under python -O)
        if not (isinstance(self.temperature, (int, float))
                and math.isfinite(self.temperature) and self.temperature >= 0):
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature!r}"
            )
        if not (isinstance(self.top_k, (int, np.integer)) and self.top_k >= 0):
            raise ValueError(f"top_k must be an int >= 0, got {self.top_k!r}")
        if not (isinstance(self.top_p, (int, float)) and 0 < self.top_p <= 1):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p!r}")
        if not isinstance(self.seed, (int, np.integer)):
            raise ValueError(f"seed must be an int, got {self.seed!r}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0

    def with_seed(self, seed: int) -> "SamplingParams":
        return dataclasses.replace(self, seed=int(seed))


#: the default params — argmax decode
GREEDY = SamplingParams()


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis in f32 (bf16 logits upcast exactly, so the
    argmax is that of the raw logits; ties go to the first index, as in
    JAX).  Returns int64 tokens with the leading shape."""
    return logits.float().argmax(dim=-1)
