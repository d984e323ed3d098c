"""Optimizers and schedules (port of ``repro.optim``)."""
from .optimizers import (
    OPTIMIZERS,
    Optimizer,
    ShardNorms,
    adamw,
    apply_updates,
    clip_by_global_norm,
    clip_scale,
    global_norm,
    lamb,
    lans,
    make,
    sgd,
)
from .schedule import constant, warmup_cosine, warmup_linear

__all__ = [
    "OPTIMIZERS",
    "Optimizer",
    "ShardNorms",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "clip_scale",
    "global_norm",
    "lamb",
    "lans",
    "make",
    "sgd",
    "constant",
    "warmup_cosine",
    "warmup_linear",
]
