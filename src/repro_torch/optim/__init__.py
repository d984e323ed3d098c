"""Optimizers and schedules (port of ``repro.optim``)."""
from .optimizers import (
    OPTIMIZERS,
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
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
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "lamb",
    "lans",
    "make",
    "sgd",
    "constant",
    "warmup_cosine",
    "warmup_linear",
]
