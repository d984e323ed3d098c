"""Training loop with DropCompute (port of ``repro.train``)."""
from . import checkpoint
from .trainer import TrainConfig, TrainResult, UnsupportedDistError, train

__all__ = ["TrainConfig", "TrainResult", "UnsupportedDistError", "checkpoint", "train"]
