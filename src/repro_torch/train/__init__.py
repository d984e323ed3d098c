"""Training loop with DropCompute (port of ``repro.train``)."""
from .trainer import (
    TrainConfig,
    TrainResult,
    UnsupportedCheckpointError,
    UnsupportedDistError,
    train,
)

__all__ = ["TrainConfig", "TrainResult", "UnsupportedCheckpointError", "UnsupportedDistError",
           "train"]
