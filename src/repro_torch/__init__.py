"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The module layout mirrors ``repro``: ``models`` (config, layers, stack,
training and serving entry points), ``configs`` (published
architectures), ``kernels`` (hand-written CUDA/Triton kernels beside their
plain PyTorch versions), ``serve`` (paged KV cache and the
continuous-batching engine), ``core`` (DropCompute's Algorithm 1, its
engines, latency models and Algorithm 2), ``data``, ``optim``, ``train``
(the trainer and its resilience subsystem) and ``launch`` (the CLI).

The package imports ``torch`` only.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; without a GPU they raise instead of
falling back (see :func:`resolve_device`).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one.  Raises when CUDA is asked for (explicitly or by
    default) and no GPU is present — the CPU path is opt-in, never a
    silent fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): host-clock
    timings of device work end here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
