"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The module layout mirrors ``repro``: ``models`` (config, layers, stack,
serving entry points), ``configs`` (published architectures), ``kernels``
(hand-written CUDA/Triton kernels beside their plain PyTorch versions)
and ``serve`` (paged KV cache and the continuous-batching engine).

The package imports ``torch`` only.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; without a GPU they raise instead of
falling back (see :func:`resolve_device`).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
