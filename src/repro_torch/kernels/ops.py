"""Kernel dispatch keyed on the tensors' device (port of ``repro.kernels.ops``).

* CUDA tensors go to the hand-written kernel (``flash_attention.py`` for
  paged attention, ``rmsnorm.py`` for RMSNorm).  A kernel that fails to
  build or launch raises: there is no fallback to the plain version.
* CPU tensors go to the plain PyTorch version in ``ref.py``.
* Any other device raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import flash_attention as _fa
from . import ref as _ref
from . import rmsnorm as _rms

#: kernel name -> the wrapper whose ``launches`` attribute counts it
KERNELS = {
    "paged_attention": _fa.paged_flash_attention,
    "rmsnorm": _rms.rmsnorm,
}


def launch_counts() -> Dict[str, int]:
    """Launches of each hand-written kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain path for device {x.device}")
    return x.device.type


def paged_flash_attention(q, k_pool, v_pool, tables, q_pos, q_slots,
                          window=0, softcap=0.0, k_scale=None, v_scale=None):
    """Fused paged attention: the CUDA kernel on the card, the vectorised
    plain path (``ref.paged_attention_ref``) on the CPU."""
    if _device_type(q) == "cuda":
        return _fa.paged_flash_attention(
            q, k_pool, v_pool, tables, q_pos, q_slots, window=window,
            softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    return _ref.paged_attention_ref(
        q, k_pool, v_pool, tables, q_pos, q_slots, window=window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale)


def rmsnorm(x, scale, eps=1e-6, model=False):
    """RMSNorm: the Triton kernel on the card, ``ref.rmsnorm_model``
    (``model=True``) or ``ref.rmsnorm_ref`` on the CPU."""
    if _device_type(x) == "cuda":
        return _rms.rmsnorm(x, scale, eps=eps, model=model)
    return (_ref.rmsnorm_model if model else _ref.rmsnorm_ref)(x, scale, eps)
