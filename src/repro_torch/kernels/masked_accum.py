"""Masked gradient accumulation as a Triton kernel: the port of the TPU
kernel ``masked_accum`` (src/repro/kernels/masked_accum.py:33, body
``_accum_kernel`` :26; ``masked_accum_tree`` :68 maps it over a tree).

Algorithm 1 line 7, fused: ``acc <- acc + keep * scale * grad``, in place,
for a gradient of any float dtype.  The accumulator is f32 (the TPU
kernel's), or bf16 where the parameters are bf16: the reference sums
gradients in the parameters' dtype (``core/dropcompute.py:147``, and
``a + g.astype(a.dtype)`` in ``launch/steps.py``).  The bf16 form rounds
the gradient to bf16, adds in f32 and rounds once to bf16, which is how XLA
adds two bf16 arrays.  ``keep`` and ``scale`` are host floats (DropCompute
keeps or drops a whole micro-batch), so the launch needs no device sync.
One program streams ``BLOCK`` elements: one read of acc and grad, one
write of acc.

Bound: 1 flop-pair per element against 4 + 2 + 4 bytes (f32 acc read and
written, bf16 grad read; the bf16 form 2 + 2 + 2): bound by bytes; the
design is exactly one pass.

``triton`` is imported, and the kernel compiled, on first launch only.
The wrapper takes CUDA tensors only (plain version:
``ref.masked_accum_ref``); ``masked_accum.launches`` counts launches.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 4096  # elements per program
#: the accumulator dtypes the kernel takes
ACC_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def masked_accum_kernel(acc_ptr, g_ptr, n, coef, BLOCK: tl.constexpr):
            offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            acc = tl.load(acc_ptr + offs, mask=mask)
            # the casts are no-ops for an f32 accumulator
            g = tl.load(g_ptr + offs, mask=mask).to(acc.dtype).to(tl.float32)
            out = acc.to(tl.float32) + coef * g
            tl.store(acc_ptr + offs, out.to(acc.dtype), mask=mask)

        _KERNEL = masked_accum_kernel
    return _KERNEL


def masked_accum(acc: torch.Tensor, grad: torch.Tensor, keep: float,
                 scale: float = 1.0) -> torch.Tensor:
    """``acc += keep * scale * grad`` on the card, in place; returns ``acc``."""
    if acc.device.type != "cuda" or grad.device != acc.device:
        raise ValueError(f"the masked-accumulate kernel takes CUDA tensors, got acc on "
                         f"{acc.device}, grad on {grad.device}")
    if acc.dtype not in ACC_DTYPES:
        raise TypeError(f"the accumulator must be float32 or bfloat16, got {acc.dtype}")
    if not grad.dtype.is_floating_point:
        raise TypeError(f"grad must be a float tensor, got {grad.dtype}")
    if acc.shape != grad.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and grad {tuple(grad.shape)} differ")
    if not (acc.is_contiguous() and grad.is_contiguous()):
        raise ValueError("acc and grad must be contiguous (the kernel reads them flat)")
    n = acc.numel()
    if n == 0:
        return acc
    coef = float(np.float32(keep) * np.float32(scale))  # formed in f32, as JAX does
    with torch.cuda.device(acc.device):
        _kernel()[(-(-n // BLOCK),)](acc, grad, n, coef, BLOCK=BLOCK, num_warps=8)
    masked_accum.launches += 1
    return acc


masked_accum.launches = 0
