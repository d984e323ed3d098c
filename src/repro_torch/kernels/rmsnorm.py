"""RMSNorm as a Triton kernel: the port of the TPU kernel ``rmsnorm``
(src/repro/kernels/rmsnorm.py:27, body ``_rmsnorm_kernel`` :20).

Each program normalises ``BLOCK_ROWS`` rows with the whole feature axis in
one tile (the reduction stays inside the program); the ragged last block
is masked.  Two modes:

* ``model=False`` — the TPU kernel's math: f32 throughout, one rounding
  at the end (plain version ``ref.rmsnorm_ref``);
* ``model=True`` — ``repro.models.layers.apply_norm``'s numerics: f32
  statistics, ``inv`` rounded to the input dtype, then each of the two
  multiplies rounded to it (plain version ``ref.rmsnorm_model``).  This is
  the mode the serving path runs.

Bound: one read of x and one write of the output, ~4 flop per element,
so the kernel is bound by bytes; the design keeps it to exactly one pass.

``triton`` is imported, and the kernel compiled, on first launch only:
the CPU test suite imports this module without triton.  The wrapper takes
CUDA tensors only; ``rmsnorm.launches`` counts launches.
"""
from __future__ import annotations

import torch

_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, n_rows, d, eps,
                           BLOCK_ROWS: tl.constexpr, BLOCK_D: tl.constexpr,
                           MODEL: tl.constexpr):
            rows = tl.program_id(0) * BLOCK_ROWS + tl.arange(0, BLOCK_ROWS)
            cols = tl.arange(0, BLOCK_D)
            cmask = cols < d
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            inv = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / d + eps)
            s = tl.load(s_ptr + cols, mask=cmask, other=0.0)
            out_ty = o_ptr.dtype.element_ty
            if MODEL:
                inv_c = inv.to(out_ty).to(tl.float32)
                xi = (x * inv_c[:, None]).to(out_ty).to(tl.float32)
                y = xi * s.to(out_ty).to(tl.float32)[None, :]
            else:
                y = x * inv[:, None] * s.to(tl.float32)[None, :]
            tl.store(o_ptr + offs, y.to(out_ty), mask=mask)

        _KERNEL = rmsnorm_kernel
    return _KERNEL


def block_shape(d: int):
    """(BLOCK_ROWS, BLOCK_D, num_warps) for feature width ``d``: the whole
    row in one power-of-two tile, ~8K elements per program."""
    block_d = 1 << max(d - 1, 1).bit_length()
    block_rows = max(1, 8192 // block_d)
    return block_rows, block_d, (8 if block_d >= 2048 else 4)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            model: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis of a CUDA tensor with the Triton kernel."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"the rmsnorm kernel takes CUDA tensors, got x on {x.device}, "
                         f"scale on {scale.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(scale.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows == 0:
        return out.reshape(x.shape)
    block_rows, block_d, num_warps = block_shape(d)
    grid = ((rows + block_rows - 1) // block_rows,)
    with torch.cuda.device(x.device):
        _kernel()[grid](x2, scale.contiguous(), out, rows, d, eps,
                        BLOCK_ROWS=block_rows, BLOCK_D=block_d, MODEL=model,
                        num_warps=num_warps)
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
