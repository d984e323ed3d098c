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

The backward (``rmsnorm_bwd``, which the Pallas package never had) is a
second Triton kernel in both modes: each program takes ``ITERS`` blocks
of rows, writes dx row by row (two row reductions: sum(x^2) and
sum(dt * x)) and one partial of dscale (its rows' sum of dy * t, f32);
a small second launch sums the partials per column.  No atomics, so
dscale is deterministic.  Plain version: ``ref.rmsnorm_bwd_ref``.  It is
bound by bytes too: x and dy read once, dx written once.

``triton`` is imported, and the kernels compiled, on first launch only:
the CPU test suite imports this module without triton.  The wrappers take
CUDA tensors only; ``rmsnorm.launches`` and ``rmsnorm_bwd.launches``
count calls (the backward's two launches count as one call).
"""
from __future__ import annotations

import torch

_KERNEL = None
_BWD_KERNELS = None


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


def _bwd_kernels():
    global _BWD_KERNELS
    if _BWD_KERNELS is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_bwd_kernel(x_ptr, s_ptr, dy_ptr, dx_ptr, part_ptr, n_rows, d, eps,
                               BLOCK_ROWS: tl.constexpr, BLOCK_D: tl.constexpr,
                               ITERS: tl.constexpr, MODEL: tl.constexpr):
            pid = tl.program_id(0)
            cols = tl.arange(0, BLOCK_D)
            cmask = cols < d
            x_ty = x_ptr.dtype.element_ty
            s = tl.load(s_ptr + cols, mask=cmask, other=0.0)
            if MODEL:
                s = s.to(x_ty)
            s = s.to(tl.float32)
            ds = tl.zeros((BLOCK_D,), dtype=tl.float32)
            for it in range(ITERS):
                rows = (pid * ITERS + it) * BLOCK_ROWS + tl.arange(0, BLOCK_ROWS)
                mask = (rows < n_rows)[:, None] & cmask[None, :]
                offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                inv = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / d + eps)
                if MODEL:
                    inv_c = inv.to(x_ty).to(tl.float32)
                    t = (x * inv_c[:, None]).to(x_ty).to(tl.float32)
                else:
                    inv_c = inv
                    t = x * inv[:, None]
                ds += tl.sum(dy * t, axis=0)
                dt = dy * s[None, :]
                dot = tl.sum(dt * x, axis=1)
                dx = dt * inv_c[:, None] - x * (inv * inv * inv * dot / d)[:, None]
                tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            tl.store(part_ptr + pid.to(tl.int64) * d + cols, ds, mask=cmask)

        @triton.jit
        def colsum_kernel(part_ptr, out_ptr, n_parts, d, BLOCK_P: tl.constexpr,
                          BLOCK_C: tl.constexpr):
            cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < d
            acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
            for p0 in range(0, n_parts, BLOCK_P):
                parts = p0 + tl.arange(0, BLOCK_P)
                m = (parts < n_parts)[:, None] & cmask[None, :]
                acc += tl.sum(tl.load(part_ptr + parts.to(tl.int64)[:, None] * d + cols[None, :],
                                      mask=m, other=0.0), axis=0)
            tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty), mask=cmask)

        _BWD_KERNELS = (rmsnorm_bwd_kernel, colsum_kernel)
    return _BWD_KERNELS


def bwd_programs(rows: int, block_rows: int, target: int = 256):
    """(programs, ITERS): enough row blocks per program that at most about
    ``target`` dscale partials are written."""
    blocks = -(-rows // block_rows)
    iters = -(-blocks // target)
    return -(-blocks // iters), iters


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6,
                model: bool = False):
    """(dx, dscale) of ``rmsnorm`` for CUDA tensors, with the Triton kernels."""
    if x.device.type != "cuda" or scale.device != x.device or dy.device != x.device:
        raise ValueError(f"the rmsnorm backward kernel takes CUDA tensors, got x on "
                         f"{x.device}, scale on {scale.device}, dy on {dy.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16) or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must share a float dtype, got {x.dtype}, {dy.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or dy.shape != x.shape:
        raise ValueError(f"scale must have shape ({d},) and dy x's shape {tuple(x.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    dx = torch.empty_like(x2)
    dscale = torch.empty_like(scale)
    rows = x2.shape[0]
    if rows == 0:
        return dx.reshape(x.shape), dscale.zero_()
    block_rows, block_d, num_warps = block_shape(d)
    programs, iters = bwd_programs(rows, block_rows)
    part = torch.empty((programs, d), dtype=torch.float32, device=x.device)
    kernel, colsum = _bwd_kernels()
    with torch.cuda.device(x.device):
        kernel[(programs,)](x2, scale.contiguous(), dy2, dx, part, rows, d, eps,
                            BLOCK_ROWS=block_rows, BLOCK_D=block_d, ITERS=iters, MODEL=model,
                            num_warps=num_warps)
        colsum[(-(-d // 256),)](part, dscale, programs, d, BLOCK_P=32, BLOCK_C=256,
                                num_warps=4)
    rmsnorm_bwd.launches += 1
    return dx.reshape(x.shape), dscale


rmsnorm_bwd.launches = 0
