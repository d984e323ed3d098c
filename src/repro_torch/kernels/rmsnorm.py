"""RMSNorm, forward as a Triton kernel: the port of the TPU kernel ``rmsnorm``
(src/repro/kernels/rmsnorm.py:27, body ``_rmsnorm_kernel`` :20); backward
as CUDA C++.

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

The backward (``rmsnorm_bwd``, which the Pallas package never had) is
CUDA C++, ``rmsnorm_bwd.cu``, in both modes: a persistent grid of one CTA
an SM stages its contiguous rows of x and dy in shared memory with
``cp.async``, a warp a row writes dx (two row reductions: sum(x^2) and
sum(dt * x)), each thread adds dy * t over the CTA's rows for its own
columns, and a second launch of 64 CTAs (at d = 2048) sums the CTAs'
partials per column in a fixed order.  No atomics, so dx and dscale are
deterministic.  Plain version: ``ref.rmsnorm_bwd_ref``.  It is bound by
bytes: x and dy read once, dx written once.  ``bwd_partition`` is the
rows' and columns' split between CTAs.

``triton`` is imported, and the forward compiled, on first launch only
(the backward's source is built by ``_build`` at first use): the CPU test
suite imports this module without triton or nvcc.  The wrappers take
CUDA tensors only; ``rmsnorm.launches`` and ``rmsnorm_bwd.launches``
count calls (the backward's two launches count as one call).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_KERNEL = None


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


# ---------------------------------------------------------------------------
# backward: CUDA C++ (rmsnorm_bwd.cu)
# ---------------------------------------------------------------------------

BWD_SOURCE = "rmsnorm_bwd.cu"
#: threads of a row CTA, columns of a dscale-sum CTA (kThreads, kColCta in
#: the source); shared memory a row CTA may take (the card's 227 KB)
BWD_THREADS, BWD_COL_CTA = 512, 32
BWD_SMEM = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BWD_ARGTYPES = [_P] * 6 + [_I] * 5 + [_F] + [_I] * 4 + [_P]


def load_bwd_library() -> ctypes.CDLL:
    """Build (first use) and load ``rmsnorm_bwd.cu``; sets the C signature."""
    lib = _build.load(BWD_SOURCE)
    fn = lib.repro_rmsnorm_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def bwd_partition(rows: int, d: int, itemsize: int, sms: int):
    """(ctas, rows_per_cta, batch_rows, col_ctas) of the backward: one CTA
    an SM at most, each taking ``rows_per_cta`` contiguous rows (the last
    CTA fewer, none empty) in batches of ``batch_rows`` that fit in shared
    memory beside two f32 rows (scale, dscale); the dscale sum's CTAs own
    ``BWD_COL_CTA`` columns each.  Raises if one row does not fit."""
    if rows <= 0 or d <= 0:
        raise ValueError(f"rows {rows} and d {d} must be positive")
    per = -(-rows // min(sms, rows))
    ctas = -(-rows // per)
    room = BWD_SMEM - 8 * d - 16  # scale and dscale rows in f32, alignment
    batch = min(per, room // (2 * d * itemsize + 4)) if room > 0 else 0  # x, dy, inv_c
    if batch < 1:
        raise ValueError(f"feature width {d}: a row of x and dy does not fit in shared memory")
    return ctas, per, batch, -(-d // BWD_COL_CTA)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6,
                model: bool = False):
    """(dx, dscale) of ``rmsnorm`` for CUDA tensors, with the CUDA kernels of
    ``rmsnorm_bwd.cu`` (rows, then the deterministic dscale sum)."""
    if x.device.type != "cuda" or scale.device != x.device or dy.device != x.device:
        raise ValueError(f"the rmsnorm backward kernel takes CUDA tensors, got x on "
                         f"{x.device}, scale on {scale.device}, dy on {dy.device}")
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must share a float dtype, got {x.dtype}, {dy.dtype}")
    if scale.dtype not in _DTYPE_CODE:
        raise TypeError(f"scale must be a float tensor, got {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or dy.shape != x.shape:
        raise ValueError(f"scale must have shape ({d},) and dy x's shape {tuple(x.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    scale = scale.contiguous()
    dx = torch.empty_like(x2)
    dscale = torch.empty_like(scale)
    rows = x2.shape[0]
    if rows == 0:
        return dx.reshape(x.shape), dscale.zero_()
    ctas, per, batch, _ = bwd_partition(rows, d, x2.element_size(), _sm_count(x.device.index))
    part = torch.empty((ctas, d), dtype=torch.float32, device=x.device)
    vec = int((d * x2.element_size()) % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x2, dy2, dx)))
    lib = load_bwd_library()
    with torch.cuda.device(x.device):
        err = lib.repro_rmsnorm_bwd(
            x2.data_ptr(), scale.data_ptr(), dy2.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            part.data_ptr(), rows, d, ctas, per, batch, float(eps), _DTYPE_CODE[x2.dtype],
            _DTYPE_CODE[scale.dtype], int(model), vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm backward launch failed (code {err})")
    rmsnorm_bwd.launches += 1
    return dx.reshape(x.shape), dscale


rmsnorm_bwd.launches = 0
