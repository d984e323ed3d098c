"""RMSNorm as CUDA C++ for Hopper, forward and backward (``rmsnorm.cu``):
the port of the TPU kernel ``rmsnorm`` (src/repro/kernels/rmsnorm.py:27,
body ``_rmsnorm_kernel`` :20) and its gradient.

Two modes:

* ``model=False`` — the TPU kernel's math: f32 throughout, one rounding
  at the end (plain version ``ref.rmsnorm_ref``);
* ``model=True`` — ``repro.models.layers.apply_norm``'s numerics: f32
  statistics, ``inv`` rounded to the input dtype, then each of the two
  multiplies rounded to it (plain version ``ref.rmsnorm_model``).  This is
  the mode the serving and training paths run.

The forward (``rmsnorm``) is bound by bytes: one read of x and one write
of the output, ~4 flop an element.  Four CTAs an SM, all resident, each
take contiguous rows (``fwd_partition``, passed to the kernel as its
launch arguments); one thread of a CTA streams its rows into a ring of
stages in shared memory with 1-D bulk copies (TMA) on mbarriers, and a
warp a row sums the squares and writes the normalised row from registers
while the later stages are still arriving.
Rows the bulk copies cannot take (a row not a multiple of 16 bytes, a
misaligned pointer) take the same kernel element by element (the
``bulk`` flag).  A row's output depends on that row and the scale alone.

The backward (``rmsnorm_bwd``, which the Pallas package never had), in
both modes: a persistent grid of one CTA an SM stages its contiguous rows
of x and dy in shared memory with ``cp.async``, a warp a row writes dx
(two row reductions: sum(x^2) and sum(dt * x)), each thread adds dy * t
over the CTA's rows for its own columns, and a second launch of 64 CTAs
(at d = 2048) sums the CTAs' partials per column in a fixed order.  No
atomics, so dx and dscale are deterministic.  Plain version:
``ref.rmsnorm_bwd_ref``.  It is bound by bytes: x and dy read once, dx
written once.  ``bwd_partition`` is the rows' and columns' split between
CTAs.

The source is built by ``_build`` at first use, never at import: the CPU
test suite imports this module without nvcc.  The wrappers take CUDA
tensors only and raise if the build or the launch fails;
``rmsnorm.launches`` and ``rmsnorm_bwd.launches`` count calls (the
backward's two launches count as one call).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

SOURCE = "rmsnorm.cu"
#: shared memory a CTA may take (the card's 227 KB)
SMEM = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGTYPES = [_P] * 3 + [_I] * 7 + [_F] + [_I] * 4 + [_P]
_BWD_ARGTYPES = [_P] * 6 + [_I] * 5 + [_F] + [_I] * 4 + [_P]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def load_library() -> ctypes.CDLL:
    """Build (first use) and load ``rmsnorm.cu``; sets both C signatures."""
    lib = _build.load(SOURCE)
    for fn, argtypes in ((lib.repro_rmsnorm_fwd, _FWD_ARGTYPES),
                         (lib.repro_rmsnorm_bwd, _BWD_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

#: warps of a forward CTA (kFwdThreads / 32 in the source), stage buffers
#: it may ring through (kMaxSlots) and their mbarriers' bytes (kHead)
FWD_WARPS, FWD_MAX_SLOTS = 8, 32
FWD_HEAD = 8 * FWD_MAX_SLOTS
#: CTAs the plan puts on an SM, all resident at once (measured on the card:
#: one CTA an SM leaves each CTA's chain of stage waits, row sums and
#: barriers exposed, PERF.md); the shared memory an SM gives them, less the
#: 1 KB the runtime reserves for each
FWD_CTAS_PER_SM = 4
FWD_CTA_SMEM = 233472 // FWD_CTAS_PER_SM - 1024
#: the most bytes of one stage (one bulk copy)
FWD_STAGE_BYTES = 16384


class FwdPlan(NamedTuple):
    """The forward's launch: ``ctas`` CTAs of ``rows_per_cta`` contiguous
    rows (the last fewer, none empty), in stages of ``stage_rows`` rows
    through a ring of ``slots`` stage buffers; ``smem`` bytes of dynamic
    shared memory."""
    ctas: int
    rows_per_cta: int
    stage_rows: int
    slots: int
    smem: int


def fwd_smem(d: int, itemsize: int, stage_rows: int, slots: int) -> int:
    """Dynamic shared memory of a forward CTA: the mbarriers, the f32 scale
    row (16-byte aligned), the ring of stages."""
    return FWD_HEAD + -(-4 * d // 16) * 16 + slots * stage_rows * d * itemsize


def fwd_partition(rows: int, d: int, itemsize: int, sms: int) -> FwdPlan:
    """The forward's plan: ``FWD_CTAS_PER_SM`` CTAs an SM share the rows
    evenly (a decode step of 8 rows: 8 CTAs of one row); a CTA's rows go in
    stages of at most a row a warp and ``FWD_STAGE_BYTES``, with as many
    stages in flight as its share of the SM's shared memory holds (at the
    main paths' shapes, all of them).  A row wider than that share takes a
    CTA's whole 227 KB.  Raises if one row does not fit beside the scale
    row."""
    if rows <= 0 or d <= 0:
        raise ValueError(f"rows {rows} and d {d} must be positive")
    per = -(-rows // (sms * FWD_CTAS_PER_SM))
    ctas = -(-rows // per)
    row_bytes = d * itemsize
    head = fwd_smem(d, itemsize, 0, 0)
    room = FWD_CTA_SMEM - head
    if room < row_bytes:
        room = SMEM - head
    if room < row_bytes:
        raise ValueError(f"feature width {d}: a row of x does not fit in shared memory")
    stage = max(1, min(per, FWD_WARPS, FWD_STAGE_BYTES // row_bytes, room // row_bytes))
    slots = min(-(-per // stage), FWD_MAX_SLOTS, room // (stage * row_bytes))
    return FwdPlan(ctas, per, stage, slots, fwd_smem(d, itemsize, stage, slots))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            model: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis of a CUDA tensor with the forward kernel
    of ``rmsnorm.cu``."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"the rmsnorm kernel takes CUDA tensors, got x on {x.device}, "
                         f"scale on {scale.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    if scale.dtype not in _DTYPE_CODE:
        raise TypeError(f"scale must be a float tensor, got {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(scale.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows == 0:
        return out.reshape(x.shape)
    plan = fwd_partition(rows, d, x2.element_size(), _sm_count(x.device.index))
    bulk = int((d * x2.element_size()) % 16 == 0
               and x2.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.repro_rmsnorm_fwd(
            x2.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, *plan, float(eps),
            _DTYPE_CODE[x2.dtype], _DTYPE_CODE[scale.dtype], int(model), bulk,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed (code {err})")
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

#: threads of a row CTA, columns of a dscale-sum CTA (kThreads, kColCta in
#: the source)
BWD_THREADS, BWD_COL_CTA = 512, 32


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
    room = SMEM - 8 * d - 16  # scale and dscale rows in f32, alignment
    batch = min(per, room // (2 * d * itemsize + 4)) if room > 0 else 0  # x, dy, inv_c
    if batch < 1:
        raise ValueError(f"feature width {d}: a row of x and dy does not fit in shared memory")
    return ctas, per, batch, -(-d // BWD_COL_CTA)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6,
                model: bool = False):
    """(dx, dscale) of ``rmsnorm`` for CUDA tensors, with the CUDA kernels of
    ``rmsnorm.cu`` (rows, then the deterministic dscale sum)."""
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
    lib = load_library()
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
