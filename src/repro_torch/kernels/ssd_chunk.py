"""Wrappers of the CUDA SSD kernels: ``ssd_chunk`` (K6, the intra-chunk term
of Mamba-2's chunked scan), its backward ``ssd_chunk_bwd``, and
``ssd_segment`` (K5, its segment-masked form over a token-packed step).

Ports of the TPU kernels ``repro.kernels.ssd_chunk.ssd_chunk``
(src/repro/kernels/ssd_chunk.py:104, body ``_ssd_chunk_kernel`` :27) and
``ssd_segment`` (:65, body ``_ssd_segment_kernel`` :45).  Both kernels are
one template in ``ssd_chunk.cu`` with a mask policy: a CTA of 4 warps on
one 16-row query tile and 1, 2 or 4 heads, C . B^T once per 16-key tile
for its heads (f32 on the FMA pipes, each element summed in order over the
state), att . x on the tensor cores in 3xTF32 (f32 accuracy), key tiles
through a ``cp.async``
ring from the first the tile admits (for K5 its first row's segment) to
its diagonal.  This module checks the arguments, plans the grid
(``ssd_plan``: heads a CTA, so the grid fills the card), allocates the
output and launches on PyTorch's current stream.

K6's backward has no TPU kernel (JAX differentiates the reference's jnp
form): two launches in ``ssd_chunk.cu`` (``repro_ssd_bwd``), shaped as
flash attention's dK/dV pass.  A CTA owns one 16-key tile of one chunk and
every head (the grid, one CTA per (chunk, tile), is mapped in the kernel):
it forms S = C . B^T for each query tile at or below its diagonal once for
all heads, then per head walks those query tiles (its 4 warps take every
fourth, each through its own ``cp.async`` ring of dy tiles), u = (S e)^T dy and q = x . dy^T on the tensor cores in
3xTF32, dS summed over the heads in order in shared memory, and ends each
head with dx, ddt and dcum of its own rows; then dB of its rows, and dS
into a (G, L, L) scratch (``scratch_bytes``) from which a second pass forms
dC.  No atomics: two runs are bit-identical.

The wrappers take CUDA tensors only: the plain versions for the CPU are
``kernels.ref.ssd_chunk_ref`` / ``ssd_chunk_bwd_ref`` / ``ssd_segment_ref``,
chosen by ``kernels.ops`` from the tensors' device.

``ssd_chunk.launches`` / ``ssd_chunk_bwd.launches`` / ``ssd_segment.launches``
count calls that launch (nothing else adds to them), so a run can show that
the serving and training paths went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import _build
from .flash_attention import UnbuiltShapeError

SOURCE = "ssd_chunk.cu"
#: (state N, head dim P) the source instantiates: the configs the port serves
BUILT = {(128, 64)}  # mamba2-130m
#: rows of a CTA's query tile and keys of a key tile in the kernel (``kRows``,
#: ``kKeys``); a dense step shorter than ``ssm_chunk`` runs one chunk of its
#: length rounded up to this (``models.ssm.chunk_len``)
ROW_TILE = 16
HEAD_GROUPS = (4, 2, 1)  # heads a CTA the source instantiates, largest first
#: the longest chunk the backward takes (its key-tile pass keeps S and dS of
#: a 16-key column of the chunk in shared memory); its L must also be a
#: multiple of ``ROW_TILE``
BWD_MAX_LEN = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_P]
_OCCUPANCY_ARGTYPES = [_I] * 2 + [_P]
_BWD_ARGTYPES = [_P] * 13 + [_I] * 5 + [_P]
_BWD_OCCUPANCY_ARGTYPES = [_I, _I, _P]
#: ``repro_ssd_occupancy``'s kinds: K6's forward, K5
MODES = {"chunk": 0, "segment": 1}
#: ``repro_ssd_bwd_occupancy``'s kernels: the key-tile pass, the dC pass
BWD_KERNELS = {"keys": 0, "dc": 1}


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; sets the C signature."""
    lib = _build.load(SOURCE)
    lib.repro_ssd.argtypes = _ARGTYPES
    lib.repro_ssd.restype = ctypes.c_int
    lib.repro_ssd_occupancy.argtypes = _OCCUPANCY_ARGTYPES
    lib.repro_ssd_occupancy.restype = ctypes.c_int
    lib.repro_ssd_bwd.argtypes = _BWD_ARGTYPES
    lib.repro_ssd_bwd.restype = ctypes.c_int
    lib.repro_ssd_bwd_occupancy.argtypes = _BWD_OCCUPANCY_ARGTYPES
    lib.repro_ssd_bwd_occupancy.restype = ctypes.c_int
    return lib


def occupancy(heads: int, mode: str) -> Tuple[int, int]:
    """(CTAs an SM, dynamic shared memory bytes) of one kernel instance
    (``mode`` one of ``MODES``) on the current card, as the runtime counts
    them from its registers and shared memory."""
    smem = ctypes.c_int(0)
    ctas = load_library().repro_ssd_occupancy(heads, MODES[mode], ctypes.byref(smem))
    if ctas < 0:
        raise RuntimeError(f"no SSD kernel instance for {heads} heads a CTA ({mode})")
    return ctas, smem.value


def bwd_occupancy(kernel: str, heads: int) -> Tuple[int, int]:
    """The same for one of the backward's kernels (``BWD_KERNELS``) at
    ``heads`` heads (the key-tile pass keeps two rows of floats a head in
    shared memory)."""
    smem = ctypes.c_int(0)
    ctas = load_library().repro_ssd_bwd_occupancy(BWD_KERNELS[kernel], heads,
                                                  ctypes.byref(smem))
    if ctas < 0:
        raise RuntimeError(f"no SSD backward kernel {kernel}")
    return ctas, smem.value


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """The kernel's grid over ``groups`` chunks of ``length`` rows and
    ``n_heads`` heads: each CTA takes one ``ROW_TILE``-row query tile of
    one chunk and ``heads`` consecutive heads; its 4 warps each hold one
    head and a slice of the head dim."""

    groups: int
    length: int
    n_heads: int
    heads: int

    @property
    def tiles(self) -> int:
        return -(-self.length // ROW_TILE)

    @property
    def ctas(self) -> int:
        return self.tiles * self.groups * -(-self.n_heads // self.heads)

    def work(self, cta: int) -> Tuple[int, int, int]:
        """(chunk, first row, first head) of CTA ``cta`` (``blockIdx.x``):
        ``ssd_chunk.cu``'s map, the last row tile (the most key tiles)
        first."""
        groups = -(-self.n_heads // self.heads)
        per_tile = self.groups * groups
        tile = self.tiles - 1 - cta // per_tile
        return (cta % per_tile) // groups, tile * ROW_TILE, (cta % groups) * self.heads


def ssd_plan(groups: int, length: int, heads: int, sms: int) -> SsdPlan:
    """The grid for ``groups`` chunks of ``length`` rows and ``heads``
    heads on ``sms`` SMs: the largest head group (each shares C . B^T among
    more heads) whose grid still gives each SM a CTA; when none does, one
    head a CTA, the most CTAs the tiles allow."""
    for hg in HEAD_GROUPS:
        plan = SsdPlan(groups, length, heads, hg)
        if plan.ctas >= sms:
            return plan
    return plan


def require_built(n: int, p: int, dtype: torch.dtype = torch.float32) -> None:
    """Raise ``UnbuiltShapeError`` unless the kernels take state size ``n``,
    head dim ``p`` and ``dtype``."""
    if (n, p) not in BUILT:
        raise UnbuiltShapeError(f"state {n} and head dim {p}: the SSD kernels are built for "
                                f"(state, head dim) in {sorted(BUILT)}")
    if dtype != torch.float32:
        raise UnbuiltShapeError(f"the SSD kernels take float32 inputs, not {dtype}")


def _check(x, dt, cum, b, c, seg=None, **more):
    """Raise on anything the kernels do not take (``more``: further f32
    tensors, the backward's y and dy)."""
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernels take CUDA tensors, got {x.device}")
    f32 = [("dt", dt), ("cum", cum), ("b", b), ("c", c), *more.items()]
    for name, t in f32 + ([("seg", seg)] if seg is not None else []):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in [("x", x)] + f32:
        if t.dtype != torch.float32:
            raise UnbuiltShapeError(f"{name} is {t.dtype}: the SSD kernels take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    require_built(b.shape[-1], x.shape[-1], x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself at a 16-byte aligned address (the kernel reads rows in
    16-byte loads), else an aligned copy (a fresh allocation is aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, dt, cum, b, c, seg, g, length, segment):
    """The output, and whether a kernel was launched (not for empty input)."""
    h = x.shape[-2]
    x, b, c = _aligned(x), _aligned(b), _aligned(c)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y, False
    plan = ssd_plan(g, length, h, _sm_count(x.device.index))
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.repro_ssd(
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b.data_ptr(), c.data_ptr(),
            seg.data_ptr() if seg is not None else 0, y.data_ptr(), g, length, h,
            x.shape[-1], b.shape[-1], int(segment), plan.heads,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed (code {err})")
    return y, True


def ssd_chunk(
    x: torch.Tensor,  # (B, NC, L, H, P) f32
    dt: torch.Tensor,  # (B, NC, L, H)
    cum: torch.Tensor,  # (B, NC, L, H) cumulative log-decay within the chunk
    b: torch.Tensor,  # (B, NC, L, N), shared by every head
    c: torch.Tensor,  # (B, NC, L, N)
) -> torch.Tensor:
    """Intra-chunk SSD term (B, NC, L, H, P) from the CUDA kernel (K6)."""
    _check(x, dt, cum, b, c)
    bs, nc, l, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bs, nc, l, h) or cum.shape != dt.shape or b.shape != (bs, nc, l, n) \
            or c.shape != b.shape:
        raise ValueError(f"want x (B, NC, L, H, P), dt and cum (B, NC, L, H), b and c "
                         f"(B, NC, L, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(cum.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    y, launched = _launch(x, dt, cum, b, c, None, bs * nc, l, segment=False)
    ssd_chunk.launches += int(launched)
    return y


def ssd_segment(
    x: torch.Tensor,  # (T, H, P) f32 packed tokens
    dt: torch.Tensor,  # (T, H)
    cum: torch.Tensor,  # (T, H) cumulative log-decay over the packed axis
    b: torch.Tensor,  # (T, N)
    c: torch.Tensor,  # (T, N)
    seg: torch.Tensor,  # (T,) int segment (slot) ids; < 0 = padding
) -> torch.Tensor:
    """Segment-masked SSD term (T, H, P) from the CUDA kernel (K5).  Each
    segment must be one contiguous run of tokens, as ``pack_step`` lays a
    step out (the plain version's ``cum`` assumes it too): a row tile's
    keys start at its first row's segment.  ``seg`` is cast to contiguous
    int32 (a few hundred bytes)."""
    _check(x, dt, cum, b, c, seg)
    t, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (t, h) or cum.shape != dt.shape or b.shape != (t, n) \
            or c.shape != b.shape or seg.shape != (t,):
        raise ValueError(f"want x (T, H, P), dt and cum (T, H), b and c (T, N), seg (T,); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, {tuple(seg.shape)}")
    y, launched = _launch(x, dt, cum, b, c, seg.to(torch.int32).contiguous(), 1, t,
                          segment=True)
    ssd_segment.launches += int(launched)
    return y


def scratch_bytes(groups: int, length: int) -> int:
    """Bytes of the backward's dS scratch, (G, L, L) f32 (dS summed over
    every head; the blocks at or below the diagonal written and read)."""
    return 4 * groups * length * length


def ssd_chunk_bwd(
    x: torch.Tensor,  # (B, NC, L, H, P) f32, the forward's inputs
    dt: torch.Tensor,  # (B, NC, L, H)
    cum: torch.Tensor,  # (B, NC, L, H)
    b: torch.Tensor,  # (B, NC, L, N)
    c: torch.Tensor,  # (B, NC, L, N)
    y: torch.Tensor,  # (B, NC, L, H, P) the forward's output
    dy: torch.Tensor,  # (B, NC, L, H, P) its cotangent
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dcum, db, dc) of K6 from the CUDA kernels (two launches).
    ``y`` gives dcum's row part, sum_j g_ij = dy_i . y_i, as flash
    attention's backward reads its output.  Every output and the dS scratch
    (``scratch_bytes``) are allocated here; L must be a multiple of
    ``ROW_TILE`` up to ``BWD_MAX_LEN``."""
    _check(x, dt, cum, b, c, y=y, dy=dy)
    bs, nc, l, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bs, nc, l, h) or cum.shape != dt.shape or b.shape != (bs, nc, l, n) \
            or c.shape != b.shape or y.shape != x.shape or dy.shape != x.shape:
        raise ValueError(f"want x, y and dy (B, NC, L, H, P), dt and cum (B, NC, L, H), b and "
                         f"c (B, NC, L, N); got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(dy.shape)}, {tuple(dt.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if l % ROW_TILE or l > BWD_MAX_LEN:
        raise UnbuiltShapeError(f"chunk length {l}: the SSD backward takes multiples of "
                                f"{ROW_TILE} up to {BWD_MAX_LEN}")
    x, b, c, y, dy = (_aligned(t) for t in (x, b, c, y, dy))
    outs = tuple(torch.empty_like(t) for t in (x, dt, cum, b, c))
    if x.numel() == 0:
        return tuple(o.zero_() for o in outs)
    g = bs * nc
    ds = torch.empty((g, l, l), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.repro_ssd_bwd(
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b.data_ptr(), c.data_ptr(),
            dy.data_ptr(), y.data_ptr(), *(o.data_ptr() for o in outs), ds.data_ptr(),
            g, l, h, p, n, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD backward launch failed (code {err})")
    ssd_chunk_bwd.launches += 1
    return outs


ssd_chunk.launches = 0
ssd_chunk_bwd.launches = 0
ssd_segment.launches = 0
