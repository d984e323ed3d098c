"""``paged_flash_attention``: the CUDA paged-attention kernel's wrapper.

Port of the TPU kernel ``repro.kernels.flash_attention.paged_flash_attention``
(src/repro/kernels/flash_attention.py:238, body ``_paged_attn_kernel``
:166).  The kernel itself is ``paged_attention.cu`` (one CTA per (query
token, KV head), pool read in its native ``(P, page_size, KV, D)`` layout,
the block range split over more CTAs when the grid is too small for the
card); this module checks the arguments, picks the split, allocates the
output and the split's scratch, and launches it on PyTorch's current
stream.  It takes CUDA tensors only: the plain version for the CPU is
``kernels.ref.paged_attention_ref``, chosen by ``kernels.ops`` from the
tensors' device.

``paged_flash_attention.launches`` counts launches (nothing else adds to
it), so a run can show that the serving path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

SOURCE = "paged_attention.cu"
# (head dim, H / KV) the source instantiates: the configs the port serves
SERVED = {(128, 8)}  # qwen2.5-3b
WARPS = 4  # kWarps in the source: blocks a CTA walks at once

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 11 + [_I] * 11 + [_F, _F] + [_I, _I] + [_P]


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; sets the C signature."""
    lib = _build.load(SOURCE)
    fn = lib.repro_paged_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_blocks(ctas: int, num_blocks: int, sms: int):
    """(splits, blocks_per_split) for a grid of ``ctas`` (token, KV head)
    CTAs over ``num_blocks`` table blocks: split the block range only when
    the grid is under two CTAs per SM (decode), and never below ``WARPS``
    blocks a split, so every warp of a CTA has a block to walk."""
    splits = 1
    if ctas < 2 * sms:
        splits = min(-(-2 * sms // ctas), max(-(-num_blocks // WARPS), 1))
    per = -(-num_blocks // splits)
    return -(-num_blocks // per), per


def _ptr(x) -> int:
    return x.data_ptr() if x is not None else 0


def paged_flash_attention(
    q: torch.Tensor,  # (T, H, D) bf16
    k_pool: torch.Tensor,  # (num_pages, page_size, KV, D) bf16 | int8
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # (num_slots, num_blocks) int
    q_pos: torch.Tensor,  # (T,) int
    q_slots: torch.Tensor,  # (T,) int; < 0 = padding
    window: int = 0,
    softcap: float = 0.0,
    k_scale: torch.Tensor = None,  # (num_pages, page_size, KV) f32, int8 pools
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take.

    The pools are never copied: they must be contiguous in their native
    layout and 16-byte aligned (the engine's pools are).  ``tables``/
    ``q_pos``/``q_slots`` are cast to contiguous int32 (a few hundred
    bytes)."""
    if q.device.type != "cuda":
        raise ValueError(f"the paged-attention kernel takes CUDA tensors, got {q.device}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables),
                    ("q_pos", q_pos), ("q_slots", q_slots)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q (T, H, D) and equal pools (P, ps, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    t, h, d = q.shape
    num_pages, page_size, kvh, dk = k_pool.shape
    if dk != d or h % kvh or (d, h // kvh) not in SERVED:
        raise ValueError(f"head dim {d} (pool {dk}) and group H/KV = {h}/{kvh}: the kernel "
                         f"is built for (head dim, group) in {sorted(SERVED)}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q must be bfloat16, got {q.dtype}")
    quantized = k_pool.dtype == torch.int8
    if (k_scale is not None) != (v_scale is not None) or quantized != (k_scale is not None):
        raise ValueError("int8 pools need both k_scale and v_scale; float pools neither")
    if not quantized and k_pool.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} must be bfloat16 or int8")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k and v pools must share a dtype")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (the kernel reads their native layout)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (the kernel reads rows in 16-byte loads)")
    if quantized:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (s.dtype != torch.float32 or tuple(s.shape) != (num_pages, page_size, kvh)
                    or not s.is_contiguous() or s.device != q.device):
                raise ValueError(f"{name} must be contiguous f32 (P, ps, KV) on {q.device}")
    num_slots, num_blocks = tables.shape
    if q_pos.shape != (t,) or q_slots.shape != (t,):
        raise ValueError("q_pos and q_slots must have shape (T,)")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()  # a fresh allocation is aligned
    tables = tables.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    q_slots = q_slots.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if t == 0:
        return out
    splits, per_split = split_blocks(t * kvh, num_blocks, _sm_count(q.device.index))
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((t, kvh, splits, h // kvh, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((t, kvh, splits, h // kvh, 2), dtype=torch.float32,
                              device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_attention(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(k_scale), _ptr(v_scale),
            _ptr(tables), _ptr(q_pos), _ptr(q_slots), _ptr(out), _ptr(part_acc),
            _ptr(part_ml), t, h, kvh, d, num_pages, page_size, num_slots, num_blocks,
            splits, per_split, int(window), float(softcap), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), int(quantized), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged-attention kernel launch failed (code {err})")
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
