"""Kernel dispatch keyed on the tensors' device (port of ``repro.kernels.ops``).

* CUDA tensors go to the hand-written kernel (``flash_attention.py`` for
  paged attention and training attention, ``rmsnorm.py`` for RMSNorm and
  its backward, ``masked_accum.py`` for the DropCompute accumulate,
  ``ssd_chunk.py`` for Mamba-2's intra-chunk and segment-masked SSD terms).  A
  kernel that fails to build or launch raises: there is no fallback to
  the plain version.
* CPU tensors go to the plain PyTorch version in ``ref.py``.
* Any other device raises.

Gradients: ``flash_attention``, ``rmsnorm`` and ``ssd_chunk`` are
``torch.autograd`` Functions whose backward dispatches the same way (the
CUDA backward kernels on the card, the explicit formulas of ``ref.py`` on
the CPU); they take the autograd path only when an input requires grad.
``ssd_segment`` (K5) is forward-only: it serves token-packed steps, and the
reference trains no packed layout, so it raises under an input that
requires grad.
"""
from __future__ import annotations

from typing import Dict, Hashable

import torch

from . import flash_attention as _fa
from . import masked_accum as _ma
from . import ref as _ref
from . import rmsnorm as _rms
from . import ssd_chunk as _ssd

#: kernel name -> the wrapper whose ``launches`` attribute counts it
KERNELS = {
    "paged_attention": _fa.paged_flash_attention,
    "rmsnorm": _rms.rmsnorm,
    "rmsnorm_bwd": _rms.rmsnorm_bwd,
    "flash_attention": _fa.flash_attention_fwd,
    "flash_attention_bwd": _fa.flash_attention_bwd,
    "masked_accum": _ma.masked_accum,
    "ssd_chunk": _ssd.ssd_chunk,
    "ssd_chunk_bwd": _ssd.ssd_chunk_bwd,
    "ssd_segment": _ssd.ssd_segment,
}


def launch_counts(by_shape: bool = False) -> Dict[Hashable, int]:
    """Launches of each hand-written kernel since the last reset, by kernel
    name.  With ``by_shape`` the kernels that also tally their launches by
    problem shape (``shapes``: K3's forward and backward, by (B, Sq, Sk))
    add one entry for each shape they launched at, keyed (name, shape)."""
    counts: Dict[Hashable, int] = {name: fn.launches for name, fn in KERNELS.items()}
    if by_shape:
        counts.update({(name, shape): n for name, fn in KERNELS.items()
                       for shape, n in getattr(fn, "shapes", {}).items()})
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes.clear()


def add_launches(counts: Dict[Hashable, int]) -> None:
    """Add ``counts`` (``launch_counts``' keys -> launches) to the counters:
    a CUDA graph's replay launches what its capture recorded
    (``graphs.StepGraph``), with no wrapper called."""
    for key, n in counts.items():
        if isinstance(key, tuple):
            name, shape = key
            tally = KERNELS[name].shapes
            tally[shape] = tally.get(shape, 0) + n
        else:
            KERNELS[key].launches += n


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain path for device {x.device}")
    return x.device.type


def paged_flash_attention(q, k_pool, v_pool, tables, q_pos, q_slots,
                          window=0, softcap=0.0, k_scale=None, v_scale=None, plan=None):
    """Fused paged attention: the CUDA kernel on the card (over ``plan``,
    the step's tile plan, made by the wrapper when None), the vectorised
    plain path (``ref.paged_attention_ref``) on the CPU, which needs no
    plan."""
    if _device_type(q) == "cuda":
        return _fa.paged_flash_attention(
            q, k_pool, v_pool, tables, q_pos, q_slots, window=window,
            softcap=softcap, k_scale=k_scale, v_scale=v_scale, plan=plan)
    return _ref.paged_attention_ref(
        q, k_pool, v_pool, tables, q_pos, q_slots, window=window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


def rmsnorm_fwd(x, scale, eps=1e-6, model=False):
    """RMSNorm without autograd: the CUDA forward kernel on the card,
    ``ref.rmsnorm_model`` (``model=True``) or ``ref.rmsnorm_ref`` on the CPU."""
    if _device_type(x) == "cuda":
        return _rms.rmsnorm(x, scale, eps=eps, model=model)
    return (_ref.rmsnorm_model if model else _ref.rmsnorm_ref)(x, scale, eps)


def rmsnorm_bwd(x, scale, dy, eps=1e-6, model=False):
    """(dx, dscale): the CUDA backward on the card, ``ref.rmsnorm_bwd_ref``
    on the CPU."""
    if _device_type(x) == "cuda":
        return _rms.rmsnorm_bwd(x, scale, dy, eps=eps, model=model)
    return _ref.rmsnorm_bwd_ref(x, scale, dy, eps, model)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with its backward kernel (K2 forward and backward)."""

    @staticmethod
    def forward(ctx, x, scale, eps, model):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.model = eps, model
        return rmsnorm_fwd(x, scale, eps, model)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps, ctx.model)
        return dx, (dscale if ctx.needs_input_grad[1] else None), None, None


def rmsnorm(x, scale, eps=1e-6, model=False):
    """RMSNorm over the last axis, differentiable through ``RMSNormFn`` when
    an input requires grad."""
    if _needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps, model)
    return rmsnorm_fwd(x, scale, eps, model)


def flash_attention_fwd(q, k, v, causal=True, window=0, q_segment_ids=None,
                        kv_segment_ids=None):
    """(out, lse): the CUDA forward kernel on the card,
    ``ref.flash_attention_fwd_ref`` on the CPU."""
    fn = _fa.flash_attention_fwd if _device_type(q) == "cuda" else _ref.flash_attention_fwd_ref
    return fn(q, k, v, causal=causal, window=window, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids)


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=0,
                        q_segment_ids=None, kv_segment_ids=None):
    """(dq, dk, dv): the CUDA backward kernels on the card,
    ``ref.flash_attention_bwd_ref`` on the CPU."""
    fn = _fa.flash_attention_bwd if _device_type(q) == "cuda" else _ref.flash_attention_bwd_ref
    return fn(q, k, v, out, lse, dout, causal=causal, window=window,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its backward kernel (K3 forward and backward); saves
    q, k, v, the output and the per-row log-sum-exp, never the (S, S)
    matrix."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_segment_ids, kv_segment_ids):
        out, lse = flash_attention_fwd(q, k, v, causal, window, q_segment_ids, kv_segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, q_segment_ids, kv_segment_ids)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qs, ks = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.window, qs, ks)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, window=0, q_segment_ids=None, kv_segment_ids=None):
    """GQA flash attention of q (B, H, Sq, D) over k/v (B, KV, Sk, D), the
    reference's ``ops.flash_attention`` layout (any strides); right-aligned
    causal mask, window, optional segment ids.  Differentiable through
    ``FlashAttentionFn`` when an input requires grad."""
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_segment_ids, kv_segment_ids)
    return flash_attention_fwd(q, k, v, causal, window, q_segment_ids, kv_segment_ids)[0]


def masked_accum(acc, grad, keep=1.0, scale=1.0):
    """``acc += keep * scale * grad`` in place on the f32 or bf16 accumulator (K1):
    the Triton kernel on the card, ``ref.masked_accum_ref`` on the CPU.
    ``keep`` and ``scale`` are host floats.  Returns ``acc``."""
    if _device_type(acc) == "cuda":
        return _ma.masked_accum(acc, grad, keep, scale)
    return acc.copy_(_ref.masked_accum_ref(acc, grad, keep, scale))


def ssd_chunk_fwd(x, dt, cum, b, c):
    """K6 without autograd: the CUDA kernel on the card, ``ref.ssd_chunk_ref``
    on the CPU."""
    fn = _ssd.ssd_chunk if _device_type(x) == "cuda" else _ref.ssd_chunk_ref
    return fn(x, dt, cum, b, c)


def ssd_chunk_bwd(x, dt, cum, b, c, y, dy):
    """(dx, ddt, dcum, db, dc) of K6: the CUDA backward on the card (it reads
    the forward's output ``y``), ``ref.ssd_chunk_bwd_ref`` on the CPU."""
    if _device_type(x) == "cuda":
        return _ssd.ssd_chunk_bwd(x, dt, cum, b, c, y, dy)
    return _ref.ssd_chunk_bwd_ref(x, dt, cum, b, c, dy)


class SsdChunkFn(torch.autograd.Function):
    """K6 with its backward kernel; saves the inputs and the output (the
    backward's row part of dcum is dy . y), never an (L, L) matrix."""

    @staticmethod
    def forward(ctx, x, dt, cum, b, c):
        y = ssd_chunk_fwd(x, dt, cum, b, c)
        ctx.save_for_backward(x, dt, cum, b, c, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        return ssd_chunk_bwd(*ctx.saved_tensors, dy.contiguous())


def ssd_chunk(x, dt, cum, b, c):
    """Intra-chunk SSD term (K6) of x (B, NC, L, H, P), dt / cum (B, NC, L, H),
    b / c (B, NC, L, N): the CUDA kernel on the card, ``ref.ssd_chunk_ref``
    on the CPU.  Differentiable through ``SsdChunkFn`` when an input
    requires grad."""
    if _needs_grad(x, dt, cum, b, c):
        return SsdChunkFn.apply(x, dt, cum, b, c)
    return ssd_chunk_fwd(x, dt, cum, b, c)


def ssd_segment(x, dt, cum, b, c, seg):
    """Segment-masked SSD term (K5) of a packed step, x (T, H, P), dt / cum
    (T, H), b / c (T, N), seg (T,): the CUDA kernel on the card,
    ``ref.ssd_segment_ref`` on the CPU.  Forward only: K5 serves packed
    steps, and no training path runs a packed layout (the reference trains
    none), so an input that requires grad raises."""
    if _needs_grad(x, dt, cum, b, c):
        raise NotImplementedError(
            "ssd_segment (K5) is forward-only: it serves token-packed steps, and training "
            "runs the dense chunked scan (ssd_chunk, K6), which has a backward")
    fn = _ssd.ssd_segment if _device_type(x) == "cuda" else _ref.ssd_segment_ref
    return fn(x, dt, cum, b, c, seg)
