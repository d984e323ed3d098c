"""Plain PyTorch versions of the ported kernels (the correctness references).

Ports of ``repro.kernels.ref``.  Its paged attention and the vectorised
XLA path ``paged_attention_xla`` (``repro.kernels.flash_attention``)
compute the same function, so one port stands for both.  The backward
passes (flash attention, RMSNorm) have no reference kernel: their plain
versions are the explicit gradient formulas, held on the CPU against
``jax.grad`` of the reference's jnp paths.  On the CPU the dispatcher
(``kernels.ops``) runs these; on the card ``chip_smoke.py`` holds each
hand-written kernel against them on the same inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def paged_attention_ref(
    q: torch.Tensor,  # (T, H, D) packed query tokens
    k_pool: torch.Tensor,  # (num_pages, page_size, KV, D)
    v_pool: torch.Tensor,  # (num_pages, page_size, KV, D)
    tables: torch.Tensor,  # (num_slots, num_blocks) int32
    q_pos: torch.Tensor,  # (T,) absolute positions
    q_slots: torch.Tensor,  # (T,) slot per query; < 0 = padding
    window: int = 0,
    softcap: float = 0.0,
    k_scale: torch.Tensor = None,  # (num_pages, page_size, KV) f32, int8 pools
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """Plain paged attention, the path the port runs on the CPU.  Port of
    both ``repro.kernels.ref.paged_attention_ref`` and the vectorised
    ``repro.kernels.flash_attention.paged_attention_xla``, which compute
    the same function: gather only each token's own pages through its
    slot's block table (one (T, num_blocks) gather, never the whole pool),
    mask by position (causal / sliding window) and by bad table entries
    (negative or ``>= num_pages``, redirected to page 0 and masked).
    Padding queries and fully-masked queries return zero rows.  int8 pools
    pass per-row scales."""
    if (k_scale is not None) != (v_scale is not None):
        # raised, not assert-ed: a half-passed pair would silently attend
        # over raw int8 codes for one of K/V
        raise ValueError("pass both k_scale and v_scale, or neither")
    t, h, d = q.shape
    num_pages, page_size, kvh, _ = k_pool.shape
    nb = tables.shape[1]
    g = h // kvh
    q_pos = q_pos.long()
    q_slots = q_slots.long()
    valid_q = q_slots >= 0
    pages = tables[q_slots.clamp(0, tables.shape[0] - 1)].long()  # (T, NB)
    page_ok = (pages >= 0) & (pages < num_pages)
    safe = torch.where(page_ok, pages, 0)
    keys = k_pool[safe].float()  # (T, NB, ps, KV, D)
    vals = v_pool[safe].float()
    if k_scale is not None:
        keys = keys * k_scale[safe][..., None]
        vals = vals * v_scale[safe][..., None]
    keys = keys.reshape(t, nb * page_size, kvh, d)
    vals = vals.reshape(t, nb * page_size, kvh, d)
    qg = q.reshape(t, kvh, g, d).float() / math.sqrt(d)
    logits = torch.einsum("thgd,tkhd->thgk", qg, keys)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(nb * page_size, device=q.device)
    mask = (kpos[None, :] <= q_pos[:, None]) & valid_q[:, None]
    if window > 0:
        mask &= kpos[None, :] > q_pos[:, None] - window
    mask &= page_ok[:, :, None].expand(-1, -1, page_size).reshape(t, nb * page_size)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    # re-mask after softmax: a fully-masked query (every page hostile or
    # unallocated) must output zeros, not a uniform mix of gathered rows
    w = torch.softmax(logits, dim=-1) * mask[:, None, None, :]
    out = torch.einsum("thgk,tkhd->thgd", w, vals)
    out = torch.where(valid_q[:, None, None, None], out, 0.0)
    return out.reshape(t, h, d).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The TPU kernel's math (``repro.kernels.ref.rmsnorm_ref``): every
    step in f32, one rounding to ``x.dtype`` at the end."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_model(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The model's RMSNorm numerics (``repro.models.layers.apply_norm``):
    statistics in f32, ``inv`` rounded to ``x.dtype`` before the two
    multiplies, each of which rounds to ``x.dtype``.  Equal to
    :func:`rmsnorm_ref` in f32, not in bf16."""
    ms = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# K3: flash attention (training), forward and backward
# ---------------------------------------------------------------------------


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def visited_keys(sq: int, sk: int, causal: bool, window: int, device=None):
    """(lo, hi): per query row (Sq,), the key range ``[lo, hi)`` the TPU
    kernel ``_attn_kernel`` walks at its default 128/128 blocks
    (``flash_attention.py:45-53``), for the 128-row query block holding
    the row.  A query with no admissible key returns the mean of the
    values in this range (``:110-112``); the CUDA kernel walks the same
    range in 64-key tiles."""
    bq, bk = min(128, sq), min(128, sk)
    qs0 = _floordiv(torch.arange(sq, device=device), bq) * bq
    hi = torch.full((sq,), sk // bk, device=device)
    if causal:
        hi = torch.minimum(_floordiv(qs0 + bq - 1 + sk - sq, bk) + 1, hi)
    lo = torch.zeros_like(hi)
    if window > 0:
        lo = torch.clamp(_floordiv(qs0 + sk - sq - window + 1, bk), min=0)
    return lo * bk, hi * bk


def attention_mask(sq: int, sk: int, causal: bool, window: int,
                   q_segment_ids=None, kv_segment_ids=None, device=None) -> torch.Tensor:
    """(B or 1, Sq, Sk) admissible pairs: right-aligned causal, window,
    equal segment ids (``repro.kernels.ref.flash_attention_ref``)."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    mask = mask[None]
    if q_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    return mask


def flash_attention_fwd_ref(q, k, v, causal=True, window=0, q_segment_ids=None,
                            kv_segment_ids=None, mask=None):
    """(out (B, H, Sq, D) in q's dtype, lse (B, H, Sq) f32).

    Port of ``repro.kernels.ref.flash_attention_ref`` (GQA grouping, no
    repeat of k/v; f32 math, one rounding at the end) plus the per-row
    log-sum-exp of the scaled logits that the backward needs.  One
    difference from that oracle, on purpose: a query with no admissible
    key returns what the TPU kernel returns, the mean of the values over
    ``visited_keys`` (0 when the range is empty), not a uniform mix of
    every key.  ``mask`` (B or 1, Sq, Sk), when given, names the admissible
    pairs in place of causal, window and segments (a check plants a
    kernel fault with it)."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(d)
    if mask is None:
        mask = attention_mask(sq, sk, causal, window, q_segment_ids, kv_segment_ids, q.device)
    mask = mask.expand(b, sq, sk)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(logits, dim=-1), v.float())
    none = ~mask.any(dim=-1)  # (B, Sq): no admissible key
    if bool(none.any()):
        lo, hi = visited_keys(sq, sk, causal, window, q.device)
        kpos = torch.arange(sk, device=q.device)
        vis = ((kpos[None] >= lo[:, None]) & (kpos[None] < hi[:, None])).float()
        mean = torch.einsum("qk,bhkd->bhqd", vis, v.float()) / vis.sum(-1).clamp(min=1)[:, None]
        out = torch.where(none[:, None, None, :, None], mean[:, :, None], out)
    return out.reshape(b, h, sq, d).to(q.dtype), lse.reshape(b, h, sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True, window=0,
                            q_segment_ids=None, kv_segment_ids=None, mask=None):
    """(dq, dk, dv) in q's / k's / v's dtypes: the explicit gradient of
    attention through the saved ``lse``, f32 math.  P = exp(s - lse) on
    admissible pairs and 0 elsewhere, delta = rowsum(dO * O), dS = P (dP -
    delta); dk and dv sum over the g query heads of each KV head.  A query
    with no admissible key sends and receives no gradient.  Equal to
    autograd of ``repro.models.layers.sdpa`` wherever every query has a
    key (causal self-attention always does).  ``mask`` as in
    ``flash_attention_fwd_ref``."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, sq, d).float()
    kf, vf = k.float(), v.float()
    if mask is None:
        mask = attention_mask(sq, sk, causal, window, q_segment_ids, kv_segment_ids, q.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    p = torch.where(mask[:, None, None], torch.exp(s - lse.reshape(b, kvh, g, sq, 1)), 0.0)
    do = dout.reshape(b, kvh, g, sq, d).float()
    delta = (do * out.reshape(b, kvh, g, sq, d).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# K2 backward: RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6, model: bool = False):
    """(dx in x's dtype, dscale in scale's dtype) of ``rmsnorm_ref``
    (``model=False``) or ``rmsnorm_model`` (``model=True``), f32 math with
    one rounding of each output.  With inv = rsqrt(mean(x^2) + eps), inv_c
    its value as the forward multiplies (rounded to x's dtype in model
    mode), t = x * inv_c (rounded likewise) and dt = dy * scale:

        dscale = sum over rows of dy * t
        dx     = dt * inv_c - x * inv^3 * mean(dt * x)

    The rounding steps pass gradients straight through, as JAX's casts do."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if model:
        inv_c = inv.to(x.dtype).float()
        t = (xf * inv_c).to(x.dtype).float()
        s = scale.to(x.dtype).float()
    else:
        inv_c, t, s = inv, xf * inv, scale.float()
    dscale = (dyf * t).reshape(-1, d).sum(dim=0)
    dt = dyf * s
    dx = dt * inv_c - xf * inv.pow(3) * (dt * xf).sum(dim=-1, keepdim=True) / d
    return dx.to(x.dtype), dscale.to(scale.dtype)


# ---------------------------------------------------------------------------
# K1: masked gradient accumulation
# ---------------------------------------------------------------------------


def masked_accum_ref(acc: torch.Tensor, grad: torch.Tensor, keep: float,
                     scale: float = 1.0) -> torch.Tensor:
    """acc + keep * scale * grad in f32 (``repro.kernels.ref.masked_accum_ref``):
    the coefficient keep * scale is formed in f32 first, as JAX does."""
    coef = float(np.float32(keep) * np.float32(scale))
    return acc + coef * grad.float()
