"""Plain PyTorch versions of the ported kernels (the correctness references).

Ports of ``repro.kernels.ref``.  Its paged attention and the vectorised
XLA path ``paged_attention_xla`` (``repro.kernels.flash_attention``)
compute the same function, so one port stands for both.  On the CPU the
dispatcher (``kernels.ops``) runs these; on the card ``chip_smoke.py``
holds each hand-written kernel against them on the same inputs.
"""
from __future__ import annotations

import math

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
