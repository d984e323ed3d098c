"""Core layers for the G/L decoder serving path (port of ``repro.models.layers``).

Plain functions on tensors and nested-dict parameters with the reference's
path names and shapes.  Parameters live in ``cfg.param_dtype`` and are
cast to ``cfg.dtype`` at use, as in the reference; ``model.compute_params``
makes those casts once for a serving engine (the cast is deterministic, so
the numbers are unchanged).

Caches are updated **in place**: JAX returns a new cache from every write,
the port writes into the pool it was given (copying a KV pool per layer
per step would cost more than the step).  JAX's ``mode="drop"`` scatters
silently discard out-of-range rows; torch indexing would raise or corrupt
memory instead, so every scatter here writes only the rows the reference
keeps, picked once per step by ``step_index``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from .config import ModelConfig

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

_TN_LO = math.erf(-2.0 / math.sqrt(2.0))
_TN_HI = math.erf(2.0 / math.sqrt(2.0))


def dense_init(gen: Optional[torch.Generator], shape, in_axis=0, scale: float = 1.0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn like ``jax.random.truncated_normal``
    (uniform on the CDF interval, then ``√2·erfinv``) from ``gen``.  On the
    ``meta`` device it allocates nothing (for ``param_count``)."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else math.prod(
        shape[a] for a in in_axis
    )
    std = scale / math.sqrt(fan_in)
    device = torch.device(device if device is not None else "cpu")
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(_TN_LO + (_TN_HI - _TN_LO) * u)
    return (z.clamp_(-2.0, 2.0) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device=None) -> Params:
    p = {"scale": torch.ones((cfg.d_model,), dtype=cfg.params_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=cfg.params_dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6):
    """RMSNorm goes through ``kernels.ops.rmsnorm`` in model mode (f32
    statistics, compute-dtype multiplies — ``layers.py:54-57``): the Triton
    kernel on the card, its plain version on the CPU.  LayerNorm is plain."""
    if cfg.norm == "rmsnorm":
        return kernel_ops.rmsnorm(x, p["scale"], eps=eps, model=True)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """Per-head RMS norm for QK-norm (Qwen3-style), f32 math."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles at ``positions`` (..., S), shaped
    (..., S, 1, D/2) to broadcast over heads.  The reference computes them
    inside ``apply_rope`` (``layers.py:74-90``); here a serving step makes
    them once for all its layers (``step_index``), with the same math."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x: (..., S, H, D); ``rope`` the (cos, sin) of ``rope_angles``."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, global or sliding-window, optional bias/QK-norm/softcap)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, device=None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = cfg.params_dtype
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype=pd, device=device),
        "wk": dense_init(gen, (d, kv, hd), dtype=pd, device=device),
        "wv": dense_init(gen, (d, kv, hd), dtype=pd, device=device),
        "wo": dense_init(gen, (h, hd, d), in_axis=(0, 1), dtype=pd, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=pd, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=pd, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=pd, device=device)
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=pd, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=pd, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d = w.shape[0]
    return (x @ w.to(cd).reshape(d, -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, rope):
    """Projections, bias, QK-norm and RoPE (``rope``: ``rope_angles`` of the
    step's positions, or None without rotary positions)."""
    cd = cfg.compute_dtype
    q = _proj(x, p["wq"], cd)
    k = _proj(x, p["wk"], cd)
    v = _proj(x, p["wv"], cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.use_qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if rope is not None:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    return q, k, v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], softcap: float = 0.0) -> torch.Tensor:
    """Plain scaled-dot-product attention with GQA head grouping (the
    dense-layout path, as in the reference).

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D); mask broadcastable to
    (B, H, Sq, Sk) (True = attend)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qh = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float())
    logits = logits / math.sqrt(d)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        m = mask.reshape(b, kvh, g, *mask.shape[-2:]) if mask.shape[1] == h else mask[:, :, None]
        logits = torch.where(m, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV addressing
# ---------------------------------------------------------------------------


def paged_index(tables, slots, positions, page_size: int, num_pages: int):
    """Translate absolute ``(slot, position)`` into physical ``(page,
    offset)`` through the block tables (``layers.py:351``).  Positions past
    the logical buffer and unallocated blocks come back as ``page ==
    num_pages``.  JAX clamps the gather index implicitly; here it is
    clamped explicitly."""
    nb = tables.shape[-1]
    blk = positions // page_size
    page = tables[slots, blk.clamp(0, nb - 1)]
    return torch.where(blk < nb, page, num_pages), positions % page_size


def _paged_quantize(rows: torch.Tensor):
    """Per-row symmetric int8: codes of ``rows``' shape plus f32 scales of
    shape (..., KV), one per (token row, kv head)."""
    rf = rows.float()
    amax = rf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    codes = torch.clamp(torch.round(rf / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def _paged_write(cache, page, off, k_rows, v_rows):
    """Scatter K/V rows (N, KV, D) into the paged pool at ``(page, off)``
    (N,), in place.  int8 pools (marked by ``k_scale``/``v_scale``)
    quantize each row and scatter its scale."""
    if "k_scale" in cache:
        kq, ks = _paged_quantize(k_rows)
        vq, vs = _paged_quantize(v_rows)
        cache["k"][page, off] = kq
        cache["v"][page, off] = vq
        cache["k_scale"][page, off] = ks
        cache["v_scale"][page, off] = vs
    else:
        cache["k"][page, off] = k_rows.to(cache["k"].dtype)
        cache["v"][page, off] = v_rows.to(cache["v"].dtype)
    return cache


def _paged_attend(q_tok, cache, page_tables, q_pos, q_slots, window, softcap):
    """Fused paged attention over flattened query tokens (T, H, D): the
    one entry point of the packed, chunked and verify paged branches.
    ``kernels.ops`` picks the CUDA kernel or the plain path by device."""
    return kernel_ops.paged_flash_attention(
        q_tok, cache["k"], cache["v"], page_tables, q_pos, q_slots,
        window=window, softcap=softcap,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
    )


@dataclasses.dataclass(frozen=True)
class StepIndex:
    """A serving step's token addressing for one layer kind.

    It is the same for every layer of the kind, so ``apply_stack`` makes
    it once per step and kind (``step_index``) and each layer only
    projects, writes and attends.  ``rope`` is the (cos, sin) of the
    step's positions (None without rotary positions).  ``write_rows``
    picks, from the step's K/V rows flattened over the token dims, the
    rows that land in the cache, and ``write_at`` says where: (page,
    offset) in the paged pool or (slot, position) in dense slots.  The
    rows JAX's ``mode="drop"`` scatters discard are filtered out here
    (torch indexing would raise or corrupt memory instead), with one host
    sync per step and kind.  ``q_pos``/``q_slots`` (int32) address the
    paged kernel's queries; ``gather``/``mask`` are the dense layout's
    per-query slot rows and attention mask."""

    rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
    write_rows: torch.Tensor
    write_at: Tuple[torch.Tensor, torch.Tensor]
    q_pos: Optional[torch.Tensor] = None
    q_slots: Optional[torch.Tensor] = None
    gather: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


def step_index(
    cfg: ModelConfig,
    kind: str,
    positions: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    decode_pos: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,
    slot_ids: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: int = 0,
) -> StepIndex:
    """The addressing of ``apply_attention``'s cache branches (token-packed
    ``layers.py:528-585``, chunked ``:601-658``) for one layer kind."""
    window = cfg.sliding_window if kind == "L" else 0
    dev = positions.device
    rope = (rope_angles(positions, cfg.hd, cfg.rope_theta)
            if cfg.pos == "rope" else None)
    if page_tables is not None:
        buf_len = page_tables.shape[-1] * page_size
    else:
        buf_len = cache["k"].shape[1]
    what = "packed step" if slot_ids is not None else "chunked prefill"
    if window > 0 and buf_len <= window:
        raise ValueError(
            f"{what} needs a linear cache "
            f"(init_decode_cache(..., linear=True)); got ring buffer of "
            f"{buf_len} rows for sliding window {window}"
        )

    if slot_ids is not None:
        slots = slot_ids  # (P,)
        qpos = positions.reshape(-1)  # (P,) absolute
        valid = slots >= 0
        rows = torch.where(valid, slots, 0)
        wp = torch.where(valid, qpos, buf_len)  # out of range => dropped
    else:
        if decode_pos is None or decode_pos.dim() != 1:
            # typed, not assert-ed (python -O): a (B, 1) positions array
            # would broadcast into wrong scatter addresses silently
            raise ValueError("chunked prefill needs per-slot positions of shape (B,)")
        b, c = positions.shape
        offs = torch.arange(c, device=dev)
        qpos = decode_pos[:, None] + offs[None, :]  # (B, C) absolute positions
        lens = torch.full((b,), c, device=dev) if seq_lens is None else seq_lens
        active = offs[None, :] < lens[:, None]  # (B, C)
        wp = torch.where(active, qpos, buf_len)  # out of range => dropped
        rows = torch.arange(b, device=dev)[:, None].expand(b, c)

    if page_tables is not None:
        num_pages = cache["k"].shape[0]
        page, off = paged_index(page_tables, rows, wp, page_size, num_pages)
        page, off = page.reshape(-1), off.reshape(-1)
        keep = ((page >= 0) & (page < num_pages)).nonzero()[:, 0]  # one sync
        q_slots = slots if slot_ids is not None else torch.where(active, rows, -1)
        return StepIndex(rope, keep, (page[keep], off[keep]),
                         q_pos=qpos.reshape(-1).int(), q_slots=q_slots.reshape(-1).int())

    rows, wp = rows.reshape(-1), wp.reshape(-1)
    keep = (wp < buf_len).nonzero()[:, 0]  # one sync
    kpos = torch.arange(buf_len, device=dev)
    if slot_ids is not None:
        mask = (kpos[None, :] <= qpos[:, None]) & valid[:, None]  # (P, L)
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        return StepIndex(rope, keep, (rows[keep], wp[keep]), gather=rows,
                         mask=mask[:, None, None, :])
    mask = kpos[None, None, :] <= qpos[..., None]  # (B, C, L)
    if window > 0:
        mask &= kpos[None, None, :] > qpos[..., None] - window
    return StepIndex(rope, keep, (rows[keep], wp[keep]), mask=mask[:, None])


def apply_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    positions: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    decode_pos: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,
    slot_ids: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: int = 0,
    index: Optional[StepIndex] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One attention block over a serving cache (the cache branches of
    ``layers.apply_attention``: token-packed ``:528-585`` and chunked
    ``:601-658``, dense or paged layout).

    slot_ids (packed step): x is (1, P, d); token j writes its K/V to slot
    ``slot_ids[j]`` at absolute position ``positions[0, j]`` and attends
    only that slot's rows at positions <= its own; ``slot_ids[j] < 0`` is
    padding.  Otherwise (chunked prefill): slot i consumes
    ``x[i, :seq_lens[i]]`` at absolute positions ``decode_pos[i]...``.
    Both need a linear cache.  ``page_tables``/``page_size`` select the
    paged layout: writes go through ``paged_index``, reads through the
    fused ``kernels.ops.paged_flash_attention``.  ``index`` is the step's
    ``step_index`` for this kind, made here when not given.
    """
    if kind not in ("G", "L"):
        raise ValueError(f"serving attention runs 'G'/'L' blocks, got {kind!r}")
    if cache is None:
        raise NotImplementedError("attention without a serving cache is not ported yet")
    if index is None:
        index = step_index(cfg, kind, positions, cache, decode_pos, seq_lens, slot_ids,
                           page_tables, page_size)
    cd = cfg.compute_dtype
    window = cfg.sliding_window if kind == "L" else 0
    q, k, v = _qkv(p, x, cfg, index.rope)
    k_rows = k.reshape(-1, *k.shape[-2:])[index.write_rows]
    v_rows = v.reshape(-1, *v.shape[-2:])[index.write_rows]
    if page_tables is not None:
        _paged_write(cache, *index.write_at, k_rows, v_rows)
        out = _paged_attend(q.reshape(-1, *q.shape[-2:]), cache, page_tables, index.q_pos,
                            index.q_slots, window, cfg.logit_softcap).reshape(q.shape)
    else:
        cache["k"][index.write_at] = k_rows.to(cache["k"].dtype)
        cache["v"][index.write_at] = v_rows.to(cache["v"].dtype)
        if slot_ids is not None:
            kk = cache["k"][index.gather]  # (P, L, KV, D)
            vv = cache["v"][index.gather]
            out = sdpa(q[0][:, None], kk.to(cd), vv.to(cd), index.mask,
                       cfg.logit_softcap)[:, 0][None]  # (1, P, H, D)
        else:
            out = sdpa(q, cache["k"].to(cd), cache["v"].to(cd), index.mask,
                       cfg.logit_softcap)

    wo = p["wo"].to(cd)
    y = out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])
    return y, cache


def init_attention_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                         linear: bool = False, device=None) -> Dict[str, torch.Tensor]:
    """Pre-allocated dense cache for one attention layer.  ``linear=True``
    gives sliding-window layers the full length (plus one row when
    ``seq_len == window``), which the chunked and packed paths require."""
    if kind == "L":
        buf = max(seq_len, cfg.sliding_window + 1) if linear else min(cfg.sliding_window, seq_len)
    else:
        buf = seq_len
    kv, hd = cfg.n_kv_heads, cfg.hd
    shape = (batch, buf, kv, hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None, device=None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    pd = cfg.params_dtype
    p = {"w_out": dense_init(gen, (f, d), dtype=pd, device=device)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d, f), dtype=pd, device=device)
        p["w_in"] = dense_init(gen, (d, f), dtype=pd, device=device)
    else:
        p["w_in"] = dense_init(gen, (d, f), dtype=pd, device=device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(cd)
        u = x @ p["w_in"].to(cd)
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(x @ p["w_in"].to(cd), approximate="tanh")
    return h @ p["w_out"].to(cd)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, cfg: ModelConfig, device=None) -> Params:
    pd = cfg.params_dtype
    p = {"embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1,
                                 dtype=pd, device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=pd,
                                  device=device)
    if cfg.pos == "learned":
        p["pos_embedding"] = dense_init(gen, (8192, cfg.d_model), in_axis=1, dtype=pd,
                                        device=device)
    return p


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig, positions=None):
    x = p["embedding"][tokens].to(cfg.compute_dtype)
    if cfg.family != "ssm":
        x = x * math.sqrt(cfg.d_model)
    if cfg.pos == "learned" and positions is not None:
        pe = p["pos_embedding"][positions % p["pos_embedding"].shape[0]]
        x = x + pe.to(cfg.compute_dtype)
    return x


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p.get("unembed")
    if w is None:
        w = p["embedding"].T
    return x @ w.to(cfg.compute_dtype)
