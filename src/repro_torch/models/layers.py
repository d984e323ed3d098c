"""Core layers for G/L decoder stacks, serving and training (port of
``repro.models.layers``).

Plain functions on tensors and nested-dict parameters with the reference's
path names and shapes.  Parameters live in ``cfg.param_dtype`` and are
cast to ``cfg.dtype`` at use, as in the reference; ``model.compute_params``
makes those casts once for a serving engine (the cast is deterministic, so
the numbers are unchanged).

Caches are updated **in place**: JAX returns a new cache from every write,
the port writes into the pool it was given (copying a KV pool per layer
per step would cost more than the step).  JAX's ``mode="drop"`` scatters
silently discard out-of-range rows; torch indexing would raise or corrupt
memory instead, and filtering the rows first (``nonzero``) would sync the
host and give the step a shape that depends on the data.  So every KV
pool is allocated with a spare row past its last (``pool_with_spare``):
the rows the reference drops are written there (``spare``), where no read
reaches, and a step's shapes are set by its inputs' shapes alone (a CUDA
graph can capture it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kernels.flash_attention import step_plan_rows, tile_plan_tensor, tile_tokens
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
    # in place on the one f32 draw: a leaf's transient is one f32 copy of
    # it (the 1.4 G-element gemma3-27b embedding is 5.6 GB), the same bits
    z = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    z.mul_(_TN_HI - _TN_LO).add_(_TN_LO).erfinv_().mul_(math.sqrt(2.0))
    return z.clamp_(-2.0, 2.0).mul_(std).to(dtype)


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
    statistics, compute-dtype multiplies — ``layers.py:54-57``): the CUDA
    forward kernel on the card, its plain version on the CPU; when x or the
    scale requires grad, its gradient is the RMSNorm backward kernel's
    (``ops.RMSNormFn``).  LayerNorm is plain."""
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


def _in_proj(p: Params, x: torch.Tensor, cfg: ModelConfig, name: str) -> torch.Tensor:
    """x's projection by ``w<name>`` ('q', 'k' or 'v'), plus ``b<name>``
    under ``qkv_bias``: (B, S, heads, D) in the compute dtype."""
    y = _proj(x, p["w" + name], cfg.compute_dtype)
    return y + p["b" + name].to(cfg.compute_dtype) if cfg.qkv_bias else y


def _out_proj(p: Params, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The attention output (B, S, H, D) through ``wo``: (B, S, d)."""
    wo = p["wo"].to(cfg.compute_dtype)
    return out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, rope):
    """Projections, bias, QK-norm and RoPE (``rope``: ``rope_angles`` of the
    step's positions, or None without rotary positions)."""
    q, k, v = (_in_proj(p, x, cfg, name) for name in "qkv")
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
# Spare rows: where the writes the reference drops land
# ---------------------------------------------------------------------------


def pool_with_spare(lead: Tuple[int, ...], rows: int, row_shape: Tuple[int, ...], dtype,
                    device=None, fill: float = 0.0) -> torch.Tensor:
    """A tensor of shape ``lead + (rows,) + row_shape`` filled with
    ``fill``, whose storage holds, past the last row of each lead index,
    one spare row: ``spare`` of a (rows, ...) slice reaches it, nothing
    else does (every shape and every read sees ``rows`` rows)."""
    buf = torch.full(lead + (rows + 1,) + row_shape, fill, dtype=dtype, device=device)
    return buf.narrow(len(lead), 0, rows)


def spare(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, ...), a contiguous slice of a ``pool_with_spare``
    tensor, seen with its spare row: (rows + 1, ...), the last the spare.
    Writes sent to index ``rows`` land there, which no read reaches (the
    reference's ``mode="drop"``)."""
    if not x.is_contiguous():
        raise ValueError("spare() takes a contiguous (rows, ...) cache slice")
    return x.as_strided((x.shape[0] + 1,) + tuple(x.shape[1:]), x.stride(), x.storage_offset())


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
    (N,), in place; ``page == num_pages`` writes to the pool's spare page
    (the reference's dropped write).  int8 pools (marked by
    ``k_scale``/``v_scale``) quantize each row and scatter its scale."""
    if "k_scale" in cache:
        kq, ks = _paged_quantize(k_rows)
        vq, vs = _paged_quantize(v_rows)
        spare(cache["k"])[page, off] = kq
        spare(cache["v"])[page, off] = vq
        spare(cache["k_scale"])[page, off] = ks
        spare(cache["v_scale"])[page, off] = vs
    else:
        spare(cache["k"])[page, off] = k_rows.to(cache["k"].dtype)
        spare(cache["v"])[page, off] = v_rows.to(cache["v"].dtype)
    return cache


def _dense_write(cache, flat, k_rows, v_rows):
    """Scatter K/V rows (N, KV, D) into dense slots (B, L, KV, D) at the
    flattened ``slot * L + position`` (N,), in place; ``B * L`` writes to
    the spare row (the reference's dropped write)."""
    for name, rows in (("k", k_rows), ("v", v_rows)):
        spare(cache[name].flatten(0, 1))[flat] = rows.to(cache[name].dtype)


def _paged_attend(q_tok, cache, page_tables, index, window, softcap):
    """Fused paged attention over flattened query tokens (T, H, D): the
    one entry point of the packed, chunked and verify paged branches.
    ``kernels.ops`` picks the CUDA kernel or the plain path by device."""
    return kernel_ops.paged_flash_attention(
        q_tok, cache["k"], cache["v"], page_tables, index.q_pos, index.q_slots,
        window=window, softcap=softcap,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"), plan=index.plan,
    )


@dataclasses.dataclass(frozen=True)
class StepIndex:
    """A serving step's token addressing for one layer kind.

    It is the same for every layer of the kind, so ``apply_stack`` makes
    it once per step and kind (``step_index``) and each layer only
    projects, writes and attends.  ``rope`` is the (cos, sin) of the
    step's positions (None without rotary positions).  ``write_at`` says
    where each of the step's K/V rows, flattened over the token dims,
    lands: (page, offset) in the paged pool, or the flattened ``slot * L +
    position`` in dense slots; the rows JAX's ``mode="drop"`` scatters
    discard go to the pool's spare page or the slots' spare row, so no
    host sync picks them.  ``q_pos``/``q_slots`` (int32) address the paged
    kernel's queries and ``plan`` is its tile plan (``paged_tile_plan``,
    padded to ``step_plan_rows``: the caller's, made on the host, or made
    here from the device tensors with a host round trip);
    ``gather``/``mask`` are the dense layout's per-query slot rows and
    attention mask."""

    rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
    write_at: Tuple[torch.Tensor, ...]
    q_pos: Optional[torch.Tensor] = None
    q_slots: Optional[torch.Tensor] = None
    plan: Optional[torch.Tensor] = None
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
    plan: Optional[torch.Tensor] = None,
) -> StepIndex:
    """The addressing of ``apply_attention``'s cache branches (token-packed
    ``layers.py:528-585``, chunked ``:601-658``, paged decode ``:659-674``
    and the dense single-token decode ``:675-708``) for one layer kind.
    A single-token decode step (no ``seq_lens``, no ``slot_ids``, one
    column) on the paged layout is the chunked addressing with C = 1 and
    every slot active, so K4 gets a chunked step's tile plan.
    ``plan`` is the paged kernel's tile plan for this kind, made by the
    caller (``model.chunk_plans`` / ``packed_plans`` / ``decode_plans``);
    without one it is made here from the device tensors, a host round trip
    a captured step cannot make."""
    window = cfg.sliding_window if kind == "L" else 0
    dev = positions.device
    rope = (rope_angles(positions, cfg.hd, cfg.rope_theta)
            if cfg.pos == "rope" else None)
    decode = seq_lens is None and slot_ids is None and positions.shape[-1] == 1
    if decode and page_tables is None:
        return _decode_index(cache, window, decode_pos, rope)
    if decode and decode_pos.dim() == 0:
        raise ValueError("paged decode needs per-slot positions, got a scalar")
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
        page = torch.where((page >= 0) & (page < num_pages), page, num_pages)  # spare page
        q_slots = (slots if slot_ids is not None else torch.where(active, rows, -1)).reshape(-1)
        qpos = qpos.reshape(-1)
        if plan is None:
            packed = slot_ids is not None
            tt = tile_tokens(cfg.hd, cfg.n_heads // cfg.n_kv_heads)
            plan = tile_plan_tensor(qpos, q_slots, page_size, page_tables.shape[-1], window,
                                    step_plan_rows(qpos.shape[0], page_tables.shape[0]
                                                   if packed else positions.shape[0], packed, tt),
                                    tt)
        return StepIndex(rope, (page.reshape(-1), off.reshape(-1)), q_pos=qpos.int(),
                         q_slots=q_slots.int(), plan=plan)

    num_slots = cache["k"].shape[0]
    flat = torch.where(wp < buf_len, rows * buf_len + wp, num_slots * buf_len)  # spare row
    kpos = torch.arange(buf_len, device=dev)
    if slot_ids is not None:
        mask = (kpos[None, :] <= qpos[:, None]) & valid[:, None]  # (P, L)
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        return StepIndex(rope, (flat,), gather=rows, mask=mask[:, None, None, :])
    mask = kpos[None, None, :] <= qpos[..., None]  # (B, C, L)
    if window > 0:
        mask &= kpos[None, None, :] > qpos[..., None] - window
    return StepIndex(rope, (flat.reshape(-1),), mask=mask[:, None])


def _decode_index(cache: Dict[str, torch.Tensor], window: int, decode_pos: torch.Tensor,
                  rope) -> StepIndex:
    """A dense single-token decode step (``layers.py:675-708``): each slot
    writes its K/V row at ``pos`` (``pos % buf_len`` in a sliding-window
    layer's ring, whose ``buf_len`` rows exclude the pool's spare row) and
    attends its buffer, the ring's rows mapped back to absolute positions.
    ``decode_pos`` is a scalar (a lockstep batch: one position, a (1, L)
    mask broadcast over the slots) or (B,) per-slot positions."""
    b, buf_len = cache["k"].shape[:2]
    dev = decode_pos.device
    kpos = torch.arange(buf_len, device=dev)
    pos_b = decode_pos.reshape(-1)  # (1,) or (B,)
    if window > 0:
        slot_b = pos_b % buf_len
    elif decode_pos.dim() == 0:  # dynamic_update_slice clamps its start
        slot_b = pos_b.clamp(max=buf_len - 1)
    else:  # a scatter past the buffer is dropped: the spare row
        slot_b = torch.where(pos_b < buf_len, pos_b, buf_len)
    rows = torch.arange(b, device=dev)
    flat = torch.where(slot_b < buf_len, rows * buf_len + slot_b, b * buf_len)
    if window > 0:
        # ring buffer: reconstruct each row's absolute position
        base = pos_b[:, None] - slot_b[:, None]
        abs_pos = torch.where(kpos[None, :] <= slot_b[:, None], base + kpos[None, :],
                              base - buf_len + kpos[None, :])
        valid = ((abs_pos >= torch.clamp(pos_b[:, None] - window + 1, min=0))
                 & (abs_pos <= pos_b[:, None]))
    else:
        valid = kpos[None, :] <= pos_b[:, None]  # (B or 1, L)
    return StepIndex(rope, (flat,), mask=valid[:, None, None, :])


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
    rope=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention block: over a serving cache (the cache branches of
    ``layers.apply_attention``: token-packed ``:528-585``, chunked
    ``:601-658`` and single-token decode ``:659-708``, dense or paged
    layout), or, with ``cache=None``, over the
    sequence itself (training; ``apply_attention_nocache``, whose RoPE
    angles ``rope`` a caller may make once for all layers).

    slot_ids (packed step): x is (1, P, d); token j writes its K/V to slot
    ``slot_ids[j]`` at absolute position ``positions[0, j]`` and attends
    only that slot's rows at positions <= its own; ``slot_ids[j] < 0`` is
    padding.  Otherwise (chunked prefill): slot i consumes
    ``x[i, :seq_lens[i]]`` at absolute positions ``decode_pos[i]...``.
    Both need a linear cache.  With neither and one column (``decode_step``),
    slot i's token is at ``decode_pos`` (a scalar or (B,)); a dense cache may
    then be the ring layout (``init_attention_cache(linear=False)``).  ``page_tables``/``page_size`` select the
    paged layout: writes go through ``paged_index``, reads through the
    fused ``kernels.ops.paged_flash_attention``.  ``index`` is the step's
    ``step_index`` for this kind, made here when not given.  The cache's
    pools must come from ``init_attention_cache`` or the paged layout
    (``serve.kv``): the rows the reference drops go to their spare row.
    'B' (bidirectional encoder) blocks run only without a cache.
    """
    if kind not in ("G", "L", "B"):
        raise ValueError(f"attention runs 'G'/'L'/'B' blocks in the port, got {kind!r}")
    if cache is None:
        return apply_attention_nocache(p, x, cfg, kind, positions, rope), None
    if kind == "B":
        raise ValueError("'B' (encoder) attention has no cache: it is never served")
    if index is None:
        index = step_index(cfg, kind, positions, cache, decode_pos, seq_lens, slot_ids,
                           page_tables, page_size)
    cd = cfg.compute_dtype
    window = cfg.sliding_window if kind == "L" else 0
    q, k, v = _qkv(p, x, cfg, index.rope)
    k_rows = k.reshape(-1, *k.shape[-2:])
    v_rows = v.reshape(-1, *v.shape[-2:])
    if page_tables is not None:
        _paged_write(cache, *index.write_at, k_rows, v_rows)
        out = _paged_attend(q.reshape(-1, *q.shape[-2:]), cache, page_tables, index, window,
                            cfg.logit_softcap).reshape(q.shape)
    else:
        _dense_write(cache, *index.write_at, k_rows, v_rows)
        if slot_ids is not None:
            kk = cache["k"][index.gather]  # (P, L, KV, D)
            vv = cache["v"][index.gather]
            out = sdpa(q[0][:, None], kk.to(cd), vv.to(cd), index.mask,
                       cfg.logit_softcap)[:, 0][None]  # (1, P, H, D)
        else:
            out = sdpa(q, cache["k"].to(cd), cache["v"].to(cd), index.mask,
                       cfg.logit_softcap)

    return _out_proj(p, out, cfg), cache


def require_no_softcap(cfg: ModelConfig) -> None:
    if cfg.logit_softcap > 0.0:
        raise NotImplementedError(
            "logit_softcap in training attention is not ported yet (the K3 kernel "
            "has no softcap); see ROADMAP.md")


def apply_attention_nocache(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                            positions: torch.Tensor, rope=None) -> torch.Tensor:
    """The no-cache branch of ``layers.apply_attention`` (``:586-600``) for
    'G' (causal), 'L' (causal, sliding window) and 'B' (bidirectional: the
    reference's ``mask = None`` and ``sdpa_flash(..., causal=(kind != "B"))``)
    blocks: x (B, S, d) -> (B, S, d).  The reference takes ``sdpa`` up to
    2048 tokens, ``sdpa_flash`` above and the banded ``sdpa_local_banded``
    for long 'L' sequences; all compute one function, which here is
    ``kernels.ops.flash_attention``
    (K3: the CUDA kernel on the card, with its backward kernel under
    autograd; the plain version on the CPU).  q, k, v stay in their
    (B, S, heads, D) storage and reach the kernel as transposed views."""
    require_no_softcap(cfg)
    if rope is None and cfg.pos == "rope":
        rope = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, rope)  # (B, S, heads, D)
    window = cfg.sliding_window if kind == "L" else 0
    out = kernel_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     causal=kind != "B", window=window).transpose(1, 2)
    return _out_proj(p, out, cfg)


def apply_cross_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, enc_kv,
                          cached: bool = False) -> torch.Tensor:
    """The 'X' kind of ``layers.apply_attention`` (``:514-524``): x (B, S,
    d) attends, without a mask, the encoder's ``enc_kv`` = (K, V), each
    (B, F, KV, D) in the compute dtype (``model._cross_kv``).  The query
    projection takes ``bq`` under ``qkv_bias``; there is no RoPE.  Without
    a cache (training, the teacher-forced forward) the attention is K3,
    ``kernels.ops.flash_attention`` with ``causal=False`` (the reference's
    ``sdpa`` up to 2,048 queries, ``sdpa_flash`` above: one function);
    in a dense-cache ``decode_step`` (``cached``, one query row) it is the
    plain ``sdpa``, as the dense decode branch's self-attention is and the
    reference's is."""
    q = _in_proj(p, x, cfg, "q")
    k, v = enc_kv
    if cached:
        out = sdpa(q, k, v, None, cfg.logit_softcap)
    else:
        require_no_softcap(cfg)
        out = kernel_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         causal=False).transpose(1, 2)
    return _out_proj(p, out, cfg)


def init_attention_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                         linear: bool = False, device=None,
                         lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Pre-allocated dense cache for one attention layer (``lead`` adds
    leading dims: a group's stacked layers).  ``linear=True`` gives
    sliding-window layers the full length (plus one row when ``seq_len ==
    window``), which the chunked and packed paths require.  Each layer's
    (batch x length) rows have a spare row past them (``pool_with_spare``)
    for the writes the reference drops."""
    if kind == "L":
        buf = max(seq_len, cfg.sliding_window + 1) if linear else min(cfg.sliding_window, seq_len)
    else:
        buf = seq_len
    kv, hd = cfg.n_kv_heads, cfg.hd

    def rows():
        flat = pool_with_spare(lead, batch * buf, (kv, hd), cfg.compute_dtype, device)
        return flat.unflatten(len(lead), (batch, buf))

    return {"k": rows(), "v": rows()}


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
