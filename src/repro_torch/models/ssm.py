"""Mamba-2 / SSD (state-space duality) block for training and serving (port
of ``repro.models.ssm``)  [arXiv:2405.21060].

The sequence is split into chunks.  Within a chunk the recurrence is a
masked, decay-weighted "attention" (``kernels.ops.ssd_chunk``, K6: the CUDA
kernel on the card, its plain version on the CPU); across chunks a small
recurrence over per-chunk states runs as a Python loop (the reference's
``lax.scan``; the chunk count is short).  A token-packed serving step runs
the segment-masked form over the packed axis instead
(``kernels.ops.ssd_segment``, K5, forward-only).

Training runs the cache-free branch under autograd, as the reference
differentiates it with ``jax.grad``: K6 through ``kernels.ops.SsdChunkFn``
(its CUDA backward on the card), everything around it (the inter-chunk
loop, the decays, the conv taps, the gated norm) through plain autograd.

One difference from the reference, which pads every dense step to a
multiple of ``ssm_chunk``: a step shorter than ``ssm_chunk`` runs one chunk
of its own length rounded up to the kernel's row tile (``chunk_len``).  The
padded columns carry dt = 0, so they add exact zeros and decay by exp(0) =
1: the sums are the reference's, and a one-token decode step no longer
pays for a 256-row chunk.  ``tests/test_torch_ssm.py`` holds the shortened
path against the reference's padded one.

Caches are updated in place (``models.layers``' convention): the per-slot
conv window and SSM state leaves of ``{"ssd": {"conv", "state"}}``.  The
single-token branch (``decode_step``) is the reference's plain recurrence,
one state step a token, with no SSD kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kernels.ssd_chunk import ROW_TILE
from . import layers as L
from .config import ModelConfig
from .recurrent import (
    PackedStep,
    chunked_conv_state,
    final_segment_decay,
    packed_conv,
    packed_step,
    scatter_rows,
)

Params = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, state size, SSD heads)."""
    di = cfg.ssm_expand * cfg.d_model
    return di, cfg.ssm_state, di // cfg.ssm_head_dim


def init_ssd(gen, cfg: ModelConfig, device=None) -> Params:
    """The reference's parameter tree (``ssm.py:30-48``); numbers drawn from
    ``gen`` (the two frameworks' generators differ)."""
    d = cfg.d_model
    di, n, nh = _dims(cfg)
    pd = cfg.params_dtype
    conv_ch = di + 2 * n
    return {
        # in_proj packs [z (gate), x, B, C, dt] like the reference impl.
        "w_in": L.dense_init(gen, (d, 2 * di + 2 * n + nh), dtype=pd, device=device),
        "conv_w": L.dense_init(gen, (cfg.ssm_conv, conv_ch), in_axis=0, dtype=pd,
                               device=device),
        "conv_b": torch.zeros((conv_ch,), dtype=pd, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)).to(pd),
        "dt_bias": torch.zeros((nh,), dtype=pd, device=device),
        "d_skip": torch.ones((nh,), dtype=pd, device=device),
        "norm_scale": torch.ones((di,), dtype=pd, device=device),
        "w_out": L.dense_init(gen, (di, d), dtype=pd, device=device),
    }


def init_ssd_cache(cfg: ModelConfig, batch: int, device=None) -> Params:
    di, n, nh = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n), dtype=cfg.compute_dtype,
                            device=device),
        "state": torch.zeros((batch, nh, n, cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, n, nh = _dims(cfg)
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    return z, xbc, dt, di, n, nh


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): the value in its own form,
    max(x, 0) + log1p(exp(-|x|)), and the gradient sigmoid(x).  Autograd
    of that form would give 1 at x = 0 (clamp passes the gradient at its
    bound, |x| gives 0 there), where logaddexp's is 1/2."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def _conv_taps(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """silu(sum_i xp[:, i : i + s] * w[i] + b): the depthwise causal conv of
    the ``s`` inputs after the K-1 history rows of ``xp``."""
    out = xp[:, :s] * w[0]
    for i in range(1, w.shape[0]):
        out = out + xp[:, i : i + s] * w[i]
    return F.silu(out + b)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d from zero history (``ssm.py:61-72`` without a
    carried state; the chunked branch carries its window itself)."""
    pad = xbc.new_zeros((xbc.shape[0], w.shape[0] - 1, xbc.shape[-1]))
    return _conv_taps(torch.cat([pad, xbc], dim=1), w, b, xbc.shape[1])


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length a dense step of ``s`` columns runs: ``chunk`` (the
    reference's partition) from ``s >= chunk`` on; below it one chunk of
    ``s`` rounded up to the kernel's row tile, never above ``chunk``."""
    if s >= chunk:
        return chunk
    return min(chunk, -(-s // ROW_TILE) * ROW_TILE)


def _ssd_chunked(x, dt, a, b, c, chunk: int, init_state=None):
    """Chunked SSD scan (``ssm.py:74-136``).

    x: (B, S, H, P) f32   dt: (B, S, H)   a: (H,) positive decay rates
    b, c: (B, S, N) (one group, shared across heads)   S a multiple of
    ``chunk``.  ``init_state`` (B, H, N, P) seeds the inter-chunk recurrence
    (a slot's carried state); None = zeros.  Returns ``(y, final_state)``,
    y (B, S, H, P) and the state after the last token (dt = 0 padding is
    an exact identity, so that is the state after each row's own last real
    token)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xc = x.reshape(bs, nc, chunk, h, p).contiguous()
    dtc = dt.reshape(bs, nc, chunk, h).contiguous()
    bc = b.reshape(bs, nc, chunk, n).contiguous()
    cc = c.reshape(bs, nc, chunk, n).contiguous()

    da = dtc * a  # (B, nc, L, H): -dt*a is the log decay per step
    cum = torch.cumsum(da, dim=2)  # cumulative log-decay within the chunk

    # ---- intra-chunk (quadratic in the chunk length): K6 ----
    y_intra = kernel_ops.ssd_chunk(xc, dtc, cum, bc, cc)

    # ---- chunk states: sum_j B_j exp(-(cum_end - cum_j)) dt_j x_j ----
    wj = torch.exp(-(cum[:, :, -1:, :] - cum)) * dtc  # (B, nc, L, H)
    u = (xc * wj[..., None]).reshape(bs, nc, chunk, h * p)
    states = (bc.transpose(-1, -2) @ u).reshape(bs, nc, n, h, p).transpose(2, 3)

    # ---- inter-chunk recurrence over nc chunks ----
    chunk_decay = torch.exp(-cum[:, :, -1, :])  # (B, nc, H)
    carry = (states.new_zeros((bs, h, n, p)) if init_state is None
             else init_state.to(states.dtype))
    prev = []  # the state entering each chunk
    for g in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, g, :, None, None] + states[:, g]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    # ---- inter-chunk contribution: C_i . state * exp(-cum_i) ----
    sp = prev_states.transpose(2, 3).reshape(bs, nc, n, h * p)
    y_inter = (cc @ sp).reshape(bs, nc, chunk, h, p) * torch.exp(-cum)[..., None]
    y = (y_intra + y_inter).reshape(bs, s, h, p)
    return y, carry


def _ssd_dense(xh, dt, a, b, c, cfg: ModelConfig, init_state=None):
    """``_ssd_chunked`` of a dense step of S columns, padded with dt = 0 to
    a multiple of ``chunk_len(S)``; returns (y cropped to S, final state)."""
    s = xh.shape[1]
    chunk = chunk_len(s, cfg.ssm_chunk)
    pad = (-s) % chunk
    if pad:  # tail pad: dt = 0 => identity decay, no update
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    y, final = _ssd_chunked(xh.float(), dt, a, b.float(), c.float(), chunk,
                            init_state=init_state)
    return y[:, :s], final


def _apply_packed(xbc, dt, a, w, bconv, cfg: ModelConfig, cache: Params,
                  slot_ids: torch.Tensor, step: Optional[PackedStep]):
    """The token-packed branch (``ssm.py:210-242``): x is (1, P, ·); per-token
    slot gather of the carried state, the segment-masked scan (K5), and the
    segment-final write-back, all without a host sync."""
    di, n, nh = _dims(cfg)
    state = cache["state"]  # (num_slots, H, N, P) f32
    num_slots = state.shape[0]
    if step is None:
        step = packed_step(slot_ids, num_slots, cfg.ssm_conv)
    info = step.info
    dtp = torch.where(info.valid[:, None], dt[0], 0.0)  # (P, H)
    conv_out, conv_state = packed_conv(xbc[0], w, bconv, cache["conv"], info,
                                       step.conv_index)
    xs, b, c = torch.split(F.silu(conv_out), [di, n, n], dim=-1)
    t = xs.shape[0]
    xh = xs.reshape(t, nh, cfg.ssm_head_dim).float()
    bf, cf = b.float().contiguous(), c.float().contiguous()
    da = dtp * a[None, :]
    cum = torch.cumsum(da, dim=0)
    y = kernel_ops.ssd_segment(xh.contiguous(), dtp, cum, bf, cf, slot_ids)
    # carried-state injection: C_t . state[slot_t] * exp(-ent_t), formed for
    # every (token, slot) pair by one product and then picked, so no
    # (P, H, N, P) gather of the state is materialised
    ent, w_end = final_segment_decay(cum, da, info)
    hp = nh * cfg.ssm_head_dim
    by_slot = (cf @ state.transpose(1, 2).reshape(num_slots, n, hp).transpose(0, 1)
               .reshape(n, num_slots * hp)).reshape(t, num_slots, nh, -1)
    inj = by_slot[torch.arange(t, device=xh.device), info.safe_slot]  # (P, H, P)
    y = y + inj * torch.exp(-ent)[..., None]
    # segment-final write-back: state * (carried decay) + sum of the
    # segment's updates B_t w_end_t dt_t x_t, summed per slot by a one-hot
    # product (padding's write slot, num_slots, matches no row)
    u = (xh * (w_end * dtp)[..., None]).reshape(t, hp)
    onehot = (info.write_slot[None, :] == torch.arange(num_slots, device=xh.device)[:, None])
    m = (onehot[:, :, None] * bf[None]).transpose(1, 2).reshape(num_slots * n, t)
    contrib = (m @ u).reshape(num_slots, n, nh, -1).transpose(1, 2)
    df = scatter_rows(torch.ones((num_slots, nh), dtype=torch.float32, device=xh.device),
                      info.last_slot, torch.exp(-ent))
    state.mul_(df[..., None, None]).add_(contrib)
    cache["conv"].copy_(conv_state)
    return y[None], xh[None]


def _apply_decode(xbc, dt, a, w, bconv, cfg: ModelConfig, cache: Params):
    """The single-token branch (``ssm.py:243-256``, ``decode_step``): x is
    (B, 1, ·); the conv window shifts by one row and the state takes one
    step of the recurrence, state <- state * exp(-dt a) + B dt x, read by
    C.  No SSD kernel: the step is the reference's own recurrence."""
    di, n, nh = _dims(cfg)
    xp = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    xs, b, c = torch.split(_conv_taps(xp, w, bconv, 1), [di, n, n], dim=-1)
    xh = xs.reshape(xs.shape[0], 1, nh, cfg.ssm_head_dim).float()
    bf, cf = b.float()[:, 0], c.float()[:, 0]
    dt1 = dt[:, 0]  # (B, H)
    decay = torch.exp(-dt1 * a)  # (B, H)
    upd = torch.einsum("bn,bh,bhp->bhnp", bf, dt1, xh[:, 0])  # state: (B, H, N, P)
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cf, state)[:, None]  # (B, 1, H, P)
    cache["conv"].copy_(xp[:, -(cfg.ssm_conv - 1):])
    cache["state"].copy_(state)
    return y, xh


def apply_ssd(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Params] = None,
              seq_lens: Optional[torch.Tensor] = None,
              slot_ids: Optional[torch.Tensor] = None,
              step: Optional[PackedStep] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """One Mamba-2 block (``ssm.py:139-265``).  x: (B, S, D).

    Without a cache, the cache-free forward.  With ``seq_lens``, a dense
    chunked-prefill step (row i consumes its first seq_lens[i] columns; dt
    is zeroed past them, an exact identity, and the carried state seeds
    the scan).  With ``slot_ids``, a token-packed step (x is (1, P, D);
    ``step`` the step's ``recurrent.packed_step``, made here when None).
    With neither, single-token decode (x is (B, 1, D)).  Returns (y, cache);
    the cache leaves are updated in place."""
    cd = cfg.compute_dtype
    proj = x @ p["w_in"].to(cd)
    z, xbc, dt, di, n, nh = _split_proj(cfg, proj)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(p["a_log"].float())  # (H,) positive rates
    w, bconv = p["conv_w"].to(cd), p["conv_b"].to(cd)

    if cache is None:
        xs, b, c = torch.split(_causal_conv(xbc, w, bconv), [di, n, n], dim=-1)
        xh = xs.reshape(*xs.shape[:2], nh, cfg.ssm_head_dim)
        y, _ = _ssd_dense(xh, dt, a, b, c, cfg)
    elif seq_lens is not None:
        bs, s = xbc.shape[:2]
        valid = torch.arange(s, device=x.device)[None, :] < seq_lens[:, None]  # (B, S)
        dt = torch.where(valid[..., None], dt, 0.0)
        xp = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
        conv_out = _conv_taps(xp, w, bconv, s)
        conv_state = chunked_conv_state(xp, seq_lens, cfg.ssm_conv)
        xs, b, c = torch.split(conv_out, [di, n, n], dim=-1)
        xh = xs.reshape(bs, s, nh, cfg.ssm_head_dim)
        y, final = _ssd_dense(xh, dt, a, b, c, cfg, init_state=cache["state"])
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(final)
    elif slot_ids is not None:
        y, xh = _apply_packed(xbc, dt, a, w, bconv, cfg, cache, slot_ids, step)
    else:
        y, xh = _apply_decode(xbc, dt, a, w, bconv, cfg, cache)

    y = y + xh * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(*y.shape[:2], di)
    # gated RMSNorm (Mamba-2 places the norm after gating by z)
    y = y * F.silu(z.float())
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    y = (y * p["norm_scale"].float()).to(cd)
    return y @ p["w_out"].to(cd), cache
