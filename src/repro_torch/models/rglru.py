"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro.models.rglru``)  [arXiv:2402.19427].

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(w_a * x_t + b_a)          (recurrence gate)
    i_t = sigmoid(w_x * x_t + b_x)          (input gate)
    a_t = a ** (c * r_t),  a = sigmoid(lam) (per-channel decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference evaluates the linear recurrence with
``jax.lax.associative_scan`` outside any Pallas kernel.  Here it is a
log-depth Hillis-Steele scan over ``_combine``'s pairs (``_scan``):
ceil(log2 S) rounds of a few elementwise ops over the whole sequence, so
its shapes are fixed by the step's and a CUDA graph can capture it.  Its
products are ordered differently from XLA's tree, so the two agree to a
tolerance, not to bits.  Training differentiates the cache-free branch's
scan through ``LinearScanFn``, whose backward is the same scan over the
reversed sequence (the reference leaves it to ``jax.grad``).

Caches are updated in place (``models.layers``' convention): the per-slot
conv window and recurrence state leaves of ``{"rglru": {"conv", "h"}}``.
The single-token branch (``decode_step``) takes one step of the
recurrence, in the reference's decode form.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig
from .recurrent import PackedStep, chunked_conv_state, packed_conv, packed_step, scatter_rows
from .ssm import _softplus

Params = Dict[str, torch.Tensor]

_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return int(cfg.rglru_expand * cfg.d_model)


def init_rglru(gen, cfg: ModelConfig, device=None) -> Params:
    """The reference's parameter tree (``rglru.py:33-49``); numbers drawn
    from ``gen`` (the two frameworks' generators differ)."""
    d, dr, pd = cfg.d_model, _width(cfg), cfg.params_dtype

    def zeros():
        return torch.zeros((dr,), dtype=pd, device=device)

    return {
        "w_branch": L.dense_init(gen, (d, dr), dtype=pd, device=device),
        "w_gate_branch": L.dense_init(gen, (d, dr), dtype=pd, device=device),
        "conv_w": L.dense_init(gen, (cfg.rglru_conv, dr), in_axis=0, dtype=pd, device=device),
        "conv_b": zeros(),
        "gate_a_w": zeros(),
        "gate_a_b": zeros(),
        "gate_x_w": zeros(),
        "gate_x_b": zeros(),
        # a = sigmoid(lam) spans (0.9, 0.999)
        "lam": torch.linspace(2.2, 6.9, dr, device=device).to(pd),
        "w_out": L.dense_init(gen, (dr, d), dtype=pd, device=device),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> Params:
    dr = _width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru_conv - 1, dr), dtype=cfg.compute_dtype,
                            device=device),
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
    }


def _taps(xp: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """sum_i xp[:, i : i + s] * w[i]: the depthwise causal conv of the ``s``
    inputs after the K-1 history rows of ``xp`` (no activation, unlike
    ``ssm._conv_taps``)."""
    out = xp[:, :s] * w[0]
    for i in range(1, w.shape[0]):
        out = out + xp[:, i : i + s] * w[i]
    return out


def _conv(x, w, b, state=None):
    """``rglru.py:52-61``: (conv output + bias, the last K-1 inputs)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    return _taps(xp, w, x.shape[1]) + b, xp[:, -(k - 1):]


def _decay_and_update(x, r, i, a_param):
    """Per-step decay a_t and gated input sqrt(1-a_t^2)*(i*x), both f32
    (``rglru.py:64-69``; the softplus is ``jax.nn.softplus``'s form)."""
    log_a = -_C * r * _softplus(-a_param)  # log(a^(c r)), a = sigmoid(lam)
    a_t = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a_t ** 2, min=1e-12)) * (i * x)
    return a_t, gated


def _scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` ((a1, b1), (a2, b2)) -> (a1 a2,
    a2 b1 + b2) along ``dim``: (running decay product, recurrence output),
    ``jax.lax.associative_scan(_combine, (a, b), axis=dim)`` up to the order
    of the products.  Hillis-Steele: round k combines each element with the
    one 2^k before it, so ceil(log2 n) rounds, no host sync."""
    n = a.shape[dim]
    k = 1
    while k < n:
        a_lo, a_hi = a.narrow(dim, 0, n - k), a.narrow(dim, k, n - k)
        b_lo, b_hi = b.narrow(dim, 0, n - k), b.narrow(dim, k, n - k)
        b = torch.cat([b.narrow(dim, 0, k), a_hi * b_lo + b_hi], dim=dim)
        a = torch.cat([a.narrow(dim, 0, k), a_lo * a_hi], dim=dim)
        k *= 2
    return a, b


class LinearScanFn(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0 (``_scan``'s
    second output), with its gradient in closed form.  Autograd through
    ``_scan`` would keep every round's (a, b) pair for the backward:
    ceil(log2 S) x 2 x (B, S, Dr) f32, 3.3 GB for one recurrentgemma-2b
    layer at 8,192 tokens.  This keeps a and h alone and runs the backward
    as the same scan over the reversed sequence:

        g_t = dh_t + a_{t+1} g_{t+1},   db_t = g_t,   da_t = g_t h_{t-1}

    (the reverse scan's decay at t is a_{t+1}; the last position has none).
    ``jax.grad`` of the reference's ``associative_scan`` computes the same
    sums through the scan's tree, so the two agree to a tolerance."""

    @staticmethod
    def forward(ctx, a, b):
        _, h = _scan(a, b, dim=1)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        _, g = _scan(a_next.flip(1), dh.flip(1), dim=1)
        g = g.flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return g * h_prev, g


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The recurrence output of (a, b) along dim 1 from a zero state:
    ``_scan(a, b, 1)[1]``, differentiable through ``LinearScanFn``."""
    return LinearScanFn.apply(a, b)


def _gates(p: Params, uf: torch.Tensor):
    r = torch.sigmoid(uf * p["gate_a_w"].float() + p["gate_a_b"].float())
    i = torch.sigmoid(uf * p["gate_x_w"].float() + p["gate_x_b"].float())
    return r, i


def apply_rglru(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Params] = None,
                seq_lens: Optional[torch.Tensor] = None,
                slot_ids: Optional[torch.Tensor] = None,
                step: Optional[PackedStep] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """One RG-LRU block (``rglru.py:97-173``).  x: (B, S, D).

    Without a cache, the cache-free forward, the training path (its scan
    differentiated by ``LinearScanFn``).  With ``seq_lens``, a dense
    chunked-prefill step: columns past a row's length get a_t = 1 and
    gated = 0, an exact identity, so the last column's state is the state
    after the row's last real token, and the carried h enters through the
    running decay product.  With ``slot_ids``, a token-packed step (x is
    (1, P, D); ``step`` the step's ``recurrent.packed_step``, made here when
    None): the carried h is injected at each segment's first token, whose
    a_t is zeroed in the scan (no flow across segments), and each segment's
    last h is written back to its slot.  With neither, single-token decode
    (x is (B, 1, D)): h <- a h + sqrt(max(1 - a^2, 1e-12)) (i u).  Returns
    (y, cache); the cache leaves are updated in place."""
    cd = cfg.compute_dtype
    u = x @ p["w_branch"].to(cd)
    g = x @ p["w_gate_branch"].to(cd)
    w, bconv = p["conv_w"].to(cd), p["conv_b"].to(cd)
    lam = p["lam"].float()

    if cache is None:
        u, _ = _conv(u, w, bconv)
        uf = u.float()
        r, i = _gates(p, uf)
        h = linear_scan(*_decay_and_update(uf, r, i, lam))
    elif seq_lens is not None:
        s = u.shape[1]
        xp = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
        uf = (_taps(xp, w, s) + bconv).float()
        conv_state = chunked_conv_state(xp, seq_lens, cfg.rglru_conv)
        r, i = _gates(p, uf)
        a_t, gated = _decay_and_update(uf, r, i, lam)
        valid = (torch.arange(s, device=x.device)[None, :] < seq_lens[:, None])[..., None]
        a_t = torch.where(valid, a_t, 1.0)  # identity past each row's length
        gated = torch.where(valid, gated, 0.0)
        a_all, h = _scan(a_t, gated, dim=1)
        h = h + a_all * cache["h"][:, None]
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h[:, -1])
    elif slot_ids is None:
        # single-token decode (``rglru.py:162-170``) in the reference's own
        # form, not ``_decay_and_update``'s, so the bits follow its decode
        u_c, conv_state = _conv(u, w, bconv, cache["conv"])
        uf = u_c.float()
        r, i = _gates(p, uf)
        a_t = torch.exp(-_C * r * _softplus(-lam))
        h = a_t * cache["h"][:, None] + torch.sqrt(torch.clamp(1.0 - a_t ** 2, min=1e-12)) * (i * uf)
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h[:, 0])
    else:
        if step is None:
            step = packed_step(slot_ids, cache["h"].shape[0], cfg.rglru_conv)
        info = step.info
        u_c, conv_state = packed_conv(u[0], w, bconv, cache["conv"], info, step.conv_index)
        uf = u_c.float()  # (P, Dr)
        r, i = _gates(p, uf)
        a_t, gated = _decay_and_update(uf, r, i, lam)
        live = info.valid[:, None]
        start = info.start[:, None]
        h0 = cache["h"][info.safe_slot]  # (P, Dr)
        a_eff = torch.where(start | ~live, 0.0, a_t)
        b_eff = torch.where(start, a_t * h0 + gated, torch.where(live, gated, 0.0))
        _, h = _scan(a_eff, b_eff, dim=0)
        cache["h"].copy_(scatter_rows(cache["h"], info.last_slot, h))
        cache["conv"].copy_(conv_state)
        h = h[None]

    y = h.to(cd) * F.gelu(g, approximate="tanh")
    return y @ p["w_out"].to(cd), cache
