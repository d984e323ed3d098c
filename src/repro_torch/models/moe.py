"""Mixture-of-Experts layer with top-k token-choice routing (port of
``repro.models.moe``).

Three dispatch forms, all plain PyTorch (the reference computes them with
``einsum`` and scatters outside any Pallas kernel; the expert products are
batched matmuls, cuBLAS's on the card):

* ``sort`` — sort-based capacity dispatch (``moe.py:76-138``): the (token,
  choice) pairs sorted by expert into a fixed (E, C, d) buffer, C =
  ``int(t * k / E * capacity_factor)``; choices past C are dropped (their
  residual passes through).  Above ``_SEGMENT_TOKENS`` tokens it runs
  segment by segment.
* ``capacity`` — the serving engine's form (``moe.py:141-221``): capacity
  ``ceil(cf * t * k / E)`` clamped to [1, t] (``cf = inf``: no drops),
  invalid (padding) tokens routed to a phantom bucket that takes no
  capacity, and the count of dropped routed choices (``expert_overflow``).
* ``dense`` — every expert on every token (``moe.py:224-234``), the exact
  oracle and the engine's default.

Every form combines a token's kept choices in one fixed order, its experts
ascending, by one product ``(t, k) x (t, k, d)`` (``_combine``).  The
reference's sort form scatter-adds them (``.at[st].add``), which on the
card would be atomics whose order changes from run to run; gathered per
token instead, runs and graphed replays agree bit for bit.  At ``cf =
inf`` the capacity form gives the dense form's bits: both multiply the
same (E, t, d) shapes and combine the same rows the same way.

Ties between router probabilities resolve to the lower expert index, as
``jax.lax.top_k`` does (a stable descending sort); the stable sorts by
expert keep token order within an expert, as ``jnp.argsort`` does.  The
reference's ``mode="drop"`` scatters send an overflowing choice to a
scratch row past the buffer; the port keeps that row and slices it off
before the expert products.  Nothing here reads the host, so a serving
step with MoE layers is captured in a CUDA graph like any other.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init

Params = Dict[str, torch.Tensor]

#: tokens a ``sort`` segment takes at most (``moe.py:73``)
_SEGMENT_TOKENS = 16384


def init_moe(gen, cfg: ModelConfig, device=None) -> Params:
    """The reference's leaves and shapes (``moe.py:30-42``): ``router`` (d,
    E), ``w_gate`` / ``w_in`` (E, d, f) and ``w_out`` (E, f, d), each drawn
    in the parameter dtype from one f32 draw of itself (``dense_init``)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    pd = cfg.params_dtype
    p = {
        "router": dense_init(gen, (d, e), dtype=pd, device=device),
        "w_out": dense_init(gen, (e, f, d), in_axis=1, dtype=pd, device=device),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (e, d, f), in_axis=1, dtype=pd, device=device)
    p["w_in"] = dense_init(gen, (e, d, f), in_axis=1, dtype=pd, device=device)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_logits(p: Params, x2d: torch.Tensor) -> torch.Tensor:
    """The router's logits (T, E), in f32 (``moe.py:47``)."""
    return x2d.float() @ p["router"].float()


def _router(p: Params, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d (T, d) -> (probs (T, k), ids (T, k), aux loss) (``moe.py:45-57``):
    f32 logits and softmax, top-k, the Mixtral renormalisation, and the
    Switch load-balancing term E * sum_e f_e * P_e."""
    probs = torch.softmax(router_logits(p, x2d), dim=-1)
    top_p, top_i = top_k(probs, cfg.top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    e = cfg.n_experts
    ids = top_i.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=x2d.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=torch.float32, device=x2d.device))
    f_e = counts / counts.sum().clamp_min(1.0)
    aux = e * torch.sum(f_e * probs.mean(dim=0))
    return top_p, top_i, aux


def _expert_ffn(p: Params, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d): each expert's MLP on its rows, batched
    products in the compute dtype (``moe.py:60-70``)."""
    cd = cfg.compute_dtype
    if cfg.act in ("swiglu", "geglu"):
        g = torch.bmm(xe, p["w_gate"].to(cd))
        u = torch.bmm(xe, p["w_in"].to(cd))
        h = (F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    else:
        h = F.gelu(torch.bmm(xe, p["w_in"].to(cd)), approximate="tanh")
    return torch.bmm(h, p["w_out"].to(cd))


def _choices(t: int, k: int, device) -> torch.Tensor:
    """The token of each flattened (token, choice) pair: (t * k,)."""
    return torch.arange(t, device=device)[:, None].expand(t, k).reshape(-1)


def _combine(rows: torch.Tensor, slot_tk: torch.Tensor, w_tk: torch.Tensor,
             top_i: torch.Tensor, cd) -> torch.Tensor:
    """y (T, d) = sum over a token's k choices of ``w_tk`` x ``rows[slot_tk]``,
    the choices in ascending expert order, in one product (the reference's
    capacity combine, ``moe.py:207-219``)."""
    ksort = torch.argsort(top_i, dim=1, stable=True)
    out = rows[torch.gather(slot_tk, 1, ksort)]  # (T, k, d)
    w = torch.gather(w_tk, 1, ksort).to(cd)
    return torch.einsum("tk,tkd->td", w, out)


def _dispatch(p: Params, x2d: torch.Tensor, cfg: ModelConfig, flat_e: torch.Tensor,
              top_p: torch.Tensor, top_i: torch.Tensor, cap: int, buckets: int):
    """The sort-by-expert dispatch shared by ``sort`` and ``capacity``:
    ``flat_e`` (T * k,) is each choice's bucket (``buckets`` of them, the
    last ``buckets - E`` phantom), ``cap`` the rows an expert takes.
    Returns (y (T, d), kept (T * k,) in the flattened choice order, routed
    (T * k,): the choice went to a real expert)."""
    cd = cfg.compute_dtype
    t, d = x2d.shape
    k, e = cfg.top_k, cfg.n_experts
    dev = x2d.device
    order = torch.argsort(flat_e, stable=True)  # within an expert, token order
    se = flat_e[order]
    st = _choices(t, k, dev)[order]
    counts = torch.zeros(buckets, dtype=torch.long, device=dev).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[se]
    routed = se < e
    keep = routed & (pos < cap)
    slot = torch.where(keep, se * cap + pos, e * cap)  # dropped -> the scratch row
    buf = torch.zeros(e * cap + 1, d, dtype=cd, device=dev)
    buf[slot] = x2d[st].to(cd)  # only the scratch row is written twice
    ye = _expert_ffn(p, buf[: e * cap].view(e, cap, d), cfg).reshape(e * cap, d)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    kept = keep[inv]
    # a dropped choice reads a real row with weight 0 (the reference masks
    # the row and the weight)
    y = _combine(ye, slot[inv].clamp_max(e * cap - 1).reshape(t, k),
                 torch.where(kept.reshape(t, k), top_p, 0.0), top_i, cd)
    return y, kept, routed[inv]


def apply_moe_sort(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   segment_tokens: int = _SEGMENT_TOKENS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch, x (B, S, d) -> (y, aux loss)
    (``moe.py:76-97``): above ``segment_tokens`` tokens, in the largest
    count of equal segments at most t // segment_tokens, the aux the
    segments' mean."""
    b, s, d = x.shape
    t = b * s
    n_seg = 1
    if t > segment_tokens:
        n_seg = t // segment_tokens
        while t % n_seg:
            n_seg -= 1
    segs = [_moe_sort_once(p, xs, cfg) for xs in x.reshape(n_seg, t // n_seg, d)]
    y = torch.cat([ys for ys, _ in segs]).reshape(b, s, d)
    return y, torch.stack([a for _, a in segs]).mean()


def _moe_sort_once(p: Params, x2d: torch.Tensor, cfg: ModelConfig):
    """One segment's sort dispatch (``moe.py:100-138``): capacity
    ``max(int(t * k / E * cf), 1)``, choices past it dropped."""
    t = x2d.shape[0]
    cap = max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
    top_p, top_i, aux = _router(p, x2d, cfg)
    y, _, _ = _dispatch(p, x2d, cfg, top_i.reshape(-1), top_p, top_i, cap, cfg.n_experts)
    return y, aux


def capacity(cfg: ModelConfig, t: int) -> int:
    """The capacity form's rows an expert takes for a step of ``t`` tokens:
    ``ceil(cf * t * k / E)`` clamped to [1, t], or t when cf is infinite."""
    cf = cfg.capacity_factor
    if math.isinf(cf):
        return t
    return min(max(math.ceil(t * cfg.top_k / cfg.n_experts * cf), 1), t)


def apply_moe_capacity(p: Params, x: torch.Tensor, cfg: ModelConfig,
                       valid: Optional[torch.Tensor] = None):
    """Serving-step capacity dispatch, x (B, S, d) -> (y, aux loss,
    expert_overflow) (``moe.py:141-221``).  ``valid`` (broadcast to (B, S))
    marks real tokens; the others route to the phantom bucket E and take no
    capacity.  ``expert_overflow`` (a device int64 scalar) counts the real
    routed choices dropped past capacity."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    x2d = x.reshape(t, d)
    top_p, top_i, aux = _router(p, x2d, cfg)
    flat_e = top_i.reshape(-1)
    if valid is not None:
        real = torch.broadcast_to(valid, (b, s)).reshape(t)
        flat_e = torch.where(real[:, None].expand(t, k).reshape(-1), flat_e, e)
    y, kept, routed = _dispatch(p, x2d, cfg, flat_e, top_p, top_i, capacity(cfg, t), e + 1)
    overflow = (routed & ~kept).sum()
    return y.reshape(b, s, d), aux, overflow


def apply_moe_dense(p: Params, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle (``moe.py:224-234``): every expert on every token (x
    expanded to (E, T, d), not copied), each token's k routed outputs
    combined by their router weights."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    top_p, top_i, aux = _router(p, x2d, cfg)
    e = cfg.n_experts
    ye = _expert_ffn(p, x2d.to(cfg.compute_dtype).expand(e, t, d), cfg).reshape(e * t, d)
    slot_tk = top_i * t + torch.arange(t, device=x.device)[:, None]
    y = _combine(ye, slot_tk, top_p, top_i, cfg.compute_dtype)
    return y.reshape(b, s, d), aux


def apply_moe_spmd(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """The reference's expert-parallel form (``moe.py:237-308``) and its
    per-device body (``_moe_sort_local``, ``:311-384``) need a device mesh
    with a model axis, which the port does not have yet."""
    from ..dist.api import UnsupportedDistError

    raise UnsupportedDistError(
        "MoE expert / tensor parallelism needs a model axis, which the port does not have yet")


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig, impl: str = "sort",
              valid: Optional[torch.Tensor] = None):
    """Dispatch by ``impl`` (``moe.py:393-402``; the reference's block calls
    the capacity form directly): (y, aux loss, expert_overflow), the
    overflow 0 except for ``"capacity"`` (``valid``: its padding mask).
    ``"spmd"`` raises ``UnsupportedDistError`` (no mesh in the port)."""
    if impl == "capacity":
        return apply_moe_capacity(p, x, cfg, valid=valid)
    if impl == "dense":
        y, aux = apply_moe_dense(p, x, cfg)
    elif impl == "sort":
        y, aux = apply_moe_sort(p, x, cfg)
    elif impl == "spmd":
        return apply_moe_spmd(p, x, cfg)
    else:
        raise ValueError(f"moe_impl must be 'sort', 'dense', 'capacity' or 'spmd', got {impl!r}")
    return y, aux, torch.zeros((), dtype=torch.long, device=x.device)


__all__ = [
    "apply_moe",
    "apply_moe_capacity",
    "apply_moe_dense",
    "apply_moe_sort",
    "apply_moe_spmd",
    "capacity",
    "init_moe",
    "top_k",
]
