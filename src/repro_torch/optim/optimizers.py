"""Optimizers over the parameter tree (port of ``repro.optim.optimizers``).

The optimizers the paper trains with — LAMB (BERT-Large, §5.1), LANS
(BERT-1.5B, §5.2 / B.1), AdamW and SGD with momentum — written as
functions over the nested-dict parameter tree, not ``torch.optim``, so the
update math is the reference's line for line (f32 math, states stored in
their own dtype).

``opt.update(grads, state, params) -> (updates, state)`` is the reference's
API (apply with ``apply_updates``).  ``opt.step(grads, state, params) ->
state`` applies the same per-leaf update in place, leaf by leaf (and, for
the elementwise AdamW and SGD, slice by slice of a large leaf), so a
training step never holds a whole tree of updates and new moments beside
the old ones: at qwen2.5-3b's 3.1 B parameters each such tree is 11.5 GiB.
``step``'s ``prep`` maps each gradient leaf (slice) to the values the
update reads, so the gradient sums (f32 or bf16) are normalised and
clipped in f32 a slice at a time (``launch.steps.TrainStep``) rather
than as a whole tree.
States are updated in place by both (the port's choice where JAX returns
new arrays).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..models.transformer import tree_leaves, tree_map, tree_unflatten

Tree = Any
_SLICE = 1 << 26  # elements per in-place slice of an elementwise update


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]
    step: Callable[..., Tree]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_unflatten(params, [(p + u).to(p.dtype) for p, u in
                                   zip(tree_leaves(params), tree_leaves(updates))])


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` scales gradients of global norm
    ``norm`` by: min(1, max_norm / (norm + 1e-9))."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32).square() for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """Scale ``grads`` so their global norm is at most ``max_norm``, in
    place (the tree is returned)."""
    scale = clip_scale(global_norm(grads), max_norm)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else lr


def _bias_correction(b: float, count: int) -> float:
    """1 - b**count in f32, as the reference computes it."""
    return float(np.float32(1) - np.float32(b) ** np.float32(count))


def _make(init, leaf_update, elementwise: bool, per_leaf_grad=None) -> Optimizer:
    """An Optimizer from ``leaf_update(g, states, p, hyper) -> (u, new
    states)`` (f32 math on one leaf, or one slice of it when
    ``elementwise``) and ``init``.  ``per_leaf_grad`` preprocesses each
    whole gradient leaf first (LANS's per-layer normalisation)."""

    def run(grads, state, params, outs, write, prep=None):
        """The per-leaf update over every leaf (slice by slice when
        ``elementwise``): states in place, ``write(out, p, u)`` for each
        leaf's (slice's) output and update; ``prep`` maps each leaf's
        (slice's) gradient to the values the update reads."""
        count = state["count"] + 1
        cols = [tree_leaves(state[k]) for k in state if k != "count"]
        g_leaves = tree_leaves(grads)
        for g, st, p, out in zip(g_leaves, zip(*cols) if cols else [()] * len(g_leaves),
                                 tree_leaves(params), outs):
            if prep is not None and not elementwise:
                g = prep(g)
            if per_leaf_grad is not None:
                g = per_leaf_grad(g)
            views = [x.view(-1) for x in (g, *st, p, out)] if elementwise else [g, *st, p, out]
            spans = ([slice(a, a + _SLICE) for a in range(0, p.numel(), _SLICE)]
                     if elementwise else [...])
            for span in spans:
                gs, *ss, ps, os_ = (x[span] for x in views)
                if prep is not None and elementwise:
                    gs = prep(gs)
                u, new = leaf_update(gs, ss, ps, count)
                for dst, src in zip(ss, new):
                    dst.copy_(src.to(dst.dtype))
                write(os_, ps, u)
        state["count"] = count

    def update(grads, state, params):
        outs = [torch.empty(p.shape, dtype=torch.float32, device=p.device)
                for p in tree_leaves(params)]
        run(grads, state, params, outs, lambda o, p, u: o.copy_(u))
        return tree_unflatten(params, outs), state

    def step(grads, state, params, prep=None):
        run(grads, state, params, tree_leaves(params),
            lambda o, p, u: o.copy_((p + u).to(o.dtype)), prep)
        return state

    return Optimizer(init, update, step)


# ---------------------------------------------------------------------------


def sgd(lr, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                "count": 0}

    def leaf(g, st, p, count):
        (mu,) = st
        lr_t = _lr_at(lr, count)
        mu = momentum * mu + g.float() + weight_decay * p.float()
        return -lr_t * mu, (mu,)

    return _make(init, leaf, elementwise=True)


# ---------------------------------------------------------------------------


def _moments(g, m, v, b1, b2):
    # math in f32, storage in the state's dtype
    m = b1 * m.float() + (1 - b1) * g.float()
    v = b2 * v.float() + (1 - b2) * torch.square(g.float())
    return m, v


def _moment_init(params, state_dtype=torch.float32):
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params),
        "count": 0,
    }


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, state_dtype=torch.float32) -> Optimizer:
    def leaf(g, st, p, count):
        m, v = _moments(g, *st, b1, b2)
        lr_t = _lr_at(lr, count)
        mh = m / _bias_correction(b1, count)
        vh = v / _bias_correction(b2, count)
        u = -lr_t * (mh / (torch.sqrt(vh) + eps) + weight_decay * p.float())
        return u, (m, v)

    return _make(lambda p: _moment_init(p, state_dtype), leaf, elementwise=True)


# ---------------------------------------------------------------------------


def _trust_ratio(p, u, min_norm: float = 1e-8):
    pn = torch.linalg.vector_norm(p.float().reshape(-1))
    un = torch.linalg.vector_norm(u.reshape(-1))
    one = torch.ones((), dtype=torch.float32, device=p.device)
    return torch.where((pn > min_norm) & (un > min_norm), pn / un, one)


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:
    """LAMB [You et al. 2019]: Adam direction rescaled by the layerwise
    trust ratio ||p|| / ||update||."""

    def leaf(g, st, p, count):
        m, v = _moments(g, *st, b1, b2)
        lr_t = _lr_at(lr, count)
        r = ((m / _bias_correction(b1, count)) / (torch.sqrt(v / _bias_correction(b2, count)) + eps)
             + weight_decay * p.float())
        return -lr_t * _trust_ratio(p, r) * r, (m, v)

    return _make(_moment_init, leaf, elementwise=False)


def lans(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:
    """LANS [Zheng et al. 2020]: Nesterov-style two-part LAMB with
    gradient normalization — the optimizer of the paper's BERT-1.5B runs."""

    def normalize(g):
        gf = g.float()
        return gf / (torch.linalg.vector_norm(gf.reshape(-1)) + 1e-9)

    def leaf(g, st, p, count):
        m, v = _moments(g, *st, b1, b2)
        lr_t = _lr_at(lr, count)
        pf = p.float()
        denom = torch.sqrt(v / _bias_correction(b2, count)) + eps
        r_m = (m / _bias_correction(b1, count)) / denom + weight_decay * pf
        r_g = g / denom + weight_decay * pf
        u = -lr_t * (b1 * _trust_ratio(p, r_m) * r_m + (1 - b1) * _trust_ratio(p, r_g) * r_g)
        return u, (m, v)

    return _make(_moment_init, leaf, elementwise=False, per_leaf_grad=normalize)


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "lamb": lamb, "lans": lans}


def make(name: str, lr, **kw) -> Optimizer:
    return OPTIMIZERS[name](lr, **kw)
