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

Under ZeRO (``dist``) a rank holds slices of the parameters, gradients and
moments.  The elementwise updates step a slice as they would the whole;
LAMB's and LANS's per-leaf norms and ``global_norm`` take ``shards``
(``ShardNorms``), which sums the split leaves' partial sums of squares over
their ranks, one collective per pass over the split leaves.  A leaf that is
whole on the rank (every leaf, without ``shards``) takes its own norms in
one pass, as on one device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

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


def _sq(x: torch.Tensor, i: int) -> torch.Tensor:
    """This rank's part of split leaf ``i``'s sum of squares: that of its
    slice ``x`` (f32)."""
    return torch.linalg.vector_norm(x, dtype=torch.float32).square()


class ShardNorms(NamedTuple):
    """How the norms of a tree stored in slices are taken (the data-parallel
    step's ZeRO placement, ``dist.Distribution.shard_norms``): ``split[i]``
    says leaf i is this rank's slice of a leaf whose other slices are on the
    other ranks of its group; ``part(x, i)`` is this rank's part of split
    leaf i's sum of squares, from what it holds of it (``x``: its slice, or
    a tensor made from it); ``reduce(v)`` sums a vector of such parts over
    the ranks, in place, in one collective.  A leaf that is not split is
    whole on every rank and needs no sum.  A one-rank comparator that holds
    whole leaves may take ``part`` as the data ranks' slices' parts summed
    in rank order, and reduce nothing."""

    split: Sequence[bool]
    reduce: Callable[[torch.Tensor], None]
    part: Callable[[torch.Tensor, int], torch.Tensor] = _sq


def _summed(parts: list, shards: ShardNorms) -> list:
    """The split leaves' norms from their parts (``parts``: a list of each
    leaf's partial sums of squares), summed over their ranks in one
    collective and rooted, in the same lists."""
    vec = torch.stack([x for ps in parts for x in ps])
    shards.reduce(vec)
    it = iter(vec.sqrt().unbind())
    return [[next(it) for _ in ps] for ps in parts]


def global_norm(tree: Tree, shards: Optional[ShardNorms] = None) -> torch.Tensor:
    """The L2 norm of every leaf at once; with ``shards``, of the whole
    leaves that ``tree``'s split leaves are slices of (each split leaf's sum
    of squares summed over its ranks, the whole leaves' counted once)."""
    leaves = tree_leaves(tree)
    split = shards.split if shards is not None else [False] * len(leaves)
    sq = [shards.part(x, i) if s else
          torch.linalg.vector_norm(x, dtype=torch.float32).square()
          for i, (x, s) in enumerate(zip(leaves, split))]
    if any(split):
        vec = torch.stack([v for v, s in zip(sq, split) if s])
        shards.reduce(vec)
        it = iter(vec.unbind())
        sq = [next(it) if s else v for v, s in zip(sq, split)]
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


def _contiguous_tail(x: torch.Tensor) -> int:
    """The elements of ``x``'s trailing dimensions that lie contiguously in
    memory (all of them when ``x`` is contiguous)."""
    inner = 1
    for size, stride in zip(reversed(x.shape), reversed(x.stride())):
        if size != 1 and stride != inner:
            break
        inner *= size
    return inner


def _make(init, leaf_update) -> Optimizer:
    """An elementwise Optimizer (SGD, AdamW) from ``leaf_update(g, states,
    p, count) -> (u, new states)`` (f32 math on one slice of a leaf) and
    ``init``."""

    def run(grads, state, params, outs, write, prep=None, shards=None):
        """The update over every leaf, slice by slice: states in place,
        ``write(out, p, u)`` for each slice's output and update; ``prep``
        maps each slice's gradient to the values the update reads.  It reads
        no norm, so a leaf stored in slices over ranks steps as its whole
        would (``shards`` is not read)."""
        count = state["count"] + 1
        cols = [tree_leaves(state[k]) for k in state if k != "count"]
        g_leaves = tree_leaves(grads)
        for g, st, p, out in zip(g_leaves, zip(*cols) if cols else [()] * len(g_leaves),
                                 tree_leaves(params), outs):
            # a gradient may be a strided view (a rank's rows of a leaf split
            # on an inner dimension): each leaf is read as rows of its
            # gradient's contiguous trailing block, at most _SLICE elements at
            # a time, so only the slice at hand is ever copied
            if p.numel() == 0:
                continue
            inner = _contiguous_tail(g)
            rows, width = max(1, _SLICE // inner), min(inner, _SLICE)
            g2 = g.reshape(-1, inner)
            rest = [x.view(-1, inner) for x in (*st, p, out)]
            for r, c in ((r, c) for r in range(0, g2.shape[0], rows)
                         for c in range(0, inner, width)):
                gs = g2[r:r + rows, c:c + width].reshape(-1)
                *ss, ps, os_ = (x[r:r + rows, c:c + width].view(-1) for x in rest)
                if prep is not None:
                    gs = prep(gs)
                u, new = leaf_update(gs, ss, ps, count)
                for dst, src in zip(ss, new):
                    dst.copy_(src.to(dst.dtype))
                write(os_, ps, u)
        state["count"] = count

    return _optimizer(init, run)


def _optimizer(init, run) -> Optimizer:
    """``update`` and ``step`` over ``run(grads, state, params, outs, write,
    prep, shards)``."""

    def update(grads, state, params, shards: Optional[ShardNorms] = None):
        outs = [torch.empty(p.shape, dtype=torch.float32, device=p.device)
                for p in tree_leaves(params)]
        run(grads, state, params, outs, lambda o, p, u: o.copy_(u), shards=shards)
        return tree_unflatten(params, outs), state

    def step(grads, state, params, prep=None, shards: Optional[ShardNorms] = None):
        run(grads, state, params, tree_leaves(params),
            lambda o, p, u: o.copy_((p + u).to(o.dtype)), prep, shards=shards)
        return state

    return Optimizer(init, update, step)


def _layerwise(directions, combine, b1: float, b2: float,
               normalize_grad: bool = False) -> Optimizer:
    """LAMB and LANS: updates scaled by norms over whole leaves.

    ``directions(g, m, v, p, count)`` gives a leaf's update directions from
    its new moments (``_moments`` at ``b1``, ``b2``, stored in f32),
    ``combine(p, dirs, p_norm, dir_norms, count)`` the update.  A leaf that
    is whole on this rank steps in one pass: (with ``normalize_grad``,
    LANS) its gradient over its norm, the moments, the directions, the
    norms and the update, as one device does it.  Under ZeRO a rank holds
    slices of the split leaves (``ShardNorms``), whose norms need every
    rank's part, so they run in passes, each ending in one batched
    collective of their partial sums: (LANS) first every split gradient's;
    then the moments (stored, f32) and the parts of each parameter's and
    its directions' norms; then the directions again from the stored
    moments, and the update.  No pass holds more than one leaf's
    temporaries."""

    def run(grads, state, params, outs, write, prep=None, shards=None):
        count = state["count"] + 1
        g_leaves, p_leaves = tree_leaves(grads), tree_leaves(params)
        ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
        split = list(shards.split) if shards is not None else [False] * len(p_leaves)
        prep = prep or (lambda g: g)

        def norm(x, i):
            """Leaf i's norm, or its part of the sum of squares when split."""
            return shards.part(x, i) if split[i] else torch.linalg.vector_norm(x.reshape(-1))

        def grad(i, gn=None):
            g = prep(g_leaves[i])
            if not normalize_grad:
                return g
            g = g.float()
            return g / ((norm(g, i) if gn is None else gn) + 1e-9)

        def moments(i, g):
            m_new, v_new = _moments(g, ms[i], vs[i], b1, b2)
            ms[i].copy_(m_new)
            vs[i].copy_(v_new)

        def update(i, dirs, pn, rns):
            write(outs[i], p_leaves[i], combine(p_leaves[i], dirs, pn, rns, count))

        for i in (i for i, s in enumerate(split) if not s):
            g = grad(i)
            moments(i, g)
            dirs = directions(g, ms[i], vs[i], p_leaves[i], count)
            update(i, dirs, norm(p_leaves[i].float(), i), [norm(r, i) for r in dirs])
        cut = [i for i, s in enumerate(split) if s]
        if cut:
            gn = (dict(zip(cut, _summed([[norm(prep(g_leaves[i]).float(), i)] for i in cut],
                                        shards)))
                  if normalize_grad else {})
            parts = []
            for i in cut:
                g = grad(i, *gn.get(i, ()))
                moments(i, g)
                parts.append([norm(p_leaves[i].float(), i)]
                             + [norm(r, i) for r in directions(g, ms[i], vs[i], p_leaves[i],
                                                               count)])
            for i, (pn, *rns) in zip(cut, _summed(parts, shards)):
                update(i, directions(grad(i, *gn.get(i, ())), ms[i], vs[i], p_leaves[i], count),
                       pn, rns)
        state["count"] = count

    return _optimizer(_moment_init, run)


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

    return _make(init, leaf)


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

    return _make(lambda p: _moment_init(p, state_dtype), leaf)


# ---------------------------------------------------------------------------


def _trust_ratio(pn, un, min_norm: float = 1e-8):
    """||p|| / ||u|| from the two norms, 1 where either is ~0."""
    one = torch.ones((), dtype=torch.float32, device=pn.device)
    return torch.where((pn > min_norm) & (un > min_norm), pn / un, one)


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:
    """LAMB [You et al. 2019]: Adam direction rescaled by the layerwise
    trust ratio ||p|| / ||update||."""

    def directions(g, m, v, p, count):
        return ((m / _bias_correction(b1, count)) / (torch.sqrt(v / _bias_correction(b2, count))
                                                     + eps) + weight_decay * p.float(),)

    def combine(p, dirs, pn, rns, count):
        (r,), (rn,) = dirs, rns
        return -_lr_at(lr, count) * _trust_ratio(pn, rn) * r

    return _layerwise(directions, combine, b1, b2)


def lans(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:
    """LANS [Zheng et al. 2020]: Nesterov-style two-part LAMB with
    gradient normalization — the optimizer of the paper's BERT-1.5B runs."""

    def directions(g, m, v, p, count):
        pf = p.float()
        denom = torch.sqrt(v / _bias_correction(b2, count)) + eps
        return ((m / _bias_correction(b1, count)) / denom + weight_decay * pf,
                g / denom + weight_decay * pf)

    def combine(p, dirs, pn, rns, count):
        (r_m, r_g), (rn_m, rn_g) = dirs, rns
        return -_lr_at(lr, count) * (b1 * _trust_ratio(pn, rn_m) * r_m
                                     + (1 - b1) * _trust_ratio(pn, rn_g) * r_g)

    return _layerwise(directions, combine, b1, b2, normalize_grad=True)


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "lamb": lamb, "lans": lans}


def make(name: str, lr, **kw) -> Optimizer:
    return OPTIMIZERS[name](lr, **kw)
