"""Local-SGD + DropCompute (appendix B.3; port of ``repro.core.local_sgd``).

Local-SGD performs H local optimizer steps per worker between parameter
averaging rounds.  DropCompute integrates by treating *local steps* the way
Algorithm 1 treats gradient accumulations: when a worker's cumulative
compute time within a synchronization period crosses ``tau``, it skips its
remaining local steps and waits at the averaging barrier.

Two pieces:
  * a runtime model reproducing fig. 12 (straggling workers drawn per local
    step, uniform vs. single-server scenarios), numpy, copied unchanged so
    its draws equal the reference's bit for bit;
  * a functional trainer that runs N virtual workers on one device, so
    convergence with dropped local steps can be checked on a real task.

The reference vmaps its workers over stacked copies of the parameters
(``local_sgd.py:112``).  At qwen2.5-3b that is N x 12.3 GB of f32
parameters plus as many gradients, so the port loops over the workers and
keeps three f32 trees (:class:`LocalSGD`): the round's average P, the
working copy W of the worker that runs, and the sum S of the workers'
results.  A local step ``w <- w - lr * k * grad`` is the masked-accumulate
kernel (K1, ``kernels.ops.masked_accum``) with ``acc = W`` and
``scale = -lr``: the loss is differentiated as the scalar it is, so the
scale is a host constant and nothing syncs.  A dropped step (k = 0) skips
its forward and backward, which leaves W bit-unchanged where the reference
multiplies a computed gradient by 0; its loss is still evaluated, since the
reference's round mean counts it.  On the card a kept step (forward and
backward, the K1 adds into W, the compute copy's refill, the post-step
loss) and a dropped step (the loss) are each one CUDA graph per
micro-batch shape (``graphs.StepGraph``, the reference's ``jax.jit`` of the
round, ``:115``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..graphs import StepGraph
from ..kernels import ops as kernel_ops
from ..models.transformer import tree_leaves, tree_map, tree_unflatten
from .dropcompute import _mark

Tree = Any


# ---------------------------------------------------------------------------
# Runtime model (fig. 12)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StragglerScenario:
    """Per-local-step straggler injection.

    mode="uniform": every (worker, step) is independently a straggler with
    probability p.  mode="single_server": only workers [0, server_size) can
    straggle (the realistic "one bad host" case).
    """

    mode: str = "uniform"
    p: float = 0.04
    delay: float = 1.0
    base: float = 0.1
    server_size: int = 8

    def sample(self, rng: np.random.Generator, iters: int, n: int, h: int):
        t = np.full((iters, n, h), self.base)
        hit = rng.random((iters, n, h)) < self.p
        if self.mode == "single_server":
            mask = np.zeros((1, n, 1), dtype=bool)
            mask[:, : self.server_size] = True
            hit = hit & mask
        return t + hit * self.delay


def localsgd_speedup(
    scenario: StragglerScenario,
    n_workers: int,
    sync_period: int,
    tau: float | None = None,
    iters: int = 500,
    tc: float = 0.05,
    seed: int = 0,
):
    """Relative speedup of (Local-SGD [+DropCompute]) vs fully synchronous.

    Synchronous baseline: barrier after every local step ->
        sum_h max_n t[:, n, h].
    Local-SGD: barrier only after H steps -> max_n sum_h t[:, n, h].
    +DropCompute: each worker caps its per-period compute at tau.

    Returns (speedup, dropped_fraction).
    """
    rng = np.random.default_rng(seed)
    t = scenario.sample(rng, iters, n_workers, sync_period)  # (I, N, H)

    sync = t.max(axis=1).sum(axis=-1) + sync_period * tc  # (I,)
    per_worker = t.sum(axis=-1)  # (I, N)

    if tau is None:
        local = per_worker.max(axis=1) + tc
        drop = 0.0
    else:
        cum = np.cumsum(t, axis=-1)
        done = cum < tau
        drop = 1.0 - done.mean()
        local = np.minimum(per_worker, tau).max(axis=1) + tc
    return float(sync.mean() / local.mean()), float(drop)


# ---------------------------------------------------------------------------
# Functional Local-SGD trainer (N virtual workers on one device)
# ---------------------------------------------------------------------------


def local_step(loss_fn: Callable, compute: Tree, w_leaves: list, mb: dict, lr: float,
               keep: float, refill: Optional[Callable[[], Any]]) -> torch.Tensor:
    """One kept local step: the gradient of the scalar ``loss_fn(compute,
    mb)`` with respect to every leaf of ``compute``, added into the f32
    working copy's leaves ``w_leaves`` by K1 (``w += keep * -lr * g``), the
    compute copy refilled from them (``refill``; None when ``compute`` is
    the working copy itself), and the loss at the updated weights."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(compute)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(compute, leaves), mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for w, g in zip(w_leaves, grads):
        if g is not None:  # an unused leaf's gradient is 0: w stays as it is
            kernel_ops.masked_accum(w, g, keep, -lr)
    del leaves, grads, loss
    if refill is not None:
        refill()
    with torch.no_grad():
        return loss_fn(compute, mb).detach()


class LocalSGD:
    """The Local-SGD state of :func:`localsgd_train`, allocated once: the
    averaged f32 parameters ``params`` (P, the caller's tree, updated in
    place), the working copy ``work`` (W) and the workers' sum (S), each a
    tree shaped like P, and the compute copy the loss reads (``cast(W)``,
    refilled in place from W after every change; W itself when ``cast`` is
    None).  ``round`` runs one round; its local steps' (kept, start, end)
    marks are kept in ``step_marks`` (CUDA events on the card, read after a
    sync; host seconds on the CPU)."""

    def __init__(self, loss_fn: Callable, params: Tree, n_workers: int, sync_period: int,
                 lr: float, cast: Optional[Callable[..., Tree]] = None):
        self.params = params
        self.n_workers, self.sync_period, self.lr = n_workers, sync_period, float(lr)
        self.dev = tree_leaves(params)[0].device
        self.work = tree_map(lambda p: p.detach().clone(), params)
        self.sum = tree_map(torch.zeros_like, params)
        self.p_leaves, self.w_leaves = tree_leaves(params), tree_leaves(self.work)
        self.s_leaves = tree_leaves(self.sum)
        self.compute = self.work if cast is None else cast(self.work)
        work, compute, w_leaves, lr_ = self.work, self.compute, self.w_leaves, self.lr
        refill = None if cast is None else (lambda: cast(work, out=compute))
        self._refill = refill
        self.step_marks: list = []
        # the step's keep value and the micro-batch's keys, set before each
        # call: a capture reads them once, a replay not at all
        self._keep: list = [1.0]
        self._names: list = []
        keep_, names = self._keep, self._names

        def step(*values):  # holds no reference to self: the graphs go with it
            mb = dict(zip(names, values))
            if keep_[0]:
                return local_step(loss_fn, compute, w_leaves, mb, lr_, keep_[0], refill)
            with torch.no_grad():
                return loss_fn(compute, mb).detach()

        self.step_graph = StepGraph(step, self.dev)

    def _start_worker(self) -> None:
        for w, p in zip(self.w_leaves, self.p_leaves):
            w.copy_(p)
        if self._refill is not None:
            self._refill()

    def step(self, mb: dict, keep: float) -> torch.Tensor:
        """One local step of the running worker on micro-batch ``mb`` (a
        dict of tensors) under ``keep`` (0: dropped); returns its post-step
        loss, a tensor the next step overwrites."""
        self._names[:] = sorted(mb)
        values = [mb[k] for k in self._names]
        self._keep[0] = keep
        key = (keep, tuple((k, tuple(v.shape), v.dtype) for k, v in zip(self._names, values)))
        return self.step_graph(key, *values)

    def round(self, batches: list, keep: np.ndarray) -> torch.Tensor:
        """One round: every worker n starts from P and runs its H local
        steps on ``batches[n]`` (a dict of tensors with leading dim H) under
        ``keep[n]``; P becomes the workers' mean.  Returns the round's loss
        (the mean over workers of each one's mean over its H post-step
        losses) as a device scalar."""
        n, h = self.n_workers, self.sync_period
        losses = torch.empty((n, h), dtype=torch.float32, device=self.dev)
        for s in self.s_leaves:
            s.zero_()
        self.step_marks = []
        for i in range(n):
            self._start_worker()
            for j in range(h):
                start = _mark(self.dev)
                loss = self.step({k: v[j] for k, v in batches[i].items()}, float(keep[i, j]))
                losses[i, j].copy_(loss)  # before the next step's replay overwrites it
                self.step_marks.append((keep[i, j] != 0.0, start, _mark(self.dev)))
            for s, w in zip(self.s_leaves, self.w_leaves):
                kernel_ops.masked_accum(s, w, 1.0, 1.0)
        for p, s in zip(self.p_leaves, self.s_leaves):
            torch.div(s, n, out=p)
        return losses.mean(dim=1).mean()


def localsgd_train(
    loss_fn: Callable,
    params,
    data_fn: Callable[[int, int], dict],  # (round, worker) -> microbatch seq
    n_workers: int,
    rounds: int,
    sync_period: int,
    lr: float,
    keep_mask: np.ndarray | None = None,
    device=None,
    cast: Optional[Callable[..., Tree]] = None,
):
    """Run Local-SGD with optional per-(round, worker, step) keep mask.

    ``keep_mask[r, n, h] = 0`` means worker n skips local step h in round r
    (DropCompute drop).  Parameters are averaged across workers after each
    round.  ``loss_fn(p, mb)`` returns a scalar; ``data_fn(r, n)`` a dict
    of arrays or tensors with leading dim H.  ``params`` (f32) are moved to
    ``device`` (CUDA unless the caller passes another) and updated in place
    to the averaged parameters.  ``cast(w, out=None)`` makes the compute
    copy the loss reads from the f32 working copy, or refills ``out`` in
    place (at the model: ``models.model.train_params`` with its config);
    None: the loss reads the f32 copy.  Returns (params, losses per round).
    """
    dev = resolve_device(device)
    params = tree_map(lambda p: p.to(dev), params)
    state = LocalSGD(loss_fn, params, n_workers, sync_period, lr, cast=cast)
    losses = []
    for r in range(rounds):
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in data_fn(r, n).items()}
                   for n in range(n_workers)]
        keep = (np.asarray(keep_mask[r], dtype=np.float32) if keep_mask is not None
                else np.ones((n_workers, sync_period), np.float32))
        losses.append(float(state.round(batches, keep)))
    return params, losses
