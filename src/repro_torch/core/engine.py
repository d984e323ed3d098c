"""Gradient-accumulation engines implementing Algorithm 1 (port of
``repro.core.engine``).

* ``HostTimedEngine`` — the paper's user-level implementation: a Python
  loop over per-micro-batch gradient steps with a wall-clock check between
  accumulations.  On the card each micro-batch is timed around
  ``torch.cuda.synchronize()``, so the drop is physical: the card's own
  compute time decides it.
* ``InGraphEngine`` — the drop decision comes from a latency tensor
  (measured before, or sampled from a ``LatencyModel``): deterministic,
  used by the reproducible experiments.  The mask is made on the host and
  dropped micro-batches are skipped.

Both add each kept micro-batch through their ``dropcompute.Accumulator``,
kept across steps: on the card one CUDA-graph replay a micro-batch (the
reference's jitted ``grad_fn`` and accumulate, ``core/engine.py:62-63``),
so HostTimedEngine's clock reads the card's compute time, not the time
the host takes to issue the micro-batch's kernels one by one.  Their
returned gradients are that accumulator's, valid until the next ``step``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

from .. import synchronize
from ..models.transformer import tree_leaves, tree_unflatten
from .dropcompute import Accumulator, DropConfig, accumulate_grads, drop_mask, normalize_grads
from .simulate import LatencyModel

Tree = Any

# grad_fn(params, microbatch) -> (grads_sum, loss_sum, weight_sum)
GradFn = Callable[[Tree, Any], Tuple[Tree, torch.Tensor, torch.Tensor]]


def make_grad_fn(loss_fn: Callable[[Tree, Any], Tuple[torch.Tensor, torch.Tensor]]) -> GradFn:
    """Lift loss_fn(params, mb) -> (loss_sum, weight_sum) into a GradFn:
    the gradients of loss_sum with respect to every leaf of ``params``, in
    each leaf's dtype (a bf16 compute copy gives bf16 gradients, as the
    reference's cast gives bf16 cotangents), a tree shaped like
    ``params``.  The leaves are detached views: nothing accumulates into
    ``.grad``."""

    def grad_fn(params, mb):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss_sum, w = loss_fn(tree, mb)
            grads = torch.autograd.grad(loss_sum, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return tree_unflatten(params, grads), loss_sum.detach(), w.detach()

    return grad_fn


class HostTimedEngine:
    """Algorithm 1 with real wall-clock timing (decentralized).

    Every ``step`` runs micro-batches until all M are done or the measured
    compute time exceeds ``cfg.tau``.  Latencies are recorded so a
    profiling phase can feed Algorithm 2."""

    def __init__(self, grad_fn: GradFn, cfg: DropConfig):
        self.cfg = cfg
        self._grad_fn = grad_fn
        self._acc = None
        self.latency_log: list[list[float]] = []

    def step(self, params: Tree, microbatches: dict) -> Tuple[Tree, torch.Tensor, dict]:
        m = next(iter(microbatches.values())).shape[0]
        dev = tree_leaves(params)[0].device
        self._acc = acc = Accumulator.reuse(self._acc, self._grad_fn, params)
        acc.zero_()
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        w_sum = torch.zeros((), dtype=torch.float32, device=dev)
        lat: list[float] = []
        computed = 0
        synchronize(dev)
        t0 = time.perf_counter()
        for i in range(m):
            if (self.cfg.enabled and computed >= self.cfg.min_microbatches
                    and (time.perf_counter() - t0) > self.cfg.tau):
                break  # drop the remaining compute, go to the All-Reduce
            tm0 = time.perf_counter()
            l, w = acc.add({k: v[i] for k, v in microbatches.items()})
            synchronize(dev)
            lat.append(time.perf_counter() - tm0)
            loss_sum = loss_sum + l
            w_sum = w_sum + w
            computed += 1
        self.latency_log.append(lat)

        normalize_grads(acc.leaves, w_sum, computed, m, self.cfg.normalize)
        stats = {
            "completed_microbatches": float(computed),
            "completed_fraction": computed / m,
            "computed_weight": w_sum,
        }
        return acc.tree, loss_sum / torch.clamp(w_sum, min=1.0), stats

    def profile(self) -> np.ndarray:
        """(I, 1, M) latency tensor for Algorithm 2 (ragged rows NaN-padded)."""
        if not self.latency_log:
            return np.zeros((0, 1, 0))
        m = max(len(r) for r in self.latency_log)
        out = np.full((len(self.latency_log), m), np.nan)
        for i, r in enumerate(self.latency_log):
            out[i, : len(r)] = r
        return out[:, None, :]


class InGraphEngine:
    """Algorithm 1 with the drop decision taken from a latency input
    (M,) or (workers, M), flattened onto the micro-batch axis; pair with
    ``LatencyModel.sample`` for simulation or with measured timings."""

    def __init__(self, grad_fn: GradFn, cfg: DropConfig):
        self.cfg = cfg
        self._grad_fn = grad_fn
        self._acc = None

    def step(self, params, microbatches, latencies):
        mask = drop_mask(latencies, self.cfg.tau, self.cfg.min_microbatches)
        if not self.cfg.enabled:
            mask = torch.ones_like(mask)
        self._acc = Accumulator.reuse(self._acc, self._grad_fn, params)
        return accumulate_grads(self._grad_fn, params, microbatches, mask.reshape(-1), self.cfg,
                                accumulator=self._acc)


def simulated_latencies(
    model: LatencyModel, steps: int, workers: int, m: int, seed: int = 0
) -> np.ndarray:
    """(steps, workers, M) host-side latency draws for InGraphEngine."""
    rng = np.random.default_rng(seed)
    return model.sample(rng, steps, workers, m)
