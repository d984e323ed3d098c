"""The data-parallel DropCompute train step (port of
``repro.launch.steps.make_train_step``, ``steps.py:119-227``), and the
prefill and single-token serve steps (``make_prefill_step``,
``make_serve_step``, ``steps.py:235-254``).

The reference builds one SPMD program: the (W, M) keep mask from the
latencies, each example weighted by its (worker, micro-batch) keep bit, a
scan over the M micro-batches, and the gradient All-Reduce falls out of
pjit.  Here each rank is a process holding ``W / R`` of the ``W`` workers
(``Distribution.workers_of``), and a step on a rank is:

1. the keep mask from the (W, M) latencies (``core.drop_mask``; all ones
   when DropCompute is off), of which the rank keeps its own workers' rows:
   every rank draws the same latencies, and each decides for its own
   workers alone, as the paper's method is decentralised;
2. its kept (worker, micro-batch) blocks of the global batch, rows
   ``(w·M + j)·mbw`` on as in the reference's ``to_micro``, through the
   ``core.Accumulator`` (on the card one CUDA-graph replay each; K1 adds
   into the f32 accumulator); a dropped block is skipped where the
   reference weighs it by 0, which gives the same sums;
3. one sum All-Reduce of the accumulator's leaves and of the 3-float
   ``[loss_sum, w_sum, kept]``, outside the graphs (in place on the
   accumulator, whose leaves keep their addresses); a rank that keeps
   nothing joins it with zeros;
4. normalisation by the global sums (the reference's ``:209-214``), clip,
   and the optimizer step on the rank's replica, in place.

No ``DistributedDataParallel``: its reducer fires inside every backward,
inside every captured micro-batch graph, and the reference too reduces
once a step.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.dropcompute import (Accumulator, DropConfig, _mark, drop_mask, normalize_grads,
                                sum_kept)
from ..core.engine import make_grad_fn
from ..models.config import InputShape, ModelConfig
from ..graphs import StepGraph
from ..models import layers as L
from ..models.model import (_cache_parts, decode_plans, decode_step, forward_features,
                            loss_fn, params_device, train_params)
from ..models.transformer import tree_leaves
from ..optim import clip_by_global_norm, make as make_opt

Tree = Any


class TrainStep:
    """One rank's step, ``step(params, opt_state, batch, latencies) ->
    (params, opt_state, metrics)``: ``params`` (the f32 master tree) and
    ``opt_state`` are updated in place and returned; ``batch`` is the global
    batch (``tokens``, ``weights``: (B, S) numpy arrays or tensors) and
    ``latencies`` the (W, M) draw.  ``drop`` may be replaced between calls
    (a new tau needs no capture).  The compute copy and the accumulator are
    made at the first call and kept: later calls refill them in place."""

    def __init__(self, cfg: ModelConfig, drop: DropConfig, n_workers: int, m: int, mbw: int,
                 opt, clip_norm: float, dist=None):
        self.cfg, self.drop, self.opt, self.clip_norm, self.dist = cfg, drop, opt, clip_norm, dist
        self.n_workers, self.m, self.mbw = n_workers, m, mbw
        self.workers = dist.workers_of(dist.rank, n_workers) if dist else range(n_workers)
        self.grad_fn = make_grad_fn(lambda p, mb: loss_fn(p, cfg, mb))
        self.compute: Optional[Tree] = None
        self.accumulator: Optional[Accumulator] = None
        self._params = None

    def _blocks(self, batch: dict, dev: torch.device) -> dict:
        """This rank's (worker, micro-batch) blocks, (W/R · M, mbw, S) each."""
        lo, hi = self.workers.start * self.m * self.mbw, self.workers.stop * self.m * self.mbw
        out = {}
        for k, dtype in (("tokens", torch.long), ("weights", torch.float32)):
            x = torch.as_tensor(batch[k])[lo:hi]
            out[k] = x.reshape(len(self.workers) * self.m, self.mbw, *x.shape[1:]).to(dev, dtype)
        return out

    def __call__(self, params: Tree, opt_state, batch: dict, latencies):
        dev = tree_leaves(params)[0].device
        w, m = self.n_workers, self.m
        mask = (drop_mask(latencies, self.drop.tau, self.drop.min_microbatches).cpu().numpy()
                if self.drop.enabled else np.ones((w, m), np.float32))
        own = mask[self.workers.start:self.workers.stop].reshape(-1)
        if self._params is not params:
            self.compute = train_params(params, self.cfg)
            self.accumulator = Accumulator(self.grad_fn, self.compute)
            self._params = params
        else:
            train_params(params, self.cfg, out=self.compute)
        acc = self.accumulator
        loss_sum, w_sum, marks = sum_kept(acc, self._blocks(batch, dev), own)

        sums = torch.stack([loss_sum, w_sum,
                            torch.tensor(np.float32(own.sum()), device=dev)])
        start = _mark(dev)
        with torch.profiler.record_function("dp_allreduce"):
            if self.dist is not None:
                self.dist.all_reduce_sum(acc.leaves + [sums])
        allreduce_marks = [(start, _mark(dev))]
        loss_sum, w_sum, kept = sums.unbind()

        normalize_grads(acc.leaves, w_sum, kept, w * m, self.drop.normalize)
        grads = acc.tree
        if self.clip_norm > 0:
            grads = clip_by_global_norm(grads, self.clip_norm)
        opt_state = self.opt.step(grads, opt_state, params)
        metrics = {
            "loss": loss_sum / torch.clamp(w_sum, min=1.0),
            # tensor by tensor: true division, the reference's f32 quotient (by
            # a Python number CUDA multiplies by its reciprocal, an ulp off)
            "completed_fraction": kept / torch.full_like(kept, w * m),
            "computed_weight": w_sum,
            "kept_local": int(own.sum()),
            "microbatch_marks": marks,
            "allreduce_marks": allreduce_marks,
        }
        return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, shape: InputShape, drop: DropConfig,
                    n_workers: Optional[int] = None, dist=None, optimizer: str = "adamw",
                    lr: float = 1e-4, clip_norm: float = 1.0,
                    weight_decay: Optional[float] = None):
    """Returns (opt, step) for this rank (``TrainStep``).  ``n_workers`` (W)
    may be given or taken from ``dist`` (a ``dist.Distribution``, one worker
    a rank); without ``dist`` the step computes all W workers and issues no
    collective.  Use ``dist.train_step(...)`` for the step in a bundle."""
    if n_workers is None:
        if dist is None:
            raise TypeError("make_train_step needs n_workers= or dist=")
        n_workers = dist.dp_size
    opt = make_opt(optimizer, lr, **({} if weight_decay is None else
                                     {"weight_decay": weight_decay}))
    m, b = shape.microbatches, shape.global_batch
    if b % (n_workers * m):
        raise ValueError(f"global batch {b} must divide into {n_workers} workers x {m} "
                         f"microbatches")
    return opt, TrainStep(cfg, drop, n_workers, m, b // (n_workers * m), opt, clip_norm, dist)


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, moe_impl: str = "sort"):
    """``step(params, batch) -> (B,)`` next tokens: the cache-free forward
    (the training path, K3 on the card; MoE layers in ``moe_impl``
    dispatch) and the logits of the last position alone
    (``steps.py:235-245``: full-sequence logits at a large vocabulary
    would not fit), argmax in f32."""
    def step(params, batch):
        x, _ = forward_features(params, cfg, batch, moe_impl=moe_impl)
        logits = L.unembed(params["embed"], x[:, -1:], cfg)
        return logits[:, -1].float().argmax(dim=-1)

    return step


class ServeStep:
    """``step(params, cache, token, pos) -> (next_tok (B, 1), cache)``: one
    ``decode_step`` and the argmax of its logits (``steps.py:248-254``).

    On the card the step runs as one captured CUDA graph per shape of
    ``token`` and ``pos`` (``graphs.StepGraph``), over the parameters and
    the cache it was first called with (their tensors' addresses are in the
    graph); a call with another parameter tree or cache starts new graphs.
    A paged cache's tile plans are made on the host from ``pos``
    (``decode_plans``), so ``pos`` is read back when it is a device tensor.
    The returned tokens, and the step's logits (B, 1, V) left in
    ``logits``, are the graph's outputs, overwritten by the next call; the
    cache is updated in place.  MoE layers run ``moe_impl`` dispatch
    (``"dense"``, the reference's default for this step)."""

    def __init__(self, cfg: ModelConfig, moe_impl: str = "dense"):
        self.cfg = cfg
        self.moe_impl = moe_impl
        self._bound = None
        self.graph: Optional[StepGraph] = None
        self.logits: Optional[torch.Tensor] = None

    def _program(self, token, pos, *plans):
        plans = dict(zip(self._kinds, plans)) if plans else None
        logits, _ = decode_step(self._params, self.cfg, self._cache, token, pos, plans=plans,
                                moe_impl=self.moe_impl)
        return logits[:, -1].float().argmax(dim=-1, keepdim=True), logits

    def __call__(self, params, cache, token, pos):
        data, tables, _ = _cache_parts(cache)
        if self._bound != (id(params), id(data), id(tables)):
            self._params, self._cache = params, cache
            self._kinds = sorted(set(self.cfg.pattern) & {"G", "L"}) if tables is not None else []
            self.graph = StepGraph(self._program, params_device(params))
            self._bound = (id(params), id(data), id(tables))
        self._cache = cache
        plans = []
        if tables is not None:
            host_pos = pos.cpu().numpy() if isinstance(pos, torch.Tensor) else np.asarray(pos)
            made = decode_plans(self.cfg, cache, host_pos)
            plans = [made[k] for k in self._kinds]
        token = token if isinstance(token, torch.Tensor) else np.asarray(token, np.int64)
        pos = pos if isinstance(pos, torch.Tensor) else np.asarray(pos, np.int64)
        key = (tuple(token.shape), tuple(pos.shape))
        next_tok, self.logits = self.graph(key, token, pos, *plans)
        return next_tok, cache


def make_serve_step(cfg: ModelConfig, moe_impl: str = "dense") -> ServeStep:
    """The single-token serve step (``ServeStep``)."""
    return ServeStep(cfg, moe_impl)
