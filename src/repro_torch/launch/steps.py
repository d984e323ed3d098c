"""The data-parallel DropCompute train step (port of
``repro.launch.steps.make_train_step``, ``steps.py:119-227``), the prefill
and single-token serve steps (``make_prefill_step``, ``make_serve_step``,
``steps.py:235-254``), and the batch placements (``batch_shardings``,
``steps.py:262-283``).

The reference builds one SPMD program: the (W, M) keep mask from the
latencies, each example weighted by its (worker, micro-batch) keep bit, a
scan over the M micro-batches, and the collectives fall out of pjit over
the parameters' and optimizer state's placements (``dist.sharding``).
Here each rank is a process holding ``W / R`` of the ``W`` workers
(``Distribution.workers_of``) and, under ZeRO, its slices of the master
parameters and optimizer state (``Distribution.shard``).  A step on a rank
is:

1. the compute copy (``models.train_params``: the compute dtype, the
   ``embed`` leaves f32) refilled in its fixed buffers: a split leaf's
   slice cast, then all-gathered over the rank's data group
   (``Distribution.all_gather``); a whole leaf cast in place (or shared
   with the master where no cast is needed, as on one device);
2. the keep mask from the (W, M) latencies (``core.drop_mask``; all ones
   when DropCompute is off), of which the rank keeps its own workers' rows:
   every rank draws the same latencies, and each decides for its own
   workers alone, as the paper's method is decentralised;
3. its kept (worker, micro-batch) blocks of the global batch, rows
   ``(w·M + j)·mbw`` on as in the reference's ``to_micro``, through the
   ``core.Accumulator`` (on the card one CUDA-graph replay each; K1 adds
   into the whole accumulator, of ``accum_dtype``: f32 by default, as the
   reference's; the trainer asks for the master parameters' dtype, as its
   ``accumulate_grads`` sums); a dropped block is skipped where the
   reference weighs it by 0, which gives the same sums;
4. outside the graphs, one sum All-Reduce of the whole leaves of the
   accumulator and of the 3-float ``[loss_sum, w_sum, kept]`` (in place:
   the accumulator's leaves keep their addresses), and a reduce-scatter of
   each split leaf, its sum's slice written over the rank's own rows of the
   accumulator (no gradient tree beside it); a rank that keeps nothing
   joins them with zeros;
5. normalisation by the global sums (the reference's ``:209-214``), clip
   by the global norm over the whole leaves (the split leaves' partial
   sums of squares summed over the data group, the whole ones counted
   once), and the optimizer step on the rank's slices, in place: the sums
   are read in f32 a slice at a time inside the optimizer step, as the
   reference's f32 quotient ``g / denom`` (for bf16 sums, a bf16 sum over
   an f32 denominator), times the clip factor, so no normalised tree is
   written; LAMB's and LANS's per-leaf norms are summed over the data
   group the same way (``optim.ShardNorms``).

One rank (or a data axis of 1) splits nothing: the step is the
single-device trainer's, bit for bit.  ``moe_impl`` is the MoE layers'
dispatch in the loss, ``state_dtype`` the AdamW moments' dtype
(``steps.py:127-129``).

No ``DistributedDataParallel`` or FSDP module: their reducers fire inside
every backward, inside every captured micro-batch graph, and the reference
too reduces once a step.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.dropcompute import Accumulator, DropConfig, _mark, drop_mask, grad_denom, sum_kept
from ..core.engine import make_grad_fn
from ..dist import mesh as mesh_lib
from ..dist.sharding import _fit_spec, batch_spec
from ..models.config import InputShape, ModelConfig
from ..graphs import StepGraph
from ..models import layers as L
from ..models.model import (_cache_parts, decode_plans, decode_step, forward_features,
                            init_params, loss_fn, params_device, train_params)
from ..models.transformer import tree_leaves, tree_map, tree_unflatten
from ..optim import clip_scale, global_norm, make as make_opt

Tree = Any


class TrainStep:
    """One rank's step, ``step(params, opt_state, batch, latencies) ->
    (params, opt_state, metrics)``: ``params`` (the master tree: under a
    ``Distribution``, this rank's slices, ``dist.shard``) and ``opt_state``
    (``opt.init(params)``) are updated in place and returned; ``batch`` is
    the global batch (``tokens``, ``weights``: (B, S) numpy arrays or
    tensors; an enc-dec model's ``frames`` (B, F, d) or a VLM's ``prefix``
    (B, P, d) beside them) and ``latencies`` the (W, M) draw.  ``drop`` may
    be replaced between calls (a new tau needs no capture).  The compute
    copy and the accumulator are made at the first call and kept: later
    calls refill them in place.  The accumulator's leaves are
    ``accum_dtype``, or the master leaves' dtypes when it is None."""

    def __init__(self, cfg: ModelConfig, drop: DropConfig, n_workers: int, m: int, mbw: int,
                 opt, clip_norm: float, dist=None, moe_impl: str = "sort",
                 accum_dtype: Optional[torch.dtype] = torch.float32):
        self.cfg, self.drop, self.opt, self.clip_norm, self.dist = cfg, drop, opt, clip_norm, dist
        self.n_workers, self.m, self.mbw = n_workers, m, mbw
        self.accum_dtype = accum_dtype
        self.workers = dist.workers_of(dist.rank, n_workers) if dist else range(n_workers)
        self.grad_fn = make_grad_fn(lambda p, mb: loss_fn(p, cfg, mb, moe_impl=moe_impl))
        self.compute: Optional[Tree] = None
        self.accumulator: Optional[Accumulator] = None
        self._params = None

    def _blocks(self, batch: dict, dev: torch.device) -> dict:
        """This rank's (worker, micro-batch) blocks of every leaf of the
        batch, (W/R · M, mbw, ...) each, as the reference's ``to_micro``
        maps the whole batch: ``tokens`` as int64, ``weights`` as f32, any
        other leaf (``frames``, ``prefix``) in its own dtype."""
        lo, hi = self.workers.start * self.m * self.mbw, self.workers.stop * self.m * self.mbw
        dtypes = {"tokens": torch.long, "weights": torch.float32}
        out = {}
        for k, v in batch.items():
            x = torch.as_tensor(v)[lo:hi]
            out[k] = x.reshape(len(self.workers) * self.m, self.mbw, *x.shape[1:]).to(
                dev, dtypes.get(k, x.dtype))
        return out

    def _bind(self, params: Tree) -> None:
        """The compute copy and the accumulator for the master tree
        ``params``: a whole leaf's compute leaf is the master itself where
        no cast is needed (``train_params``' rule), any other a buffer of
        the whole leaf's shape in the compute dtype (``_refill`` fills it);
        a split leaf's gradient is its rows of the accumulator."""
        abstract = abstract_params(self.cfg)
        whole = tree_leaves(abstract)
        self.dims = self.dist.split_dims(abstract) if self.dist else [None] * len(whole)
        masters = tree_leaves(params)
        for p, w, d in zip(masters, whole, self.dims):
            want = w.shape if d is None else self.dist.own_rows(w, d).shape
            if p.shape != want:
                raise ValueError(f"a master leaf of shape {tuple(p.shape)} where this rank holds "
                                 f"{tuple(want)}: pass dist.shard(params)")
        meta = tree_leaves(train_params(tree_map(lambda p: p.to("meta"), params), self.cfg))
        self.compute = tree_unflatten(params, [
            p if d is None and c.dtype == p.dtype
            else torch.empty(w.shape, dtype=c.dtype, device=p.device)
            for p, w, c, d in zip(masters, whole, meta, self.dims)])
        self.accumulator = Accumulator(self.grad_fn, self.compute, [
            self.accum_dtype or p.dtype for p in masters])
        # a split leaf's reduced slice is written over the accumulator's own
        # rows (a view; the accumulator is zeroed at the next step)
        self.grads = [a if d is None else self.dist.own_rows(a, d)
                      for a, d in zip(self.accumulator.leaves, self.dims)]
        self.shards = (self.dist.shard_norms([d is not None for d in self.dims])
                       if self.dist else None)
        self._params = params

    def _refill(self, params: Tree) -> None:
        """The compute copy from the masters: a split leaf's slice cast and
        all-gathered, a whole leaf cast in place (nothing where it is the
        master)."""
        for dst, src, d in zip(tree_leaves(self.compute), tree_leaves(params), self.dims):
            if d is not None:
                self.dist.all_gather(dst, src.to(dst.dtype), d)
            elif dst is not src:
                dst.copy_(src)

    def __call__(self, params: Tree, opt_state, batch: dict, latencies):
        dev = tree_leaves(params)[0].device
        w, m = self.n_workers, self.m
        mask = (drop_mask(latencies, self.drop.tau, self.drop.min_microbatches).cpu().numpy()
                if self.drop.enabled else np.ones((w, m), np.float32))
        own = mask[self.workers.start:self.workers.stop].reshape(-1)
        if self._params is not params:
            self._bind(params)
        start = _mark(dev)
        with torch.profiler.record_function("dp_all_gather"):
            self._refill(params)
        gather_marks = [(start, _mark(dev))]
        acc = self.accumulator
        loss_sum, w_sum, marks = sum_kept(acc, self._blocks(batch, dev), own)

        sums = torch.stack([loss_sum, w_sum,
                            torch.tensor(np.float32(own.sum()), device=dev)])
        start = _mark(dev)
        with torch.profiler.record_function("dp_allreduce"):
            if self.dist is not None:
                self.dist.all_reduce_sum(
                    [a for a, d in zip(acc.leaves, self.dims) if d is None] + [sums])
        allreduce_marks = [(start, _mark(dev))]
        start = _mark(dev)
        with torch.profiler.record_function("dp_reduce_scatter"):
            for a, g, d in zip(acc.leaves, self.grads, self.dims):
                if d is not None:
                    self.dist.reduce_scatter(g, a, d)
        scatter_marks = [(start, _mark(dev))]
        loss_sum, w_sum, kept = sums.unbind()

        grads = tree_unflatten(params, self.grads)
        denom = grad_denom(w_sum, kept, w * m, self.drop.normalize)
        scale = (clip_scale(global_norm(grads, self.shards) / denom, self.clip_norm)
                 if self.clip_norm > 0 else None)
        opt_state = self.opt.step(grads, opt_state, params,
                                  prep=lambda g: _normalized(g, denom, scale), shards=self.shards)
        metrics = {
            "loss": loss_sum / torch.clamp(w_sum, min=1.0),
            # tensor by tensor: true division, the reference's f32 quotient (by
            # a Python number CUDA multiplies by its reciprocal, an ulp off)
            "completed_fraction": kept / torch.full_like(kept, w * m),
            "computed_weight": w_sum,
            "kept_local": int(own.sum()),
            "microbatch_marks": marks,
            "allreduce_marks": allreduce_marks,
            "reduce_scatter_marks": scatter_marks,
            "all_gather_marks": gather_marks,
        }
        return params, opt_state, metrics


def _normalized(g: torch.Tensor, denom: torch.Tensor, scale: Optional[torch.Tensor]):
    """A gradient sum's values in f32 over the denominator, times the clip
    factor ``scale`` (None: no clipping)."""
    g = g.float() / denom
    return g if scale is None else g * scale


def make_train_step(cfg: ModelConfig, shape: InputShape, drop: DropConfig,
                    n_workers: Optional[int] = None, dist=None, optimizer: str = "adamw",
                    lr: float = 1e-4, clip_norm: float = 1.0,
                    weight_decay: Optional[float] = None, moe_impl: str = "sort",
                    state_dtype: torch.dtype = torch.float32,
                    accum_dtype: Optional[torch.dtype] = torch.float32):
    """Returns (opt, step) for this rank (``TrainStep``).  ``n_workers`` (W)
    may be given or taken from ``dist`` (a ``dist.Distribution``, one worker
    a rank); without ``dist`` the step computes all W workers and issues no
    collective.  ``moe_impl``, ``state_dtype`` (AdamW's moments) and
    ``accum_dtype`` (the gradient sums; None: the master parameters')
    as the reference's (``steps.py:119-160``).  Use ``dist.train_step(...)``
    for the step in a bundle."""
    if n_workers is None:
        if dist is None:
            raise TypeError("make_train_step needs n_workers= or dist=")
        n_workers = dist.dp_size
    opt_kw = {} if weight_decay is None else {"weight_decay": weight_decay}
    if optimizer == "adamw":
        opt_kw["state_dtype"] = state_dtype
    opt = make_opt(optimizer, lr, **opt_kw)
    m, b = shape.microbatches, shape.global_batch
    if b % (n_workers * m):
        raise ValueError(f"global batch {b} must divide into {n_workers} workers x {m} "
                         f"microbatches")
    return opt, TrainStep(cfg, drop, n_workers, m, b // (n_workers * m), opt, clip_norm, dist,
                          moe_impl=moe_impl, accum_dtype=accum_dtype)


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, moe_impl: str = "sort"):
    """``step(params, batch) -> (B,)`` next tokens: the cache-free forward
    (the training path, K3 on the card; MoE layers in ``moe_impl``
    dispatch) and the logits of the last position alone
    (``steps.py:235-245``: full-sequence logits at a large vocabulary
    would not fit), argmax in f32.  A VLM's ``batch`` carries its
    ``prefix`` (B, P, d) beside the text tokens, as the reference's prefill
    inputs (``steps.py:78-81``); the last position is the text's."""
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
    An enc-dec model's cache (``init_decode_cache(..., enc_out=)``) holds
    each layer's cross K/V: the graph reads them in place, as static
    buffers, so a new request batch's encoder output is written into them
    (``copy_``) or given in a new cache.
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


# ---------------------------------------------------------------------------
# Abstract inputs and input placements
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig) -> Tree:
    """The parameter tree's shapes and dtypes as meta tensors (the
    reference's ``jax.eval_shape`` of ``init_params``): no allocation."""
    return init_params(cfg, seed=0, device="meta")


def input_shapes(cfg: ModelConfig, shape: InputShape, n_workers: Optional[int] = None,
                 mesh=None) -> dict:
    """The model inputs' shapes for one workload shape (the reference's
    ``input_specs``, ``steps.py:50-90``, without dtypes): ``batch`` and
    ``latencies`` (W, M) to train, ``batch`` to prefill, ``token`` and
    ``pos`` to decode."""
    b, s = shape.global_batch, shape.seq_len
    text = s - cfg.prefix_len if cfg.prefix_len else s
    batch = {"tokens": (b, text)}
    if shape.mode == "train":
        batch["weights"] = (b, text)
    if shape.mode in ("train", "prefill"):
        if cfg.prefix_len:
            batch["prefix"] = (b, cfg.prefix_len, cfg.d_model)
        if cfg.is_encdec:
            batch["frames"] = (b, cfg.enc_seq, cfg.d_model)
    if shape.mode == "train":
        w = n_workers or (mesh_lib.dp_size(mesh) if mesh is not None else 1)
        return {"batch": batch, "latencies": (w, shape.microbatches)}
    if shape.mode == "prefill":
        return {"batch": batch}
    return {"token": (b, 1), "pos": ()}


def batch_shardings(cfg: ModelConfig, shape: InputShape, mesh,
                    n_workers: Optional[int] = None) -> dict:
    """The inputs' specs (``steps.py:262-283``): every batch leaf's leading
    dim over the data axes (``batch_spec``), the (W, M) latencies fitted to
    their own shape, a decode step's ``token`` like the batch and ``pos``
    replicated."""
    mesh = getattr(mesh, "mesh", mesh)
    lead = batch_spec(mesh, shape.global_batch)[0]
    shapes = input_shapes(cfg, shape, n_workers, mesh)
    out = {}
    if "batch" in shapes:
        out["batch"] = {k: (lead,) + (None,) * (len(v) - 1) for k, v in shapes["batch"].items()}
    if "latencies" in shapes:
        # W need not divide over the dp size even where the global batch does
        out["latencies"] = _fit_spec(shapes["latencies"], (lead, None), mesh)
    if "token" in shapes:
        out["token"] = (lead, None)
        out["pos"] = ()
    return out
