"""DropCompute (Algorithm 1) in PyTorch (port of ``repro.core.dropcompute``).

During gradient accumulation each worker tracks the compute time of its
micro-batches and, once the cumulative time crosses ``tau``, stops and
joins the All-Reduce with the gradients it has.  Synchronous semantics
are kept; only the batch size becomes stochastic.

The reference scans over micro-batches under ``lax.cond`` (a dropped
micro-batch runs the zero branch).  The port decides on the host: a
dropped micro-batch is skipped, so it costs nothing, and each kept one's
gradients are added into an f32 accumulator by the masked-accumulate
kernel (``kernels.ops.masked_accum``, K1).  Adding the reference's zeros
for a dropped micro-batch changes no bit, so both give the same sums.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from ..models.transformer import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class DropConfig:
    """Configuration for DropCompute.

    Attributes:
      enabled: master switch; disabled == vanilla synchronous accumulation.
      tau: compute threshold in seconds (set via Algorithm 2, see
        ``core.threshold``). ``inf`` behaves exactly like vanilla.
      normalize: how the summed micro-batch gradients are normalized.
        * "nominal"  — divide by the *maximal* batch (paper's Algorithm 1:
          ``g_n += g^(m) / M``): dropped micro-batches shrink the gradient.
        * "computed" — divide by the number of actually-computed samples
          (the stochastic correction of appendix B.2.2).
      min_microbatches: never drop below this many accumulations per worker.
    """

    enabled: bool = True
    tau: float = float("inf")
    normalize: str = "computed"
    min_microbatches: int = 1

    def __post_init__(self):
        if self.normalize not in ("nominal", "computed"):
            raise ValueError(f"bad normalize: {self.normalize}")


# ---------------------------------------------------------------------------
# Drop masks
# ---------------------------------------------------------------------------


def drop_mask(latencies, tau, min_microbatches: int = 1) -> torch.Tensor:
    """Keep-mask from per-micro-batch latencies (Algorithm 1 line 8):
    micro-batch m of a worker is kept iff  sum_{j<=m} t^(j) < tau, and the
    first ``min_microbatches`` are always kept.

    ``latencies`` (..., M) is a numpy array or a tensor; it is taken in
    f32, as the reference's ``jnp.asarray`` does (x64 off), the running sum
    is taken in f32 in the order of the reference's ``cumsum`` on the CPU
    (``_cumsum_like_xla``) and ``tau`` is compared in f32, so a micro-batch
    sitting at tau falls on the same side.  Returns an f32 tensor of the
    same shape (1.0 computed, 0.0 dropped) on the latencies' device (the
    CPU for numpy input)."""
    t = torch.as_tensor(np.asarray(latencies) if not isinstance(latencies, torch.Tensor)
                        else latencies).to(torch.float32)
    m = t.shape[-1]
    keep = _cumsum_like_xla(t) < torch.tensor(np.float32(tau), device=t.device)
    if min_microbatches > 0:
        keep = keep | (torch.arange(m, device=t.device) < min_microbatches)
    return keep.to(torch.float32)


_XLA_SCAN_BLOCK = 16


def _cumsum_like_xla(t: torch.Tensor) -> torch.Tensor:
    """f32 running sum over the last axis, added in the order XLA's CPU
    backend adds ``jnp.cumsum`` (a reduce-window): one element at a time up
    to 16; longer axes in 16-wide blocks, each summed one element at a
    time, plus the running sum (the same way, recursively) of the block
    totals before it.  Pinned against ``jnp.cumsum`` by
    ``tests/test_torch_core.py`` at M from 2 to 64."""
    m = t.shape[-1]
    if m <= _XLA_SCAN_BLOCK:
        out = torch.empty_like(t)
        run = torch.zeros_like(t[..., 0])
        for j in range(m):
            run = run + t[..., j]
            out[..., j] = run
        return out
    pad = (-m) % _XLA_SCAN_BLOCK
    tp = torch.nn.functional.pad(t, (0, pad))
    inner = _cumsum_like_xla(tp.reshape(*t.shape[:-1], -1, _XLA_SCAN_BLOCK))
    totals = _cumsum_like_xla(inner[..., -1])
    carry = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    return (inner + carry[..., None]).reshape(tp.shape)[..., :m]


def completed_fraction(mask) -> torch.Tensor:
    """M~ / M: average fraction of computed micro-batches (drop rate = 1-x)."""
    return torch.as_tensor(mask, dtype=torch.float32).mean()


# ---------------------------------------------------------------------------
# Masked gradient accumulation
# ---------------------------------------------------------------------------


def _host_mask(mask) -> np.ndarray:
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    return np.asarray(mask, dtype=np.float32).reshape(-1)


def _mark(dev: torch.device):
    """A point on ``dev``'s timeline: a CUDA event recorded on the current
    stream (no sync), or the host clock on the CPU, where work is
    synchronous."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def elapsed_s(marks) -> list:
    """Seconds of each (start, end) pair of ``stats["microbatch_marks"]``.
    On the card the events must have completed: read them after a sync
    (the trainer reads them once the step's loss is on the host)."""
    return [e - s if isinstance(s, float) else s.elapsed_time(e) / 1e3 for s, e in marks]


def add_microbatch(grad_fn, params: Tree, mb: dict, acc_leaves: list):
    """One kept micro-batch: its gradients added into the f32 accumulator
    leaves by K1 (``kernels.ops.masked_accum``); returns its (loss_sum,
    weight_sum)."""
    g, loss_sum, w_sum = grad_fn(params, mb)
    for a, gl in zip(acc_leaves, tree_leaves(g)):
        kernel_ops.masked_accum(a, gl, 1.0, 1.0)
    return loss_sum, w_sum


def normalize_grads(acc_leaves: list, w_sum: torch.Tensor, kept: float, m: int,
                    normalize: str) -> torch.Tensor:
    """Divide the summed gradients in place by Algorithm 1's denominator
    and return it: the computed weight ("computed"), or the weight the
    full M micro-batches would have had ("nominal")."""
    if normalize == "computed":
        denom = torch.clamp(w_sum, min=1.0)
    else:
        kept_t = torch.tensor(np.float32(kept), device=w_sum.device)
        denom = torch.clamp(w_sum / torch.clamp(kept_t, min=1.0) * m, min=1.0)
    for a in acc_leaves:
        a.div_(denom)
    return denom


def accumulate_grads(
    grad_fn: Callable[[Tree, Any], Tuple[Tree, torch.Tensor, torch.Tensor]],
    params: Tree,
    microbatches: dict,
    mask,
    cfg: DropConfig,
) -> Tuple[Tree, torch.Tensor, dict]:
    """Accumulate the kept micro-batches' gradients (Algorithm 1).

    Args:
      grad_fn: (params, microbatch) -> (grads_sum, loss_sum, weight_sum),
        sums over the micro-batch's tokens (``engine.make_grad_fn``).
      params: the tree the loss reads (the trainer passes its compute copy).
      microbatches: dict of tensors with leading dim M.
      mask: (M,) keep mask on the host (numpy, list or CPU tensor).
      cfg: DropConfig.

    Returns (grads, loss, stats): grads an f32 tree shaped like ``params``,
    normalized per ``cfg.normalize``, with the reference's ``stats`` keys
    plus ``microbatch_marks``, a (start, end) pair per kept micro-batch
    for ``elapsed_s`` (CUDA events on the card: no sync here).
    """
    keep = _host_mask(mask)
    m = keep.shape[0]
    dev = tree_leaves(params)[0].device
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)
    acc_leaves = tree_leaves(acc)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    w_sum = torch.zeros((), dtype=torch.float32, device=dev)
    marks = []
    for i in range(m):
        if keep[i] <= 0.5:
            continue  # dropped: never computed
        start = _mark(dev)
        l, w = add_microbatch(grad_fn, params, {k: v[i] for k, v in microbatches.items()},
                              acc_leaves)
        loss_sum = loss_sum + l
        w_sum = w_sum + w
        marks.append((start, _mark(dev)))

    kept = float(keep.sum())
    denom = normalize_grads(acc_leaves, w_sum, kept, m, cfg.normalize)
    kept_t = torch.tensor(np.float32(kept), device=dev)
    stats = {
        "completed_microbatches": kept_t,
        "completed_fraction": kept_t / m,
        "computed_weight": w_sum,
        "grad_denom": denom,
        "microbatch_marks": marks,
    }
    return acc, loss_sum / torch.clamp(w_sum, min=1.0), stats


# ---------------------------------------------------------------------------
# Per-example weighting formulation (single-pass global-batch steps)
# ---------------------------------------------------------------------------


def example_weights(mask: torch.Tensor, batch_per_worker: int,
                    microbatch_size: int) -> torch.Tensor:
    """Expand a (workers, M) keep-mask to per-example weights (workers*B,):
    example e of worker n belongs to micro-batch e // microbatch_size."""
    mask = torch.as_tensor(mask, dtype=torch.float32)
    w, m = mask.shape
    if m * microbatch_size != batch_per_worker:
        raise ValueError(f"M={m} x microbatch {microbatch_size} != batch per worker "
                         f"{batch_per_worker}")
    return mask.repeat_interleave(microbatch_size, dim=1).reshape(w * batch_per_worker)


def weighted_loss(token_losses: torch.Tensor, token_weights: torch.Tensor,
                  ex_weights: torch.Tensor, cfg: DropConfig,
                  nominal_weight=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global weighted-mean loss: eq. (1) plus the drop normalization.
    Returns (scalar loss, scalar computed weight)."""
    w = token_weights * ex_weights[:, None]
    num = torch.sum(token_losses * w)
    computed = torch.sum(w)
    if cfg.normalize == "computed":
        denom = torch.clamp(computed, min=1.0)
    else:
        if nominal_weight is None:
            nominal_weight = torch.sum(token_weights)
        denom = torch.clamp(torch.as_tensor(nominal_weight, dtype=torch.float32), min=1.0)
    return num / denom, computed
