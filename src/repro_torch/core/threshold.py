"""Automatic threshold selection (Algorithm 2, appendix C.1).

Carried over from ``repro.core.threshold`` unchanged (numpy only: the port keeps its own
copy); ``tests/test_torch_core.py`` pins it to exact equality.

Each worker records the wall-clock latency of every micro-batch for the
first ``I`` iterations plus the per-iteration communication time ``T_i^c``.
The samples are synchronized across workers (an all-gather that happens
once per training session) and every worker then runs the same
deterministic grid search below, so all workers independently arrive at
the same ``tau*`` — no coordinator required (decentralized, like the
All-Reduce itself).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ThresholdResult:
    tau: float
    speedup: float
    grid: np.ndarray
    speedups: np.ndarray
    completion: np.ndarray  # mean fraction of computed micro-batches per tau
    step_speedup: np.ndarray  # time-only speedup per tau (fig. 3c)

    def summary(self) -> str:
        return (
            f"tau*={self.tau:.4f}s  S_eff={self.speedup:.4f}  "
            f"completion={self.completion[np.argmax(self.speedups)]:.3f}"
        )


def fill_profile_nans(latencies: np.ndarray) -> np.ndarray:
    """Fill NaN micro-batch times with their column mean (over I and N).

    ``HostTimedEngine.profile()`` NaN-pads micro-batches a worker dropped;
    Algorithm 2 wants a dense profile, and the best unbiased stand-in for
    a never-run accumulation is the mean time of that accumulation slot
    where it *was* run.  Columns with no observations fall back to the
    global mean.  No-op (same array returned) when nothing is NaN.
    """
    lat = np.asarray(latencies, dtype=np.float64)
    if not np.isnan(lat).any():
        return lat
    col = np.nanmean(lat, axis=(0, 1), keepdims=True) if lat.ndim == 3 else np.nanmean(lat)
    col = np.where(np.isnan(col), np.nanmean(lat), col)
    return np.where(np.isnan(lat), col, lat)


def select_threshold(
    latencies: np.ndarray,
    tc,
    grid: Optional[Sequence[float]] = None,
    grid_size: int = 256,
    min_microbatches: int = 1,
    max_drop: Optional[float] = None,
) -> ThresholdResult:
    """Algorithm 2: pick tau* maximizing the mean per-iteration S_eff.

    Args:
      latencies: (I, N, M) micro-batch times t_{i,n}^{(m)} gathered from all
        N workers over I profiling iterations.  NaNs (host-timed profiles of
        partially-dropped steps) are filled via :func:`fill_profile_nans`.
      tc: scalar or (I,) per-iteration communication/serial time.
      grid: candidate thresholds; default = linspace over observed range.
      max_drop: optional drop-rate ceiling — tau* is restricted to grid
        points whose mean completion is >= 1 - max_drop (the online
        controller's guardrail).  If no grid point qualifies, the
        highest-completion point wins.

    Returns ThresholdResult with tau* = argmax_tau mean_i S_i(tau).
    """
    lat = np.asarray(latencies, dtype=np.float64)
    if lat.ndim != 3:
        raise ValueError(f"latencies must be (I, N, M), got {lat.shape}")
    lat = fill_profile_nans(lat)
    i_, n_, m_ = lat.shape
    tc = np.broadcast_to(np.asarray(tc, dtype=np.float64), (i_,))

    cum = np.cumsum(lat, axis=-1)  # (I, N, M): T_{i,n}^{(m)}
    t_in = cum[..., -1]  # (I, N): worker step compute time
    t_i = t_in.max(axis=1)  # (I,): slowest worker

    if grid is None:
        lo = float(np.quantile(t_in, 0.05))
        hi = float(t_i.max()) * 1.05
        grid = np.linspace(lo, hi, grid_size)
    grid = np.asarray(list(grid), dtype=np.float64)

    # completed micro-batches per (tau, I): mean_n sum_m [T_{i,n}^{(m)} < tau],
    # with the same min_microbatches floor as dropcompute.drop_mask /
    # SimResult.with_threshold (workers never drop their first few).
    done = cum[None, ...] < grid[:, None, None, None]  # (G, I, N, M)
    if min_microbatches > 0:
        done |= np.arange(m_) < min_microbatches
    m_tilde = done.sum(axis=-1).mean(axis=-1)  # (G, I)

    # worker time = cum at its last kept micro-batch; done is a prefix
    # mask, so gather at index count-1 instead of materializing a
    # (G, I, N, M) float temp alongside the boolean one.
    counts = done.sum(axis=-1)  # (G, I, N)
    w_time = np.take_along_axis(
        np.broadcast_to(cum[None], done.shape),  # view, no copy
        np.maximum(counts - 1, 0)[..., None], axis=-1,
    )[..., 0]
    w_time = np.where(counts > 0, w_time, 0.0)  # (G, I, N)
    forced = w_time.max(axis=-1)  # (G, I)
    t_drop = (
        np.maximum(np.minimum(t_i[None, :], grid[:, None]), forced) + tc[None, :]
    )  # (G, I)
    s_step = (t_i + tc)[None, :] / t_drop  # time-only speedup
    s_i = s_step * (m_tilde / m_)  # effective speedup per iteration
    s_eff = s_i.mean(axis=1)  # (G,)

    completion = (m_tilde / m_).mean(axis=1)  # (G,)
    if max_drop is not None:
        allowed = completion >= 1.0 - max_drop
        if not allowed.any():
            allowed = completion >= completion.max()
        k = int(np.argmax(np.where(allowed, s_eff, -np.inf)))
    else:
        k = int(np.argmax(s_eff))
    return ThresholdResult(
        tau=float(grid[k]),
        speedup=float(s_eff[k]),
        grid=grid,
        speedups=s_eff,
        completion=completion,
        step_speedup=s_step.mean(axis=1),
    )


def gather_latency_profile(local_latencies: np.ndarray, axis_name=None):
    """All-gather per-worker latency profiles.

    In a real multi-host deployment this is a
    ``jax.experimental.multihost_utils.process_allgather``; in this
    single-process environment the "workers" are the data-parallel shards
    and the profile is already globally replicated, so this is an identity
    with shape validation.  Kept as a seam so the launcher can swap in the
    real collective.
    """
    lat = np.asarray(local_latencies)
    if lat.ndim == 2:  # (I, M) single worker -> (I, 1, M)
        lat = lat[:, None, :]
    return lat
