"""Latency models and cluster simulation for compute-variance studies.

Carried over from ``repro.core.simulate`` unchanged (numpy only: the port keeps its own
copy); ``tests/test_torch_core.py`` pins it to exact equality.

Implements the simulated-delay environment of DropCompute (appendix B.1)
and the noise-distribution study of appendix C.3.

The paper models the per-micro-batch compute latency of worker ``n`` at
accumulation ``m`` as

    t_n^(m) = t_base + mu * eps,     eps = min(Z / alpha, beta)

with ``Z ~ LogNormal(4, 1)``, ``alpha = 2 exp(4.5)``, ``beta = 5.5`` so that
each accumulation takes x1.5 longer on average and at most x6.5 longer.

All samplers return a latency tensor of shape ``(iters, workers, M)``
(seconds).  Everything here is host-side numpy: these are *models* of
wall-clock behaviour used to drive simulations, analytics and the
in-graph DropCompute mask, never traced compute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Noise models (appendix B.1 and C.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Additive noise ``eps`` on top of a deterministic micro-batch time.

    ``t = base * (1 + eps)`` where eps is drawn from ``kind``; matches the
    paper's ``t <- t + mu * eps`` with ``mu = base``.
    """

    kind: str = "lognormal"  # lognormal|normal|bernoulli|exponential|gamma|none
    # Parameters as used in appendix C.3, figures 13/14: mean/var of eps.
    mean: float = 0.5
    var: float = 0.25
    # Paper's B.1 parameterization (overrides mean/var when kind=paper_lognormal)
    ln_mu: float = 4.0
    ln_sigma: float = 1.0
    alpha: float = 2.0 * math.exp(4.5)
    beta: float = 5.5

    def sample(self, rng: np.random.Generator, shape) -> np.ndarray:
        k = self.kind
        if k == "none":
            return np.zeros(shape)
        if k == "paper_lognormal":
            z = rng.lognormal(self.ln_mu, self.ln_sigma, size=shape)
            return np.minimum(z / self.alpha, self.beta)
        if k == "lognormal":
            # Solve LN(mu, sig) with given mean/var:
            #   mean = exp(mu + sig^2/2); var = (exp(sig^2)-1) exp(2mu+sig^2)
            sig2 = math.log(1.0 + self.var / self.mean**2)
            mu = math.log(self.mean) - sig2 / 2.0
            return rng.lognormal(mu, math.sqrt(sig2), size=shape)
        if k == "normal":
            return np.maximum(
                rng.normal(self.mean, math.sqrt(self.var), size=shape), 0.0
            )
        if k == "bernoulli":
            # eps = c * Br(p); mean = c p, var = c^2 p (1-p)
            # With p=0.5: c = 2*mean, var = mean^2 -> matches table (0.45 Br(.5)).
            p = 1.0 / (1.0 + self.var / self.mean**2)
            c = self.mean / p
            return c * (rng.random(size=shape) < p)
        if k == "exponential":
            return rng.exponential(self.mean, size=shape)
        if k == "gamma":
            # alpha = mean^2/var, beta(rate) = mean/var
            a = self.mean**2 / self.var
            scale = self.var / self.mean
            return rng.gamma(a, scale, size=shape)
        raise ValueError(f"unknown noise kind: {k}")


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Per-micro-batch latency ``t = base * (1 + eps)`` (seconds)."""

    base: float = 0.45  # figure 13/14 use 0.45 s per accumulation
    noise: NoiseModel = dataclasses.field(default_factory=NoiseModel)
    # Optional per-worker speed skew (heterogeneous clusters): worker n runs
    # at base * (1 + skew * n / N).
    worker_skew: float = 0.0
    # Straggler injection: with prob p a worker's whole step gains `delay` s.
    straggler_prob: float = 0.0
    straggler_delay: float = 1.0

    def sample(
        self, rng: np.random.Generator, iters: int, workers: int, m: int
    ) -> np.ndarray:
        eps = self.noise.sample(rng, (iters, workers, m))
        base = np.full((1, workers, 1), self.base)
        if self.worker_skew:
            base = base * (
                1.0 + self.worker_skew * np.arange(workers)[None, :, None] / workers
            )
        t = base * (1.0 + eps)
        if self.straggler_prob > 0:
            hit = rng.random((iters, workers, 1)) < self.straggler_prob
            t = t + hit * (self.straggler_delay / m)
        return t

    def sample_at(
        self, step: int, workers: int, m: int, seed: Optional[int] = 0
    ) -> np.ndarray:
        """One step's (N, M) draw keyed by ``(seed, step)`` — the same
        distribution as ``sample`` but deterministic per step regardless of
        call order, so a checkpointed run resumes onto the identical
        latency stream.  Fault scenarios (``train.resilience.faults``)
        override this with their perturbation stack."""
        rng = np.random.default_rng([0 if seed is None else seed, step])
        return self.sample(rng, 1, workers, m)[0]

    @property
    def mean(self) -> float:
        return self.base * (1.0 + self.noise_mean)

    @property
    def noise_mean(self) -> float:
        n = self.noise
        if n.kind == "none":
            return 0.0
        if n.kind == "paper_lognormal":
            # E[min(Z/a, b)] estimated numerically once (stable, cached).
            rng = np.random.default_rng(0)
            return float(np.mean(n.sample(rng, 200_000)))
        return n.mean

    @property
    def std(self) -> float:
        n = self.noise
        if n.kind == "none":
            return 0.0
        if n.kind == "paper_lognormal":
            rng = np.random.default_rng(0)
            return float(self.base * np.std(n.sample(rng, 200_000)))
        return self.base * math.sqrt(n.var)


PAPER_DELAY = LatencyModel(base=0.45, noise=NoiseModel(kind="paper_lognormal"))

# ---------------------------------------------------------------------------
# Cluster simulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    """Outcome of simulating synchronous training with/without DropCompute."""

    t: np.ndarray  # (I, N, M) micro-batch latencies
    T_n: np.ndarray  # (I, N) per-worker step compute time
    T: np.ndarray  # (I,) iteration compute time = max_n T_n
    tc: float  # serial/communication latency per iteration

    @property
    def mean_iter_time(self) -> float:
        return float(np.mean(self.T) + self.tc)

    @property
    def mean_worker_time(self) -> float:
        return float(np.mean(self.T_n) + self.tc)

    def with_threshold(self, tau: float, min_microbatches: int = 1):
        """Apply DropCompute with threshold ``tau`` (on compute time only).

        Mirrors ``dropcompute.drop_mask`` exactly: micro-batch ``m`` is kept
        iff its cumulative time is below ``tau`` OR ``m < min_microbatches``
        (a worker never drops its first ``min_microbatches`` accumulations,
        so tiny thresholds report >= min_microbatches/M completion, not 0).
        The iteration time is floored accordingly: when the guaranteed
        micro-batches overrun ``tau``, the step takes as long as the slowest
        worker needs to compute them.

        Returns (iteration_time (I,), completed micro-batch fraction (I,)).
        """
        cum = np.cumsum(self.t, axis=-1)  # (I, N, M)
        done = cum < tau
        if min_microbatches > 0:
            done |= np.arange(self.t.shape[-1]) < min_microbatches
        counts = done.sum(axis=-1)  # (I, N) kept micro-batches
        m_tilde = counts.mean(axis=-1)  # (I,) avg over workers
        # worker time = cum at its last kept micro-batch (prefix mask)
        w_time = np.take_along_axis(
            cum, np.maximum(counts - 1, 0)[..., None], axis=-1
        )[..., 0]
        forced = np.where(counts > 0, w_time, 0.0).max(axis=-1)  # (I,)
        t_iter = np.maximum(np.minimum(self.T, tau), forced) + self.tc
        return t_iter, m_tilde / self.t.shape[-1]

    def effective_speedup(self, tau: float, min_microbatches: int = 1) -> float:
        """Empirical S_eff(tau), eq. (6), averaged per-iteration (Alg. 2)."""
        t_iter, frac = self.with_threshold(tau, min_microbatches)
        s_i = (self.T + self.tc) / t_iter * frac
        return float(np.mean(s_i))


def simulate(
    model: LatencyModel,
    iters: int,
    workers: int,
    m: int,
    tc: float = 0.5,
    seed: int = 0,
) -> SimResult:
    rng = np.random.default_rng(seed)
    t = model.sample(rng, iters, workers, m)
    t_n = t.sum(axis=-1)
    return SimResult(t=t, T_n=t_n, T=t_n.max(axis=-1), tc=tc)


def scale_curve(
    model: LatencyModel,
    worker_counts,
    m: int,
    tc: float = 0.5,
    iters: int = 200,
    tau: Optional[float] = None,
    seed: int = 0,
):
    """Throughput-per-worker scale graph (figure 1).

    Returns dict: N -> (throughput in micro-batches/s, scaling efficiency
    vs. single worker).
    """
    out = {}
    single = simulate(model, iters, 1, m, tc, seed)
    t1 = single.mean_iter_time
    for n in worker_counts:
        sim = simulate(model, iters, n, m, tc, seed + n)
        if tau is None:
            t_iter = sim.mean_iter_time
            mbs = n * m / t_iter
        else:
            t_it, frac = sim.with_threshold(tau)
            mbs = float(np.mean(n * m * frac / t_it))
        out[n] = (mbs, mbs / (n * m / t1))
    return out
