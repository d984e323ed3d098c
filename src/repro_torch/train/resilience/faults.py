"""Seeded straggler/fault injection for compute-time variance studies.

Carried over from ``repro.train.resilience.faults`` unchanged (numpy only: the port keeps its own
copy); ``tests/test_torch_core.py`` pins it to exact equality.

Perturbs the per-worker (N, M) micro-batch latency tensor a trainer step
draws from its ``LatencyModel`` with the heavy-tail regimes that motivate
DropCompute (and OptiReduce's tail analysis): log-normal and Pareto
per-micro-batch tails, a persistent slow rank ("bad node"), transient
whole-step stalls, and base-rate ramps (non-stationary clusters — the
regime where a one-shot-calibrated tau goes stale).

Everything is deterministic in ``(seed, step)``: fault randomness is keyed
by ``default_rng([seed, step, fault_index])``, never by call order, so a
resumed run replays exactly the same perturbations and two policies under
the same scenario see identical latency tensors.

``FaultyLatencyModel`` is drop-in wherever a ``LatencyModel`` is accepted
(``sample`` has the same signature); the trainer prefers ``sample_at`` so
per-step determinism survives checkpoint/restore.  For *real* SPMD runs,
``host_delay_at`` returns the injected extra seconds for one rank so a
launcher can ``time.sleep`` them around its jitted step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ...core.simulate import LatencyModel, NoiseModel


class Fault:
    """Base class: a deterministic perturbation of one step's latencies."""

    def perturb(self, t: np.ndarray, step: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ParetoTail(Fault):
    """Pareto(alpha) multiplicative tail on random micro-batches.

    With probability ``prob`` per (worker, micro-batch), the latency gains
    ``scale * X`` seconds, ``X ~ Pareto(alpha)`` — alpha <= 2 gives the
    infinite-variance tails where the max over workers diverges fastest.
    """

    alpha: float = 1.8
    scale: float = 0.3
    prob: float = 0.15

    def perturb(self, t, step, rng):
        hit = rng.random(t.shape) < self.prob
        tail = self.scale * rng.pareto(self.alpha, size=t.shape)
        return t + hit * tail


@dataclasses.dataclass(frozen=True)
class LogNormalTail(Fault):
    """Additive log-normal tail (the paper's B.1 shape, heavier knobs)."""

    mu: float = -1.0
    sigma: float = 1.2
    prob: float = 0.2

    def perturb(self, t, step, rng):
        hit = rng.random(t.shape) < self.prob
        return t + hit * rng.lognormal(self.mu, self.sigma, size=t.shape)


@dataclasses.dataclass(frozen=True)
class BadNode(Fault):
    """A persistent slow rank: worker ``rank`` runs ``factor`` x slower
    for steps in ``[start, end)`` (``end=None`` = forever).  ``rank=-1``
    picks a worker deterministically from the scenario seed."""

    rank: int = -1
    factor: float = 2.0
    start: int = 0
    end: Optional[int] = None

    def perturb(self, t, step, rng):
        if step < self.start or (self.end is not None and step >= self.end):
            return t
        n = t.shape[0]
        # seeded, step-independent choice: key the pick by start, not step
        rank = self.rank if self.rank >= 0 else int(
            np.random.default_rng([17, self.start]).integers(0, n)
        )
        out = t.copy()
        out[rank % n] = out[rank % n] * self.factor
        return out


@dataclasses.dataclass(frozen=True)
class TransientStall(Fault):
    """With probability ``prob`` per step, one random worker stalls for
    ``stall_s`` seconds before its first micro-batch (GC pause, network
    hiccup, preemption)."""

    prob: float = 0.05
    stall_s: float = 3.0

    def perturb(self, t, step, rng):
        if rng.random() >= self.prob:
            return t
        out = t.copy()
        w = int(rng.integers(0, t.shape[0]))
        out[w, 0] = out[w, 0] + self.stall_s
        return out


@dataclasses.dataclass(frozen=True)
class RampSlowdown(Fault):
    """All workers slow by ``factor`` from step ``start`` on — the
    non-stationary base shift that makes a statically calibrated tau
    stale (too low for the new regime)."""

    start: int = 0
    factor: float = 1.5

    def perturb(self, t, step, rng):
        return t * self.factor if step >= self.start else t


@dataclasses.dataclass(frozen=True)
class FaultyLatencyModel:
    """A ``LatencyModel`` composed with a fault stack.

    ``sample_at(step, N, M)`` is the trainer's entry point: base draw and
    every fault keyed by ``(seed, step)``.  ``sample(rng, I, N, M)`` keeps
    the plain ``LatencyModel`` signature for ``core.simulate.simulate``
    and friends (iterations are treated as steps ``0..I-1``).
    """

    base: LatencyModel = dataclasses.field(default_factory=LatencyModel)
    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    def sample_at(
        self, step: int, workers: int, m: int, seed: Optional[int] = None
    ) -> np.ndarray:
        """(N, M) draw keyed by ``(seed, step)``; ``seed=None`` uses the
        scenario's own seed (the trainer passes its run seed so two
        policies under one scenario replay identical latencies)."""
        key = self.seed if seed is None else int(seed)
        rng = np.random.default_rng([key, step])
        t = self.base.sample(rng, 1, workers, m)[0]
        return self._perturb(t, step, key)

    def sample(
        self, rng: np.random.Generator, iters: int, workers: int, m: int
    ) -> np.ndarray:
        t = self.base.sample(rng, iters, workers, m)
        return np.stack([self._perturb(t[i], i, self.seed) for i in range(iters)])

    def _perturb(self, t: np.ndarray, step: int, key: int) -> np.ndarray:
        for i, f in enumerate(self.faults):
            t = f.perturb(t, step, np.random.default_rng([key, step, i]))
        return t

    def host_delay_at(
        self, step: int, rank: int, workers: int, m: int, seed: Optional[int] = None
    ) -> float:
        """Injected extra seconds for ``rank`` at ``step`` (perturbed minus
        base step time) — what a real SPMD launcher sleeps to turn the
        scenario into physical compute variance."""
        key = self.seed if seed is None else int(seed)
        rng = np.random.default_rng([key, step])
        base = self.base.sample(rng, 1, workers, m)[0]
        delta = self._perturb(base.copy(), step, key) - base
        return float(np.clip(delta[rank % workers].sum(), 0.0, None))

    # LatencyModel-compatible summary stats (used by theory plug-ins)
    @property
    def mean(self) -> float:
        return self.base.mean

    @property
    def std(self) -> float:
        return self.base.std


# ---------------------------------------------------------------------------
# Scenario registry (shared by launch/train.py, benchmarks, examples)
# ---------------------------------------------------------------------------

_MILD = LatencyModel(base=0.45, noise=NoiseModel(kind="normal", mean=0.1, var=0.002))
_PAPER = LatencyModel(base=0.45, noise=NoiseModel(kind="paper_lognormal"))

SCENARIOS: Dict[str, Tuple[Fault, ...]] = {
    # no tail: the controller must be a no-op here (parity scenario)
    "none": (),
    # heavy Pareto tail plus a steep mid-run base ramp: after the ramp the
    # whole latency scale (tails included) moves up 2.5x, so a tau
    # calibrated once pre-ramp sits far below the new tau* and its
    # completion collapses — the acceptance scenario where online tau must
    # beat both tau=inf and the one-shot static calibration
    "pareto": (ParetoTail(alpha=1.8, scale=0.6, prob=0.25), RampSlowdown(start=40, factor=2.5)),
    # pure heavy log-normal tail, stationary
    "lognormal": (LogNormalTail(mu=-0.5, sigma=1.2, prob=0.25),),
    # one rank goes bad mid-run
    "badnode": (BadNode(rank=2, factor=2.5, start=30),),
    # rare long whole-step stalls
    "stall": (TransientStall(prob=0.1, stall_s=4.0),),
}


def make_scenario(
    name: str,
    base: Optional[LatencyModel] = None,
    seed: int = 0,
    onset: Optional[int] = None,
) -> FaultyLatencyModel:
    """Build the named fault scenario over ``base`` (default: a mild
    low-variance cluster, so the *faults* are the tail).  ``onset``
    overrides the step at which mid-run faults (ramp/badnode) kick in."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; pick from {sorted(SCENARIOS)}")
    faults = SCENARIOS[name]
    if onset is not None:
        moved = []
        for f in faults:
            if isinstance(f, (RampSlowdown, BadNode)):
                f = dataclasses.replace(f, start=onset)
            moved.append(f)
        faults = tuple(moved)
    if base is None:
        base = _PAPER if name == "lognormal" else _MILD
    return FaultyLatencyModel(base=base, faults=faults, seed=seed)
