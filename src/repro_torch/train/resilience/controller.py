"""Online Algorithm-2 tau controller.

Carried over from ``repro.train.resilience.controller`` unchanged (numpy only: the port keeps its own
copy); ``tests/test_torch_core.py`` pins it to exact equality.

``trainer.py``'s original threshold selection ran once, on a fixed
calibration window, and never revisited tau.  ``TauController`` re-runs
the Algorithm-2 grid search on the telemetry ring-buffer window every
``check_every`` steps, so tau tracks the cluster: a rank that goes bad, a
base-rate ramp, or a tail that appears mid-run all move tau* — and a run
with *no* tail keeps tau = inf (the controller is a no-op by
construction, which the parity tests pin).

Changing tau is not free on the SPMD path: the drop mask is traced with
tau baked in, so every change costs a ``build_bundle(tau)`` recompile.
Three gates stand between a candidate tau* and an applied one:

* **gain gate** — the candidate's effective speedup over the window must
  beat holding the current tau by ``min_gain`` (this is what makes the
  no-tail case a structural no-op: with zero variance S_eff(tau) <= ~1
  everywhere, no candidate clears the bar);
* **hysteresis** — relative tau moves under ``hysteresis`` are noise,
  hold;
* **recompile amortization** — the predicted per-step time saving (via
  ``core.theory``'s effective-speedup model, empirical E[T] plugged in)
  times the steps remaining must exceed ``recompile_cost_s``.

Drop-rate guardrails ride on ``select_threshold``: candidates are
restricted to completion >= 1 - ``max_drop`` and the traced mask keeps
honoring ``min_microbatches``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...core import theory
from ...core.threshold import select_threshold
from .telemetry import ComputeTelemetry


def effective_speedup_at(
    window: np.ndarray, tc: float, tau: float, min_microbatches: int = 1
) -> Tuple[float, float]:
    """Empirical (S_eff, completion) of holding ``tau`` over a (W, N, M)
    latency window — the same arithmetic as ``SimResult.effective_speedup``
    without materializing a SimResult."""
    t = np.asarray(window, dtype=np.float64)
    t_n = t.sum(axis=-1)  # (W, N)
    t_i = t_n.max(axis=-1)  # (W,)
    if not np.isfinite(tau):
        return 1.0, 1.0
    cum = np.cumsum(t, axis=-1)
    done = cum < tau
    if min_microbatches > 0:
        done |= np.arange(t.shape[-1]) < min_microbatches
    counts = done.sum(axis=-1)  # (W, N)
    frac = counts.mean(axis=-1) / t.shape[-1]  # (W,)
    w_time = np.take_along_axis(cum, np.maximum(counts - 1, 0)[..., None], axis=-1)[..., 0]
    forced = np.where(counts > 0, w_time, 0.0).max(axis=-1)  # (W,)
    t_iter = np.maximum(np.minimum(t_i, tau), forced) + tc
    s = (t_i + tc) / t_iter * frac
    return float(s.mean()), float(frac.mean())


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs for the online tau controller."""

    warmup_steps: int = 16  # min telemetry window fill before deciding
    check_every: int = 8  # steps between decisions
    hysteresis: float = 0.05  # hold when |tau_new - tau| / tau < this
    min_gain: float = 0.02  # hold when S_eff gain over current < this
    # cost one tau change must amortize; None = auto (the trainer plugs in
    # its measured bundle-build time on the SPMD path, 0 on the
    # single-device path where the mask is a step *input* and tau is free)
    recompile_cost_s: Optional[float] = None
    max_drop: float = 0.5  # guardrail: completion >= 1 - max_drop
    min_microbatches: int = 1
    grid_size: int = 128


@dataclasses.dataclass
class Decision:
    """Outcome of one controller evaluation (applied or gated)."""

    step: int
    tau: float  # candidate tau* from the window (current tau when no candidate)
    applied: bool
    reason: str  # applied | warmup | cadence | no_gain | hysteresis | not_amortized
    speedup: float = 1.0  # predicted S_eff at the candidate
    current_speedup: float = 1.0  # S_eff of holding the current tau
    gain_per_step_s: float = 0.0  # predicted effective seconds saved/step
    predicted_completion: float = 1.0


class TauController:
    """Re-estimates tau* online from a ``ComputeTelemetry`` window."""

    def __init__(
        self,
        cfg: ControllerConfig,
        tc: float,
        tau: float = float("inf"),
        total_steps: Optional[int] = None,
        default_recompile_cost_s: float = 0.0,
    ):
        self.cfg = cfg
        self.tc = float(tc)
        self.tau = float(tau)
        self.total_steps = total_steps
        self.recompile_cost_s = (
            cfg.recompile_cost_s
            if cfg.recompile_cost_s is not None
            else float(default_recompile_cost_s)
        )
        self.trajectory: List[Tuple[int, float]] = [(0, self.tau)]
        self.decisions: List[Decision] = []
        self.rebuilds = 0
        self._last_check = -1

    # -- the decision -------------------------------------------------------

    def maybe_update(
        self,
        step: int,
        telemetry: ComputeTelemetry,
        steps_remaining: Optional[int] = None,
    ) -> Decision:
        """Evaluate the window at ``step``; apply tau* if every gate passes.

        Returns the full Decision either way (``applied`` tells the caller
        whether to rebuild its step bundle).
        """
        d = self._evaluate(step, telemetry, steps_remaining)
        self.decisions.append(d)
        if d.applied:
            self.tau = d.tau
            self.trajectory.append((step, d.tau))
            self.rebuilds += 1
        return d

    def _evaluate(
        self, step: int, telemetry: ComputeTelemetry, steps_remaining: Optional[int]
    ) -> Decision:
        cfg = self.cfg
        if telemetry.window_size < max(cfg.warmup_steps, 2):
            return Decision(step, self.tau, False, "warmup")
        if self._last_check >= 0 and step - self._last_check < cfg.check_every:
            return Decision(step, self.tau, False, "cadence")
        self._last_check = step

        window = telemetry.window()  # (W, N, M)
        res = select_threshold(
            window,
            self.tc,
            grid_size=cfg.grid_size,
            min_microbatches=cfg.min_microbatches,
            max_drop=cfg.max_drop,
        )
        cand, s_cand = res.tau, res.speedup
        comp = float(res.completion[int(np.argmin(np.abs(res.grid - cand)))])
        s_cur, _ = effective_speedup_at(window, self.tc, self.tau, cfg.min_microbatches)

        if s_cand < s_cur + cfg.min_gain:
            # includes the no-tail case: zero variance => S_eff ~ 1
            # everywhere, no candidate clears the bar, tau stays put
            return Decision(step, cand, False, "no_gain", s_cand, s_cur, 0.0, comp)
        if np.isfinite(self.tau) and abs(cand - self.tau) / self.tau < cfg.hysteresis:
            return Decision(step, cand, False, "hysteresis", s_cand, s_cur, 0.0, comp)

        gain = self._predicted_gain_s(window, s_cand, s_cur)
        remaining = steps_remaining
        if remaining is None:
            remaining = (self.total_steps - step) if self.total_steps else 1
        if gain * max(remaining, 0) <= self.recompile_cost_s:
            return Decision(step, cand, False, "not_amortized", s_cand, s_cur, gain, comp)
        return Decision(step, cand, True, "applied", s_cand, s_cur, gain, comp)

    def _predicted_gain_s(self, window: np.ndarray, s_cand: float, s_cur: float) -> float:
        """Predicted *effective* seconds saved per step by moving to the
        candidate, via the theory effective-speedup model (eq. 11):

            S_eff(tau) = (E[T] + tc) / t_eff(tau)   =>
            t_eff(tau) = (E[T] + tc) / S_eff(tau)

        with the empirical E[T] and window S_eff estimates plugged in —
        the pure-Gaussian E[M~] of ``theory.expected_completed_microbatches``
        under-counts completion on heavy (Pareto) tails (the fig. 3b
        caveat), which would wedge the controller at a stale tau, so the
        model is evaluated at the measured quantities instead."""
        t = np.asarray(window, dtype=np.float64)
        e_t = float(t.sum(axis=-1).max(axis=-1).mean())
        return (e_t + self.tc) * (1.0 / max(s_cur, 1e-9) - 1.0 / max(s_cand, 1e-9))

    # -- persistence --------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "tau": self.tau if np.isfinite(self.tau) else None,
            "tc": self.tc,
            "trajectory": [
                [int(s), (t if np.isfinite(t) else None)] for s, t in self.trajectory
            ],
            "rebuilds": self.rebuilds,
            "last_check": self._last_check,
            "cfg": dataclasses.asdict(self.cfg),
        }

    def load_state_dict(self, s: Dict[str, Any]) -> None:
        self.tau = float("inf") if s["tau"] is None else float(s["tau"])
        self.tc = float(s.get("tc", self.tc))
        self.trajectory = [
            (int(st), float("inf") if t is None else float(t))
            for st, t in s.get("trajectory", [[0, None]])
        ]
        self.rebuilds = int(s.get("rebuilds", 0))
        self._last_check = int(s.get("last_check", -1))
