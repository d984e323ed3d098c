"""``repro_torch.train.resilience`` — tail-tolerant training as a subsystem
(carried over from ``repro.train.resilience`` unchanged, numpy only).

Three pillars, wired through ``repro_torch.train.trainer``:

* :mod:`telemetry` — per-worker, per-step compute-time collection in
  bounded ring buffers with streaming mean/std/percentile estimators;
  the rolling window feeds Algorithm 2 online.
* :mod:`controller` — the online tau controller: re-estimates tau* from
  the telemetry window during the run, with hysteresis, a
  recompile-cost amortization gate (tau is baked into the traced SPMD
  drop mask, so changing it costs a rebuild) and drop-rate guardrails.
* :mod:`faults` — seeded straggler/fault injection (log-normal and
  Pareto tails, persistent slow ranks, transient stalls, base-rate
  ramps), composable with ``core.simulate.LatencyModel`` and usable as
  real injected delays in SPMD runs.
"""
from .controller import ControllerConfig, Decision, TauController, effective_speedup_at
from .faults import (
    SCENARIOS,
    BadNode,
    FaultyLatencyModel,
    LogNormalTail,
    ParetoTail,
    RampSlowdown,
    TransientStall,
    make_scenario,
)
from .telemetry import (
    ComputeTelemetry,
    P2Quantile,
    RingBuffer,
    StepRecord,
    StreamingMoments,
)

__all__ = [
    "ControllerConfig",
    "Decision",
    "TauController",
    "effective_speedup_at",
    "SCENARIOS",
    "BadNode",
    "FaultyLatencyModel",
    "LogNormalTail",
    "ParetoTail",
    "RampSlowdown",
    "TransientStall",
    "make_scenario",
    "ComputeTelemetry",
    "P2Quantile",
    "RingBuffer",
    "StepRecord",
    "StreamingMoments",
]
