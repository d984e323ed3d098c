"""DropCompute core in PyTorch (port of ``repro.core``): the paper's
contribution (Algorithm 1, drop masks, engines) plus the numpy carry-overs
(latency simulation, closed-form theory, Algorithm 2)."""
from .dropcompute import (
    DropConfig,
    accumulate_grads,
    completed_fraction,
    drop_mask,
    example_weights,
    weighted_loss,
)
from .engine import HostTimedEngine, InGraphEngine, make_grad_fn, simulated_latencies
from .simulate import PAPER_DELAY, LatencyModel, NoiseModel, SimResult, scale_curve, simulate
from .theory import (
    effective_speedup,
    expected_completed_microbatches,
    expected_max_normal,
    expected_step_time,
    norm_cdf,
    norm_ppf,
    optimal_tau,
    speedup_vs_workers,
)
from .threshold import ThresholdResult, gather_latency_profile, select_threshold

__all__ = [
    "DropConfig",
    "accumulate_grads",
    "completed_fraction",
    "drop_mask",
    "example_weights",
    "weighted_loss",
    "HostTimedEngine",
    "InGraphEngine",
    "make_grad_fn",
    "simulated_latencies",
    "PAPER_DELAY",
    "LatencyModel",
    "NoiseModel",
    "SimResult",
    "scale_curve",
    "simulate",
    "effective_speedup",
    "expected_completed_microbatches",
    "expected_max_normal",
    "expected_step_time",
    "norm_cdf",
    "norm_ppf",
    "optimal_tau",
    "speedup_vs_workers",
    "ThresholdResult",
    "gather_latency_profile",
    "select_threshold",
]
