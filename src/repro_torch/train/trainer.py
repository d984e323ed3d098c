"""Training loop with DropCompute as a first-class feature (port of the
single-device path of ``repro.train.trainer``, ``trainer.py:134-359``).

The trainer virtualizes N data-parallel workers on one device: each step
draws an (N, M) micro-batch latency tensor from a ``LatencyModel`` (or a
``resilience.faults`` scenario wrapping one), derives the Algorithm-1
drop mask, and accumulates the kept micro-batches' gradients.  Simulated
iteration time

    T_iter = max_n min(T_n, tau) + T_c

is tracked per step, so loss-vs-wallclock curves come out of any run.
Threshold selection is static (``auto_threshold``: one-shot Algorithm 2
after ``calibration_steps``) or online (``online_tau``: a
``resilience.TauController`` re-estimates tau* from rolling telemetry).
Nothing here compiles, so the controller's recompile cost is 0.

A step: the f32 master parameters are cast once into a compute copy
(``models.train_params``), ``core.accumulate_grads`` runs each kept
micro-batch's forward and backward and adds its gradients into an f32
accumulator (the masked-accumulate kernel), the compute copy is freed,
then the gradients are clipped and the optimizer updates the master
parameters in place (``Optimizer.step``).  The latency draws, masks and
simulated times are the reference's numpy, so drop fractions, tau
trajectories and ``sim_times`` equal the reference's exactly.

Left out until ported (each raises a typed error): the SPMD path
(``mesh=``) and checkpoints (``ckpt_dir=``, ``resume_from=``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, synchronize
from ..core.dropcompute import DropConfig, accumulate_grads, drop_mask, elapsed_s
from ..core.engine import make_grad_fn
from ..core.simulate import LatencyModel
from ..core.threshold import select_threshold
from ..data.synthetic import DataConfig, microbatches_at
from ..models.config import ModelConfig
from ..models.model import init_params, loss_fn, require_trainable, train_params
from ..models.transformer import tree_map
from ..optim import clip_by_global_norm, make as make_opt
from .resilience import ComputeTelemetry, ControllerConfig, TauController

Tree = Any


class UnsupportedDistError(NotImplementedError):
    """``mesh=`` asks for the SPMD path, which the port has not ported."""


class UnsupportedCheckpointError(NotImplementedError):
    """``ckpt_dir=`` / ``resume_from=``: checkpoints are not ported yet."""


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    n_workers: int = 8  # virtual data-parallel workers
    microbatches: int = 4  # M (gradient accumulations per worker)
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    seed: int = 0
    # DropCompute
    drop: DropConfig = dataclasses.field(default_factory=lambda: DropConfig(enabled=False))
    latency: LatencyModel = dataclasses.field(default_factory=LatencyModel)
    tc: float = 0.5  # serial/communication seconds per iteration
    calibration_steps: int = 20  # Algorithm 2 profiling window
    auto_threshold: bool = False  # static: one-shot tau* after calibration
    online_tau: bool = False
    controller: Optional[ControllerConfig] = None
    telemetry_window: int = 64
    inject_real_delays: bool = False
    mesh: Optional[Any] = None  # not ported: raises UnsupportedDistError
    # bookkeeping
    log_every: int = 10
    ckpt_dir: Optional[str] = None  # not ported: raises UnsupportedCheckpointError
    ckpt_every: int = 0
    resume_from: Optional[str] = None  # not ported: raises UnsupportedCheckpointError


@dataclasses.dataclass
class TrainResult:
    params: Tree
    losses: List[float]
    sim_times: List[float]  # simulated seconds per iteration
    drop_fractions: List[float]  # per-step drop rate (1 - completed fraction)
    tau: float  # final threshold
    metrics: Dict[str, Any]
    tau_trajectory: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    telemetry: Optional[Dict[str, Any]] = None  # ComputeTelemetry.summary()

    @property
    def cum_time(self) -> np.ndarray:
        return np.cumsum(self.sim_times)

    @property
    def drop_rates(self) -> List[float]:
        return self.drop_fractions

    def tau_series(self, start_step: int = 0) -> np.ndarray:
        """Per-step tau in effect, aligned with ``losses`` (len(losses),)."""
        n = len(self.losses)
        out = np.full(n, np.inf)
        traj = self.tau_trajectory or [(start_step, self.tau)]
        for step, tau in traj:
            i = max(int(step) - start_step, 0)
            if i < n:
                out[i:] = tau
        return out


def _make_opt(tcfg: TrainConfig):
    # sgd: no decay, as the reference's _make_step
    if tcfg.optimizer == "sgd":
        return make_opt("sgd", tcfg.lr)
    return make_opt(tcfg.optimizer, tcfg.lr, weight_decay=tcfg.weight_decay)


def _latencies_at(tcfg: TrainConfig, step: int, n: int, m: int) -> np.ndarray:
    """The step's (N, M) latency draw, keyed by (seed, step)."""
    return np.asarray(tcfg.latency.sample_at(step, n, m, seed=tcfg.seed + 1))


def train(
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    tcfg: TrainConfig,
    params: Optional[Tree] = None,
    eval_fn: Optional[Callable[[Tree], float]] = None,
    device=None,
) -> TrainResult:
    """Train on one device (CUDA unless ``device`` names another).
    ``params`` (the f32 master tree) are moved there and updated in place
    (the reference returns new arrays); without them they are drawn from
    ``tcfg.seed``.  Returns the trained parameters with the per-step
    losses, simulated times, drop fractions and tau trajectory;
    ``metrics`` adds each step's wall seconds (``step_s``) and each kept
    micro-batch's seconds on the device's timeline (``microbatch_s``).
    A config the training kernels are not built for raises before any
    work (``models.model.require_trainable``)."""
    if tcfg.mesh is not None:
        raise UnsupportedDistError("the SPMD path (mesh=) is not ported yet; see ROADMAP.md")
    if tcfg.ckpt_dir or tcfg.resume_from:
        raise UnsupportedCheckpointError(
            "checkpoints (ckpt_dir=, resume_from=) are not ported yet; see ROADMAP.md")
    n, m = tcfg.n_workers, tcfg.microbatches
    total_m = n * m
    if data_cfg.batch_size % total_m:
        raise ValueError(f"global batch {data_cfg.batch_size} must divide into {n} workers "
                         f"x {m} microbatches")
    dev = resolve_device(device)
    require_trainable(model_cfg, data_cfg.seq_len, dev)
    if params is None:
        params = init_params(model_cfg, seed=tcfg.seed, device=dev)
    else:
        params = tree_map(lambda p: p.to(dev), params)

    opt = _make_opt(tcfg)
    opt_state = opt.init(params)
    grad_fn = make_grad_fn(lambda p, mb: loss_fn(p, model_cfg, mb))

    tau = tcfg.drop.tau
    profile: List[np.ndarray] = []
    telemetry = ComputeTelemetry(n, m, window=tcfg.telemetry_window)
    controller: Optional[TauController] = None
    if tcfg.online_tau and tcfg.drop.enabled:
        ccfg = tcfg.controller or ControllerConfig(min_microbatches=tcfg.drop.min_microbatches)
        controller = TauController(ccfg, tcfg.tc, tau=tau, total_steps=tcfg.steps,
                                   default_recompile_cost_s=0.0)
    trajectory: List[Tuple[int, float]] = [(0, tau)]

    losses, sim_times, drops, step_s, microbatch_s = [], [], [], [], []
    for step in range(tcfg.steps):
        mbs = microbatches_at(step, data_cfg, total_m)
        mbs = {"tokens": torch.from_numpy(mbs["tokens"]).to(dev, torch.long),
               "weights": torch.from_numpy(mbs["weights"]).to(dev)}

        # latency draws for the N virtual workers (Algorithm 1 input)
        t = _latencies_at(tcfg, step, n, m)
        profile.append(t)

        # static: one-shot Algorithm 2 after the calibration window
        if (tcfg.auto_threshold and not tcfg.online_tau and tcfg.drop.enabled
                and not np.isfinite(tau) and step == tcfg.calibration_steps):
            tau = select_threshold(np.stack(profile), tcfg.tc).tau
            trajectory.append((step, tau))
        # online: the controller re-estimates tau* from the rolling window
        if controller is not None:
            decision = controller.maybe_update(step, telemetry, steps_remaining=tcfg.steps - step)
            if decision.applied:
                tau = decision.tau
                trajectory.append((step, tau))

        # drop mask (per worker), flattened onto the micro-batch axis
        if tcfg.drop.enabled and np.isfinite(tau):
            mask_nm = drop_mask(t, tau, tcfg.drop.min_microbatches).numpy()
        else:
            mask_nm = np.ones((n, m), np.float32)

        if tcfg.inject_real_delays and hasattr(tcfg.latency, "host_delay_at"):
            worst = max(tcfg.latency.host_delay_at(step, r, n, m, seed=tcfg.seed + 1)
                        for r in range(n))
            if worst > 0:
                time.sleep(worst)

        synchronize(dev)
        h0 = time.monotonic()
        compute = train_params(params, model_cfg)
        grads, loss, stats = accumulate_grads(grad_fn, compute, mbs, mask_nm.reshape(total_m),
                                              tcfg.drop)
        del compute
        if tcfg.clip_norm > 0:
            grads = clip_by_global_norm(grads, tcfg.clip_norm)
        opt_state = opt.step(grads, opt_state, params)
        del grads
        loss = float(loss)  # syncs the device
        host_step_s = time.monotonic() - h0

        # simulated iteration time (eq. in §4.3)
        t_workers = (t * mask_nm).sum(axis=-1)
        t_iter = (float(t_workers.max() + tcfg.tc) if tcfg.drop.enabled and np.isfinite(tau)
                  else float(t.sum(axis=-1).max() + tcfg.tc))
        drop_frac = 1.0 - float(stats["completed_fraction"])
        losses.append(loss)
        sim_times.append(t_iter)
        drops.append(drop_frac)
        step_s.append(host_step_s)
        microbatch_s.append(elapsed_s(stats["microbatch_marks"]))
        telemetry.record(step, t, host_step_s=host_step_s, tau=tau, drop_fraction=drop_frac)

    final_trajectory = list(controller.trajectory) if controller else trajectory
    metrics: Dict[str, Any] = {
        "final_loss": losses[-1] if losses else float("nan"),
        "mean_drop": float(np.mean(drops)) if drops else 0.0,
        "total_sim_time": float(np.sum(sim_times)),
        "tau_changes": max(len(final_trajectory) - 1, 0),
        "bundle_rebuilds": 0,
        "step_s": step_s,
        "microbatch_s": microbatch_s,
    }
    if eval_fn is not None:
        metrics["eval"] = float(eval_fn(params))
    return TrainResult(params, losses, sim_times, drops, float(tau), metrics,
                       tau_trajectory=final_trajectory, telemetry=telemetry.summary())
