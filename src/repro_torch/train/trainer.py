"""Training loop with DropCompute as a first-class feature (port of
``repro.train.trainer``, ``trainer.py:134-359``).

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
A tau change needs no new capture (the keep mask never enters a graph),
so the controller's recompile cost is 0.

A step (``launch.steps.TrainStep``): the master parameters are cast
into a compute copy (``models.train_params``, one buffer refilled in
place each step; bf16 masters, the MoE models', are their own copy), each
kept micro-batch's forward and backward adds its gradients into an
accumulator in the masters' dtype, as the reference's ``accumulate_grads``
sums (``core.dropcompute.sum_kept``; the masked-accumulate kernel; the
accumulator is one buffer zeroed in place each step), then the gradients
are normalised and clipped and the optimizer updates the master
parameters in place (``Optimizer.step``).  The data-parallel path sums in
f32, as the reference's ``make_train_step`` does by default.
On the card each kept
micro-batch is one CUDA-graph replay (``core.Accumulator``, the
reference's ``jax.jit(step)`` at ``trainer.py:150``); Algorithm 1's keep
decision stays on the host between the replays.  The tail (normalisation,
clipping, the optimizer) runs eagerly: its learning rate and bias
corrections are host floats each step, which a graph would freeze.  The
latency draws, masks and simulated times are the reference's numpy, so drop fractions, tau
trajectories and ``sim_times`` equal the reference's exactly.

Checkpoints (``trainer.py:223-260``, ``:343-344``): ``ckpt_dir`` with
``ckpt_every`` saves ``{"params", "opt"}`` and the resilience state (tau,
the ``TauController`` state, the ``ComputeTelemetry`` window, the tau
trajectory) after every ``ckpt_every``-th step, in the reference's npz +
``meta.json`` format (``checkpoint``); ``resume_from`` restores them in
place before the first step and runs the remaining steps, so a resumed run
repeats the uninterrupted run's losses, drop fractions and tau.

The data-parallel path (``mesh="N"``, the reference's SPMD path,
``trainer.py:123-131``, ``:177-201``): each of the N ranks of the process
group runs ``train`` with the same arguments and holds ``W / N`` of the W
workers.  Its step (built by ``Distribution.train_step``) takes its own
workers' rows of the global batch.  The latency draws, masks, tau
selection and simulated times are the same host numpy on every rank (from
the shared ``(seed, step)`` draws), so the ranks' tau trajectories agree
with no collective.  The master parameters and the optimizer state are
placed by the reference's rules (``dist.sharding``, ZeRO): with a data axis
above 1 each rank keeps its slices of the split leaves
(``Distribution.shard`` of rank 0's tree after init; a restore reads the
whole trees on every rank and takes the slices), and the step gathers and
reduce-scatters them.  A checkpoint gathers the whole trees on every rank
and rank 0 writes them, in the single-device format, so it loads in
either trainer; ``TrainResult.params`` is the whole tree gathered after
the last step (the tree passed in is not updated).  A mesh with
``model > 1`` raises ``UnsupportedDistError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, synchronize
from ..core.dropcompute import DropConfig, drop_mask, elapsed_s
from ..core.simulate import LatencyModel
from ..core.threshold import select_threshold
from ..data.synthetic import DataConfig, batch_at
from ..dist.api import Distribution, UnsupportedDistError
from ..models.config import InputShape, ModelConfig
from ..launch.steps import make_train_step
from ..models.model import init_params, require_trainable
from ..models.transformer import tree_map
from . import checkpoint as ckpt
from .resilience import ComputeTelemetry, ControllerConfig, TauController

Tree = Any

__all__ = ["TrainConfig", "TrainResult", "UnsupportedDistError", "train"]


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
    mesh: Optional[Any] = None  # "N" | (N,) | Distribution: the data-parallel path
    # bookkeeping
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    resume_from: Optional[str] = None


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


def _resolve_dist(mesh, device) -> Optional[Distribution]:
    """None | "4" | (4,) | Distribution -> Optional[Distribution]; a spec's
    ranks run on ``device`` (``procs.rank_device``'s rules)."""
    if mesh is None or isinstance(mesh, Distribution):
        return mesh
    return Distribution.from_spec(mesh, device=device)


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
    """Train on one device (CUDA unless ``device`` names another), or with
    ``tcfg.mesh`` as one rank of the data-parallel group (every rank calls
    ``train`` alike; ``device`` as ``procs.rank_device`` reads it: by
    default the GPU of the rank's local rank).  ``params`` (the master
    tree) are moved there and updated in place (the reference returns new
    arrays; on the data-parallel path each rank updates its slices, and the
    whole tree is returned); without them they are drawn from
    ``tcfg.seed``.  Returns the
    trained parameters with the per-step losses, simulated times, drop
    fractions and tau trajectory; ``metrics`` adds each step's wall seconds
    (``step_s``) and each kept micro-batch's seconds on the device's
    timeline (``microbatch_s``), and on the data-parallel path each step's
    seconds on the same timeline in its All-Reduce (``allreduce_s``), its
    reduce-scatters (``reduce_scatter_s``) and its all-gathers of the
    compute copy (``all_gather_s``), and the micro-batches this rank kept
    (``kept_local``).  A config the training
    kernels are not built for, a mesh without its process group, or workers
    that do not split over the ranks raise before any work."""
    dist = _resolve_dist(tcfg.mesh, device)
    n, m = tcfg.n_workers, tcfg.microbatches
    total_m = n * m
    if data_cfg.batch_size % total_m:
        raise ValueError(f"global batch {data_cfg.batch_size} must divide into {n} workers "
                         f"x {m} microbatches")
    if dist is not None:
        dist.check_group()
        dist.workers_of(dist.rank, n)
        dev = dist.device
    else:
        dev = resolve_device(device)
    require_trainable(model_cfg, data_cfg.seq_len, dev)
    if params is None:
        params = init_params(model_cfg, seed=tcfg.seed, device=dev)
    else:
        params = tree_map(lambda p: p.to(dev), params)

    shape = InputShape("train_cli", data_cfg.seq_len, data_cfg.batch_size, "train",
                       microbatches=m)
    # sgd: no decay, as the reference's _make_step
    kw = dict(optimizer=tcfg.optimizer, lr=tcfg.lr, clip_norm=tcfg.clip_norm,
              weight_decay=None if tcfg.optimizer == "sgd" else tcfg.weight_decay)
    if dist is not None:
        bundle = dist.train_step(model_cfg, shape, tcfg.drop, n_workers=n, **kw)
        opt, train_step = bundle.opt, bundle.fn
        # placements from the whole trees' shapes (ZeRO: the split leaves'
        # slices of the masters and of the moments are this rank's)
        specs = {"params": dist.param_shardings(params),
                 "opt": dist.opt_shardings(opt.init(tree_map(lambda p: p.to("meta"), params)))}
        params = dist.shard(params, specs["params"])
    else:  # all N workers on this device, no collective; sums in the masters' dtype
        opt, train_step = make_train_step(model_cfg, shape, tcfg.drop, n, accum_dtype=None, **kw)
    opt_state = opt.init(params)

    tau = tcfg.drop.tau
    profile: List[np.ndarray] = []
    telemetry = ComputeTelemetry(n, m, window=tcfg.telemetry_window)
    controller: Optional[TauController] = None
    if tcfg.online_tau and tcfg.drop.enabled:
        ccfg = tcfg.controller or ControllerConfig(min_microbatches=tcfg.drop.min_microbatches)
        controller = TauController(ccfg, tcfg.tc, tau=tau, total_steps=tcfg.steps,
                                   default_recompile_cost_s=0.0)

    # resume: params / opt state (in place; on the data-parallel path read
    # into whole trees on every rank, then this rank's slices taken) plus
    # the adapted tau and controller
    start_step = 0
    if tcfg.resume_from:
        state = {"params": params, "opt": opt_state}
        if dist is not None:
            state = dist.gather(state, specs)
        state, start_step = ckpt.restore(tcfg.resume_from, state)
        if dist is not None:
            state = dist.shard(state, specs)
        params, opt_state = state["params"], state["opt"]
        state = ckpt.resilience_state(tcfg.resume_from)
        if state:
            tau = float("inf") if state.get("tau") is None else float(state["tau"])
            if controller is not None and state.get("controller"):
                controller.load_state_dict(state["controller"])
                tau = controller.tau
            if state.get("telemetry"):
                telemetry.load_state_dict(state["telemetry"])
    trajectory: List[Tuple[int, float]] = [(start_step, tau)]

    def save_ckpt(step_now: int) -> None:
        """Every rank gathers the whole trees; rank 0 writes; every rank
        waits for the files."""
        tree = {"params": params, "opt": opt_state}
        if dist is not None:
            tree = dist.gather(tree, specs)
        if dist is None or dist.rank == 0:
            res_state = {
                "tau": None if not np.isfinite(tau) else float(tau),
                "controller": controller.state_dict() if controller else None,
                "telemetry": telemetry.state_dict(),
                "trajectory": [[int(s), (None if not np.isfinite(t) else float(t))]
                               for s, t in (controller.trajectory if controller else trajectory)],
            }
            ckpt.save(tcfg.ckpt_dir, tree, step_now, extra={"resilience": res_state})
        if dist is not None:
            dist.barrier()

    losses, sim_times, drops, step_s, microbatch_s = [], [], [], [], []
    allreduce_s, reduce_scatter_s, all_gather_s, kept_local = [], [], [], []
    for step in range(start_step, tcfg.steps):
        b = batch_at(step, data_cfg)  # the global batch; the step takes its workers' rows
        batch = {k: b[k] for k in ("tokens", "weights")}

        # latency draws for the N workers (Algorithm 1 input)
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

        # tau is a host float the step reads: nothing to rebuild or recapture
        train_step.drop = dataclasses.replace(tcfg.drop, tau=tau)
        synchronize(dev)
        h0 = time.monotonic()
        # a span a torch.profiler trace can cut steps by (free when not profiling)
        with torch.profiler.record_function("train_step"):
            _, opt_state, stats = train_step(params, opt_state, batch, t)
            loss = float(stats["loss"])  # syncs the device
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
        if dist is not None:
            allreduce_s.append(elapsed_s(stats["allreduce_marks"])[0])
            reduce_scatter_s.append(elapsed_s(stats["reduce_scatter_marks"])[0])
            all_gather_s.append(elapsed_s(stats["all_gather_marks"])[0])
            kept_local.append(stats["kept_local"])
        telemetry.record(step, t, host_step_s=host_step_s, tau=tau, drop_fraction=drop_frac)
        if tcfg.ckpt_dir and tcfg.ckpt_every and (step + 1) % tcfg.ckpt_every == 0:
            save_ckpt(step + 1)

    final_trajectory = list(controller.trajectory) if controller else trajectory
    metrics: Dict[str, Any] = {
        "final_loss": losses[-1] if losses else float("nan"),
        "mean_drop": float(np.mean(drops)) if drops else 0.0,
        "total_sim_time": float(np.sum(sim_times)),
        "tau_changes": max(len(final_trajectory) - 1, 0),
        "bundle_rebuilds": (controller.rebuilds if controller else 0) if dist is not None else 0,
        "step_s": step_s,
        "microbatch_s": microbatch_s,
    }
    if dist is not None:
        metrics.update(allreduce_s=allreduce_s, reduce_scatter_s=reduce_scatter_s,
                       all_gather_s=all_gather_s, kept_local=kept_local)
        params = dist.gather(params, specs["params"])
    if eval_fn is not None:
        metrics["eval"] = float(eval_fn(params))
    return TrainResult(params, losses, sim_times, drops, float(tau), metrics,
                       tau_trajectory=final_trajectory, telemetry=telemetry.summary())
