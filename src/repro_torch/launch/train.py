"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 3 --drop-compute --tau 1.2 --device cpu  # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --full-config --seq 2048 --batch 8 --workers 4 --microbatches 2 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 20 --drop-compute --auto-threshold --device cpu  # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --full-config --seq 2048 --batch 32 --workers 4 --microbatches 2 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch bert-1.5b \
        --optimizer lans --steps 2 --device cpu  # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --arch bert-1.5b \
        --full-config --optimizer lans --seq 128 --batch 768 --workers 4 \
        --microbatches 12 --steps 3 --drop-compute --auto-threshold  # B.1's micro-batch
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
        --steps 3 --drop-compute --auto-threshold --device cpu  # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
        --full-config --seq 8192 --batch 8 --workers 4 --microbatches 2 --lr 1e-4 \
        --steps 3 --drop-compute --tau 1.0

Selects an architecture from the port's registry (``--arch``: one of
``ARCHITECTURES`` or the paper's ``PAPER_MODELS``, the reduced smoke config
unless ``--full-config``), builds the synthetic data and the
DropCompute trainer, and runs on one device: CUDA unless ``--device cpu``.
``--ckpt DIR`` saves a checkpoint every 50 steps, ``--resume DIR`` resumes
from one (parameters, optimizer state and the adapted tau-controller
state), as the reference's launcher does.  A config that the training
kernels are not built for is refused on CUDA before any work: attention
at a (head dim, group) outside ``kernels.flash_attention.TRAINED`` or not
in bf16 (qwen's smoke config is f32 with head dim 32, the BERT and MoE
smoke configs f32 with head dim 32, recurrentgemma's f32 with head dim 64,
group 2), or SSD layers other than state 128, head dim 64 (mamba's smoke
config has state 16, head dim 32); run those with ``--device cpu``.  The
MoE models train in the sort dispatch with their router's aux loss:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \
        --steps 3 --seq 32 --batch 8 --workers 2 --microbatches 2 \
        --drop-compute --tau 0.6 --device cpu  # smoke config

``--mesh N`` trains data-parallel on N ranks (``repro_torch.dist``): under
``torchrun`` each process joins the group it made; run alone, the launcher
spawns N local ranks, one a GPU (NCCL; fewer GPUs than N raise
``NotEnoughDevicesError``), or all on the CPU with ``--device cpu``
(gloo).  Rank 0 prints.  A model axis (``--mesh 2,2``) is refused.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 3 --batch 8 --seq 32 --workers 4 --microbatches 2 \
        --drop-compute --tau 1.0 --device cpu --mesh 2
"""
import argparse
import os
import sys

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, PAPER_MODELS, get_config, get_smoke_config
from repro_torch.core import DropConfig, LatencyModel, NoiseModel
from repro_torch.data import DataConfig
from repro_torch.dist import Distribution, UnsupportedDistError, procs
from repro_torch.kernels.flash_attention import UnbuiltShapeError
from repro_torch.models.model import require_trainable
from repro_torch.train import TrainConfig, train
from repro_torch.train.resilience import SCENARIOS, make_scenario


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help=f"one of {ARCHITECTURES + PAPER_MODELS}")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced same-family config (the default)")
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "lamb", "lans", "sgd"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--drop-compute", action="store_true")
    ap.add_argument("--tau", type=float, default=float("inf"))
    ap.add_argument("--auto-threshold", action="store_true")
    ap.add_argument("--normalize", default="computed", choices=["computed", "nominal"])
    ap.add_argument("--noise", default="paper_lognormal")
    ap.add_argument("--tc", type=float, default=0.5)
    ap.add_argument("--faults", default="", choices=[""] + sorted(SCENARIOS))
    ap.add_argument("--fault-onset", type=int, default=None)
    ap.add_argument("--online-tau", action="store_true")
    ap.add_argument("--inject-real-delays", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--ckpt", default="", help="checkpoint dir, saved every 50 steps")
    ap.add_argument("--resume", default="",
                    help="checkpoint dir to resume from (params, opt state "
                         "AND the adapted tau-controller state)")
    ap.add_argument("--mesh", default="",
                    help="data-parallel ranks, e.g. 2 (one GPU a rank, or --device cpu)")
    return ap


def _run(args, verbose: bool) -> int:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
                      strategy="pack", seed=args.seed)
    latency = LatencyModel(base=0.45, noise=NoiseModel(kind=args.noise))
    if args.faults:
        latency = make_scenario(args.faults, base=latency, seed=args.seed,
                                onset=args.fault_onset)
    tcfg = TrainConfig(
        steps=args.steps, n_workers=args.workers, microbatches=args.microbatches,
        optimizer=args.optimizer, lr=args.lr,
        drop=DropConfig(enabled=args.drop_compute, tau=args.tau, normalize=args.normalize),
        auto_threshold=args.auto_threshold and not args.online_tau,
        calibration_steps=min(20, args.steps // 2),
        online_tau=args.online_tau, inject_real_delays=args.inject_real_delays,
        latency=latency, tc=args.tc, seed=args.seed,
        ckpt_dir=args.ckpt or None, ckpt_every=50 if args.ckpt else 0,
        resume_from=args.resume or None, mesh=args.mesh or None,
    )
    r = train(cfg, data, tcfg, device=args.device)
    if not verbose:
        return 0
    print(f"[train] loss {r.losses[0]:.3f} -> {r.losses[-1]:.3f}  "
          f"sim time {r.metrics['total_sim_time']:.0f}s  "
          f"drop {np.mean(r.drop_fractions):.1%}  tau={r.tau}  "
          f"step s {np.median(r.metrics['step_s']):.3f} (median)", flush=True)
    if len(r.tau_trajectory) > 1:
        print("[train] tau trajectory: "
              + " -> ".join(f"{s}:{t:.2f}" if np.isfinite(t) else f"{s}:inf"
                            for s, t in r.tau_trajectory))
    return 0


def _rank_main(rank: int, world_size: int, argv) -> None:
    """One spawned rank of ``--mesh N``: the same run, rank 0 printing."""
    _run(_parser().parse_args(argv), verbose=rank == 0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    dist = None
    if args.mesh:
        try:
            dist = Distribution.from_spec(args.mesh, device=args.device)
        except (UnsupportedDistError, ValueError) as e:
            ap.error(str(e))

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        require_trainable(cfg, args.seq, torch.device(args.device or "cuda"))
    except (UnbuiltShapeError, NotImplementedError) as e:
        ap.error(f"{cfg.name} on {args.device or 'cuda'}: {e}")
    torchrun = dist is not None and "LOCAL_RANK" in os.environ and "WORLD_SIZE" in os.environ
    if torchrun:  # join the group torchrun made
        procs.init_from_env(device=args.device)
    if dist is None or dist.rank == 0:
        print(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
              f"family={cfg.family} pattern={cfg.layer_pattern}"
              + (f" ranks={dist.dp_size}" if dist else ""), flush=True)
    if dist is None:
        return _run(args, verbose=True)
    if torchrun:
        try:
            return _run(args, verbose=dist.rank == 0)
        finally:
            torch.distributed.destroy_process_group()
    procs.spawn(_rank_main, dist.dp_size, device=args.device, args=(argv,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
