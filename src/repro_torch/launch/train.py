"""Training launcher (port of ``repro.launch.train``, single device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 3 --drop-compute --tau 1.2 --device cpu  # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --full-config --seq 2048 --batch 8 --workers 4 --microbatches 2 --steps 3

Selects an architecture from the port's registry (``--arch``, the reduced
smoke config unless ``--full-config``), builds the synthetic data and the
DropCompute trainer, and runs on one device: CUDA unless ``--device cpu``.
``--mesh``, ``--ckpt`` and ``--resume`` are refused: the SPMD path and
checkpoints are not ported yet.  So is, on CUDA, a config whose attention
the training kernels are not built for (the smoke config is f32 with head
dim 32: run it with ``--device cpu``).
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.core import DropConfig, LatencyModel, NoiseModel
from repro_torch.data import DataConfig
from repro_torch.kernels.flash_attention import UnbuiltShapeError
from repro_torch.models.model import require_trainable
from repro_torch.train import TrainConfig, train
from repro_torch.train.resilience import SCENARIOS, make_scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help=f"one of {ARCHITECTURES}")
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
    ap.add_argument("--ckpt", default="", help="not ported: refused")
    ap.add_argument("--resume", default="", help="not ported: refused")
    ap.add_argument("--mesh", default="", help="not ported: refused")
    args = ap.parse_args(argv)
    for flag in ("mesh", "ckpt", "resume"):
        if getattr(args, flag):
            ap.error(f"--{flag} is not ported to repro_torch yet (see ROADMAP.md)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        require_trainable(cfg, args.seq, torch.device(args.device or "cuda"))
    except (UnbuiltShapeError, NotImplementedError) as e:
        ap.error(f"{cfg.name} on {args.device or 'cuda'}: {e}")
    print(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"family={cfg.family} pattern={cfg.layer_pattern}", flush=True)
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
    )
    r = train(cfg, data, tcfg, device=args.device)
    print(f"[train] loss {r.losses[0]:.3f} -> {r.losses[-1]:.3f}  "
          f"sim time {r.metrics['total_sim_time']:.0f}s  "
          f"drop {np.mean(r.drop_fractions):.1%}  tau={r.tau}  "
          f"step s {np.median(r.metrics['step_s']):.3f} (median)", flush=True)
    if len(r.tau_trajectory) > 1:
        print("[train] tau trajectory: "
              + " -> ".join(f"{s}:{t:.2f}" if np.isfinite(t) else f"{s}:inf"
                            for s, t in r.tau_trajectory))
    return 0


if __name__ == "__main__":
    sys.exit(main())
