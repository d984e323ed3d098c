#!/usr/bin/env python3
"""Where the time goes on the card: device time by kernel family and the
device's idle share, for the serving and training runs that
``chip_smoke.py`` drives.

    python3 chip_profile.py            # from the root of a checkout, one GPU

qwen2.5-3b at full width (random weights from ``--seed``) serves the same
eight requests as ``chip_smoke.py`` through the paged engine, unpacked and
packed; mamba2-130m at full width and depth serves ``chip_smoke.py``'s
mamba requests the same way; then qwen2.5-3b trains one DropCompute step
of ``chip_smoke.py``'s training run (step 0: 4 workers x 2 micro-batches
of 2048 tokens at its tau).  Each
run goes twice: once on the host clock alone (the wall time a user sees),
then under ``torch.profiler`` for the kernels' device times (training: a
warm-up step first).  The idle share is one minus the union of the
kernels' device intervals over the unprofiled wall time.  Prints one JSON
line per run and nothing else is claimed: profiling slows the host, never
the kernels.

    python3 chip_profile.py --only kernels --tag change

times the kernels ``chip_smoke.py`` times, at its main-path shapes
(``k4_timing``, ``k2_timing``, ``k2_bwd_checks_and_timing``), and prints one
JSON line; ``--only qwen`` (qwen2.5-3b's serving runs) and ``--only
train`` run one part of the profile.  A copy of this script placed at the root of another checkout (a
``git archive`` of a parent commit) imports that checkout's
``chip_smoke.py`` and kernels, so one call can time two trees in turns;
``--tag`` labels each line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.models.model import compute_params, init_params

FAMILIES = (  # first match wins; K4's and K2 backward's two kernels are sub-rows
    # (each pattern also names the kernel the previous version had there, so
    # that a copy of this script files a checkout of an older commit the same way)
    ("K4 paged_attention: main", re.compile(r"paged_attention_tc|paged_attention_kernel")),
    ("K4 paged_attention: split merge", re.compile(r"paged_attention_combine")),
    ("K3 flash_attention: forward", re.compile(r"attn_fwd")),
    ("K3 flash_attention: backward delta", re.compile(r"attn_bwd_delta")),
    ("K3 flash_attention: backward dK/dV", re.compile(r"attn_bwd_dkdv")),
    ("K3 flash_attention: backward group sum", re.compile(r"attn_bwd_group_sum")),
    ("K3 flash_attention: backward dQ", re.compile(r"attn_bwd_dq")),
    ("K2 rmsnorm: backward rows", re.compile(r"rmsnorm_bwd_rows|rmsnorm_bwd_kernel")),
    ("K2 rmsnorm: backward dscale sum", re.compile(r"rmsnorm_bwd_colsum|colsum_kernel")),
    ("K2 rmsnorm", re.compile(r"rmsnorm_kernel")),
    ("K1 masked_accum", re.compile(r"masked_accum_kernel")),
    ("K6 ssd_chunk", re.compile(r"ssd_chunk_kernel")),
    ("K5 ssd_segment", re.compile(r"ssd_segment_kernel")),
    ("matmul (cuBLAS)", re.compile(r"gemm|xmma|nvjet|cutlass|cublas|splitK", re.I)),
    ("index / scatter / gather", re.compile(r"index|scatter|gather", re.I)),
    ("reduce / argmax / softmax", re.compile(r"reduce|argmax|softmax", re.I)),
    ("copy / cast", re.compile(r"copy|cast|convert", re.I)),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other elementwise"


def timed_run(cfg, params, prompts, packed, make=cs.engine):
    eng = make(cfg, params, prompts, packed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, eng.steps


def kernel_intervals(prof):
    """(name, start_us, end_us) of every device kernel in the trace."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def union_us(intervals) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_record(prof, wall_s: float, per: int) -> dict:
    """Device busy time, idle share and time by kernel family of one
    profiled run (``per``: the steps or micro-batches to divide counts by)."""
    ks = kernel_intervals(prof)
    if not ks:
        raise RuntimeError("the profiler recorded no device kernels")
    by_fam, by_name, n_fam = defaultdict(float), defaultdict(float), defaultdict(int)
    for name, s, e in ks:
        by_fam[family(name)] += (e - s) / 1e3
        by_name[name[:90]] += (e - s) / 1e3
        n_fam[family(name)] += 1
    busy_ms = union_us(ks) / 1e3
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall_s * 1e3), "kernels_per_unit": len(ks) / per,
        "families_ms": {k: v for k, v in sorted(by_fam.items(), key=lambda x: -x[1])},
        "families_launches": dict(n_fam),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda x: -x[1])[:8]),
    }


def train_profile(cfg, seed: int) -> dict:
    """One training step of ``chip_smoke.train_phase``'s run (its step 0)."""
    n, m = cs.TRAIN_WORKERS, cs.TRAIN_MB
    data = cs.DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_SEQ, batch_size=n * m,
                         strategy="pack", seed=seed)
    latency = cs.LatencyModel(base=0.45, noise=cs.NoiseModel(kind="paper_lognormal"))
    draws = [latency.sample_at(step, n, m, seed=seed + 1) for step in range(cs.TRAIN_STEPS)]
    tau = float(np.median(np.stack(draws).sum(-1)))
    tcfg = cs.TrainConfig(steps=1, n_workers=n, microbatches=m, lr=1e-4, clip_norm=1.0,
                          seed=seed, latency=latency, drop=cs.DropConfig(enabled=True, tau=tau))
    kept = int(cs.drop_mask(draws[0], tau, 1).sum())
    params = init_params(cfg, seed=seed, device="cuda")
    cs.train(cfg, data, tcfg, params=params, device="cuda")  # warm-up: JIT, cuBLAS plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.train(cfg, data, tcfg, params=params, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cs.train(cfg, data, tcfg, params=params, device="cuda")
        torch.cuda.synchronize()
    rec = {"tag": TAG, "run": "train", "kept_microbatches": kept,
           **profile_record(prof, wall, kept)}
    rec["k2_bwd_ms"] = sum(v for k, v in rec["families_ms"].items()
                           if k.startswith("K2 rmsnorm: backward"))
    return rec


def serve_profiles(cfg, params, prompts, make) -> None:
    """Warm up, then for the unpacked and the packed engine: the wall time
    unprofiled, then the profiled run's record (one JSON line each)."""
    timed_run(cfg, params, prompts, True, make)  # warm-up: kernel builds, cuBLAS plans
    for packed in (False, True):
        wall, steps = timed_run(cfg, params, prompts, packed, make)
        eng = make(cfg, params, prompts, packed)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            eng.run()
            torch.cuda.synchronize()
        rec = {"tag": TAG, "run": "serve", "model": cfg.name,
               "layout": "packed" if packed else "unpacked",
               "steps": steps, **profile_record(prof, wall, eng.steps)}
        rec["k4_ms"] = sum(v for k, v in rec["families_ms"].items() if k.startswith("K4"))
        print(json.dumps(rec), flush=True)


TAG = ""


def kernel_times(seed: int) -> dict:
    """``chip_smoke.py``'s K4, K2 and K2-backward timings (the checks inside
    them included) at its main-path shapes, from a stream seeded as its
    run's."""
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1, cs.SLOTS)]
    k4 = cs.k4_timing(rng, lens)
    k2 = cs.k2_timing(rng)
    _, k2b = cs.k2_bwd_checks_and_timing(rng)
    return {"tag": TAG, "run": "kernels", "k4": k4, "k2": k2, "k2_bwd": k2b}


def main() -> int:
    global TAG
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("qwen", "train", "kernels"), default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    TAG = args.tag
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.only == "kernels":
        print(json.dumps(kernel_times(args.seed)), flush=True)
        return 0
    if args.only == "train":
        print(json.dumps(train_profile(get_config("qwen2_5_3b"), args.seed)), flush=True)
        return 0

    rng = np.random.default_rng(args.seed)
    cfg = get_config("qwen2_5_3b")
    lens = [int(n) for n in rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1, cs.SLOTS)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    params = compute_params(init_params(cfg, seed=args.seed, device="cuda"), cfg)
    serve_profiles(cfg, params, prompts, cs.engine)
    del params
    cs.free_device()
    if args.only == "qwen":
        return 0

    mcfg = get_config("mamba2_130m")
    _, mprompts = cs.mamba_requests(mcfg, args.seed)
    params = compute_params(init_params(mcfg, seed=args.seed, device="cuda"), mcfg)
    serve_profiles(mcfg, params, mprompts,
                   lambda c, p, pr, packed: cs.mamba_engine(c, p, pr, "paged", packed))
    del params
    cs.free_device()
    print(json.dumps(train_profile(cfg, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
