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
of 2048 tokens at its tau).  Each run goes in two modes, eager
(``repro_torch.graphs.disable_graphs()``) and graphed (each step a captured
CUDA graph, the default), and in each mode twice: once on the host clock
alone (the wall time a user sees), then under ``torch.profiler`` for the
kernels' device times (a warm-up run first, which also captures the
graphs).  The idle share is one minus the union of the kernels' device
intervals over the unprofiled wall time; host launches are the launch
calls the profiler records on the host (kernel launches, graph launches,
copies and fills), per step (serving) or per kept micro-batch (training,
where the graphed run's tail, every launch after its step's last graph
launch, is counted apart).  Prints one JSON line per run and nothing else
is claimed: profiling slows the host, never the kernels.

    python3 chip_profile.py --only kernels mamba --tag change

runs the named parts alone: ``kernels`` times the kernels ``chip_smoke.py``
times, at its main-path shapes (``k4_timing``, ``k2_timing``,
``k2_bwd_checks_and_timing``, K6 / K5 at the mamba serving shapes and K6
forward and backward at the Mamba-2 training shape), with digests of K6's
and K5's outputs, and prints one JSON line; ``k6_precision`` times K6's
backward against copies of its source with its two precision choices
(``__expf``, truncating 3xTF32 splits) undone, with each one's errors;
``qwen`` and ``mamba`` profile one model's serving
runs, ``train`` the training step, ``localsgd`` the last round of
``chip_smoke.py``'s Local-SGD run (qwen2.5-3b, 36 layers), ``dp`` one
graphed training step of ``chip_smoke.py``'s phase 9a (one NCCL rank,
``mesh="1"``) with its ``dp_allreduce``, ``dp_reduce_scatter`` and
``dp_all_gather`` spans apart, ``mamba_train`` one
eager and one graphed step of its phase 10 (mamba2-130m at 24 layers,
micro-batches of 4 x 2048 tokens; K6's forward and its backward's kernels
filed apart), ``bert_train`` one eager and one graphed step of its phase
11c (bert-1.5b at 48 layers, 4 workers x 12 micro-batches of 16 x 128
tokens, LANS; K3's (64, 1) build filed under K3), ``rg_serve`` the
serving runs of its phase 12c (recurrentgemma-2b at 26 layers, its nine
requests; K4's (256, 10) build filed under K4), then each step shape's
device time beside one RG-LRU mixer's and its products'
(``rg_mixer_shares``), ``rg_train`` one eager and one graphed step of its
phase 13c (recurrentgemma-2b at 26 layers, 4 workers x 2 micro-batches of
one 8,192-token sequence; K3's (256, 10) build filed under K3), then the
18 RG-LRU mixers' share of a kept micro-batch (``rg_train_mixer_share``),
``sampled_serve`` and ``spec_serve`` its phase 14c and 14d engines
(``sampled_profiles``: the sampler's share of the busy time, read from
the eager run's trace, the proposer's of the wall), ``zoo_serve`` the
serving runs of its phase 15 for gemma3-27b (62 layers, bf16 parameters,
its nine requests; K4's (128, 2) build filed under K4), ``moe_serve`` the
decode-only steps of its phase 17b engine for mixtral-8x22b (12 layers,
full width, bf16; 8 requests of 128-512 tokens, all prefilled and one
decode step run before the window: ``decode_profiles``), in the dense
dispatch and at cf 1.25 (K4's (128, 6) build filed under K4; the expert
products under cuBLAS, the dispatch's sort under sort, its scatter and
gathers under index), ``moe_train`` one kept micro-batch of its phase 18c
for each MoE model (1 layer, full width, bf16: ``moe_microbatch_profile``,
the expert products also timed apart at the dispatch's buffer),
``whisper_serve`` its phase 19b's encode (the serving path's direct call)
and one decode step eager and graphed (``whisper_serve_profiles``),
``whisper_train`` one kept micro-batch of its phase 19c eager and graphed
(whisper-tiny at full width and depth; K3's (64, 1) build at the ragged
lengths filed under K3), ``vlm_serve`` the decode-only steps of its phase
20b engine (internvl2-1b at full width and depth, bf16 compute copy, text
only; its 8 requests of 128-512 tokens: ``decode_profiles``; K4's (64, 7)
build filed under K4), ``vlm_train`` one kept micro-batch of its phase 20c
eager and graphed (4 x (256 patch rows + 1,792 tokens), f32 masters; K3's
(64, 7) build filed under K3).  ``kernels`` also times K3's (128, 8) build at the
qwen training shape (``k3_timing``) with a digest of its outputs, gives a
digest of K4's (128, 8) outputs (``k4_digests``) and times K4's (256, 10)
build; ``k4_builds`` gives a digest and the decode and mixed times of each
K4 build of a dense or 'R' model at that model's widths (run it from the root of
two trees in turns to hold a change to their bits and times); ``opt_step``
times the training step's optimizer tail on one device, LANS over
bert-1.5b's tree and LAMB over bert-large's at full depth
(``opt_step_times``; from the root of two trees in turns it holds a change
to the optimizers).  A copy of this script placed at the
root of another checkout (a ``git archive`` of a later commit: its
``chip_smoke.py`` must have ``mode`` and ``train_setup``) imports that
checkout's ``chip_smoke.py`` and kernels, so one call can time two trees
in turns; ``--tag`` labels each line.  Copied there together with this
tree's ``chip_smoke.py``, ``--only kernels`` times that tree's kernels with
this tree's timing code (K2's forward back to back, for one), as long as
the kernel wrappers that code calls have the same names and signatures in
both trees.
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.dist import procs
from repro_torch.models.model import compute_params, init_params
from repro_torch.models.transformer import tree_leaves, tree_unflatten
from repro_torch.optim import make as make_opt

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
    ("K2 rmsnorm", re.compile(r"rmsnorm_fwd_rows|rmsnorm_kernel")),
    ("K1 masked_accum", re.compile(r"masked_accum_kernel")),
    ("K6 ssd_chunk: backward key-tile pass", re.compile(r"ssd_bwd_keys_kernel")),
    ("K6 ssd_chunk: backward dC", re.compile(r"ssd_bwd_dc_kernel")),
    ("K6 ssd_chunk: backward column pass", re.compile(r"ssd_column_kernel")),
    ("K6 ssd_chunk: backward dS", re.compile(r"ssd_bwd_ds_kernel")),
    ("K6 ssd_chunk: backward dB / dC", re.compile(r"ssd_bwd_bc_kernel")),
    ("K6 ssd_chunk: backward finish", re.compile(r"ssd_bwd_finish_kernel")),
    ("K6 ssd_chunk", re.compile(r"ssd_chunk_kernel")),
    ("K5 ssd_segment", re.compile(r"ssd_segment_kernel")),
    ("matmul (cuBLAS)", re.compile(r"gemm|xmma|nvjet|cutlass|cublas|splitK", re.I)),
    ("sort", re.compile(r"RadixSort|sort", re.I)),
    ("index / scatter / gather", re.compile(r"index|scatter|gather", re.I)),
    ("reduce / argmax / softmax", re.compile(r"reduce|argmax|softmax", re.I)),
    ("copy / cast", re.compile(r"copy|cast|convert", re.I)),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other elementwise"


#: host calls that put work on the card (runtime and driver API names)
LAUNCH_CALLS = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|cuLaunchKernelEx"
                          r"|cudaGraphLaunch|cudaMemcpyAsync|cudaMemsetAsync)")


def kernel_intervals(prof):
    """(name, start_us, end_us) of every device kernel in the trace (not
    the device-side copies of ``record_function`` spans)."""
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
                and not getattr(e, "is_user_annotation", False)
                and e.name not in ("train_step", "localsgd_round", "dp_allreduce",
                                   "dp_reduce_scatter", "dp_all_gather")):
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


def host_launches(prof):
    """(name, start_us) of every launch call the host made in the trace."""
    return [(e.name, e.time_range.start) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and LAUNCH_CALLS.match(e.name)]


def profile_record(prof, wall_s: float, per: int, window=None) -> dict:
    """Device busy time, idle share, time by kernel family and host launches
    of one profiled run (``per``: the steps or micro-batches to divide
    counts by; ``window``: (start, end) us, the kernels starting and the
    launches made inside it alone)."""
    lo, hi = window or (float("-inf"), float("inf"))
    ks = [k for k in kernel_intervals(prof) if lo <= k[1] <= hi]
    if not ks:
        raise RuntimeError("the profiler recorded no device kernels")
    calls = [c for c in host_launches(prof) if lo <= c[1] <= hi]
    by_fam, by_name, n_fam = defaultdict(float), defaultdict(float), defaultdict(int)
    for name, s, e in ks:
        by_fam[family(name)] += (e - s) / 1e3
        by_name[name[:90]] += (e - s) / 1e3
        n_fam[family(name)] += 1
    busy_ms = union_us(ks) / 1e3
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall_s * 1e3), "kernels_per_unit": len(ks) / per,
        "host_launches_per_unit": len(calls) / per if calls else "not measured",
        "graph_launches": sum(1 for n, _ in calls if n.startswith("cudaGraphLaunch")),
        "families_ms": {k: v for k, v in sorted(by_fam.items(), key=lambda x: -x[1])},
        "families_launches": dict(n_fam),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda x: -x[1])[:8]),
    }


def train_profile(cfg, seed: int, eager: bool, mesh=None, seqs: int = 1, run: str = None,
                  shape: dict = None, optimizer: str = "adamw") -> dict:
    """Step 1 of a 2-step run of ``chip_smoke.train_phase``'s training (its
    steps 0 and 1), eager or graphed: step 0 builds the kernels and
    captures the micro-batch graph, step 1 replays it.  The record covers
    the trainer's ``train_step`` span of step 1 (host launches in it, device
    kernels that start in it); its wall time is step 1's ``step_s`` of an
    unprofiled run.  With ``mesh`` ("1": ``chip_smoke``'s phase 9a, one
    NCCL rank in this process) the record adds the step's collective spans,
    ``dp_allreduce``, ``dp_reduce_scatter`` and ``dp_all_gather``: each
    one's host ms and the device ms of the kernels that start in it (on one
    rank nothing is split: the reduce-scatter span is empty and the
    all-gather span holds the compute copy's casts; 9b's and 9c's two
    ranks time them with events, ``chip_smoke.dp_gloo_phase``).
    ``seqs`` > 1 (``chip_smoke``'s phase 10: mamba2-130m, micro-batches of
    ``M_TRAIN_SEQS`` sequences) needs a ``chip_smoke.py`` whose
    ``train_setup`` takes ``seqs``; ``shape`` (``seq``, ``mb``: phase 11's
    BERT run) one whose ``train_setup`` takes those too.  ``run`` labels the
    record."""
    n, m = cs.TRAIN_WORKERS, (shape or {}).get("mb", cs.TRAIN_MB)
    data, latency, tau, masks = cs.train_setup(cfg, seed, *([seqs] if seqs > 1 else []),
                                               **(shape or {}))
    tcfg = cs.TrainConfig(steps=2, n_workers=n, microbatches=m, optimizer=optimizer, lr=1e-4,
                          clip_norm=1.0, seed=seed, latency=latency,
                          drop=cs.DropConfig(enabled=True, tau=tau), mesh=mesh)
    kept = int(masks[1].sum())
    params = init_params(cfg, seed=seed, device=cs.DEV)
    group = procs.local_group(backend="nccl", device="cuda") if mesh else contextlib.nullcontext()
    with group, cs.mode(eager):
        res = cs.train(cfg, data, tcfg, params=params, device=cs.DEV)
        wall = res.metrics["step_s"][1]
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            cs.train(cfg, data, tcfg, params=params, device=cs.DEV)
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == "train_step" and e.device_type == torch.autograd.DeviceType.CPU)
    lo, hi = spans[-1]
    run = run or ("dp" if mesh else ("mamba_train" if seqs > 1 else "train"))
    rec = {"tag": TAG, "run": run, "mode": "eager" if eager else "graphed",
           "kept_microbatches": kept, **profile_record(prof, wall, kept, window=(lo, hi))}
    if mesh:  # the step's collectives, each a span of its own
        for span in ("dp_allreduce", "dp_reduce_scatter", "dp_all_gather"):
            (a_lo, a_hi), = [(e.time_range.start, e.time_range.end) for e in prof.events()
                             if e.name == span
                             and e.device_type == torch.autograd.DeviceType.CPU
                             and lo <= e.time_range.start <= hi]
            rec[f"{span}_host_ms"] = (a_hi - a_lo) / 1e3
            rec[f"{span}_device_ms"] = sum(
                (e - s) / 1e3 for _, s, e in kernel_intervals(prof) if a_lo <= s <= a_hi)
            rec[f"{span}_kernels"] = sorted({name for name, s, _ in kernel_intervals(prof)
                                            if a_lo <= s <= a_hi})
    rec["k2_bwd_ms"] = sum(v for k, v in rec["families_ms"].items()
                           if k.startswith("K2 rmsnorm: backward"))
    rec["k6_bwd_ms"] = sum(v for k, v in rec["families_ms"].items()
                           if k.startswith("K6 ssd_chunk: backward"))
    rec["k3_ms"] = sum(v for k, v in rec["families_ms"].items() if k.startswith("K3"))
    calls = [t for _, t in host_launches(prof) if lo <= t <= hi]
    graph_at = [t for name, t in host_launches(prof)
                if name.startswith("cudaGraphLaunch") and lo <= t <= hi]
    if graph_at:  # the eager calls around the replays: the refill before, the tail after
        rec["refill_host_launches"] = sum(1 for t in calls if t < graph_at[0])
        rec["tail_host_launches"] = sum(1 for t in calls if t > graph_at[-1])
    return rec


def localsgd_profile(cfg, seed: int, eager: bool) -> dict:
    """The last round of ``chip_smoke.localsgd_phase``'s Local-SGD run (2
    workers x 2 local steps, its keep mask; the first round builds the
    kernels and captures the step graphs), eager or graphed: the kernels
    that start and the launches made in its ``localsgd_round`` span; its
    wall time is that round's wall in an unprofiled run."""
    _, keep = cs.localsgd_keep(seed)

    def run():
        params = init_params(cfg, seed=seed, device=cs.DEV)
        return cs.localsgd_run(cfg, params, keep, seed, cs.TRAIN_SEQ, cs.LSGD_LR, eager)[1]

    wall = run()[-1]
    cs.free_device()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == "localsgd_round" and e.device_type == torch.autograd.DeviceType.CPU)
    steps = int(keep[-1].size)
    return {"tag": TAG, "run": "localsgd", "mode": "eager" if eager else "graphed",
            "kept_steps": int(keep[-1].sum()), "steps": steps,
            **profile_record(prof, wall, steps, window=spans[-1])}


def warm_engine(cfg, params, prompts, packed, make, eager):
    """An engine that has served a warm-up set (the prompts' lengths, other
    tokens, so no prefix is shared with them: kernels built, its step
    graphs captured), with ``prompts`` submitted."""
    warm = [[(t + 1) % cfg.vocab_size for t in p] for p in prompts]
    eng = make(cfg, params, warm, packed)
    with cs.mode(eager):
        eng.run()
    eng.reset_stats()
    for i, p in enumerate(prompts):
        eng.submit(cs.Request(uid=i, prompt=list(p), max_new_tokens=cs.NEW_TOKENS))
    return eng


def serve_profiles(cfg, params, prompts, make) -> None:
    """For the unpacked and the packed engine, eager and graphed, each on an
    engine warmed up on another set (``warm_engine``): the wall time
    unprofiled, then the profiled run's record (one JSON line each)."""
    for packed in (False, True):
        for eager in (True, False):
            eng = warm_engine(cfg, params, prompts, packed, make, eager)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cs.mode(eager):
                eng.run()
            torch.cuda.synchronize()
            wall, steps = time.perf_counter() - t0, eng.steps
            eng = warm_engine(cfg, params, prompts, packed, make, eager)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with cs.mode(eager), torch.profiler.profile(activities=acts) as prof:
                eng.run()
                torch.cuda.synchronize()
            rec = {"tag": TAG, "run": "serve", "model": cfg.name,
                   "layout": "packed" if packed else "unpacked",
                   "mode": "eager" if eager else "graphed",
                   "steps": steps, **profile_record(prof, wall, eng.steps)}
            rec["k4_ms"] = sum(v for k, v in rec["families_ms"].items() if k.startswith("K4"))
            print(json.dumps(rec), flush=True)
            del eng
            cs.free_device()


#: decode-only steps a ``decode_profiles`` run times
DECODE_STEPS = 16


def decode_profiles(cfg, params, prompts, make, **tags) -> None:
    """Decode-only steps of the unpacked engine ``make`` builds, eager and
    graphed: every prompt prefilled and one decode step run first (the
    decode graph captured), then ``DECODE_STEPS`` steps timed unprofiled on
    one engine and profiled on another (one JSON line each, ``tags``
    added)."""
    def ready(eager):
        eng = make(cfg, params, prompts, False)
        with cs.mode(eager):
            while eng.queue or any(s.req is not None and s.prefilling for s in eng.slots):
                eng.step()
            eng.step()
        torch.cuda.synchronize()
        return eng

    for eager in (True, False):
        eng = ready(eager)
        t0 = time.perf_counter()
        with cs.mode(eager):
            for _ in range(DECODE_STEPS):
                eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del eng
        cs.free_device()
        eng = ready(eager)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with cs.mode(eager), torch.profiler.profile(activities=acts) as prof:
            for _ in range(DECODE_STEPS):
                eng.step()
            torch.cuda.synchronize()
        check_decode = [st.prefill_tokens for st in eng.step_stats[-DECODE_STEPS:]]
        if any(check_decode):
            raise RuntimeError(f"decode_profiles: a profiled step prefilled: {check_decode}")
        rec = {"tag": TAG, "run": "decode", "model": cfg.name, **tags,
               "mode": "eager" if eager else "graphed", "steps": DECODE_STEPS,
               "overflow_a_step": [st.expert_overflow for st in eng.step_stats[-DECODE_STEPS:]],
               **profile_record(prof, wall, DECODE_STEPS)}
        rec["k4_ms"] = sum(v for k, v in rec["families_ms"].items() if k.startswith("K4"))
        print(json.dumps(rec), flush=True)
        del eng
        cs.free_device()


@contextlib.contextmanager
def sampler_ranges():
    """The engine's sampler call (``scheduler.sample_rows``) inside a
    ``record_function("sample_rows")`` range, so that a trace files the
    sampler's kernels under it (an eager run's: a graph's replay runs no
    Python)."""
    from repro_torch.serve import scheduler

    sound = scheduler.sample_rows

    def ranged(*args):
        with torch.profiler.record_function("sample_rows"):
            return sound(*args)

    scheduler.sample_rows = ranged
    try:
        yield
    finally:
        scheduler.sample_rows = sound


def range_device_ms(prof, name: str) -> float:
    """Device ms of the kernels launched inside the host ranges ``name``
    (each range's kernels and its children's, as the profiler links them)."""
    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3


def sampled_profiles(cfg, params, prompts, seed: int, part: str) -> None:
    """``chip_smoke.py``'s 14c (``sampled_serve``: six sampled requests and
    two greedy, paged, unpacked and packed) or 14d (``spec_serve``: the
    same requests, paged unpacked, with ``NGramProposer`` and with the
    target drafting for itself, k = ``SPEC_K``), eager then graphed, each
    on an engine warmed on other tokens: the wall unprofiled, then the
    profiled run's record, with the sampler's share of the busy time and
    the proposer's share of the wall (its host time, the draft model's
    steps and their syncs included).  The sampler's device ms are read from
    the eager run's trace (``sampler_ranges``); the graphed run replays the
    same steps' programs, so its share is the eager run's sampler ms over
    its own busy time."""
    from repro_torch.serve import DraftModelProposer, NGramProposer, SpecConfig

    if part == "sampled_serve":
        runs = [("none", None, packed) for packed in (False, True)]
    else:
        runs = [("ngram", lambda: SpecConfig(NGramProposer(), k=cs.SPEC_K), False),
                ("self-draft", lambda: SpecConfig(
                    DraftModelProposer(params, cfg, cs.SLOTS, cs.MAX_LEN), k=cs.SPEC_K), False)]
    sampler = {}
    for name, spec, packed in runs:
        for eager in (True, False):
            def warm():
                eng = cs.spec_engine(cfg, params, [[(t + 1) % cfg.vocab_size for t in p]
                                                   for p in prompts], packed, True, seed,
                                     spec() if spec else None)
                with cs.mode(eager):
                    eng.run()
                eng.reset_stats()
                for i, p in enumerate(prompts):
                    eng.submit(cs.Request(uid=i, prompt=list(p), max_new_tokens=cs.NEW_TOKENS,
                                          sampling=cs.sampled_params(i, seed)))
                propose_s = [0.0]
                propose = eng._propose

                def timed_propose():
                    t0 = time.perf_counter()
                    out = propose()
                    propose_s[0] += time.perf_counter() - t0
                    return out

                eng._propose = timed_propose
                return eng, propose_s

            eng, propose_s = warm()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cs.mode(eager):
                eng.run()
            torch.cuda.synchronize()
            wall, n_steps = time.perf_counter() - t0, eng.steps
            proposer_share = propose_s[0] / wall
            del eng
            cs.free_device()
            eng, _ = warm()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with cs.mode(eager), sampler_ranges(), torch.profiler.profile(activities=acts) as prof:
                eng.run()
                torch.cuda.synchronize()
            rec = {"tag": TAG, "run": part, "proposer": name,
                   "layout": "packed" if packed else "unpacked",
                   "mode": "eager" if eager else "graphed", "steps": n_steps,
                   **profile_record(prof, wall, eng.steps)}
            del eng
            cs.free_device()
            if eager:
                sampler[name, packed] = range_device_ms(prof, "sample_rows")
            rec["sampler_ms"] = sampler[name, packed] or "not measured"
            rec["sampler_ms_from"] = "this run's trace" if eager else "the eager run's trace"
            rec["sampler_share_of_busy"] = (sampler[name, packed] / rec["device_busy_ms"]
                                            if sampler[name, packed] else "not measured")
            rec["proposer_share_of_wall"] = proposer_share if spec else 0.0
            rec["k4_ms"] = sum(v for k, v in rec["families_ms"].items() if k.startswith("K4"))
            print(json.dumps(rec), flush=True)


#: kept micro-batches a ``moe_microbatch_profile`` run times
MOE_MB_REPS = 4


def expert_ffn_ms(cfg, t: int) -> dict:
    """One MoE layer's expert products (``moe._expert_ffn``: gate, up, the
    activation, down) at the sort dispatch's (E, capacity, d) buffer of
    ``t`` tokens, bf16: the forward and its backward alone
    (``chip_smoke.grad_only_ms``), each one graph replay, L2 flushed."""
    from repro_torch.models import moe

    cap = max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    p = moe.init_moe(gen, cfg, device=cs.DEV)
    keys = sorted(k for k in p if k != "router")
    xe = torch.randn(cfg.n_experts, cap, cfg.d_model, generator=gen, device=cs.DEV).to(
        torch.bfloat16)
    leaves = tuple(x.detach().requires_grad_() for x in (xe, *(p[k] for k in keys)))

    def fwd(x, *ws):
        return moe._expert_ffn(dict(zip(keys, ws)), x, cfg)

    with torch.no_grad():
        fwd_ms = cs.time_ms(lambda: fwd(*leaves))
    return {"fwd_ms": fwd_ms, "bwd_ms": cs.grad_only_ms(fwd, leaves, torch.ones_like(xe)),
            "capacity": cap}


def repeated_profile(fn, reps: int, eager: bool) -> dict:
    """``fn`` called ``reps`` times, eager or graphed (after one call that
    builds and captures): the wall a call on the host clock, then the
    ``profile_record`` of ``reps`` calls under the profiler with its device
    ms, kernels and launches divided to one call."""
    with cs.mode(eager):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    rec = {"mode": "eager" if eager else "graphed", **profile_record(prof, wall, reps)}
    for key in ("families_ms", "families_launches", "top_kernels_ms"):
        rec[key] = {k: v / reps for k, v in rec[key].items()}
    rec["wall_ms"], rec["device_busy_ms"] = rec["wall_ms"] / reps, rec["device_busy_ms"] / reps
    return rec


def microbatch_profile(cfg, params, mb: dict, eager: bool, reps: int) -> dict:
    """One kept micro-batch ``mb`` of ``cfg`` from ``params``:
    ``core.Accumulator.add`` (forward, backward, K1 into sums of the
    masters' dtypes), profiled by ``repeated_profile``."""
    from repro_torch.core import Accumulator
    from repro_torch.core.engine import make_grad_fn
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import tree_leaves

    compute = model_lib.train_params(params, cfg)
    grad_fn = make_grad_fn(lambda p, b: model_lib.loss_fn(p, cfg, b))
    acc = Accumulator(grad_fn, compute, [p.dtype for p in tree_leaves(params)])
    rec = repeated_profile(lambda: acc.add(mb), reps, eager)
    del acc, compute
    cs.free_device()
    return rec


def moe_microbatch_profile(name: str, seed: int, eager: bool) -> dict:
    """One kept micro-batch of ``chip_smoke.py``'s phase 18c (the model at
    full width, ``MOE_TRAIN_LAYERS`` layer, bf16; its first micro-batch of
    one ``MOE_TRAIN_SEQ`` sequence), ``MOE_MB_REPS`` times
    (``microbatch_profile``): device time by family a micro-batch (the
    dispatch's sort apart from its index / scatter / gather), idle share,
    host launches.  The expert products are timed apart at the dispatch's
    buffer (``expert_ffn_ms``), times the layers and the remat forward."""
    from repro_torch.data import microbatches_at

    cfg = cs.moe_config(name, cs.MOE_TRAIN_LAYERS)
    seq = cs.MOE_TRAIN_SEQ[name]
    data, _, _, _ = cs.train_setup(cfg, seed, 1, seq)
    mbs = microbatches_at(0, data, cs.TRAIN_WORKERS * cs.TRAIN_MB)
    mb = {"tokens": torch.from_numpy(mbs["tokens"][0]).to(cs.DEV, torch.long),
          "weights": torch.from_numpy(mbs["weights"][0]).to(cs.DEV)}
    params = init_params(cfg, seed=seed, device=cs.DEV)
    rec = {"tag": TAG, "run": "moe_train", "model": cfg.name, "tokens": seq,
           **microbatch_profile(cfg, params, mb, eager, MOE_MB_REPS)}
    del params
    cs.free_device()
    ex = expert_ffn_ms(cfg, seq)
    rec["expert_ffn"] = ex
    rec["expert_gemms_ms"] = cfg.n_layers * (ex["fwd_ms"] * (2 if cfg.remat else 1) + ex["bwd_ms"])
    rec["other_cublas_ms"] = rec["families_ms"].get("matmul (cuBLAS)", 0.0) - rec["expert_gemms_ms"]
    return rec


#: calls a whisper profile times and profiles
WHISPER_REPS = 10


def whisper_serve_profiles(seed: int) -> None:
    """``chip_smoke.py``'s phase 19b run (whisper-tiny at full width and
    depth, bf16 compute copy; its 8 requests of 1,500 frames): one batched
    ``encode`` (a direct call, as the serving path makes it, K3's forward
    at 8 x 6 x 1,500), then one decode step through ``make_serve_step``
    at the last position, eager and graphed; ``WHISPER_REPS`` calls each
    (``repeated_profile``), one JSON line each."""
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib

    cfg = cs.whisper_config()
    params = compute_params(init_params(cfg, seed=seed, device=cs.DEV), cfg)
    frames = cs.whisper_frames(cfg, seed, cs.W_REQUESTS).to(cs.DEV)
    first = cs.whisper_tokens(cfg, seed, (cs.W_REQUESTS, 1), offset=1).to(cs.DEV)
    rec = repeated_profile(lambda: model_lib.encode(params, cfg, frames), WHISPER_REPS, True)
    rec["mode"] = "eager (the serving path's own: no graph)"
    print(json.dumps({"tag": TAG, "run": "whisper_encode", "requests": cs.W_REQUESTS,
                      **rec}), flush=True)
    cache = model_lib.init_decode_cache(params, cfg, cs.W_REQUESTS, cs.W_NEW,
                                        enc_out=model_lib.encode(params, cfg, frames))
    pos = np.full(cs.W_REQUESTS, cs.W_NEW - 1, np.int64)
    for eager in (True, False):
        step = steps.make_serve_step(cfg)
        rec = repeated_profile(lambda: step(params, cache, first, pos), WHISPER_REPS, eager)
        print(json.dumps({"tag": TAG, "run": "whisper_decode_step",
                          "requests": cs.W_REQUESTS, **rec}), flush=True)
        del step
        cs.free_device()


def whisper_train_profiles(seed: int) -> None:
    """One kept micro-batch of ``chip_smoke.py``'s phase 19c (whisper-tiny
    at full width and depth, f32 masters, 16 x (1,500 frames + 448
    tokens)), eager and graphed (``microbatch_profile``), one JSON line
    each."""
    cfg = cs.whisper_config()
    mb = cs.whisper_batch(cfg, seed, 0, cs.W_MB_SEQS)
    params = init_params(cfg, seed=seed, device=cs.DEV)
    for eager in (True, False):
        rec = microbatch_profile(cfg, params, mb, eager, WHISPER_REPS)
        rec["k3_ms"] = sum(v for k, v in rec["families_ms"].items() if k.startswith("K3"))
        print(json.dumps({"tag": TAG, "run": "whisper_train", "sequences": cs.W_MB_SEQS,
                          **rec}), flush=True)


#: kept micro-batches a VLM training profile times and profiles
VLM_MB_REPS = 4


def vlm_train_profiles(seed: int) -> None:
    """One kept micro-batch of ``chip_smoke.py``'s phase 20c (internvl2-1b at
    full width and depth, f32 masters, its step 0's first micro-batch of 4 x
    (256 patch rows + 1,792 tokens)), eager and graphed
    (``microbatch_profile``), one JSON line each."""
    cfg = cs.vlm_config()
    mb = cs.vlm_batch(cfg, seed, 0, cs.V_MB_SEQS)
    params = init_params(cfg, seed=seed, device=cs.DEV)
    for eager in (True, False):
        rec = microbatch_profile(cfg, params, mb, eager, VLM_MB_REPS)
        rec["k3_ms"] = sum(v for k, v in rec["families_ms"].items() if k.startswith("K3"))
        print(json.dumps({"tag": TAG, "run": "vlm_train", "model": cfg.name,
                          "sequences": cs.V_MB_SEQS, **rec}), flush=True)


TAG = ""
PARTS = ("kernels", "k6_precision", "k4_builds", "opt_step", "qwen", "mamba", "train",
         "localsgd", "dp", "mamba_train", "bert_train", "rg_serve", "rg_train", "sampled_serve",
         "spec_serve", "zoo_serve", "moe_serve", "moe_train", "whisper_serve", "whisper_train",
         "vlm_serve", "vlm_train")
#: the parts that time one piece alone (kernels, the optimizer step), run
#: only when named
KERNEL_PARTS = ("kernels", "k6_precision", "k4_builds", "opt_step")


#: K6's (sequences, chunks, rows) at the mamba serving run's decode and
#: 64-token steps, at a full 256-row chunk, and at the Mamba-2 training
#: micro-batch (4 sequences of 8 chunks of 256); its backward at the last
#: and at 64-row chunks
SSD_CHUNK_SHAPES = {"decode": (8, 1, 16), "serve": (8, 1, 64), "chunk256": (8, 1, 256),
                    "train": (4, 8, 256)}
SSD_BWD_SHAPES = {"train": (4, 8, 256), "train64": (4, 8, 64)}


def ssd_times(rng) -> dict:
    """K6 and K5 alone (us, graph replay, L2 flushed) at the mamba serving
    and training shapes, and K6's backward at the training shapes, through
    calls that every checkout's ``chip_smoke.py`` has since K6's backward
    was ported (PR 20), so a parent tree is timed the same way."""
    out = {}
    for name, (bs, nc, l) in SSD_CHUNK_SHAPES.items():
        a = cs.ssd_chunk_scenario(rng, bs, nc, l)
        out[f"k6_{name}"] = cs.time_ms(lambda: cs.ssd_chunk.ssd_chunk(*a)) * 1e3
    for name, (bs, nc, l) in SSD_BWD_SHAPES.items():
        a, y, dy = cs.ssd_bwd_scenario(rng, bs, nc, l)
        out[f"k6_bwd_{name}"] = cs.time_ms(lambda: cs.ssd_chunk.ssd_chunk_bwd(*a, y, dy)) * 1e3
    for name, seg in (("mixed", cs.K5_MIXED), ("decode", cs.K5_DECODE)):
        a = cs.ssd_segment_scenario(rng, seg)
        out[f"k5_{name}"] = cs.time_ms(lambda: cs.ssd_chunk.ssd_segment(*a)) * 1e3
    return out


def ssd_digests(seed: int) -> dict:
    """sha256 of K6's and K5's outputs (forward) at the shapes ``ssd_times``
    times, on inputs from their own stream (``seed`` + 1), so that two
    trees' digests are equal exactly when their kernels give the same
    bits."""
    import hashlib

    rng = np.random.default_rng(seed + 1)
    outs = {}
    for name, (bs, nc, l) in SSD_CHUNK_SHAPES.items():
        outs[f"k6_{name}"] = cs.ssd_chunk.ssd_chunk(*cs.ssd_chunk_scenario(rng, bs, nc, l))
    for name, seg in (("mixed", cs.K5_MIXED), ("decode", cs.K5_DECODE)):
        outs[f"k5_{name}"] = cs.ssd_chunk.ssd_segment(*cs.ssd_segment_scenario(rng, seg))
    torch.cuda.synchronize()
    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16] for k, v in outs.items()}


def k3_digests(seed: int) -> dict:
    """sha256 of K3's forward (out, lse) and backward (dq, dk, dv) outputs
    at the qwen training shape (``chip_smoke.attn_inputs``, causal), on
    inputs from their own stream (``seed`` + 2), and (``d64_``) of its
    (64, 1) build at bert-1.5b's micro-batch, bidirectional: two trees'
    digests are equal exactly when their builds give the same bits."""
    import hashlib

    rng = np.random.default_rng(seed + 2)
    outs = {}
    builds = [("", cs.attn_inputs(rng), True)]
    if hasattr(cs, "bert_attn_inputs"):  # the (64, 1) bidirectional build at bert-1.5b's
        builds.append(("d64_", cs.bert_attn_inputs(rng, 16, 25, 128), False))
    for tag, (q, k, v, do), causal in builds:
        out, lse = cs.flash_attention.flash_attention_fwd(q, k, v, causal=causal)
        grads = cs.flash_attention.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        outs.update(zip((tag + n for n in ("out", "lse", "dq", "dk", "dv")), (out, lse, *grads)))
    torch.cuda.synchronize()
    return {name: hashlib.sha256(x.float().cpu().numpy().tobytes()).hexdigest()[:16]
            for name, x in outs.items()}


def k4_digests(seed: int, dims=None, window: int = 0) -> dict:
    """sha256 of K4's outputs over a decode and a mixed step
    (``chip_smoke.decode_scenario`` / ``paged_scenario`` at ``dims``,
    qwen2.5-3b's by default, the wrapper's own plan), bf16 and int8 pools,
    on inputs from their own stream (``seed`` + 3): two trees' digests are
    equal exactly when their builds give the same bits."""
    import hashlib

    rng = np.random.default_rng(seed + 3)
    lens = [int(n) for n in rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1, cs.SLOTS)]
    outs = {}
    for name, a in (("decode", cs.decode_scenario(rng, lens, dims=dims)),
                    ("mixed", cs.paged_scenario(rng, lens, [cs.CHUNK] * 4 + [1] * 4, dims=dims))):
        outs[name] = cs.flash_attention.paged_flash_attention(**a, window=window)
        kq, ks = cs._paged_quantize(a["k_pool"])
        vq, vs = cs._paged_quantize(a["v_pool"])
        outs[f"{name}_int8"] = cs.flash_attention.paged_flash_attention(
            **dict(a, k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs), window=window)
    torch.cuda.synchronize()
    return {k: hashlib.sha256(v.float().cpu().numpy().tobytes()).hexdigest()[:16]
            for k, v in outs.items()}


#: K4's builds for the dense and 'R' models at their widths: (head dim, group, KV
#: heads, window, slot blocks) of qwen2.5-3b, recurrentgemma-2b, gemma3-27b's
#: local layers and starcoder2-7b
K4_BUILDS = ((128, 8, 2, 0, 34), (256, 10, 1, 2048, 147), (128, 2, 16, 1024, 77),
             (128, 9, 4, 0, 34))


def k4_builds(seed: int) -> dict:
    """Each of ``K4_BUILDS`` at a decode and a mixed step: its digests
    (``k4_digests``) and its time (``chip_smoke.k4_timing``, us, at the
    digests' prompt lengths)."""
    rec = {"tag": TAG, "run": "k4_builds"}
    for d, g, kv, window, blocks in K4_BUILDS:
        dims = (kv * g, kv, d, blocks)
        rng = np.random.default_rng(seed + 3)
        lens = [int(n) for n in rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1, cs.SLOTS)]
        t = cs.k4_timing(rng, lens, dims=dims, window=window)
        rec[f"{d},{g}"] = {"digests": k4_digests(seed, dims, window),
                           "us": {shape: round(r["ms"] * 1e3, 2) for shape, r in t.items()}}
    return rec


def kernel_times(seed: int) -> dict:
    """``chip_smoke.py``'s K4, K2, K2-backward and K3 timings (the checks
    inside them included) at its main-path shapes, from a stream seeded as
    its run's, then K6 and K5 (``ssd_times``) and the digests of K4's
    (128, 8), K6's, K5's and K3's outputs (``k4_digests``, ``ssd_digests``,
    ``k3_digests``); with a ``chip_smoke.py`` that has phase 12, K4's
    (256, 10) build at recurrentgemma's decode and mixed steps too."""
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1, cs.SLOTS)]
    k4 = cs.k4_timing(rng, lens)
    k2 = cs.k2_timing(rng)
    _, k2b = cs.k2_bwd_checks_and_timing(rng)
    k3f, k3b = cs.k3_timing(rng)
    rec = {"tag": TAG, "run": "kernels", "k4": k4, "k2": k2, "k2_bwd": k2b,
           "k3": {"fwd": k3f, "bwd": k3b}, "ssd_us": ssd_times(rng),
           "k4_digests": k4_digests(seed), "ssd_digests": ssd_digests(seed),
           "k3_digests": k3_digests(seed)}
    if hasattr(cs, "RG_DIMS"):
        rg_lens = cs.rg_requests(get_config("recurrentgemma_2b"), seed)[0][:cs.SLOTS]
        rec["k4_d256_g10"] = cs.k4_timing(rng, rg_lens, dims=cs.RG_DIMS, window=cs.RG_WINDOW)
    if (256, 10) in cs.flash_attention.TRAINED:  # the tree trains the 'R' family
        k3f, k3b = cs.k3_rg_timing(rng)
        rec["k3_d256_g10"] = {"fwd": k3f, "bwd": k3b}
    return rec


def rg_mixer_shares(cfg, params, seed: int) -> dict:
    """Device time (graph replay, L2 flushed, us) of one recurrentgemma-2b
    step at each of the engine's four step shapes (unpacked decode (8, 1)
    and mixed (8, 64); packed decode 8 and mixed 257: four prefill chunks
    of 256 tokens in all and four decodes), over a paged cache whose 8 slots hold 300 positions
    each; beside it one 'R' layer's RG-LRU mixer (``rglru.apply_rglru``, a
    layer's input in its carried state) and that mixer's three products
    alone.  ``mixers_rest_share``: the part of the step the 18 mixers take
    besides their products (conv, gates, scan, output gate), the work a
    fused gates-and-scan kernel would take over."""
    from repro_torch.models import rglru
    from repro_torch.models.model import chunk_plans, packed_plans, packed_prefill, prefill_chunk
    from repro_torch.models.recurrent import packed_step
    from repro_torch.models.transformer import tree_map

    rng = np.random.default_rng(seed + 4)
    n_r = cfg.pattern.count("R")
    layer = tree_map(lambda t: t[0], params["stack"]["groups"][cfg.layer_pattern.index("R")])
    p = layer["rglru"]
    kv = cs.KVCacheSpec(num_slots=cs.SLOTS, max_len=cs.RG_MAX_LEN, layout="paged",
                        page_size=cs.PAGE).build(params, cfg)
    ctx = 300
    for i in range(cs.SLOTS):
        kv.admit_slot(i, [1] * ctx, cs.CHUNK)
        kv.prepare_write(i, 0, ctx + cs.CHUNK)
    state = kv.state
    cache = {k: v.clone() for k, v in rglru.init_rglru_cache(cfg, cs.SLOTS, device="cuda").items()}
    out = {}
    for name, packed, c in (("unpacked_decode", False, 1), ("unpacked_mixed", False, cs.CHUNK),
                            ("packed_decode", True, 1), ("packed_mixed", True, cs.CHUNK)):
        if packed:
            # the budget's 256 tokens: three chunks, a 60-token one, four decodes
            spans = [c] * 3 + [c - 4] + [1] * 4 if c > 1 else [1] * cs.SLOTS
            cap = cs.BUDGET + 1 if c > 1 else cs.SLOTS
            lay = cs.pack_step([(i, ctx, [1] * n) for i, n in enumerate(spans)], cap)
            plans = packed_plans(cfg, state, lay.slot_ids, lay.positions)
            plans = {k: torch.as_tensor(v, device="cuda") for k, v in plans.items()}
            toks, slots, pos = (torch.as_tensor(x, device="cuda").long()
                                for x in (lay.tokens, lay.slot_ids, lay.positions))
            info = packed_step(slots, cs.SLOTS, cfg.rglru_conv)
            x = torch.randn(1, cap, cfg.d_model, device="cuda").to(cfg.compute_dtype)
            args = ((params, cfg, state, toks, slots, pos), dict(plans=plans),
                    dict(slot_ids=slots, step=info))
            run = packed_prefill
        else:
            pos_np = np.full(cs.SLOTS, ctx, np.int64)
            lens_np = np.full(cs.SLOTS, c, np.int64)
            plans = chunk_plans(cfg, state, pos_np, lens_np, c)
            plans = {k: torch.as_tensor(v, device="cuda") for k, v in plans.items()}
            toks = torch.ones((cs.SLOTS, c), dtype=torch.long, device=cs.DEV)
            pos, lens = (torch.as_tensor(v, device="cuda") for v in (pos_np, lens_np))
            x = torch.randn(cs.SLOTS, c, cfg.d_model, device="cuda").to(cfg.compute_dtype)
            args = ((params, cfg, state, toks, pos, lens), dict(plans=plans),
                    dict(seq_lens=lens))
            run = prefill_chunk
        y = torch.randn(*x.shape[:2], p["w_out"].shape[0], device="cuda").to(cfg.compute_dtype)
        step_args, step_kw, mixer_kw = args

        def step():
            return run(*step_args, **step_kw)

        def mixer():
            return rglru.apply_rglru(p, x, cfg, cache, **mixer_kw)

        def products():
            return x @ p["w_branch"], x @ p["w_gate_branch"], y @ p["w_out"]

        rec = {k: cs.time_ms(f, iters=20) * 1e3
               for k, f in (("step_us", step), ("mixer_us", mixer), ("products_us", products))}
        rec["mixers_rest_share"] = n_r * (rec["mixer_us"] - rec["products_us"]) / rec["step_us"]
        out[name] = rec
    return {"tag": TAG, "run": "rg_mixer", "model": cfg.name, "r_layers": n_r, **out}


def rg_train_mixer_share(cfg, seed: int, rec: dict) -> dict:
    """One 'R' layer's RG-LRU mixer at the training micro-batch (1 x 8,192
    tokens of d 2,560), beside ``rec`` (``train_profile``'s graphed record
    of phase 13c's step 1): the mixer's forward (graph replay, L2 flushed),
    its backward alone (``grad_only_ms``: x and every mixer leaf), and its
    three products' forward.  A kept micro-batch runs each of the 18
    mixers' forward twice (remat) and its backward once, so
    ``mixers_share`` = 18 (2 fwd + bwd) over the micro-batch's device busy
    ms; ``mixers_rest_share`` takes out the products, each product's
    backward counted as two products of its size (conv, gates, scan and
    output gate: the work a fused gates-and-scan kernel would take over)."""
    from repro_torch.models import rglru

    g = torch.Generator(device="cuda").manual_seed(seed)
    block = compute_params(rglru.init_rglru(g, cfg, device="cuda"), cfg)  # one layer's mixer
    names = sorted(block)
    vals = [block[k].detach().requires_grad_() for k in names]
    x = torch.randn(1, cs.RG_TRAIN_SEQ, cfg.d_model, device="cuda", generator=g).to(
        cfg.compute_dtype).requires_grad_()
    dy = torch.randn(x.shape, device="cuda", generator=g).to(cfg.compute_dtype)
    p = dict(zip(names, vals))

    def mixer(xx, *vv):
        return rglru.apply_rglru(dict(zip(names, vv)), xx, cfg)[0]

    def products():
        u = x @ p["w_branch"]
        return u, x @ p["w_gate_branch"], u @ p["w_out"]

    with torch.no_grad():
        fwd = cs.time_ms(lambda: mixer(x, *vals), iters=10)
        prod = cs.time_ms(products, iters=10)
    bwd = cs.grad_only_ms(mixer, (x, *vals), dy)
    n_r = cfg.pattern.count("R")
    mb_ms = rec["device_busy_ms"] / rec["kept_microbatches"]
    mixers = n_r * (2 * fwd + bwd)
    return {"tag": TAG, "run": "rg_train_mixer", "model": cfg.name, "r_layers": n_r,
            "mixer_fwd_ms": fwd, "mixer_bwd_ms": bwd, "products_fwd_ms": prod,
            "microbatch_busy_ms": mb_ms, "mixers_share": mixers / mb_ms,
            "mixers_rest_share": (mixers - n_r * 4 * prod) / mb_ms}


#: K6's backward's two precision choices, each undone by one edit of a copy
#: of its source: ``__expf`` (ex2.approx) back to ``expf``, and its 3xTF32
#: splits by truncation back to rounding (``cvt.rna``, the forward's split)
K6_BWD_PRECISE = {
    "expf": [("= __expf(rt > 0", "= expf(rt > 0")],
    "rounded": [("  hi = __float_as_uint(v);\n"
                 "  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));\n",
                 "  split(v, hi, lo);\n")],
}
K6_BWD_PRECISE["both"] = K6_BWD_PRECISE["expf"] + K6_BWD_PRECISE["rounded"]


@contextlib.contextmanager
def ssd_source(name: str):
    """``ssd_chunk``'s wrappers built from and launching ``name`` (a file in
    the kernel directory) instead of ``ssd_chunk.cu``."""
    sound = cs.ssd_chunk.SOURCE
    cs.ssd_chunk.SOURCE = name
    try:
        yield
    finally:
        cs.ssd_chunk.SOURCE = sound


def k6_bwd_precision(seed: int) -> dict:
    """K6's backward from ``ssd_chunk.cu`` beside copies of it with one or
    both of its precision choices undone (``K6_BWD_PRECISE``; the copies
    built together, removed after): each one's errors against the plain
    version (``chip_smoke.ssd_bwd_errs``: dx by row, the rest by norm) and
    its time (graph replay, L2 flushed) at 4 x 8 x 256 and 4 x 8 x 64, in
    turns: the source, each copy, each copy again in reverse, the source."""
    import concurrent.futures

    from repro_torch.kernels import _build

    text = (_build.KERNEL_DIR / cs.ssd_chunk.SOURCE).read_text()
    files = {"source": cs.ssd_chunk.SOURCE}
    for name, edits in K6_BWD_PRECISE.items():
        copy = text
        for old, new in edits:
            if copy.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {cs.ssd_chunk.SOURCE} once")
            copy = copy.replace(old, new)
        files[name] = f"_precise_{name}.cu"
        (_build.KERNEL_DIR / files[name]).write_text(copy)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(files)) as pool:
            list(pool.map(_build.load, files.values()))
        rng = np.random.default_rng(seed)
        order = ["source", *K6_BWD_PRECISE, *reversed(K6_BWD_PRECISE), "source"]
        rows = {}
        for bs, nc, l in SSD_BWD_SHAPES.values():
            a, y, dy = cs.ssd_bwd_scenario(rng, bs, nc, l)
            want = cs.ref.ssd_chunk_bwd_ref(*a, dy)
            row = {name: {"us": []} for name in files}
            for name in order:
                with ssd_source(files[name]):
                    got = cs.ssd_chunk.ssd_chunk_bwd(*a, y, dy)
                    row[name]["errs"] = cs.ssd_bwd_errs(got, want)
                    row[name]["us"].append(
                        cs.time_ms(lambda: cs.ssd_chunk.ssd_chunk_bwd(*a, y, dy)) * 1e3)
            rows[f"{bs}x{nc}x{l}"] = row
            del a, y, dy, want, got
    finally:
        for name in K6_BWD_PRECISE:
            (_build.KERNEL_DIR / files[name]).unlink(missing_ok=True)
    return {"tag": TAG, "run": "k6_precision", "rows": rows}


#: (config, optimizer) of the step tails ``opt_step_times`` times: phase
#: 11c's two BERT runs at their full depth
OPT_STEP_RUNS = (("bert_1_5b", "lans"), ("bert_large", "lamb"))


def opt_step_times(seed: int, steps: int = 4) -> dict:
    """The training step's optimizer tail on one device: ``opt.step`` as
    ``launch.steps.TrainStep`` calls it (each gradient sum read in f32 over
    the denominator, times the clip factor, a slice at a time) over each
    model of ``OPT_STEP_RUNS`` at its full depth, from random f32 gradient
    sums.  Per model, each step's device ms (CUDA events around the step;
    the device waits on the host's launches inside it), its host ms, and
    the peak allocated above the trees (GiB); the first step is a warm-up,
    reported apart."""
    out = {"tag": TAG, "run": "opt_step"}
    for name, opt_name in OPT_STEP_RUNS:
        cfg = get_config(name)
        params = init_params(cfg, seed=seed, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        grads = tree_unflatten(params, [torch.randn(p.shape, generator=gen, device="cuda")
                                        for p in tree_leaves(params)])
        opt = make_opt(opt_name, 1e-4)
        state = opt.init(params)
        denom = torch.tensor(48.0, device="cuda")
        scale = torch.tensor(0.5, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        device_ms, host_ms = [], []
        for _ in range(steps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            opt.step(grads, state, params, prep=lambda g: g.float() / denom * scale)
            b.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(a.elapsed_time(b))
        out[name] = {"optimizer": opt_name, "n_layers": cfg.n_layers,
                     "parameters": sum(p.numel() for p in tree_leaves(params)),
                     "leaves": len(tree_leaves(params)), "warmup_device_ms": device_ms[0],
                     "device_ms": device_ms[1:], "host_ms": host_ms[1:],
                     "peak_above_trees_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
        del params, grads, state, opt
        cs.free_device()
    return out


def main() -> int:
    global TAG
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", choices=PARTS,
                    default=[p for p in PARTS if p not in KERNEL_PARTS],
                    help="parts to run, always in the order kernels, k6_precision, k4_builds, "
                         "opt_step, qwen, mamba, train, localsgd, dp, mamba_train, bert_train, rg_serve, "
                         "rg_train, sampled_serve, spec_serve, zoo_serve, moe_serve, moe_train, "
                         "whisper_serve, whisper_train, vlm_serve, vlm_train (default: all but "
                         "the first four)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    TAG = args.tag
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cfg = get_config("qwen2_5_3b")
    for part in [p for p in PARTS if p in args.only]:
        if part == "kernels":
            print(json.dumps(kernel_times(args.seed)), flush=True)
        elif part == "k6_precision":
            print(json.dumps(k6_bwd_precision(args.seed)), flush=True)
        elif part == "k4_builds":
            print(json.dumps(k4_builds(args.seed)), flush=True)
        elif part == "opt_step":
            print(json.dumps(opt_step_times(args.seed)), flush=True)
        elif part == "qwen":
            rng = np.random.default_rng(args.seed)
            lens = [int(n) for n in rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1, cs.SLOTS)]
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
            params = compute_params(init_params(cfg, seed=args.seed, device="cuda"), cfg)
            serve_profiles(cfg, params, prompts, cs.engine)
        elif part in ("sampled_serve", "spec_serve"):  # phase 14c / 14d's engines
            rng = np.random.default_rng(args.seed)
            lens = [int(n) for n in rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1, cs.SLOTS)]
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
            params = compute_params(init_params(cfg, seed=args.seed, device="cuda"), cfg)
            sampled_profiles(cfg, params, prompts, args.seed, part)
            del params
            cs.free_device()
        elif part == "mamba":
            mcfg = get_config("mamba2_130m")
            _, mprompts = cs.mamba_requests(mcfg, args.seed)
            params = compute_params(init_params(mcfg, seed=args.seed, device="cuda"), mcfg)
            serve_profiles(mcfg, params, mprompts,
                           lambda c, p, pr, packed: cs.mamba_engine(c, p, pr, "paged", packed))
        elif part == "dp":  # one graphed step of phase 9a
            print(json.dumps(train_profile(cfg, args.seed, False, mesh="1")), flush=True)
        elif part == "mamba_train":  # phase 10's step 1, eager then graphed
            mcfg = get_config("mamba2_130m")
            for eager in (True, False):
                print(json.dumps(train_profile(mcfg, args.seed, eager, seqs=cs.M_TRAIN_SEQS)),
                      flush=True)
                cs.free_device()
        elif part == "rg_serve":  # phase 12c's serving runs, then the mixers' share
            rcfg = get_config("recurrentgemma_2b")
            _, rprompts = cs.rg_requests(rcfg, args.seed)
            params = compute_params(init_params(rcfg, seed=args.seed, device="cuda"), rcfg)
            serve_profiles(rcfg, params, rprompts, cs.rg_engine)
            print(json.dumps(rg_mixer_shares(rcfg, params, args.seed)), flush=True)
        elif part == "zoo_serve":  # phase 15's gemma3-27b serving runs
            gcfg = cs.zoo_config("gemma3_27b")
            _, gprompts = cs.zoo_requests(gcfg, args.seed, cs.ZOO.index("gemma3_27b"))
            params = init_params(gcfg, seed=args.seed, device="cuda")
            serve_profiles(gcfg, params, gprompts, cs.zoo_engine)
        elif part == "moe_serve":  # phase 17b's mixtral-8x22b decode steps, both dispatches
            mcfg = cs.moe_config("mixtral_8x22b")
            _, mprompts = cs.zoo_requests(mcfg, args.seed,
                                          len(cs.ZOO) + cs.MOE.index("mixtral_8x22b"))
            params = init_params(mcfg, seed=args.seed, device="cuda")
            for cf in (None, mcfg.capacity_factor):
                decode_profiles(mcfg, params, mprompts[-cs.SLOTS:],
                                lambda c, p, pr, pk, cf=cf: cs.zoo_engine(c, p, pr, pk,
                                                                          capacity_factor=cf),
                                dispatch="dense" if cf is None else f"capacity {cf}")
        elif part == "moe_train":  # one kept micro-batch of phase 18c, each model
            for name in cs.MOE:
                for eager in (True, False):
                    print(json.dumps(moe_microbatch_profile(name, args.seed, eager)), flush=True)
                    cs.free_device()
        elif part == "whisper_serve":  # phase 19b: an encode, a decode step
            whisper_serve_profiles(args.seed)
        elif part == "whisper_train":  # phase 19c: one kept micro-batch
            whisper_train_profiles(args.seed)
        elif part == "vlm_serve":  # phase 20b's internvl2-1b decode steps, text-only
            vcfg = cs.vlm_config()
            _, vprompts = cs.vlm_requests(vcfg, args.seed)
            params = compute_params(init_params(vcfg, seed=args.seed, device="cuda"), vcfg)
            decode_profiles(vcfg, params, vprompts, cs.zoo_engine)
        elif part == "vlm_train":  # phase 20c: one kept micro-batch
            vlm_train_profiles(args.seed)
        elif part == "rg_train":  # phase 13c's step 1, eager then graphed; the mixers' share
            rcfg = get_config("recurrentgemma_2b")
            recs = {}
            for eager in (True, False):
                recs[eager] = train_profile(rcfg, args.seed, eager, run="rg_train",
                                            shape=dict(seq=cs.RG_TRAIN_SEQ))
                print(json.dumps(recs[eager]), flush=True)
                cs.free_device()
            print(json.dumps(rg_train_mixer_share(rcfg, args.seed, recs[False])), flush=True)
        elif part == "bert_train":  # phase 11c's step 1, eager then graphed
            bcfg = get_config("bert_1_5b")
            shape = dict(seq=cs.BERT_SEQ, mb=cs.BERT_MB)
            for eager in (True, False):
                print(json.dumps(train_profile(bcfg, args.seed, eager, seqs=cs.BERT_SEQS,
                                               run="bert_train", shape=shape,
                                               optimizer="lans")), flush=True)
                cs.free_device()
        else:
            prof = train_profile if part == "train" else localsgd_profile
            for eager in (True, False):
                print(json.dumps(prof(cfg, args.seed, eager)), flush=True)
                cs.free_device()
        params = None
        cs.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
