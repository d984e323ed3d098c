#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failed check raises and the script exits non-zero
without printing a result:

1. device — the card's name and power limit (``nvidia-smi``); fails
   without CUDA;
2. build — the four CUDA sources, ``paged_attention.cu``,
   ``flash_attention.cu``, ``ssd_chunk.cu`` and ``rmsnorm_bwd.cu``
   (``nvcc``, sm_90a, the builds started together; ptxas's registers and
   spills of the K3, K4 and K2-backward kernels printed), and the Triton
   kernels' JIT, with their build seconds;
3. kernels — each kernel against its plain PyTorch version on the card at
   qwen2.5-3b widths, timed by CUDA-graph replay with L2 flushed, beside
   its bound, its plain version's time and, where one PyTorch call computes
   the same function, that call's time:
   * paged attention (K4): bf16 and int8 pools, window, softcap, hostile
     tables, padding and fully masked queries, the decode step's grid split
     many ways, a prefill-sized grid; the tile plan passed or made by the
     wrapper; a planted fault (a tile's last page skipped) must fail the
     same check;
   * RMSNorm (K2): d = 2048, both modes, bf16 and f32, row counts on and
     off the block, timed at serving's and training's shapes; its backward
     at the training shape (2048 x 2048): two runs bit-identical, and a
     planted fault (one CTA's rows left out of dscale) must fail the f32
     check; timed beside ``F.rms_norm``'s backward alone (graph-captured);
   * flash attention (K3), forward and backward, at the training shape
     (B 1, H 16, KV 2, S 2048, D 128, bf16, causal), with a window and with
     segment ids (queries without a key: the TPU kernel's visited-range
     mean), row by row; a planted fault must fail the same check; the
     backward also timed launch by launch (delta, dK/dV partials, group
     sum, dQ) beside SDPA's backward alone; ptxas's registers and spills
     of each K3 kernel are printed with the build;
   * masked accumulation (K1) on the largest leaf (36 x 2048 x 11008, bf16
     gradients), keep 0 and 1;
   * the SSD terms at mamba2-130m's widths (24 heads of 64, state 128,
     f32), row by row: K6 (intra-chunk) over 8 rows of one and of two
     256-token chunks and at the serving run's 64-row steps, K5
     (segment-masked) at the packed mixed capacity (257: decodes, prefill
     chunks, padding) and the packed decode capacity (8); each check also
     against a planted fault it must reject (K6's diagonal key tile
     skipped; K5's segment mask dropped);
4. serving — qwen2.5-3b at full width (36 layers, random weights from
   ``--seed``) through ``ContinuousBatcher(cache="paged", chunk_size=64,
   token_budget=256)``, unpacked then packed, 8 requests of 128-512 prompt
   tokens and 32 new tokens each; the launch counters must show 36
   paged-attention and 73 RMSNorm launches per engine step, and the first
   prefill step's logits must agree with the dense-cache engine's plain
   attention;
5. Mamba-2 serving — mamba2-130m at full width and depth (24 layers,
   d_model 768, random weights from ``--seed``, f32 master and bf16 compute
   copy) through ``ContinuousBatcher(chunk_size=64, token_budget=256)`` on
   the dense-slot and the paged layout, unpacked then packed, 8 requests of
   128-512 prompt tokens and 32 new tokens each: full-length streams, no
   prefix-shared tokens, no leaked pages, and the launch counters the code
   implies (one K6 per layer per dense step, one K5 per layer per packed
   step, 25 RMSNorms per step); first, a 2-layer full-width model's first
   dense and first packed step on the card (kernels, bf16) must give logits
   within a stated limit of the CPU's (plain versions, f32), and a planted
   K6 or K5 fault must fall outside it; last, the dense decode step's
   device time with the port's 64-row chunk against the reference's
   256-row padding, and the packed-vs-unpacked agreement in f32;
6. training — qwen2.5-3b at 36 layers through ``repro_torch.train.train``:
   f32 master weights, bf16 compute, remat, synthetic packed sequences of
   2048 tokens, 4 virtual workers x 2 micro-batches of one sequence,
   AdamW (lr 1e-4, clip 1.0), DropCompute at a fixed tau (the median of
   the run's per-worker latency sums under ``paper_lognormal``), 3 steps.
   Losses must be finite, the drop fractions those of the numpy latency
   draws, and the launch counters those the code implies per kept
   micro-batch; then a 2-layer full-width model at 256 tokens must give
   ``loss_sum`` and every gradient leaf on the card (kernels, bf16)
   within a stated tolerance of the CPU's (plain versions, f32), and a
   planted K3 backward fault must fall outside it.

The last two lines of standard output are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``.  K6 and K5's record rows are read at the
mamba serving run's shapes: 8 rows of one 64-row chunk, and the packed
mixed step.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config  # noqa: E402  (fails outside a checkout)
from repro_torch.core import DropConfig, LatencyModel, NoiseModel, drop_mask  # noqa: E402
from repro_torch.core.engine import make_grad_fn  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import _build, flash_attention, masked_accum, ops, ref, rmsnorm  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.layers import _paged_quantize  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    compute_params,
    init_decode_cache,
    init_params,
    packed_prefill,
    prefill_chunk,
)
from repro_torch.models.transformer import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request, pack_step  # noqa: E402
from repro_torch.train import TrainConfig, train  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; full 700 W power limit).  The
# SSD kernels compute in f32 on the FMA pipes, so their operations bound is
# taken at the f32 rate outside the tensor cores, not the bf16 one.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

DEV = "cuda"

# qwen2.5-3b attention widths and the serving run's shape
H, KV, D, PAGE = 16, 2, 128, 16
SLOTS, NEW_TOKENS, CHUNK, BUDGET = 8, 32, 64, 256
PROMPT_MIN, PROMPT_MAX = 128, 512
MAX_LEN = PROMPT_MAX + NEW_TOKENS
BLOCKS = -(-MAX_LEN // PAGE)

# Tolerances.  Kernel vs plain version on the same inputs: both accumulate
# in f32 and round the output once to bf16, so they differ by ~1 bf16 ulp
# (2^-8 relative) of an O(1) output; 2e-2 leaves room for that and for the
# different summation order.  RMSNorm in f32: the kernel and the plain
# version differ only in reduction order and rsqrt rounding (~1e-7).
K4_TOL = dict(atol=2e-2, rtol=2e-2)
K2_F32_TOL = dict(atol=1e-5, rtol=1e-5)
K2_BF16_ULPS = 1
# First-step logits, paged kernel vs dense plain attention, both bf16: each
# layer's attention output can differ by ~1 bf16 ulp (2^-8 relative), and 36
# residual layers carry that into the logits.  The bound is on the largest
# difference relative to the largest logit: 3%, against the 0.9% the first
# kernel showed on the card.
LOGITS_REL_TOL = 0.03
# K3 against its plain version, bf16, row by row: the largest relative
# error of one row, ||got_r - want_r|| / ||want_r||, over the query rows of
# out and dq and the key rows of dk and dv (``row_rel_err``).  A causal
# row's magnitude falls as 1/sqrt(its key count), so a limit relative to a
# whole tensor's largest value would let late rows be wrong; per row the
# kernel's roundings (P and dS to bf16 before the tensor-core products,
# each output once: 2^-9 relative each) stay near 1e-3 wherever the row
# lies.  The limit sits between the sound readings and a planted fault
# (``k3_planted_fault``: the diagonal 64-key tile skipped for query rows
# from S/2 on), whose readings the smoke also checks: see PERF.md.  The
# log-sum-exp is compared absolutely (f32 in both).
K3_ROW_TOL = 2e-2
K3_LSE_TOL = 1e-3
# K2's backward against its plain version, bf16: the largest difference
# over the largest magnitude (every row of dx is O(1) at the same scale, so
# no row hides under another); dx is rounded once.  K1 is exact at keep 0
# and 1 with scale 1 (the product keep * grad is exact in f32).
TRAIN_REL_TOL = 2e-2
K2_BWD_F32_REL_TOL = 1e-5
# The 2-layer full-width model at 256 tokens, card (kernels, bf16 compute)
# against the CPU (plain versions, f32): bf16 rounds the compute copy of
# the weights and every activation (2^-9 relative each), so the loss sum,
# an average of ~255 CE terms near log(V), moves by well under 1%.  Every
# gradient leaf is held on its own, ||g_card - g_cpu|| / ||g_cpu||; the
# limit sits between the sound run's worst leaf and a planted backward
# fault (``one_head_dkdv``: K3's dK/dV from one query head of each group
# instead of all g), whose worst leaf the smoke also checks: see PERF.md.
PARITY_LOSS_REL_TOL = 0.01
PARITY_LEAF_REL_TOL = 0.05
# K6 / K5 against their plain versions on the card, both f32, row by row
# (``row_rel_err``): the same sums in another order and CUDA's expf (2 ulp)
# against torch's exp, ~1e-6 a row; a planted fault (the diagonal key tile
# skipped, the segment mask dropped) zeroes or mixes whole rows, ~0.1-1.
SSD_ROW_TOL = 1e-4
# The 2-layer full-width mamba2-130m, first dense and first packed step, card
# (kernels, bf16 compute) against the CPU (plain versions, f32), row by row
# (``row_rel_err`` over the vocabulary of each token's logits).  bf16 rounds
# the weights' compute copy and every activation of the block (projections,
# conv taps, gate, norm: 2^-9 relative each): each layer's output moves ~1%
# and the worst logit row ~7.5% (the same comparison in bf16 on the CPU); a
# planted K6 or K5 fault changes whole rows of the SSD output, which the
# norms carry into the logits at their own size (0.58-1.7 on the CPU).
MAMBA_LOGITS_ROW_TOL = 0.2
# mamba2-130m's SSD widths: heads, head dim, state
M_H, M_P, M_N = 24, 64, 128

# the training phase: qwen2.5-3b, 4 virtual workers x 2 micro-batches of one
# 2048-token sequence, 3 steps
TRAIN_SEQ, TRAIN_WORKERS, TRAIN_MB, TRAIN_STEPS = 2048, 4, 2, 3
PARITY_LAYERS, PARITY_SEQ = 2, 256


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def capture(fn) -> torch.cuda.CUDAGraph:
    """``fn`` captured once into a CUDA graph, after a warm-up call off the
    capture (builds, allocator)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_ms(graph: torch.cuda.CUDAGraph, iters: int = 30) -> float:
    """Median device time of one replay of ``graph``, between two events,
    behind a short spin kernel that keeps the device busy while the host
    enqueues: the events then bracket the graph's kernels alone, not the
    host's launch cost (Triton's launcher takes longer on the host than
    RMSNorm takes on the card).  L2 is flushed (64 MiB write) before each
    replay, as the serving loop finds it: 36 layers of weights and pools
    pass through L2 between two calls of one layer's kernel."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(50_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call of ``fn``, captured into a CUDA graph
    and replayed (``replay_ms``)."""
    return replay_ms(capture(fn), iters)


def time_ms_eager(fn, iters: int = 5) -> float:
    """Median device time of one call of ``fn`` between two events, L2
    flushed before each: for calls that cannot be captured in a CUDA graph
    (a host sync inside, or autograd's backward).  Host launch time is
    inside, which at the millisecond sizes timed this way is small."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def ptxas_lines(source: str, names: str = r"attn_[a-z_]+"):
    """One line per kernel of ``source`` whose name matches ``names``, from
    its build's ``ptxas -v`` report: registers at launch and the most bytes
    spilled (stores / loads) over its template instances, and whether ptxas
    serialized its wgmma instructions for want of registers."""
    import re

    kernel = re.compile(r"\d+(" + names + r")[EI]")
    seen, notes, name, spills = {}, [], None, (0, 0)
    for line in _build.ptxas_report(source).splitlines():
        m = kernel.search(line)
        if "Compiling entry function" in line and m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            seen.setdefault(name, []).append((int(m.group(1)), *spills))
            name = None
        if "wgmma.mma_async instructions are serialized" in line and kernel.search(line):
            notes.append(f"wgmma serialized in {kernel.search(line).group(1)}")
    out = []
    for k, v in seen.items():
        regs = sorted({r for r, _, _ in v})
        span = f"{regs[0]}" if len(regs) == 1 else f"{regs[0]}-{regs[-1]}"
        out.append(f"{k}: {span} registers at launch ({len(v)} instance(s)), spill stores "
                   f"{max(x for _, x, _ in v)} B, loads {max(x for _, _, x in v)} B (most)")
    return out + notes


def bound_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# K4: paged attention
# ---------------------------------------------------------------------------


def paged_scenario(rng: np.random.Generator, ctx, spans, dtype=torch.bfloat16):
    """Pools whose slots own scattered pages, block tables, and packed
    queries: slot s has ``ctx[s]`` cached positions and ``spans[s]`` query
    tokens at its last positions."""
    num_slots = len(ctx)
    num_pages = num_slots * BLOCKS
    perm = rng.permutation(num_pages)
    tables = np.full((num_slots, BLOCKS), num_pages, np.int32)
    for s, n in enumerate(ctx):
        nb = -(-n // PAGE)
        tables[s, :nb] = perm[s * BLOCKS : s * BLOCKS + nb]
    q_pos = np.concatenate([np.arange(n - m, n) for n, m in zip(ctx, spans)]).astype(np.int32)
    q_slots = np.concatenate([np.full(m, s) for s, m in enumerate(spans)]).astype(np.int32)
    t = len(q_pos)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEV, dtype)

    return dict(
        q=randn(t, H, D), k_pool=randn(num_pages, PAGE, KV, D),
        v_pool=randn(num_pages, PAGE, KV, D),
        tables=torch.from_numpy(tables).to(DEV), q_pos=torch.from_numpy(q_pos).to(DEV),
        q_slots=torch.from_numpy(q_slots).to(DEV),
    )


def paged_cost(a, window=0):
    """(bytes, flops) the call needs.  Bytes: q and the output once; each
    slot's admissible key rows once, k and v, all KV heads, with their
    scales (a row is admissible to some query of the slot: at or before
    its position, inside the window, in a block whose table entry is
    good); the int inputs.  Flops: 4*D per (head, admissible key) of each
    query."""
    tables = a["tables"].cpu().numpy()
    q_pos = a["q_pos"].cpu().numpy()
    q_slots = a["q_slots"].cpu().numpy()
    num_pages = a["k_pool"].shape[0]
    row_bytes = KV * D * a["k_pool"].element_size() + (KV * 4 if "k_scale" in a else 0)
    good = (tables >= 0) & (tables < num_pages)
    kpos = np.arange(tables.shape[1] * PAGE)
    rows = keys = 0
    for slot in np.unique(q_slots[q_slots >= 0]):
        pos = q_pos[q_slots == slot][:, None]
        adm = (kpos <= pos) & np.repeat(good[slot], PAGE)
        if window > 0:
            adm &= kpos > pos - window
        keys += int(adm.sum())
        rows += int(adm.any(axis=0).sum())
    nbytes = (2 * a["q"].numel() * a["q"].element_size() + 2 * rows * row_bytes
              + (tables.size + 2 * q_pos.size) * 4)
    return nbytes, 4.0 * D * H * keys


def decode_scenario(rng, prompt_lens):
    """The serving run's decode step, mid-generation: one query per slot at
    ``prompt_len + NEW_TOKENS // 2`` cached positions."""
    return paged_scenario(rng, [n + NEW_TOKENS // 2 for n in prompt_lens], [1] * SLOTS)


def skip_last_page(a, plan_row):
    """A planted K4 fault: inputs on which the plain version returns what a
    kernel that skips the last page of tile ``plan_row`` (first token,
    tokens, slot, block lo, block hi) would return: the tile's tokens move
    to a new slot whose table is their slot's with that block masked."""
    t0, n, slot, _, hi = (int(x) for x in plan_row)
    tables = torch.cat([a["tables"], a["tables"][slot:slot + 1]])
    tables[-1, hi - 1] = -1
    slots = a["q_slots"].clone()
    slots[t0:t0 + n] = tables.shape[0] - 1
    return dict(a, tables=tables, q_slots=slots)


def step_plan(a, window=0):
    """The tile plan of a scenario, as ``step_index`` makes it for a step."""
    return flash_attention.tile_plan_tensor(a["q_pos"], a["q_slots"], a["k_pool"].shape[1],
                                            a["tables"].shape[1], window)


def k4_checks(rng, prompt_lens):
    ctx = [int(x) for x in rng.integers(PROMPT_MIN, MAX_LEN, SLOTS)]
    spans = [1, 64, 1, 9, 1, 33, 1, 1]  # decode, prefill chunks and verify-sized spans
    base = paged_scenario(rng, ctx, spans)
    num_pages = base["k_pool"].shape[0]
    cases = {}
    cases["bf16"] = (base, {}, None)
    kq, ks = _paged_quantize(base["k_pool"])  # the model's write-path scheme
    vq, vs = _paged_quantize(base["v_pool"])
    cases["int8"] = (dict(base, k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs), {}, None)
    cases["window"] = (base, {"window": 100}, None)
    cases["softcap"] = (base, {"softcap": 5.0}, None)
    hostile = base["tables"].clone()
    hostile[0, 2], hostile[1, 0], hostile[5, 3] = -3, num_pages + 7, -1
    cases["hostile_tables"] = (dict(base, tables=hostile), {}, None)
    pad_slots = base["q_slots"].clone()
    pad_slots[::7] = -1
    cases["padding"] = (dict(base, q_slots=pad_slots), {}, pad_slots < 0)
    masked = base["tables"].clone()
    masked[3, :] = -1  # every block of slot 3 hostile: its queries see nothing
    cases["fully_masked"] = (dict(base, tables=masked), {}, base["q_slots"] == 3)
    # a grid large enough to run unsplit (the prefill steps' path), with a
    # window and padding on top
    many = paged_scenario(rng, ctx, [CHUNK] * SLOTS)
    many_slots = many["q_slots"].clone()
    many_slots[::5] = -1
    cases["many_queries"] = (dict(many, q_slots=many_slots), {"window": 200}, many_slots < 0)
    # the decode steps' grid (one query per slot, as k4_timing times it) plus
    # a padding query: the block range splits many ways, and the splits past
    # a short slot's last block are empty
    dec = decode_scenario(rng, prompt_lens)
    dec = {k: (torch.cat([v, v[:1]]) if k in ("q", "q_pos", "q_slots") else v)
           for k, v in dec.items()}
    dec["q_slots"][-1] = -1
    pad = dec["q_slots"] < 0
    kq, ks = _paged_quantize(dec["k_pool"])
    vq, vs = _paged_quantize(dec["v_pool"])
    cases["decode"] = (dec, {}, pad)
    cases["decode_int8"] = (dict(dec, k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs), {}, pad)
    cases["decode_window"] = (dec, {"window": 100}, pad)

    max_err = 0.0
    for name, (a, kw, zero_rows) in cases.items():
        plan = step_plan(a, kw.get("window", 0))
        out = flash_attention.paged_flash_attention(**a, **kw)
        again = flash_attention.paged_flash_attention(**a, **kw, plan=plan)
        want = ref.paged_attention_ref(**a, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"K4 {name}: the step's plan and the wrapper's differ")
        err = (out.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        check(bool(torch.isfinite(out.float()).all()), f"K4 {name}: non-finite output")
        check(torch.allclose(out.float(), want.float(), **K4_TOL),
              f"K4 {name}: max |err| {err} beyond {K4_TOL}")
        if zero_rows is not None:
            check(int(zero_rows.sum()) > 0, f"K4 {name}: scenario has no zero rows")
            check(bool((out[zero_rows] == 0).all()), f"K4 {name}: rows not exactly zero")
        t = a["q"].shape[0]
        splits, _ = flash_attention.split_blocks(plan.shape[0] * KV, BLOCKS,
                                                 flash_attention._sm_count(0))
        if name.startswith("decode"):
            check(splits > 2, f"K4 {name}: {splits} splits, the decode grid should split > 2 ways")
        if name in ("bf16", "many_queries"):
            # the planted fault: the last page of the tile with the most tokens skipped
            row = plan[int(plan[:, 1].argmax())].tolist()
            bad = ref.paged_attention_ref(**skip_last_page(a, row), **kw)
            bad_err = (bad.float() - want.float()).abs().max().item()
            check(not torch.allclose(bad.float(), want.float(), **K4_TOL),
                  f"K4 {name}: K4_TOL lets a planted fault pass (max |err| {bad_err})")
            log(f"K4 {name}: planted fault (tile of {row[1]} tokens, its last page "
                f"skipped): max|err|={bad_err:.3e}, rejected")
        log(f"K4 {name:15s} T={t:3d} tiles={plan.shape[0]:3d} splits={splits} "
            f"max|err|={err:.3e} ok")
    return max_err


def k4_timing(rng, prompt_lens):
    """Kernel, plain version and bound at two main-path shapes: a decode
    step (one query per slot, mid-generation) and a mixed packed step (4
    prefill chunks of 64)."""
    decode = decode_scenario(rng, prompt_lens)
    mixed = paged_scenario(rng, [n for n in prompt_lens], [CHUNK] * 4 + [1] * 4)
    rows = {}
    for shape, a in (("decode", decode), ("mixed", mixed)):
        plan = step_plan(a)  # made once per step by step_index, outside the layers' calls
        kern = time_ms(lambda: flash_attention.paged_flash_attention(**a, plan=plan))
        plain = time_ms(lambda: ref.paged_attention_ref(**a), iters=10)
        nbytes, flops = paged_cost(a)
        b, by = bound_ms(nbytes, flops)
        rows[shape] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by,
                           T=a["q"].shape[0])
        log(f"K4 time {shape:6s} T={a['q'].shape[0]:4d} tiles={plan.shape[0]}: kernel "
            f"{kern * 1e3:.1f} us, "
            f"plain {plain * 1e3:.1f} us, bound {b * 1e3:.2f} us ({by}), "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP")
    return rows


# ---------------------------------------------------------------------------
# K2: RMSNorm
# ---------------------------------------------------------------------------


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""

    def line(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((line(a) - line(b)).abs().max().item())


def k2_checks(rng, d=2048, eps=1e-6):
    block_rows = rmsnorm.block_shape(d)[0]
    max_err = 0.0
    for rows in (8, 256, 3, 257):
        for dtype in (torch.float32, torch.bfloat16):
            for model in (False, True):
                x = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(DEV, dtype)
                s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV)
                out = rmsnorm.rmsnorm(x, s, eps=eps, model=model)
                want = (ref.rmsnorm_model if model else ref.rmsnorm_ref)(x, s, eps)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                tag = (f"K2 rows={rows:3d} ({'on' if rows % block_rows == 0 else 'off'} the "
                       f"block) {str(dtype)[6:]:8s} {'model' if model else 'f32'}")
                if dtype == torch.float32:
                    check(torch.allclose(out, want, **K2_F32_TOL), f"{tag}: max |err| {err}")
                    log(f"{tag}: max|err|={err:.3e} ok")
                else:
                    ulps = bf16_ulps(out, want)
                    check(ulps <= K2_BF16_ULPS, f"{tag}: {ulps} ulps apart")
                    log(f"{tag}: max|err|={err:.3e} ({ulps} ulp) ok")
    return max_err


def k2_timing(rng, d=2048, eps=1e-6):
    """At the main paths' shapes: a decode step (8 rows), the packed mixed
    step (257 rows) and a training micro-batch (2048 rows), bf16 model
    mode."""
    rows_out = {}
    s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV)
    for shape, rows in (("decode", SLOTS), ("mixed", BUDGET + 1), ("train", TRAIN_SEQ)):
        x = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(DEV, torch.bfloat16)
        kern = time_ms(lambda: rmsnorm.rmsnorm(x, s, eps=eps, model=True))
        plain = time_ms(lambda: ref.rmsnorm_model(x, s, eps))
        sb = s.to(torch.bfloat16)
        lib = time_ms(lambda: torch.nn.functional.rms_norm(x, (d,), weight=sb, eps=eps))
        nbytes = 2 * x.numel() * x.element_size() + s.numel() * 4
        b, by = bound_ms(nbytes, 4.0 * x.numel())
        rows_out[shape] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=b,
                               bound_by=by, rows=rows)
        log(f"K2 time {shape:6s} rows={rows:3d}: kernel {kern * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, F.rms_norm {lib * 1e3:.1f} us, bound {b * 1e3:.2f} us ({by})")
    return rows_out


# ---------------------------------------------------------------------------
# K3: training flash attention, forward and backward
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def row_rel_err(got, want) -> float:
    """max over rows (the last axis) of ||got_r - want_r|| / ||want_r||, a
    row's norm taken as at least 2^-12 of the largest row's: a row that is
    zero in exact arithmetic (dq of a query with one admissible key) is f32
    rounding noise in both versions, ~1e-6 against rows of ~10."""
    got, want = got.float(), want.float()
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1)
    return (num / den.clamp(min=2.0 ** -12 * den.max().item() + 1e-30)).max().item()


def k3_planted_fault(q, k, v, do, want, wants):
    """What a K3 kernel that skips the diagonal 64-key tile for query rows
    from S/2 on would return (the plain versions on that mask), held
    against the sound plain result by the checks' own metrics; returns
    the readings (row errors of out, dq, dk, dv; the whole-tensor metric
    of out)."""
    s = q.shape[2]
    rows = torch.arange(s, device=DEV)[:, None]
    keys = torch.arange(s, device=DEV)[None]
    tile = (rows >= s // 2) & (keys // 64 == rows // 64)
    mask = ref.attention_mask(s, s, True, 0, device=DEV) & ~tile
    bad, bad_lse = ref.flash_attention_fwd_ref(q, k, v, mask=mask)
    bad_grads = ref.flash_attention_bwd_ref(q, k, v, bad, bad_lse, do, mask=mask)
    return ([row_rel_err(bad, want)] + [row_rel_err(g, w) for g, w in zip(bad_grads, wants)],
            rel_err(bad, want))


def attn_inputs(rng):
    """q, k, v, dO as transposed (1, heads, S, D) views of (1, S, heads, D)
    bf16 storage at the training length, the layout the model passes."""

    def t(heads):
        x = torch.from_numpy(rng.standard_normal((1, TRAIN_SEQ, heads, D), dtype=np.float32))
        return x.to(DEV, torch.bfloat16).transpose(1, 2)

    return t(H), t(KV), t(KV), t(H)


def k3_cases():
    seg = torch.zeros((1, TRAIN_SEQ), dtype=torch.int32, device=DEV)
    seg[:, 700:] += 1
    seg[:, 1500:] += 1
    qseg = seg.clone()
    qseg[:, 1000:1010] = 9  # no key has segment 9: the visited-range mean
    return {"causal": {}, "window": {"window": 256},
            "segments": {"q_segment_ids": qseg, "kv_segment_ids": seg}}


def k3_checks(rng):
    """Forward (out, lse) and backward (dq, dk, dv) against the plain
    versions at the training shape, row by row, and the same metric
    against a planted fault; returns (fwd max|err|, bwd max|err|)."""
    q, k, v, do = attn_inputs(rng)
    fwd_err = bwd_err = 0.0
    for name, kw in k3_cases().items():
        out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        # the backward's plain version takes the kernel's own out and lse: where
        # one key dominates a softmax, dq is smaller than what one bf16 ulp of
        # O moves through delta = rowsum(dO * O), so feeding the two versions
        # different roundings of O would compare the roundings
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x.float()).all()) for x in (out, lse, *grads)),
              f"K3 {name}: non-finite output")
        e_out = row_rel_err(out, want)
        e_lse = (lse - want_lse).abs().max().item()
        errs = [row_rel_err(g, w) for g, w in zip(grads, wants)]
        log(f"K3 {name:8s} S={TRAIN_SEQ}: row rel err fwd {e_out:.2e} (lse abs {e_lse:.1e}), "
            f"bwd dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} (whole-tensor metric: "
            f"fwd {rel_err(out, want):.2e}, bwd {max(rel_err(g, w) for g, w in zip(grads, wants)):.2e})")
        check(e_out <= K3_ROW_TOL, f"K3 fwd {name}: row relative error {e_out}")
        check(e_lse <= K3_LSE_TOL, f"K3 fwd {name}: lse off by {e_lse}")
        if name == "segments":
            lonely = np.s_[:, :, 1000:1010]
            check(row_rel_err(out[lonely], want[lonely]) <= K3_ROW_TOL,
                  "K3 fwd: queries without a key differ from the visited-range mean")
        check(max(errs) <= K3_ROW_TOL, f"K3 bwd {name}: row relative errors (dq, dk, dv) {errs}")
        if name == "causal":
            bad, whole = k3_planted_fault(q, k, v, do, want, wants)
            log(f"K3 planted fault (diagonal 64-key tile skipped from row {TRAIN_SEQ // 2}): "
                f"row rel err out {bad[0]:.2e} dq {bad[1]:.2e} dk {bad[2]:.2e} dv {bad[3]:.2e}; "
                f"whole-tensor metric of out {whole:.2e}")
            check(min(bad) > K3_ROW_TOL, f"K3: the row metric lets a planted fault pass: {bad}")
        fwd_err = max(fwd_err, (out.float() - want.float()).abs().max().item())
        bwd_err = max(bwd_err, max((g.float() - w.float()).abs().max().item()
                                   for g, w in zip(grads, wants)))
        again = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"K3 bwd {name}: two runs differ (it has no atomics: it must not)")
        log(f"K3 {name:8s}: deterministic ok")
    return fwd_err, bwd_err


# the backward's launches, in order: kernel names in flash_attention.cu
K3_BWD_KERNELS = {"delta": "attn_bwd_delta", "dkdv": "attn_bwd_dkdv",
                  "group_sum": "attn_bwd_group_sum", "dq": "attn_bwd_dq"}


def kernel_split_ms(fn, kernels, iters: int = 10) -> dict:
    """Median device time of each of ``fn``'s kernels (``kernels``: label ->
    a substring of the kernel's name), from ``torch.profiler`` over eager
    calls with L2 flushed before each; fails if a kernel is missing."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {label: [] for label in kernels}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, name in kernels.items():
            if name in ev.name:
                times[label].append((ev.time_range.end - ev.time_range.start) / 1e3)
    check(all(len(t) == iters for t in times.values()),
          f"the profiler saw {({k: len(t) for k, t in times.items()})} launches, want {iters} each")
    return {label: statistics.median(t) for label, t in times.items()}


def k3_timing(rng):
    """Kernel, plain version, F.scaled_dot_product_attention (GQA) and the
    bounds at the training shape, causal; the backward also launch by
    launch (delta, dK/dV partials, their group sum, dQ) and SDPA's backward
    alone."""
    q, k, v, do = attn_inputs(rng)
    # admissible (query, key) pairs of one head: the work K3 must do
    pairs = int(ref.attention_mask(TRAIN_SEQ, TRAIN_SEQ, True, 0, device=DEV).sum().item())
    io = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # bf16 q, k, v, o
    out, lse = flash_attention.flash_attention_fwd(q, k, v)
    fwd = time_ms(lambda: flash_attention.flash_attention_fwd(q, k, v))
    bwd = time_ms(lambda: flash_attention.flash_attention_bwd(q, k, v, out, lse, do))
    parts = kernel_split_ms(lambda: flash_attention.flash_attention_bwd(q, k, v, out, lse, do),
                            K3_BWD_KERNELS)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v)
    plain_fwd = time_ms_eager(lambda: ref.flash_attention_fwd_ref(q, k, v), iters=3)
    plain_bwd = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, want, want_lse, do), iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    lib_bwd = sdpa_bwd_ms(q, k, v, do)
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))

    def lib_fwd_bwd():
        torch.autograd.grad(sdpa(ql, kl, vl, is_causal=True, enable_gqa=True), (ql, kl, vl), do)

    lib_both = time_ms_eager(lib_fwd_bwd, iters=10)
    # forward: 2 products (QK^T, PV) of 2*D flops per admissible pair and
    # head; backward: 5 (S again, dP, dV, dQ, dK) — P is not an input
    fb, fby = bound_ms(io + 4 * lse.numel(), 4.0 * D * H * pairs)
    bb, bby = bound_ms(io + 2 * q.numel() + 4 * lse.numel() + 2 * (q.numel() + 2 * k.numel()),
                       10.0 * D * H * pairs)
    split = ", ".join(f"{n} {t * 1e3:.1f}" for n, t in parts.items())
    log(f"K3 time S={TRAIN_SEQ} causal: fwd kernel {fwd * 1e3:.1f} us, plain {plain_fwd * 1e3:.1f} "
        f"us, SDPA {lib_fwd * 1e3:.1f} us, bound {fb * 1e3:.1f} us ({fby}); bwd kernels "
        f"{bwd * 1e3:.1f} us (device time by launch, profiler: {split} us), plain "
        f"{plain_bwd * 1e3:.1f} us, SDPA bwd alone {lib_bwd * 1e3:.1f} us (graph-captured "
        f"autograd.grad), bound {bb * 1e3:.1f} us ({bby}); fwd+bwd kernels "
        f"{(fwd + bwd) * 1e3:.1f} us, SDPA fwd+bwd {lib_both * 1e3:.1f} us (eager, events)")
    return (dict(ms=fwd, plain_ms=plain_fwd, bound_ms=fb, bound_by=fby, library_ms=lib_fwd),
            dict(ms=bwd, plain_ms=plain_bwd, bound_ms=bb, bound_by=bby, library_ms=lib_bwd))


# ---------------------------------------------------------------------------
# K2 backward and K1
# ---------------------------------------------------------------------------


def grad_only_ms(fwd, inputs, grad_out) -> float:
    """A PyTorch function's backward alone on the kernels' footing: ``fwd``
    of ``inputs`` (leaves that require grad) captured into one CUDA graph,
    ``torch.autograd.grad`` into a second one on the same pool (as
    ``torch.cuda.make_graphed_callables`` does), and only the second
    replayed and timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(2):
            torch.autograd.grad(fwd(*inputs), inputs, grad_out)
    torch.cuda.current_stream().wait_stream(side)
    fwd_graph, bwd_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd_graph):
        out = fwd(*inputs)
    with torch.cuda.graph(bwd_graph, pool=fwd_graph.pool()):
        torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
    fwd_graph.replay()
    return replay_ms(bwd_graph)


def sdpa_bwd_ms(q, k, v, do) -> float:
    """SDPA's backward alone (``grad_only_ms``), causal, GQA."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = tuple(x.detach().requires_grad_() for x in (q, k, v))
    return grad_only_ms(lambda a, b, c: sdpa(a, b, c, is_causal=True, enable_gqa=True),
                        leaves, do)


def k2_bwd_checks_and_timing(rng, d=2048, rows=TRAIN_SEQ, eps=1e-6):
    """The backward against its plain version at the training shape, both
    modes, bf16 and f32; two runs bit-identical; a planted fault (the first
    CTA's rows left out of dscale) against the f32 check; then timed beside
    ``F.rms_norm``'s backward alone."""
    max_err = 0.0
    for dtype, tol in ((torch.bfloat16, TRAIN_REL_TOL), (torch.float32, K2_BWD_F32_REL_TOL)):
        for model in (True, False):
            x, dy = (torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32))
                     .to(DEV, dtype) for _ in range(2))
            s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV, dtype)
            dx, ds = rmsnorm.rmsnorm_bwd(x, s, dy, eps=eps, model=model)
            dx2, ds2 = rmsnorm.rmsnorm_bwd(x, s, dy, eps=eps, model=model)
            wdx, wds = ref.rmsnorm_bwd_ref(x, s, dy, eps, model)
            torch.cuda.synchronize()
            e = max(rel_err(dx, wdx), rel_err(ds, wds))
            check(e <= tol, f"K2 bwd {dtype} model={model}: relative error {e}")
            check(torch.equal(dx, dx2) and torch.equal(ds, ds2),
                  f"K2 bwd {dtype} model={model}: two runs differ (it has no atomics: it must not)")
            max_err = max(max_err, (dx.float() - wdx.float()).abs().max().item(),
                          (ds.float() - wds.float()).abs().max().item())
            log(f"K2 bwd rows={rows} {str(dtype)[6:]:8s} {'model' if model else 'f32'}: "
                f"rel err {e:.2e}, deterministic ok")
            if dtype == torch.float32 and not model:
                _, per, _, _ = rmsnorm.bwd_partition(rows, d, 4, rmsnorm._sm_count(0))
                keep = torch.ones(rows, dtype=torch.bool, device=DEV)
                keep[:per] = False
                bad = ref.rmsnorm_bwd_ref(x[keep], s, dy[keep], eps, model)[1]
                e_bad = rel_err(bad, wds)
                check(e_bad > K2_BWD_F32_REL_TOL,
                      f"K2 bwd: the f32 check lets a planted fault pass ({e_bad})")
                log(f"K2 bwd planted fault (the first CTA's {per} rows left out of dscale): "
                    f"rel err {e_bad:.2e} against f32 limit {K2_BWD_F32_REL_TOL:.0e} "
                    f"(bf16 limit {TRAIN_REL_TOL:.0e}), rejected")
    x, dy = (torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32))
             .to(DEV, torch.bfloat16) for _ in range(2))
    s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV, torch.bfloat16)
    kern = time_ms(lambda: rmsnorm.rmsnorm_bwd(x, s, dy, eps=eps, model=True))
    plain = time_ms(lambda: ref.rmsnorm_bwd_ref(x, s, dy, eps, True))
    leaves = (x.detach().requires_grad_(), s.detach().requires_grad_())
    library = grad_only_ms(lambda a, b: torch.nn.functional.rms_norm(a, (d,), weight=b, eps=eps),
                           leaves, dy)
    b, by = bound_ms(3 * x.numel() * 2 + 2 * d * 2, 8.0 * x.numel())
    log(f"K2 bwd time rows={rows}: kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
        f"F.rms_norm backward alone (graph-captured autograd.grad) {library * 1e3:.1f} us, "
        f"bound {b * 1e3:.2f} us ({by})")
    return max_err, dict(ms=kern, plain_ms=plain, library_ms=library, bound_ms=b, bound_by=by)


def k1_checks_and_timing(rng, shape=(36, 2048, 11008)):
    """The largest leaf of the stacked qwen2.5-3b tree (w_gate / w_in)."""
    n = math.prod(shape)
    acc = torch.empty(shape, dtype=torch.float32, device=DEV).normal_()
    g = torch.empty(shape, dtype=torch.bfloat16, device=DEV).normal_()
    for keep in (0.0, 1.0):
        want = ref.masked_accum_ref(acc, g, keep, 1.0)
        got = masked_accum.masked_accum(acc.clone(), g, keep, 1.0)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 keep={keep}: differs from the plain version")
        del want, got
        log(f"K1 {shape} bf16 grads keep={keep}: exact ok")
    kern = time_ms(lambda: masked_accum.masked_accum(acc, g, 1.0, 1.0), iters=10)
    plain = time_ms(lambda: ref.masked_accum_ref(acc, g, 1.0, 1.0), iters=5)
    library = time_ms(lambda: acc.add_(g, alpha=1.0), iters=10)
    b, by = bound_ms(n * (4 + 4 + 2), 2.0 * n)
    log(f"K1 time {n / 1e6:.0f} M elements: kernel {kern:.3f} ms, plain {plain:.3f} ms, "
        f"acc.add_ {library:.3f} ms, bound {b:.3f} ms ({by})")
    return 0.0, dict(ms=kern, plain_ms=plain, library_ms=library, bound_ms=b, bound_by=by)


# ---------------------------------------------------------------------------
# K6 / K5: the SSD intra-chunk and segment-masked terms
# ---------------------------------------------------------------------------


def f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEV)


def ssd_chunk_scenario(rng, bs, nc, l):
    """K6's inputs as the model forms them: x, B, C; dt in [0.1, 0.9] and
    cum its running sum times mamba2-130m's decay rates (1..16) inside each
    chunk (up to ~3,000 at 256 rows)."""
    dt = rng.uniform(0.1, 0.9, (bs, nc, l, M_H)).astype(np.float32)
    a = np.exp(np.log(np.linspace(1.0, 16.0, M_H, dtype=np.float32)))
    cum = np.cumsum(dt * a, axis=2, dtype=np.float32)
    return (f32(rng, bs, nc, l, M_H, M_P), torch.from_numpy(dt).to(DEV),
            torch.from_numpy(cum).to(DEV), f32(rng, bs, nc, l, M_N), f32(rng, bs, nc, l, M_N))


def packed_segments(spans, pad: int):
    """Slot ids of a packed step: ``spans`` tokens for slots 0, 1, ...,
    then ``pad`` padding entries."""
    return [s for s, n in enumerate(spans) for _ in range(n)] + [-1] * pad


def ssd_segment_scenario(rng, seg):
    """K5's inputs over a packed step's slot ids: dt 0 on padding, cum one
    running sum over the whole packed axis (thousands at 257 tokens)."""
    seg = np.asarray(seg, np.int32)
    t = len(seg)
    dt = rng.uniform(0.1, 0.9, (t, M_H)).astype(np.float32)
    dt[seg < 0] = 0.0
    a = np.linspace(1.0, 16.0, M_H, dtype=np.float32)
    cum = np.cumsum(dt * a, axis=0, dtype=np.float32)
    return (f32(rng, t, M_H, M_P), torch.from_numpy(dt).to(DEV), torch.from_numpy(cum).to(DEV),
            f32(rng, t, M_N), f32(rng, t, M_N), torch.from_numpy(seg).to(DEV))


def ssd_diagonal_skipped(l: int):
    """K6's planted fault: the causal mask less each row's own 64-key tile."""
    rows = torch.arange(l, device=DEV)
    return (rows[:, None] >= rows[None]) & (rows[:, None] // 64 != rows[None] // 64)


def segment_mask_dropped(seg):
    """K5's planted fault: every valid token in one segment."""
    return torch.where(seg >= 0, 0, seg)


# the serving run's packed steps: a mixed step at the mixed capacity (257:
# 4 decodes, 3 prefill chunks of 64, one of 60, one padding entry) and a
# decode step at the decode capacity (one token per slot)
K5_MIXED = packed_segments([1, 1, 1, 1, 64, 64, 64, 60], 1)
K5_DECODE = packed_segments([1] * SLOTS, 0)


def k6_checks(rng):
    """K6 against its plain version, row by row, at full width: 8 rows of
    one and of two 256-token chunks and the serving run's 64-row steps; the
    same metric on a planted fault (the diagonal 64-key tile skipped)."""
    max_err = 0.0
    for bs, nc, l in ((8, 1, 256), (8, 2, 256), (8, 1, 64)):
        a = ssd_chunk_scenario(rng, bs, nc, l)
        got = ssd_chunk.ssd_chunk(*a)
        want = ref.ssd_chunk_ref(*a)
        bad = ref.ssd_chunk_ref(*a, mask=ssd_diagonal_skipped(l))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K6 B{bs} NC{nc} L{l}: non-finite output")
        e, e_bad = row_rel_err(got, want), row_rel_err(bad, want)
        max_err = max(max_err, (got - want).abs().max().item())
        log(f"K6 B={bs} NC={nc} L={l}: row rel err {e:.2e}; planted fault (diagonal 64-key "
            f"tile skipped) {e_bad:.2e}")
        check(e <= SSD_ROW_TOL, f"K6 B{bs} NC{nc} L{l}: row relative error {e}")
        check(e_bad > SSD_ROW_TOL, f"K6: the row metric lets a planted fault pass: {e_bad}")
    return max_err


def k5_checks(rng):
    """K5 against its plain version, row by row, at the packed mixed and
    decode capacities and a padding-heavy step; padding rows exact zeros;
    the same metric on a planted fault (the segment mask dropped)."""
    max_err = 0.0
    cases = {"mixed": K5_MIXED, "decode": K5_DECODE,
             "padded": packed_segments([40, 1, 90], 126)}
    for name, seg in cases.items():
        a = ssd_segment_scenario(rng, seg)
        got = ssd_chunk.ssd_segment(*a)
        want = ref.ssd_segment_ref(*a)
        bad = ref.ssd_segment_ref(*a[:5], segment_mask_dropped(a[5]))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K5 {name}: non-finite output")
        pad = a[5] < 0
        check(bool((got[pad] == 0).all()), f"K5 {name}: padding rows not exactly zero")
        e, e_bad = row_rel_err(got, want), row_rel_err(bad, want)
        max_err = max(max_err, (got - want).abs().max().item())
        log(f"K5 {name:6s} T={len(seg)} ({int(pad.sum())} padding): row rel err {e:.2e}; "
            f"planted fault (segment mask dropped) {e_bad:.2e}; cum up to {a[2].max().item():.0f}")
        check(e <= SSD_ROW_TOL, f"K5 {name}: row relative error {e}")
        check(e_bad > SSD_ROW_TOL, f"K5: the row metric lets a planted fault pass: {e_bad}")
    return max_err


def ssd_cost(pairs: int, *tensors):
    """(bytes, flops) an SSD term needs: each tensor read or written once;
    per admissible (i, j) pair 2N flops for C_i . B_j (once for every head)
    and 2P per head for att . x."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return nbytes, 2.0 * pairs * (M_N + M_P * M_H)


def k6_timing(rng):
    """Kernel, plain version and bound: the serving run's 64-row steps (8
    rows of one chunk) and one full 256-token chunk a row."""
    rows = {}
    for shape, (bs, nc, l) in (("serve", (8, 1, 64)), ("chunk256", (8, 1, 256))):
        a = ssd_chunk_scenario(rng, bs, nc, l)
        kern = time_ms(lambda: ssd_chunk.ssd_chunk(*a))
        plain = time_ms(lambda: ref.ssd_chunk_ref(*a), iters=10)
        nbytes, flops = ssd_cost(bs * nc * l * (l + 1) // 2, *a, a[0])
        b, by = bound_ms(nbytes, flops, F32_FLOP_PER_S)
        rows[shape] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"K6 time B={bs} NC={nc} L={l}: kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} "
            f"us, bound {b * 1e3:.2f} us ({by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP "
            f"at the f32 rate)")
    return rows


def k5_timing(rng):
    """Kernel, plain version and bound at the packed mixed and decode steps."""
    rows = {}
    for shape, seg in (("mixed", K5_MIXED), ("decode", K5_DECODE)):
        a = ssd_segment_scenario(rng, seg)
        kern = time_ms(lambda: ssd_chunk.ssd_segment(*a))
        plain = time_ms(lambda: ref.ssd_segment_ref(*a), iters=10)
        lens = np.bincount(np.asarray([s for s in seg if s >= 0]))
        nbytes, flops = ssd_cost(int((lens * (lens + 1) // 2).sum()), *a, a[0])
        b, by = bound_ms(nbytes, flops, F32_FLOP_PER_S)
        rows[shape] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"K5 time {shape:6s} T={len(seg)}: kernel {kern * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, bound {b * 1e3:.2f} us ({by}; {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP at the f32 rate)")
    return rows


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def first_step_logits_check(cfg, params, prompts):
    """First prefill step (one 64-token chunk per slot) through the paged
    cache (CUDA kernel) and the dense cache (plain attention)."""
    tokens = np.stack([np.asarray(p[:CHUNK]) for p in prompts])
    pos = np.zeros(SLOTS, np.int64)
    lens = np.full(SLOTS, CHUNK, np.int64)
    paged = KVCacheSpec(num_slots=SLOTS, max_len=MAX_LEN, layout="paged",
                        page_size=PAGE).build(params, cfg)
    for i, p in enumerate(prompts):
        check(paged.admit_slot(i, p, NEW_TOKENS) == 0, "unexpected prefix sharing")
    paged.prepare_step([(i, 0, p[:CHUNK]) for i, p in enumerate(prompts)])
    dense = KVCacheSpec(num_slots=SLOTS, max_len=MAX_LEN, layout="dense").build(params, cfg)
    lp, _ = prefill_chunk(params, cfg, paged.state, tokens, pos, lens)
    ld, _ = prefill_chunk(params, cfg, dense.state, tokens, pos, lens)
    lp, ld = lp.float(), ld.float()
    check(tuple(lp.shape) == (SLOTS, CHUNK, cfg.vocab_size), f"logits shape {tuple(lp.shape)}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(ld).all()), "non-finite logits")
    err = (lp - ld).abs().max().item()
    scale = ld.abs().max().item()
    agree = (lp.argmax(-1) == ld.argmax(-1)).float().mean().item()
    log(f"first prefill step: paged vs dense logits max|err|={err:.4f} "
        f"(max|logit|={scale:.2f}, ratio {err / scale:.4f}), greedy agreement {agree:.4f}")
    check(err <= LOGITS_REL_TOL * scale,
          f"paged vs dense logits differ by {err}, over {LOGITS_REL_TOL} x {scale}")
    del paged, dense


def engine(cfg, params, prompts, packed: bool) -> ContinuousBatcher:
    """The serving run's engine with every request submitted."""
    eng = ContinuousBatcher(params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                            chunk_size=CHUNK, token_budget=BUDGET, cache="paged",
                            page_size=PAGE, packed=packed)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=NEW_TOKENS))
    return eng


def serve(cfg, params, prompts, packed: bool):
    eng = engine(cfg, params, prompts, packed)
    before = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = ops.launch_counts()
    runs = {k: after[k] - before[k] for k in after}
    tag = "packed" if packed else "unpacked"
    check(sorted(eng.finished) == list(range(SLOTS)), f"{tag}: unfinished requests")
    for r in eng.finished.values():
        check(len(r.output) == NEW_TOKENS and not r.truncated,
              f"{tag}: request {r.uid} has {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output), f"{tag}: token out of range")
    eng.kv.check_invariants()
    check(eng.kv.used_pages == 0, f"{tag}: {eng.kv.used_pages} pages leaked")
    steps = eng.steps
    check(runs["paged_attention"] == cfg.n_layers * steps,
          f"{tag}: {runs['paged_attention']} paged-attention launches over {steps} steps")
    check(runs["rmsnorm"] == (2 * cfg.n_layers + 1) * steps,
          f"{tag}: {runs['rmsnorm']} rmsnorm launches over {steps} steps")
    decode_ms = [s.wall_time * 1e3 for s in eng.step_stats if s.prefill_tokens == 0]
    mixed_ms = [s.wall_time * 1e3 for s in eng.step_stats if s.prefill_tokens > 0]
    gen = sum(len(r.output) for r in eng.finished.values())
    summary = eng.stats_summary()
    log(f"serve {tag}: {steps} steps ({len(mixed_ms)} mixed, {len(decode_ms)} decode-only), "
        f"launches/step K4={runs['paged_attention'] / steps:.0f} "
        f"K2={runs['rmsnorm'] / steps:.0f}; median step ms: decode-only "
        f"{statistics.median(decode_ms):.2f}, mixed {statistics.median(mixed_ms):.2f}; "
        f"{gen / wall:.1f} generated tok/s, {(gen + sum(map(len, prompts))) / wall:.1f} "
        f"processed tok/s over {wall:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; peak pages "
        f"{summary['peak_used_pages']:.0f}/{summary['num_pages']:.0f}")
    return {u: r.output for u, r in eng.finished.items()}, runs


# ---------------------------------------------------------------------------
# Mamba-2 serving
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def planted_ssd_fault(kind: str):
    """Route the model's K6 (``"chunk"``: the diagonal 64-key tile skipped)
    or K5 (``"segment"``: the segment mask dropped) through the plain
    version with that fault, on the card."""
    name = f"ssd_{kind}"
    sound = getattr(ops, name)  # what models.ssm calls

    def chunk(x, dt, cum, b, c):
        return ref.ssd_chunk_ref(x, dt, cum, b, c, mask=ssd_diagonal_skipped(x.shape[2]))

    def segment(x, dt, cum, b, c, seg):
        return ref.ssd_segment_ref(x, dt, cum, b, c, segment_mask_dropped(seg))

    setattr(ops, name, chunk if kind == "chunk" else segment)
    try:
        yield
    finally:
        setattr(ops, name, sound)


def mamba_first_steps(cfg, params, prompts):
    """Logits (on the CPU, f32) of the serving run's first dense step (64
    prompt tokens in every slot: K6) and first packed step (64 in each of
    the four oldest slots, the budget's 256: K5), each from a fresh cache."""
    dev = params["embed"]["embedding"].device
    tokens = np.stack([np.asarray(p[:CHUNK]) for p in prompts])
    cache = init_decode_cache(params, cfg, SLOTS, MAX_LEN, linear=True)
    dense, _ = prefill_chunk(params, cfg, cache, tokens, np.zeros(SLOTS, np.int64),
                             np.full(SLOTS, CHUNK, np.int64))
    lay = pack_step([(i, 0, list(p[:CHUNK])) for i, p in enumerate(prompts[:BUDGET // CHUNK])],
                    BUDGET + 1)
    cache = init_decode_cache(params, cfg, SLOTS, MAX_LEN, linear=True)
    packed, _ = packed_prefill(params, cfg, cache, lay.tokens, lay.slot_ids, lay.positions)
    valid = torch.from_numpy(lay.slot_ids >= 0).to(dev)
    return {"dense": dense.float().cpu(), "packed": packed[valid].float().cpu()}


def mamba_parity(cfg, seed: int, prompts):
    """A 2-layer full-width mamba2-130m: the first dense and packed steps'
    logits on the card (kernels, bf16 compute) against the CPU (plain
    versions, f32), then the same metric with a planted K6 and K5 fault."""
    small = dataclasses.replace(cfg, n_layers=PARITY_LAYERS)
    cpu_cfg = dataclasses.replace(small, dtype="float32")
    params = init_params(cpu_cfg, seed=seed, device="cpu")
    t0 = time.perf_counter()
    want = mamba_first_steps(cpu_cfg, params, prompts)
    t_cpu = time.perf_counter() - t0
    card = compute_params(tree_map(lambda x: x.to(DEV), params), small)

    def errs(got):
        return {k: row_rel_err(got[k], w) for k, w in want.items()}

    sound = errs(mamba_first_steps(small, card, prompts))
    with planted_ssd_fault("chunk"):
        bad_chunk = errs(mamba_first_steps(small, card, prompts))["dense"]
    with planted_ssd_fault("segment"):
        bad_seg = errs(mamba_first_steps(small, card, prompts))["packed"]
    log(f"mamba parity {PARITY_LAYERS} layers: first-step logits, row rel err card vs cpu: "
        f"dense (K6) {sound['dense']:.2e}, packed (K5) {sound['packed']:.2e}; planted K6 fault "
        f"(diagonal tile skipped) {bad_chunk:.2e}, planted K5 fault (segment mask dropped) "
        f"{bad_seg:.2e}; the CPU pass took {t_cpu:.1f} s")
    check(all(math.isfinite(e) and e <= MAMBA_LOGITS_ROW_TOL for e in sound.values()),
          f"mamba first-step logits differ from the CPU's: {sound}")
    check(min(bad_chunk, bad_seg) > MAMBA_LOGITS_ROW_TOL,
          f"the logits metric lets a planted fault pass: K6 {bad_chunk}, K5 {bad_seg}")


def mamba_requests(cfg, seed: int):
    """The mamba phase's prompt lengths and prompts (its own draws)."""
    rng = np.random.default_rng(seed + 1)
    lens = [int(n) for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS)]
    return lens, [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def mamba_engine(cfg, params, prompts, cache: str, packed: bool) -> ContinuousBatcher:
    """The mamba serving run's engine with every request submitted."""
    eng = ContinuousBatcher(params, cfg, batch_slots=SLOTS, max_len=MAX_LEN, chunk_size=CHUNK,
                            token_budget=BUDGET, cache=cache, page_size=PAGE, packed=packed)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=NEW_TOKENS))
    return eng


def mamba_serve(cfg, params, prompts, cache: str, packed: bool):
    """One serving run of the mamba phase, checked; returns the streams,
    the run's launches and its numbers."""
    eng = mamba_engine(cfg, params, prompts, cache, packed)
    before = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = ops.launch_counts()
    runs = {k: after[k] - before[k] for k in after}
    tag = f"mamba {cache} {'packed' if packed else 'unpacked'}"
    check(sorted(eng.finished) == list(range(SLOTS)), f"{tag}: unfinished requests")
    for r in eng.finished.values():
        check(len(r.output) == NEW_TOKENS and not r.truncated,
              f"{tag}: request {r.uid} has {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output), f"{tag}: token out of range")
    summary = eng.stats_summary()
    check(summary.get("shared_tokens", 0.0) == 0.0, f"{tag}: prefix-shared tokens {summary}")
    if eng.kv is not None:
        eng.kv.check_invariants()
        check(eng.kv.used_pages == 0, f"{tag}: {eng.kv.used_pages} pages leaked")
    steps, n = eng.steps, cfg.n_layers
    want = {k: 0 for k in runs}
    want["ssd_segment" if packed else "ssd_chunk"] = n * steps
    want["rmsnorm"] = (n + 1) * steps
    check(runs == want, f"{tag}: launches {runs} over {steps} steps, the code implies {want}")
    decode_ms = [st.wall_time * 1e3 for st in eng.step_stats if st.prefill_tokens == 0]
    mixed_ms = [st.wall_time * 1e3 for st in eng.step_stats if st.prefill_tokens > 0]
    gen = sum(len(r.output) for r in eng.finished.values())
    rec = dict(steps=steps, mixed_steps=len(mixed_ms), decode_ms=statistics.median(decode_ms),
               mixed_ms=statistics.median(mixed_ms), gen_tok_s=gen / wall,
               processed_tok_s=(gen + sum(map(len, prompts))) / wall, wall_s=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"serve {tag}: {steps} steps ({len(mixed_ms)} mixed, {len(decode_ms)} decode-only), "
        f"launches/step K6={runs['ssd_chunk'] / steps:.0f} K5={runs['ssd_segment'] / steps:.0f} "
        f"K2={runs['rmsnorm'] / steps:.0f}; median step ms: decode-only {rec['decode_ms']:.2f}, "
        f"mixed {rec['mixed_ms']:.2f}; {rec['gen_tok_s']:.1f} generated tok/s, "
        f"{rec['processed_tok_s']:.1f} processed tok/s over {wall:.2f} s; peak device memory "
        f"{rec['peak_gib']:.2f} GiB")
    return {u: r.output for u, r in eng.finished.items()}, runs, rec


def decode_step_ms(cfg, params, row_tile: int) -> float:
    """Device time of one dense decode step (8 slots, one token each, over
    a carried state), by CUDA-graph replay, with short steps run as one
    chunk rounded up to ``row_tile`` rows: 64 is the port's, 256
    (``ssm_chunk``) the reference's padding."""
    cache = init_decode_cache(params, cfg, SLOTS, MAX_LEN, linear=True)
    tokens = torch.ones((SLOTS, 1), dtype=torch.long, device=DEV)
    pos = torch.full((SLOTS,), 300, dtype=torch.long, device=DEV)
    lens = torch.ones(SLOTS, dtype=torch.long, device=DEV)
    sound, ssm.ROW_TILE = ssm.ROW_TILE, row_tile
    try:
        return time_ms(lambda: prefill_chunk(params, cfg, cache, tokens, pos, lens), iters=20)
    finally:
        ssm.ROW_TILE = sound


def f32_agreement(cfg, seed: int, prompts) -> int:
    """Greedy tokens (of 256) on which the packed and the unpacked engine
    agree when the model computes in f32 (the two paths sum in different
    orders: in bf16 a near-tie of random weights' logits flips early)."""
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(c32, seed=seed, device=DEV)
    outs = []
    for packed in (False, True):
        eng = mamba_engine(c32, params, prompts, "dense", packed)
        eng.run()
        outs.append({u: r.output for u, r in eng.finished.items()})
    return sum(x == y for u in outs[0] for x, y in zip(outs[0][u], outs[1][u]))


def mamba_phase(seed: int):
    """mamba2-130m at full width and depth: the 2-layer parity first, then
    the four serving runs (the counters' window), then the decode step with
    and without the shortened chunk (in turns)."""
    cfg = get_config("mamba2_130m")
    lens, prompts = mamba_requests(cfg, seed)
    mamba_parity(cfg, seed, prompts)
    free_device()
    t0 = time.perf_counter()
    params = compute_params(init_params(cfg, seed=seed, device=DEV), cfg)
    torch.cuda.synchronize()
    log(f"mamba2-130m: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e6:.1f} M parameters, f32 init + bf16 compute copy in "
        f"{time.perf_counter() - t0:.1f} s; prompt lens {lens}")
    outs, recs = {}, {}
    ops.reset_launch_counts()  # the main path starts here
    for cache in ("dense", "paged"):
        for packed in (False, True):
            outs[cache, packed], _, recs[cache, packed] = mamba_serve(cfg, params, prompts,
                                                                      cache, packed)
    counts = ops.launch_counts()  # ... and ends here
    total = SLOTS * NEW_TOKENS

    def agree(a, b):
        return sum(x == y for u in a for x, y in zip(a[u], b[u]))

    for packed in (False, True):
        log(f"mamba dense vs paged cache ({'packed' if packed else 'unpacked'}) greedy agreement: "
            f"{agree(outs['dense', packed], outs['paged', packed])}/{total}")
    log(f"mamba packed vs unpacked greedy agreement: "
        f"{agree(outs['dense', False], outs['dense', True])}/{total}")
    check(counts["ssd_chunk"] > 0 and counts["ssd_segment"] > 0 and counts["rmsnorm"] > 0,
          f"mamba: kernels not run: {counts}")
    short = [decode_step_ms(cfg, params, t) for t in (ssm.ROW_TILE, cfg.ssm_chunk,
                                                      cfg.ssm_chunk, ssm.ROW_TILE)]
    log(f"mamba dense decode step (8 slots), device ms by graph replay, in turns 64-row chunk / "
        f"256-row padding / 256 / 64: {' / '.join(f'{x:.3f}' for x in short)}")
    del params
    free_device()
    log(f"mamba packed vs unpacked greedy agreement in f32 compute: "
        f"{f32_agreement(cfg, seed, prompts)}/{total}")
    return counts, recs


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def launches_per_microbatch(cfg, n_leaves: int):
    """Kernel calls one kept micro-batch makes, from the code: each layer
    runs two RMSNorms and one attention, the final norm one more RMSNorm;
    under remat (``transformer._apply_stack_train``) the backward runs each
    layer's forward again, the final norm's not; each backward call of the
    K2 / K3 Functions is one backward launch; each gradient leaf is added
    once by K1 (``core.accumulate_grads``)."""
    n = cfg.n_layers
    again = n if cfg.remat else 0
    return {"paged_attention": 0, "flash_attention": n + again, "flash_attention_bwd": n,
            "rmsnorm": 2 * n + 1 + 2 * again, "rmsnorm_bwd": 2 * n + 1,
            "masked_accum": n_leaves, "ssd_chunk": 0, "ssd_segment": 0}


def train_phase(cfg, seed: int):
    """qwen2.5-3b at full depth through ``repro_torch.train.train``."""
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32",
          "the training phase wants remat, bf16 compute and f32 master weights")
    n, m = TRAIN_WORKERS, TRAIN_MB
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=n * m,
                      strategy="pack", seed=seed)
    latency = LatencyModel(base=0.45, noise=NoiseModel(kind="paper_lognormal"))
    # the trainer's own draws (trainer._latencies_at): tau at the median of
    # the workers' latency sums drops the second micro-batch of about half
    draws = [latency.sample_at(step, n, m, seed=seed + 1) for step in range(TRAIN_STEPS)]
    tau = float(np.median(np.stack(draws).sum(-1)))
    masks = [drop_mask(t, tau, 1).numpy() for t in draws]
    want_drops = [1.0 - float(np.float32(k.sum()) / np.float32(k.size)) for k in masks]
    kept = int(sum(k.sum() for k in masks))
    check(0 < kept < n * m * TRAIN_STEPS and max(want_drops) > 0,
          f"tau {tau} should drop some micro-batches, not all: {want_drops}")
    tcfg = TrainConfig(steps=TRAIN_STEPS, n_workers=n, microbatches=m, optimizer="adamw",
                       lr=1e-4, clip_norm=1.0, seed=seed, latency=latency,
                       drop=DropConfig(enabled=True, tau=tau))
    params = init_params(cfg, seed=seed, device=DEV)
    n_leaves = len(tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the training path starts here
    t0 = time.perf_counter()
    res = train(cfg, data, tcfg, params=params, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(x) for x in res.losses), f"non-finite losses {res.losses}")
    check(res.drop_fractions == want_drops,
          f"drop fractions {res.drop_fractions}, the latency draws give {want_drops}")
    per_mb = launches_per_microbatch(cfg, n_leaves)
    want = {k: kept * v for k, v in per_mb.items()}
    check(counts == want, f"training launches {counts}, the code implies {want}")
    steps = res.metrics["step_s"]
    kept_per_step = [int(k.sum()) for k in masks]
    tok_s = [kps * TRAIN_SEQ / s for kps, s in zip(kept_per_step, steps)]
    mb_ms = [[round(t * 1e3, 1) for t in ts] for ts in res.metrics["microbatch_s"]]
    log(f"train qwen2.5-3b: {cfg.n_layers} layers, seq {TRAIN_SEQ}, {n} workers x {m} "
        f"micro-batches, tau {tau:.4f} s, drop fractions {res.drop_fractions} (kept "
        f"{kept_per_step} micro-batches), losses {[round(x, 4) for x in res.losses]}")
    log(f"train: step wall s {[round(x, 3) for x in steps]}; per kept micro-batch ms {mb_ms}; "
        f"kept tokens/s {[round(x, 1) for x in tok_s]}; peak device memory {peak:.2f} GiB; "
        f"whole call {wall:.1f} s")
    log(f"train launches over {kept} kept micro-batches: {counts} (per micro-batch {per_mb})")
    del params, res
    return counts


def named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@contextlib.contextmanager
def one_head_dkdv():
    """A planted backward fault: K3's dK and dV summed over one query head of
    each KV head's group instead of all g (the other heads' dO zeroed for
    them: their dS is then zero); dQ is left sound."""
    sound = ops.flash_attention_bwd  # what ops.FlashAttentionFn.backward calls

    def faulty(q, k, v, out, lse, dout, *args):
        dq, _, _ = sound(q, k, v, out, lse, dout, *args)
        first = torch.arange(q.shape[1], device=q.device) % (q.shape[1] // k.shape[1]) == 0
        _, dk, dv = sound(q, k, v, out, lse, dout * first[:, None, None], *args)
        return dq, dk, dv

    ops.flash_attention_bwd = faulty
    try:
        yield
    finally:
        ops.flash_attention_bwd = sound


def parity_phase(cfg, seed: int):
    """A 2-layer full-width model: loss_sum and every gradient leaf on the
    card (kernels, bf16 compute) against the CPU (plain, f32); then the
    same metric on the card with a planted K3 backward fault."""
    small = dataclasses.replace(cfg, n_layers=PARITY_LAYERS)
    cpu_cfg = dataclasses.replace(small, dtype="float32")
    params = init_params(cpu_cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PARITY_SEQ)))

    def run(p, c, dev):
        grad_fn = make_grad_fn(lambda pp, mb: model_lib.loss_fn(pp, c, mb))
        g, ls, _ = grad_fn(model_lib.train_params(p, c), {"tokens": tokens.to(dev)})
        return float(ls), {k: x.float().cpu() for k, x in named_leaves(g)}

    def leaf_errs(g):
        return {k: (torch.linalg.vector_norm(g[k] - w) / torch.linalg.vector_norm(w)).item()
                for k, w in cpu_g.items()}

    t0 = time.perf_counter()
    cpu_loss, cpu_g = run(params, cpu_cfg, "cpu")
    t_cpu = time.perf_counter() - t0
    card_params = tree_map(lambda x: x.to(DEV), params)
    card_loss, card_g = run(card_params, small, DEV)
    with one_head_dkdv():
        _, bad_g = run(card_params, small, DEV)
    el = abs(card_loss - cpu_loss) / abs(cpu_loss)
    errs, bad = leaf_errs(card_g), leaf_errs(bad_g)
    worst, bad_worst = max(errs, key=errs.get), max(bad, key=bad.get)
    log(f"parity {PARITY_LAYERS} layers seq {PARITY_SEQ}: loss_sum card {card_loss:.4f} / cpu "
        f"{cpu_loss:.4f} (rel {el:.2e}); the CPU pass took {t_cpu:.1f} s")
    log("parity per-leaf ||g_card - g_cpu|| / ||g_cpu||: "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    log(f"parity worst leaf {worst} {errs[worst]:.2e}; planted fault (dK/dV from one query "
        f"head): worst leaf {bad_worst} {bad[bad_worst]:.2e}, "
        + ", ".join(f"{k} {e:.2e}" for k, e in bad.items() if e > PARITY_LEAF_REL_TOL))
    check(math.isfinite(card_loss) and all(math.isfinite(e) for e in errs.values()),
          "non-finite card result")
    check(el <= PARITY_LOSS_REL_TOL, f"loss_sum relative difference {el}")
    check(errs[worst] <= PARITY_LEAF_REL_TOL, f"gradient leaf {worst}: relative difference "
          f"{errs[worst]}")
    check(bad[bad_worst] > PARITY_LEAF_REL_TOL,
          f"the per-leaf metric lets a planted dK/dV fault pass: {bad}")


def free_device() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per CUDA source, started together
    t0 = time.perf_counter()
    loaders = (flash_attention.load_library, flash_attention.load_train_library,
               ssd_chunk.load_library, rmsnorm.load_bwd_library)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for b in [pool.submit(f) for f in loaders]:
            b.result()
    sources = {flash_attention.SOURCE: r"paged_attention_[a-z]+",
               flash_attention.TRAIN_SOURCE: r"attn_[a-z_]+", ssd_chunk.SOURCE: None,
               rmsnorm.BWD_SOURCE: r"rmsnorm_bwd_[a-z]+"}
    for src in sources:
        log(f"build: {src} (nvcc sm_90a) -> "
            f"{_build.library_path(src).relative_to(_build.BUILD_DIR.parents[1])}")
    log(f"build: {len(loaders)} CUDA sources in {time.perf_counter() - t0:.1f} s")
    for src, names in sources.items():
        for line in (ptxas_lines(src, names) if names else []):
            log(f"build: ptxas -v, {src}: {line}")
    t0 = time.perf_counter()
    ones = torch.ones(2048, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for model in (False, True):
            rmsnorm.rmsnorm(torch.ones(4, 2048, device="cuda", dtype=dtype), ones, model=model)
        masked_accum.masked_accum(torch.zeros(4096, device="cuda"),
                                  torch.ones(4096, device="cuda", dtype=dtype), 1.0)
    torch.cuda.synchronize()
    log(f"build: Triton JIT (rmsnorm, masked_accum) {time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain versions
    rng = np.random.default_rng(args.seed)
    cfg = get_config("qwen2_5_3b")
    prompt_lens = [int(n) for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]
    k4_err = k4_checks(rng, prompt_lens)
    k2_err = k2_checks(rng)
    k3_fwd_err, k3_bwd_err = k3_checks(rng)
    k2b_err, k2b_t = k2_bwd_checks_and_timing(rng)
    k1_err, k1_t = k1_checks_and_timing(rng)
    free_device()
    k6_err = k6_checks(rng)
    k5_err = k5_checks(rng)
    free_device()
    k4_t = k4_timing(rng, prompt_lens)
    k2_t = k2_timing(rng)
    k3f_t, k3b_t = k3_timing(rng)
    k6_t = k6_timing(rng)
    k5_t = k5_timing(rng)
    free_device()

    # 4. serving at full width
    t0 = time.perf_counter()
    params = compute_params(init_params(cfg, seed=args.seed, device=DEV), cfg)
    torch.cuda.synchronize()
    log(f"qwen2.5-3b: {cfg.param_count() / 1e9:.3f} B parameters, f32 init + bf16 "
        f"compute copy in {time.perf_counter() - t0:.1f} s; prompt lens {prompt_lens}")
    first_step_logits_check(cfg, params, prompts)
    ops.reset_launch_counts()  # the main path starts here
    out_unpacked, runs_u = serve(cfg, params, prompts, packed=False)
    out_packed, runs_p = serve(cfg, params, prompts, packed=True)
    counts = ops.launch_counts()  # ... and ends here
    same = sum(a == b for u in out_unpacked for a, b in zip(out_unpacked[u], out_packed[u]))
    log(f"packed vs unpacked greedy agreement: {same}/{SLOTS * NEW_TOKENS}")
    check(counts["paged_attention"] > 0 and counts["rmsnorm"] > 0, f"kernels not run: {counts}")
    serve_counts = counts
    del params
    free_device()

    # 5. Mamba-2 serving at full width and depth
    mamba_counts, _ = mamba_phase(args.seed)
    free_device()

    # 6. training at full depth, then the 2-layer card-vs-CPU parity
    train_counts = train_phase(cfg, args.seed)
    free_device()
    parity_phase(cfg, args.seed)
    launches = {k: serve_counts[k] + mamba_counts[k] + train_counts[k] for k in serve_counts}
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was launched no time on the main paths")

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:238",
             launches=launches["paged_attention"], max_abs_err=k4_err,
             ms=k4_t["decode"]["ms"], plain_ms=k4_t["decode"]["plain_ms"],
             bound_ms=k4_t["decode"]["bound_ms"], bound_by=k4_t["decode"]["bound_by"],
             library_ms=None),
        dict(name="rmsnorm", route="triton",
             source="src/repro_torch/kernels/rmsnorm.py",
             replaces="src/repro/kernels/rmsnorm.py:27",
             launches=launches["rmsnorm"], max_abs_err=k2_err,
             ms=k2_t["decode"]["ms"], plain_ms=k2_t["decode"]["plain_ms"],
             bound_ms=k2_t["decode"]["bound_ms"], bound_by=k2_t["decode"]["bound_by"],
             library_ms=k2_t["decode"]["library_ms"]),
        dict(name="rmsnorm_bwd", route="cuda", source="src/repro_torch/kernels/rmsnorm_bwd.cu",
             replaces="src/repro/kernels/rmsnorm.py:27",
             launches=launches["rmsnorm_bwd"], max_abs_err=k2b_err, **k2b_t),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:91",
             launches=launches["flash_attention"], max_abs_err=k3_fwd_err, **k3f_t),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:91",
             launches=launches["flash_attention_bwd"], max_abs_err=k3_bwd_err, **k3b_t),
        dict(name="masked_accum", route="triton",
             source="src/repro_torch/kernels/masked_accum.py",
             replaces="src/repro/kernels/masked_accum.py:33",
             launches=launches["masked_accum"], max_abs_err=k1_err, **k1_t),
        dict(name="ssd_chunk", route="cuda", source="src/repro_torch/kernels/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk.py:104",
             launches=launches["ssd_chunk"], max_abs_err=k6_err, **k6_t["serve"],
             library_ms=None),
        dict(name="ssd_segment", route="cuda", source="src/repro_torch/kernels/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk.py:65",
             launches=launches["ssd_segment"], max_abs_err=k5_err, **k5_t["mixed"],
             library_ms=None),
    ]
    log(f"launches, qwen serving: {serve_counts}; mamba serving: {mamba_counts}; "
        f"training: {train_counts}")
    for k in kernels:
        check(all(isinstance(k[f], float) and math.isfinite(k[f])
                  for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")), f"bad record {k}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
