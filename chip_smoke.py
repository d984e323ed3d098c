#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failed check raises and the script exits non-zero
without printing a result:

1. device — the card's name and power limit (``nvidia-smi``); fails
   without CUDA;
2. build — the CUDA paged-attention kernel from
   ``src/repro_torch/kernels/paged_attention.cu`` (``nvcc``, sm_90a) and the
   Triton RMSNorm JIT, with their build seconds;
3. kernels — each kernel against its plain PyTorch version on the card at
   qwen2.5-3b widths (paged attention: bf16 and int8 pools, window,
   softcap, hostile tables, padding and fully masked queries, the decode
   step's grid split many ways, a prefill-sized grid unsplit; RMSNorm: d = 2048, both modes, bf16 and f32, row counts
   on and off the block), with device times (CUDA-graph replay) beside
   each kernel's bound;
4. serving — qwen2.5-3b at full width (36 layers, random weights from
   ``--seed``) through ``ContinuousBatcher(cache="paged", chunk_size=64,
   token_budget=256)``, unpacked then packed, 8 requests of 128-512 prompt
   tokens and 32 new tokens each; the launch counters must show 36
   paged-attention and 73 RMSNorm launches per engine step, and the first
   prefill step's logits must agree with the dense-cache engine's plain
   attention.

The last two lines of standard output are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
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
from repro_torch.kernels import _build, flash_attention, ops, ref, rmsnorm  # noqa: E402
from repro_torch.models.layers import _paged_quantize  # noqa: E402
from repro_torch.models.model import compute_params, init_params, prefill_chunk  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

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


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call of ``fn``.

    The call is captured once into a CUDA graph and replayed between two
    events, behind a short spin kernel that keeps the device busy while
    the host enqueues: the events then bracket the call's kernels alone,
    not the host's launch cost (Triton's launcher takes longer on the host
    than RMSNorm takes on the card).  L2 is flushed (64 MiB write) before
    each call, as the serving loop finds it: 36 layers of weights and
    pools pass through L2 between two calls of one layer's kernel."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: builds, allocator
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
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
        out = flash_attention.paged_flash_attention(**a, **kw)
        want = ref.paged_attention_ref(**a, **kw)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        check(bool(torch.isfinite(out.float()).all()), f"K4 {name}: non-finite output")
        check(torch.allclose(out.float(), want.float(), **K4_TOL),
              f"K4 {name}: max |err| {err} beyond {K4_TOL}")
        if zero_rows is not None:
            check(int(zero_rows.sum()) > 0, f"K4 {name}: scenario has no zero rows")
            check(bool((out[zero_rows] == 0).all()), f"K4 {name}: rows not exactly zero")
        t = a["q"].shape[0]
        splits, _ = flash_attention.split_blocks(t * KV, BLOCKS, flash_attention._sm_count(0))
        if name.startswith("decode"):
            check(splits > 2, f"K4 {name}: {splits} splits, the decode grid should split > 2 ways")
        log(f"K4 {name:15s} T={t:3d} splits={splits} max|err|={err:.3e} ok")
    return max_err


def k4_timing(rng, prompt_lens):
    """Kernel, plain version and bound at two main-path shapes: a decode
    step (one query per slot, mid-generation) and a mixed packed step (4
    prefill chunks of 64)."""
    decode = decode_scenario(rng, prompt_lens)
    mixed = paged_scenario(rng, [n for n in prompt_lens], [CHUNK] * 4 + [1] * 4)
    rows = {}
    for shape, a in (("decode", decode), ("mixed", mixed)):
        kern = time_ms(lambda: flash_attention.paged_flash_attention(**a))
        plain = time_ms(lambda: ref.paged_attention_ref(**a), iters=10)
        nbytes, flops = paged_cost(a)
        b, by = bound_ms(nbytes, flops)
        rows[shape] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by,
                           T=a["q"].shape[0])
        log(f"K4 time {shape:6s} T={a['q'].shape[0]:4d}: kernel {kern * 1e3:.1f} us, "
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
    """At the main path's shapes: a decode step (8 rows) and the packed
    mixed step (257 rows), bf16 model mode."""
    rows_out = {}
    s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV)
    for shape, rows in (("decode", SLOTS), ("mixed", BUDGET + 1)):
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

    # 2. build
    t0 = time.perf_counter()
    flash_attention.load_library()
    t_k4 = time.perf_counter() - t0
    log(f"build: paged_attention.cu (nvcc sm_90a) {t_k4:.1f} s -> "
        f"{_build.library_path(flash_attention.SOURCE).relative_to(_build.BUILD_DIR.parents[1])}")
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for model in (False, True):
            rmsnorm.rmsnorm(torch.ones(4, 2048, device="cuda", dtype=dtype),
                            torch.ones(2048, device="cuda"), model=model)
    torch.cuda.synchronize()
    log(f"build: rmsnorm Triton JIT (4 variants) {time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain versions
    rng = np.random.default_rng(args.seed)
    cfg = get_config("qwen2_5_3b")
    prompt_lens = [int(n) for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]
    k4_err = k4_checks(rng, prompt_lens)
    k2_err = k2_checks(rng)
    k4_t = k4_timing(rng, prompt_lens)
    k2_t = k2_timing(rng)

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

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:238",
             launches=counts["paged_attention"], max_abs_err=k4_err,
             ms=k4_t["decode"]["ms"], plain_ms=k4_t["decode"]["plain_ms"],
             bound_ms=k4_t["decode"]["bound_ms"], bound_by=k4_t["decode"]["bound_by"],
             library_ms=None),
        dict(name="rmsnorm", route="triton",
             source="src/repro_torch/kernels/rmsnorm.py",
             replaces="src/repro/kernels/rmsnorm.py:27",
             launches=counts["rmsnorm"], max_abs_err=k2_err,
             ms=k2_t["decode"]["ms"], plain_ms=k2_t["decode"]["plain_ms"],
             bound_ms=k2_t["decode"]["bound_ms"], bound_by=k2_t["decode"]["bound_by"],
             library_ms=k2_t["decode"]["library_ms"]),
    ]
    for k in kernels:
        check(all(isinstance(k[f], float) and math.isfinite(k[f])
                  for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")), f"bad record {k}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
