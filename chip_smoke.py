#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failed check raises and the script exits non-zero
without printing a result.  Every serving and training path runs twice:
eagerly under ``repro_torch.graphs.disable_graphs()`` and as the default,
each step a captured CUDA graph (``graphs.StepGraph``; its capture time and
pool size printed); the graphed runs are the main path (the launch
counters' window) and must give the eager runs' streams, losses and
gradient leaves (bit-identical, or within ``GRAPH_LEAF_GAP`` of a leaf's
norm with the leaf that differs named).  A planted fault, one replay whose
input copy is skipped, must fail the stream check.

1. device — the card's name and power limit (``nvidia-smi``); fails
   without CUDA;
2. build — the four CUDA sources, ``paged_attention.cu``,
   ``flash_attention.cu``, ``ssd_chunk.cu`` and ``rmsnorm.cu``
   (``nvcc``, sm_90a, the builds started together; ptxas's registers and
   spills of the K3, K4 and K2 forward and backward kernels printed, K3's
   and K4's per head dim, K2's
   forward's plan and dynamic shared memory at the main paths' shapes, and
   each SSD kernel instance's and K6's backward's two kernels' with their
   shared memory and CTAs an SM), and the Triton kernel's (K1) JIT, with
   their build seconds;
3. kernels — each kernel against its plain PyTorch version on the card at
   qwen2.5-3b widths, timed by CUDA-graph replay with L2 flushed, beside
   its bound, its plain version's time and, where one PyTorch call computes
   the same function, that call's time:
   * paged attention (K4): bf16 and int8 pools, window, softcap, hostile
     tables, padding and fully masked queries, the decode step's grid split
     many ways, a prefill-sized grid; the tile plan passed or made by the
     wrapper, and padded to a packed step's fixed rows as the engine makes
     it (timed padded, the unpadded plan beside); a planted fault (a tile's
     last page skipped) must fail the same check;
   * RMSNorm (K2): d = 2048 and 768 (serving's and both trainings' row
     counts, ragged ones, rows that ring through the stage slots, rows one
     slot wide), both modes, f32, bf16 and f16, row counts on and off the
     plan; aligned and one element off alignment (the element-wise path,
     the aligned run's bits); two runs bit-identical; rows 0..7 alone the
     same bits as in the 8,192-row call; a planted fault (each row's last
     16-byte vector left out of its sum) must fail the bf16 check; timed at
     serving's and training's shapes, one replay and back to back; its backward
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
     gradients), keep 0 and 1, and as the Local-SGD step (keep 1, scale
     -lr: within one f32 spacing of the sum);
   * the SSD terms at mamba2-130m's widths (24 heads of 64, state 128,
     f32), row by row: K6 (intra-chunk) over 8 rows of one and of two
     256-token chunks, at the serving run's 64-row and 16-row (decode)
     steps and at 17 rows, K5 (segment-masked) at the packed mixed capacity
     (257: decodes, prefill chunks, padding), the packed decode capacity
     (8), a padding-heavy step and one segment over 13 key tiles; each
     check also against a planted fault it must reject (K6's diagonal
     16-key tile skipped; K5's segment mask dropped), beside the row error
     of the plain version with its operands rounded to TF32 (what one TF32
     pass would give); two runs bit-identical; times at the serving
     shapes and (K6) at the Mamba-2 training micro-batch beside the
     tensor-core bound (the record's) and the f32-FMA bound;
   * K6's backward (two launches: the key-tile pass and the dC pass) at
     the training shape (B 4, NC 8, L 256) and at L 64: dx row by row,
     ddt, dcum, dB and dC by norm, two runs bit-identical, two planted
     faults (dB without the diagonal key tile, dcum without its row part);
     timed at both shapes, launch by launch too, beside its plain version
     and both bounds; K2's backward again at mamba2-130m's width (d 768,
     8,192 rows), bf16 and f32;
4. serving — qwen2.5-3b at full width (36 layers, random weights from
   ``--seed``) through ``ContinuousBatcher(cache="paged", chunk_size=64,
   token_budget=256)``, unpacked then packed, 8 requests of 128-512 prompt
   tokens and 32 new tokens each; the launch counters must show 36
   paged-attention and 73 RMSNorm launches per engine step (a replay adds
   what its capture recorded), and the first prefill step's logits must
   agree with the dense-cache engine's plain attention; the planted
   stale-input fault runs here;
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
   device time with the port's 16-row chunk against the reference's
   256-row padding, and the packed-vs-unpacked agreement in f32;
6. training — qwen2.5-3b at 36 layers through ``repro_torch.train.train``:
   f32 master weights, bf16 compute, remat, synthetic packed sequences of
   2048 tokens, 4 virtual workers x 2 micro-batches of one sequence,
   AdamW (lr 1e-4, clip 1.0), DropCompute at a fixed tau (the median of
   the run's per-worker latency sums under ``paper_lognormal``), 3 steps.
   Losses must be finite, the drop fractions those of the numpy latency
   draws, and the launch counters those the code implies per kept
   micro-batch; the final parameters and step 0's accumulated gradient
   (36 layers) of the graphed run against the eager run's; then a 2-layer
   full-width model at 256 tokens must give
   ``loss_sum`` and every gradient leaf on the card (kernels, bf16)
   within a stated tolerance of the CPU's (plain versions, f32), and a
   planted K3 backward fault must fall outside it;
7. Local-SGD + DropCompute (appendix B.3) — qwen2.5-3b at 36 layers through
   ``core.local_sgd.LocalSGD`` (f32 P, W and S trees, the bf16 compute
   copy, remat): 2 workers x 2 local steps of one 2048-token sequence x 2
   rounds, lr 1e-4, the keep mask of fig. 12's single-server straggler
   scenario capped at tau = 0.32 (the first seed from ``--seed`` that drops
   a step, printed); eager then graphed: finite round losses, graphed equal
   to eager (losses and final parameters), the launch counters the code
   implies (14 K1 launches a kept step, none a dropped step, 14 a worker
   for S += W), each round's wall seconds, each local step's device ms and
   the allocated peak; then a 2-layer full-width model at 256 tokens,
   lr 1e-2: round losses and every leaf's update on the card (kernels,
   bf16) within a stated tolerance of the CPU's (plain versions, f32), and
   a planted K1 fault (the scale's sign flipped for one leaf) outside it;
   then mamba2-130m at ``M_LSGD_LAYERS`` (24, its full depth) through the
   same run, eager then graphed, with the same checks but the parity (the
   local steps run K6 forward and backward, the post-step losses K6's
   forward);
8. checkpoints — a 2-layer full-width qwen through ``train`` (2 workers x
   2 micro-batches, AdamW, DropCompute with the online controller, the
   badnode scenario): run A saves at step 1, run B resumes from it; B's
   losses, drop fractions, tau trajectory and final parameters must equal
   the uninterrupted 3-step run's bit for bit; the bytes written and the
   save and restore seconds are printed, the directory deleted;
9. data parallel (``repro_torch.dist``, the trainer's ``mesh=``) — 9a: the
   training phase's run (36 layers) as one rank of a one-rank NCCL group in
   this process: losses, drop fractions and every final leaf bit-identical
   to the training phase's graphed run, the launches its kept micro-batches
   imply, each step's All-Reduce device ms (12.34 GB of f32 in place);
   9b: the same data and latencies at 4 layers of the same widths on two
   ranks sharing the card (spawned processes, gloo with CUDA tensors, 2
   workers a rank; the card's compute mode must be ``Default`` and its free
   memory twice a rank's reckoning) against 9a's code at 4 layers on one
   rank: every rank's replica, losses, drop fractions and tau trajectory the
   same, each rank's kept and computed micro-batches those of its workers'
   masks, drop fractions and tau exact, the losses within
   ``GRAPH_LEAF_GAP`` of the one-rank run's and every final leaf within
   ``DP_ORDER_FACTOR`` times the gap the one-rank run itself shows with its
   sums in the reverse order (``DP_ZERO_GAP_FLOOR`` of its norm where that
   gap is 0); each rank's step wall, All-Reduce seconds and peak memory
   printed; then, in the same two processes, a planted fault (rank 1 skips
   one kept micro-batch) that both the launch counts and the values must
   reject, the log naming each check that did; then the same two-rank
   runs, sound and planted,
   for mamba2-130m at ``M_DP_LAYERS`` (24, its full depth; two replicas
   fit);
10. Mamba-2 training — mamba2-130m at 24 layers (random weights from
   ``--seed``, f32 master, bf16 compute copy, remat) through ``train``: the
   training phase's 4 workers x 2 micro-batches, each of 4 packed
   2048-token sequences (8,192 tokens), AdamW (lr 1e-4, clip 1.0), its tau
   rule, 3 steps, eager then graphed (the counters' window): finite losses,
   the drop fractions of the latency draws, the launches the code implies
   a kept micro-batch (per layer one K6 forward and one more under remat,
   one K6 backward, one K2 forward and one more under remat, one K2
   backward; the final norm; one K1 a leaf), the graphed run's losses and
   final parameters and step 0's accumulated gradient against the eager
   run's; step walls, ms a kept micro-batch, kept tokens/s, peak memory
   beside the reckoning of its trees; then a 2-layer full-width model at
   256 tokens: ``loss_sum`` and every gradient leaf on the card (kernels,
   bf16) against the CPU (plain, f32), each leaf within the larger of 5%
   and twice the CPU's own bf16 gap, and a planted K6-backward fault (dcum
   without its row part) outside it;
11. the paper's own models (BERT, 'B' encoder blocks, appendix B.1) —
   11a: K3's (head dim 64, group 1) bidirectional build at bert-1.5b's
   micro-batch (B 16, H = KV = 25, S 128) and bert-large's phase-2 length
   (B 2, H = KV = 16, S 512), forward and backward against the plain
   versions row by row, two backward runs bit-identical, two planted faults
   (the causal flag passed for one launch; the last 64-key step skipped)
   outside the limit; timed by graph replay with L2 flushed (one replay, and
   back to back in one graph), the backward launch by launch, SDPA's forward
   and backward alone beside it; 11b: a 2-layer bert-1.5b (d 1600) on 2 x
   128 tokens, ``loss_sum`` and every gradient leaf on the card against the
   CPU as in phase 10, a planted K3 fault (causal in place of
   bidirectional) outside it; 11c: bert-1.5b at full width cut to
   ``BERT_LAYERS`` of its 48 layers (d 1600, 25 heads of 64; the whole
   model 1,536.8 M parameters; random weights from ``--seed``; the cut
   keeps the smoke inside its time limit) through ``train`` with LANS, 4 workers x 12
   micro-batches of 16 x 128 tokens, the training phase's tau rule, 3
   steps, eager then graphed, with phase 10's checks and readings; 11d:
   bert-large at 24 layers with LAMB, 4 workers x 2 micro-batches of 16 x
   128 tokens, 2 steps, the same;
12. recurrentgemma-2b serving (the 'R' family: RG-LRU and local
   attention) — 12a: K4's (head dim 256, group 10) build with phase 3's
   K4 checks at recurrentgemma's widths (10 heads on 1 KV head, contexts
   up to 2,332, its 2,048-token window on the unsplit and decode grids)
   and two more planted faults (heads 8-9 given zero queries; one split's
   partial dropped from a token's merge), timed at its decode and mixed
   steps under the window; K2's forward at d 2,560 (5,120-byte rows) at
   its steps' row counts, timed beside ``F.rms_norm``; 12b: a 3-layer
   (RRL) full-width model's first dense and packed steps over paged caches
   (K4 in the 'L' layer), card (kernels, bf16) against CPU (plain, f32),
   logits within ``LOGITS_ROW_TOL`` a row, a planted K4 fault outside
   it; 12c: recurrentgemma-2b at full width and depth (26 layers: 18 'R',
   8 'L'; random weights from ``--seed``, f32 master and a bf16 compute
   copy) through ``ContinuousBatcher(cache="paged", chunk_size=64,
   token_budget=256, page_size=16)``, unpacked then packed, eager then
   graphed: 8 requests of 128-512 prompt tokens and one of 2,300 (past the
   window), 32 new tokens each; full-length streams, no leaked pages, no
   prefix-shared tokens, graphed equal to eager, 8 K4 and 53 K2 launches
   an engine step; step times, tokens/s and peak memory printed;
13. recurrentgemma-2b training (the 'R' family through DropCompute) —
   13a: K3's (head dim 256, group 10) build, causal under the window, at
   the training shape (B 1, 10 heads on 1 KV head, S 8,192, window
   2,048) and at B 2 x 512 tokens under window 128, forward and backward
   against the plain versions row by row, two backward runs bit-identical,
   three planted faults outside the limit (``window=0`` passed; the
   window's edge moved one 64-step inward in the schedule; the diagonal
   step skipped); timed by graph replay with L2 flushed (one replay, and
   back to back), the backward launch by launch, beside SDPA with the same
   boolean band mask (forward, and its backward alone; the kernel each
   ran is printed); K2's backward at 8,192 x 2,560 (phase 3's checks) beside
   ``F.rms_norm``'s backward; 13b: a 3-layer (RRL) full-width model on 2 x
   256 tokens, ``loss_sum`` and every gradient leaf on the card against the
   CPU as in phase 10 (the RG-LRU leaves printed apart), a planted K3
   backward fault (``one_head_dkdv``) outside it; 13c: recurrentgemma-2b at
   full width and depth (26 layers, 2,836 M parameters, random weights from
   ``--seed``) through ``train`` with AdamW, 4 workers x 2 micro-batches of
   one 8,192-token sequence, the training phase's tau rule, 3 steps, eager
   then graphed, with phase 10's checks and readings (launches: 2 K2 an 'R'
   layer, and again under remat);
14. decode, sampling and speculation — 14a ``decode_step`` at full width
   (qwen2.5-3b paged against dense, recurrentgemma-2b ring and paged past
   its 2,048-row wrap, mamba2-130m; planted faults); 14b the sampler card
   against CPU; 14c sampled serving with a replay of every token; 14d
   n-gram and self-draft speculation with a replay of every acceptance;
15. the dense zoo — internlm2-1.8b (24 layers, 16 / 8 heads of 128),
   starcoder2-7b (32 layers, 36 / 4 heads, LayerNorm, QKV bias, GELU) and
   gemma3-27b (62 layers 'LLLLLG', window 1,024, 32 / 16 heads, QK-norm,
   GeGLU, vocab 262,144, bf16 parameters: its f32 masters would not fit)
   at full width and depth, random weights from ``--seed``, each through
   the qwen run's engine (8 requests of 128-512 prompt tokens and, for
   gemma3-27b, one of ``ZOO_LONG`` past its window; 32 new tokens each):
   a 2-layer full-width card-vs-CPU logits check (gemma3-27b's as 'LG')
   within ``LOGITS_ROW_TOL`` with a planted K4 fault outside it;
   paged vs dense first-step logits within ``LOGITS_REL_TOL`` (gemma3-27b
   also every 64-token chunk of the long prompt, past the window's edge);
   unpacked and packed, eager then graphed (the counters' window): full
   streams, no leaked pages, graphed equal to eager, one K4 an attention
   layer and (RMSNorm) 2L + 1 K2 a step (none for starcoder2-7b's
   LayerNorm); step times, tokens/s, peak memory and the init's peak;
   K4's (128, 2) and (128, 9) builds are held in phase 3 (gemma3-27b's and
   starcoder2-7b's widths, with phase 12a's planted faults) and timed at
   each model's decode and mixed steps;
16. the front-end — gemma3-27b through ``AsyncEngine`` over the paged,
   packed engine, graphed: submissions while steps run (one during the
   first, capturing step), greedy and seeded sampled requests, a cancel
   mid-flight, a waiting-room overflow (``AdmissionError``) and a deadline
   drop that reclaims its pages; every stream token-identical to the same
   engine driven synchronously through the same schedule of submissions
   and cancels (``EngineSchedule``), and a planted fault (one published
   token dropped) rejected; TTFT of the requests whose wait saw no graph
   capture (the metric) beside TTFT over all, captures included; then
   ``examples/serve_http_torch.py``'s card command (``HTTP_ARGV``: it
   builds gemma3-27b itself, bf16 parameters, serves on 127.0.0.1 at port
   0 and runs its self-test), in process for its launch counts;
17. the MoE family — 17a K4's (128, 6) build (mixtral-8x22b: 48 / 8 heads,
   one n8 tile, heads 6-7 padding) and (128, 16) build (qwen3-moe-235b-a22b:
   64 / 4 heads, two full n8 tiles) held as phase 3 holds K4 (decode and
   mixed grids, bf16 and int8 pools, mixtral's 4,096 window past its edge,
   planted faults) and timed at each model's decode and mixed steps; K2 at
   d 6144 and 4096; then per model 17c a 2-layer full-width card-vs-CPU
   check: the first MoE layer on the card's own input (dense dispatch and
   capacity at cf 1.25 and inf; routes equal but at near-ties under
   ``MOE_LAYER_TIE``, a planted bf16 router rejected; rows within
   ``MOE_ROW_TOL``) and the first steps' logits with the card's routes
   pinned to the CPU's (the routes it would take otherwise at near-ties
   under ``MOE_MODEL_TIE``, a planted router off by one rejected), with
   planted K4 and router (no top-k renormalisation) faults outside the
   limits; 17b the model at ``MOE_LAYERS`` layers and full width
   (bf16 weights drawn on the card; the depth cut is the one one card
   forces): paged vs dense first step, mixtral's ``MOE_LONG``-token prompt
   chunk by chunk past its window, then the zoo's engine with 8 requests of
   128-512 tokens (mixtral one more of ``MOE_LONG``), unpacked and packed,
   in the dense dispatch and at the config's capacity factor, eager then
   graphed (the counters' window): full streams, no leaks, graphed equal to
   eager, L K4 and 2L + 1 K2 a step, each step's ``expert_overflow``
   equal to a plain recount from its own router ids (eager) and the same
   graphed; step times, tokens/s, peaks beside the weights, overflow a
   step.  Every serving phase collects the earlier runs' engines and
   parameters before it draws its own and reads its peaks after a reset.

The last two lines of standard output are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``.  K4's (256, 10) build has a record of
its own (``paged_attention_d256_g10``), read at recurrentgemma's decode
step with phase 12c's launches; K4's (128, 8) record keeps the earlier
phases'.  K3's (64, 1) build has records of its
own (``flash_attention_d64_g1`` and its backward), read at bert-1.5b's
micro-batch with phase 11's launches, and so has its (256, 10) build
(``flash_attention_d256_g10`` and its backward), read at recurrentgemma's
training shape with phase 13c's launches; K3's (128, 8) records keep the
earlier phases' launches.  K6's backward's record row is read at
the Mamba-2 training shape, its launches from phase 10; K2's forward's at
the Mamba-2 training micro-batch (8,192 x 768).  K6 and K5's
record rows are read at the mamba serving run's shapes: 8 rows of one
64-row chunk (a 64-token
prefill step), and the packed
mixed step.  K4's (128, 2) build's record (``paged_attention_d128_g2``) is
read at gemma3-27b's decode step under its window, with internlm2-1.8b's
and gemma3-27b's launches (15) and the front-end's (16); its (128, 9)
build's (``paged_attention_d128_g9``) at starcoder2-7b's decode step with
its launches; its (128, 6) and (128, 16) builds' (``paged_attention_d128_g6``,
``paged_attention_d128_g16``) at mixtral-8x22b's and qwen3-moe-235b-a22b's
decode steps with their serving's launches (17).
"""
from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import graphs  # noqa: E402  (fails outside a checkout)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Accumulator, DropConfig, LatencyModel, NoiseModel  # noqa: E402
from repro_torch.core import accumulate_grads, drop_mask  # noqa: E402
from repro_torch.core.engine import make_grad_fn  # noqa: E402
from repro_torch.core.local_sgd import LocalSGD, StragglerScenario  # noqa: E402
from repro_torch.data import DataConfig, microbatches_at  # noqa: E402
from repro_torch.dist import Distribution, procs  # noqa: E402
from repro_torch.launch import steps as dp_steps  # noqa: E402
from repro_torch.kernels import _build, flash_attention, masked_accum, ops, ref, rmsnorm  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.layers import _paged_quantize  # noqa: E402
from repro_torch.models import layers, moe, ssm  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    compute_params,
    init_decode_cache,
    init_params,
    packed_prefill,
    prefill_chunk,
)
from repro_torch.models.transformer import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request, pack_step  # noqa: E402
from repro_torch.serve import DraftModelProposer, NGramProposer, SamplingParams  # noqa: E402
from repro_torch.serve import SpecConfig, sampling, scheduler  # noqa: E402
from repro_torch.serve import AdmissionError, AsyncEngine, frontend  # noqa: E402
from repro_torch.serve import spec as spec_lib  # noqa: E402
from repro_torch.train import TrainConfig, checkpoint, train  # noqa: E402
from repro_torch.train.resilience import ControllerConfig, make_scenario  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; full 700 W power limit).  The
# SSD kernels compute at f32 accuracy with their products on the tensor
# cores, three TF32 products per f32 product: their record's operations
# bound is taken so (``ssd_bound``); the log gives beside it the bound with
# every product at the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

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
# version differ only in reduction order and rsqrt rounding (~1e-7); in bf16
# and f16 by at most one ulp of the output (K2_BF16_ULPS holds both).
K4_TOL = dict(atol=2e-2, rtol=2e-2)
K2_F32_TOL = dict(atol=1e-5, rtol=1e-5)
K2_BF16_ULPS = 1
# K2 in model mode, bf16 or f16: inv is rounded to x's dtype before the
# multiplies, so a row whose inv (f64) lies within this of the midpoint
# between two neighbouring values of the dtype (relative) may have it rounded
# either way by the kernel and by the plain version, each with its own f32
# sum of squares and rsqrt (~1e-6 apart at most); such a row is held to
# whichever rounding it is nearer (``k2_model_ulps``).  Seen on the card: one
# f16 row of 40,000 at 3.6e-8 from the midpoint, 2 ulps from the plain
# version.
K2_INV_TIE = 2.0 ** -18
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
# A graphed step against the same step run eagerly (``disable_graphs``): the
# same kernels on the same inputs, so bit-identical is expected; where a
# library picks another algorithm under capture, the largest gap of a
# gradient leaf (or a loss) must stay below 1e-3 of its norm.
GRAPH_LEAF_GAP = 1e-3
# K6 / K5 against their plain versions on the card, both f32, row by row
# (``row_rel_err``): C . B^T summed in the plain version's order, att . x in
# 3xTF32 (dropped lo.lo terms ~2^-22 relative), CUDA's expf (2 ulp) against
# torch's exp: ~3e-7 a row.  The rows are ill-conditioned where a steep
# decay leaves one cancelling C_i . B_i term (another summation order of it
# alone reads up to 4e-4: PERF.md, the SSD findings); a planted fault (the
# diagonal key tile skipped, the segment mask dropped) zeroes or mixes whole
# rows, ~0.1-1.
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
# K6's backward against its plain version on the card, both f32: dx row by
# row (``row_rel_err``: u = sum_i S_ij e_ij dy_i in 3xTF32 as the forward's
# att . x, times dt), ddt, dcum, dB and dC each relative to its norm (dot
# products over the head dim; dcum the difference of the column and row
# parts, the row part dy . y read from the forward kernel's y; dB and dC
# sums over the heads and the chunk in another order than the plain
# version's).  A planted fault (the diagonal key tile left out, or dcum's
# row part dropped) moves a whole output, ~0.01-1.
SSD_BWD_TOL = 1e-4

# the Mamba-2 training phase (10): mamba2-130m at 24 layers, the training
# phase's 4 virtual workers x 2 micro-batches, each of 4 packed 2048-token
# sequences (8,192 tokens), 3 steps
M_TRAIN_SEQS = 4
# its 2-layer card-vs-CPU gradient check (``train_parity``, which phase 11
# runs for bert-1.5b too): bf16 rounds the compute copy and
# every activation of the block (the projections, the conv taps, the gate,
# the norms) where the CPU's f32 run does not; on the CPU a bf16 compute
# copy moves every gradient leaf of this model by 2.5-3.8% of its norm (a_log
# and dt_bias, whose gradients sum dcum's cancelling difference over every
# token, as much as the rest).  Each leaf is held to the larger of
# PARITY_LEAF_REL_TOL and PARITY_CONTROL_FACTOR times that control's gap for it,
# measured in this run (the CPU's plain versions in bf16 against f32); a
# planted K6-backward fault (dcum's row part dropped) moves the leaves 17x
# to 40,000x on the CPU.
PARITY_CONTROL_FACTOR = 2

# phase 11, the paper's BERT models (appendix B.1): bert-1.5b's micro-batch of
# 16 sequences x 128 tokens, 12 accumulations a worker, LANS; bert-large 2
# micro-batches a worker, LAMB, 2 steps; K3's (head dim 64, group 1)
# bidirectional build checked at bert-1.5b's micro-batch (B 16, 25 heads,
# S 128) and at bert-large's phase-2 length (B 2, 16 heads, S 512)
BERT_SEQS, BERT_SEQ, BERT_MB = 16, 128, 12
# 11c's depth: bert-1.5b's full width at half its 48 layers (the eager run
# alone took 54 s of the smoke at 48)
BERT_LAYERS = 24
BERT_LARGE_MB, BERT_LARGE_STEPS = 2, 2
BERT_D = 64
BERT_K3_SHAPES = {"bert_1_5b": (16, 25, 128), "bert_large_s512": (2, 16, 512)}

# the training phase: qwen2.5-3b, 4 virtual workers x 2 micro-batches of one
# 2048-token sequence, 3 steps
TRAIN_SEQ, TRAIN_WORKERS, TRAIN_MB, TRAIN_STEPS = 2048, 4, 2, 3
PARITY_LAYERS, PARITY_SEQ = 2, 256

# the Local-SGD phase (appendix B.3): 2 workers x 2 local steps of one
# 2048-token sequence, 2 rounds, lr 1e-4; the keep mask from fig. 12's
# single-server straggler scenario capped at tau = H x 0.1 x 1.6
LSGD_WORKERS, LSGD_H, LSGD_ROUNDS, LSGD_LR = 2, 2, 2, 1e-4
LSGD_SCENARIO = dict(mode="single_server", p=0.3, delay=1.0, base=0.1, server_size=1)
LSGD_TAU = LSGD_H * 0.1 * 1.6
# K1 as the local step (scale -lr) against its plain version: the product
# keep * scale * grad is rounded, and Triton may fuse it into the add (one
# rounding where the plain version has two).  The two results then differ by
# at most half a spacing of the product plus half a spacing of each result
# (``f32_spacing``; a result across a binade edge has twice the spacing), so
# the limit is two spacings of the plain sum plus one of the product.  Where
# the add cancels, the sum's spacing is far below the product's.
# The 2-layer card-vs-CPU Local-SGD check: lr 1e-2 (an update of 1e-4 would
# sit near the f32 spacing of the weights, so the comparison would read
# rounding); each leaf's update over the run, dP = P_final - P_start, is a
# sum of -lr x gradients, each within the gradient parity's 5%
# (PARITY_LEAF_REL_TOL), so ||dP_card - dP_cpu|| / ||dP_cpu|| is held to
# the same 5%; the round losses, means of CE terms, to PARITY_LOSS_REL_TOL.
# A planted fault (K1's scale sign flipped for one leaf's local steps) turns
# that leaf's update around: ~2.
LSGD_PARITY_LR = 1e-2
LSGD_FAULT_LEAF = "/stack/groups/0/attn/wq"

# the checkpoint phase: a 2-layer full-width qwen through the trainer, 2
# workers x 2 micro-batches (with one micro-batch a worker,
# min_microbatches 1 keeps everything), 3 steps, the badnode scenario with
# the online controller deciding every step from step 1, saved at step 1
CKPT_LAYERS, CKPT_WORKERS, CKPT_MB, CKPT_STEPS, CKPT_AT = 2, 2, 2, 3, 1

# the data-parallel phase: 9b runs the training phase's data and latencies
# (4 workers x 2 micro-batches, 3 steps) on 2 gloo ranks sharing the card, at
# 4 layers so that two replicas fit on it; each rank's training pool is
# reckoned at 6 GiB (PERF.md); the spawned group's time limit
DP_LAYERS, DP_RANKS, DP_POOL_GIB, DP_TIMEOUT_S = 4, 2, 6.0, 600
# mamba2-130m through phases 7 and 9b (its micro-batches one 2048-token
# sequence, as qwen's there): the full depth in both; a 9b rank's training
# pool reckoned from phase 10's (6.28 GB at 8,192 tokens a micro-batch)
M_LSGD_LAYERS, M_DP_LAYERS, M_DP_POOL_GIB = 24, 24, 3.0
# 9b's final leaves against one rank's differ only by the order of the f32
# sums (each rank sums its own blocks, then the two sums are added).  How far
# that moves a leaf depends on its gradient: a cancelling sum (the attention
# K bias, whose every token's term nearly cancels) read 6.4e-3 of its norm on
# an H100 at 4 layers, a well-conditioned one far less (PERF.md, the
# data-parallel findings).  So the same one-rank run is made again with each
# step's kept micro-batches added in the reverse order (``reversed_sums``:
# the same sums, another order, no second rank), and each leaf is held to
# DP_ORDER_FACTOR times that run's gap for it, with no wider floor: a fixed
# floor of 1e-3 sat ~300x above what a skipped micro-batch does to
# mamba2-130m's leaves.  A leaf whose order gap reads 0 (its sums came out
# the same both ways) is held to DP_ZERO_GAP_FLOOR of its norm instead: four
# f32 spacings (2^-23 relative each), room for one more order of the same
# sums to round differently.
DP_ORDER_FACTOR = 4
DP_ZERO_GAP_FLOOR = 4 * 2.0 ** -23

# phase 12, recurrentgemma-2b serving: its local attention's widths (10 heads
# of 256 on 1 KV head, the (256, 10) build of K4) and window; 8 requests of
# the serving run's 128-512 prompt tokens and one of RG_LONG (past the
# window, so the long request's later queries mask keys), 32 new tokens
# each, through the qwen run's engine; a slot holds the long one
RG_H, RG_KV, RG_D, RG_WINDOW = 10, 1, 256, 2048
RG_LONG = 2300
RG_MAX_LEN = RG_LONG + NEW_TOKENS
RG_BLOCKS = -(-RG_MAX_LEN // PAGE)
RG_DIMS = (RG_H, RG_KV, RG_D, RG_BLOCKS)
# 12b and 15: a 2-3-layer full-width model's first dense and packed steps'
# logits, card (kernels, bf16) against the CPU (plain, f32), by
# ``row_rel_err`` (``logits_parity``): bf16 roundings of the weights'
# compute copy and the activations read ~0.01 a row on an H100
# (recurrentgemma's RRL, the dense zoo's 0.65-0.84%); a planted K4 fault
# (the heads of each group's last n8 tile given zero queries,
# ``without_heads``) reads 0.12-0.33 there (PERF.md), so the limit sits
# between the two.
RG_PARITY_LAYERS = 3
LOGITS_ROW_TOL = 0.05
#: K2 at recurrentgemma's width: its decode step (8 rows), its packed mixed
#: step (257) and its unpacked mixed step (8 x 64 = 512 rows) of 2,560
RG_K2_ROWS = (SLOTS, BUDGET + 1, SLOTS * CHUNK)
# phase 13, recurrentgemma-2b training: one sequence of RG_TRAIN_SEQ tokens a
# micro-batch (the RecurrentGemma report's training length; past twice the
# window, so its edge cuts every later query's keys and the reference's
# banded branch is the one it would take), the training phase's 4 workers x
# 2 micro-batches, 3 steps; K3's (256, 10) build held at that shape and at 2
# x 512 tokens under a window of 128 (its edge within one 128-key tile); the
# 3-layer (RRL) card-vs-CPU gradient check on 2 x 256 tokens
RG_TRAIN_SEQ = 8192
RG_K3_SHAPES = {"train": (1, RG_TRAIN_SEQ, RG_WINDOW), "short": (2, 512, 128)}

# phase 14: decode_step, sampling, speculation.  Each 14a layout's first
# DECODE_EAGER_STEPS steps also run eagerly (their logits must equal the
# graphed steps' bit for bit; the planted faults run over them too); the
# paged and ring layouts are held to the linear (dense) one by phase 4's
# LOGITS_REL_TOL at every step, mamba's decode_step to the engine's C = 1
# step by phase 5's MAMBA_LOGITS_ROW_TOL.  14b's sampler steps have
# SAMPLER_ROWS rows at qwen's and recurrentgemma's vocabularies; the Gumbel
# draws, card against CPU, within GUMBEL_TOL (absolute, relative): each
# ``log`` may differ by an ulp between libraries (CUDA's logf and the CPU's;
# the same as XLA against torch on the CPU: tests/test_torch_sampling.py),
# an ulp of the inner log near 1 (~2^-24) divided by -log(u) ~ 1 carried
# into the outer one, 2^-21 read at most.  14d verifies SPEC_K drafts a slot.
DECODE_EAGER_STEPS = 64
# mamba's cache leaves after one decode_step from the engine's own state,
# bf16 compute, each relative to its norm: MAMBA_DECODE_LEAF_TOL, 4x the
# sound reading (1.26e-2), 26x under the
# planted fault's (decay skipped: 1.28).  Run free in f32 compute (f32
# weights, each path on its own state for all 525 steps), the logits of
# every step (``row_gap``) and every leaf at the end: MAMBA_F32_DECODE_TOL,
# ~10x the sound reading (logits 9.5e-5, leaves 2.4e-5: f32 sums in other
# orders, K6's 3xTF32 products, through 24 layers of random weights),
# ~1,400x under the planted fault's (1.45; leaves 12.6).  Readings on an
# H100 80GB HBM3 at 700 W (PERF.md, 14a).
MAMBA_DECODE_LEAF_TOL = 0.05
MAMBA_F32_DECODE_TOL = 1e-3
SAMPLER_ROWS, SAMPLER_VOCABS = 8, (151_936, 256_000)
GUMBEL_TOL = (2.0 ** -20, 2.0 ** -21)
SPEC_K = 4
# phase 15, the dense zoo: internlm2-1.8b, starcoder2-7b and gemma3-27b at
# full width and depth through the qwen run's engine, 8 requests of 128-512
# prompt tokens and, for gemma3-27b, one more of ZOO_LONG tokens (past its
# 1,024-token window), 32 new tokens each; their 2-layer card-vs-CPU check
# is phase 12b's (``logits_parity``)
ZOO = ("internlm2_1_8b", "starcoder2_7b", "gemma3_27b")
ZOO_LONG = 1200
ZOO_PARITY_LAYERS = 2
# phase 16, the front-end over gemma3-27b: the waiting room and the engine
# queue it feeds (a burst of 4 x FE_WAITING_ROOM requests of FE_BURST_PROMPT
# tokens must meet AdmissionError)
FE_WAITING_ROOM, FE_MAX_QUEUE, FE_BURST_PROMPT = 4, 4, 16
# phase 17, the MoE family: mixtral-8x22b and qwen3-moe-235b-a22b at full
# width cut to MOE_LAYERS layers (one layer is 4.66 / 4.63 GiB of bf16
# weights; 12 with the embeddings are 56.7 / 57.9 GiB, the weights gemma3-27b
# serves with plus its headroom on an 80 GB card), through the zoo's engine
# in the dense dispatch and at the config's capacity factor (1.25), 8
# requests of 128-512 prompt tokens and, for mixtral, one more of MOE_LONG
# tokens (past its 4,096-token window), 32 new tokens each
MOE = ("mixtral_8x22b", "qwen3_moe_235b_a22b")
MOE_LAYERS, MOE_LONG, MOE_PARITY_LAYERS = 12, 4600, 2
# 17c: the MoE layer on the card's own input against the CPU's f32, row by
# row over the tokens routed alike: the card's bf16 expert weights and
# products (2^-9 relative each) against f32; a router that skips the top-k
# renormalisation scales each output by the kept probability mass (0.2-0.6
# at top-2 of 8, less at top-8 of 128), far outside it
MOE_ROW_TOL = 0.02
# Two runs of one MoE model that differ only in rounding can route a token
# at a near-tie of its k-th and (k+1)-th router logits to other experts, and
# its changed output reaches every later layer; so the run under test takes
# the other run's routes (``routes_pinned``), and the routes it would take
# otherwise are held by ``route_flips``: the router logits close, every
# token routed elsewhere at a stated near-tie of the pinned run's logits,
# at most MOE_FLIP_SHARE of a layer's tokens routed elsewhere, and each
# token's own top-k consistent with its own logits.
# 17c's MoE layer on the card's own input: both routers read the same f32
# input and f32 weights, so their logits differ by the order of f32 sums
# alone (4.0-4.6e-7 of the largest on the card, no token routed
# elsewhere); they must agree within MOE_LAYER_LOGITS of the largest, and a
# token may go elsewhere only at a gap under MOE_LAYER_TIE logits.  A
# router computed in bf16 (planted, ``router_in_bf16``) reads 2.8-2.9e-3.
MOE_LAYER_TIE, MOE_LAYER_LOGITS = 1e-4, 1e-5
# Whole models (17c's 2 layers, card against CPU; 17b's 12 layers, paged
# against dense): the routers read hidden states that differ by bf16
# roundings (the logits within LOGITS_REL_TOL of their largest).  A token
# may go elsewhere only at a gap under MOE_MODEL_TIE logits: the sound runs
# on the card flipped tokens at gaps up to 0.010 (2 layers), 0.025 (12
# layers) and 0.039-0.052 (mixtral's long prompt), on at most 0.078 of a
# layer's tokens; a router whose k-th choice is its (k+1)-th (planted,
# ``router_off_by_one``) moves 0.98-1.0 of them, at gaps up to 0.25
# (qwen3-moe) and 1.3 (mixtral).  Readings: PERF.md.
MOE_MODEL_TIE, MOE_FLIP_SHARE = 0.1, 0.25
# 17c's 2-layer steps take this many prompt tokens a slot (8 slots dense,
# 8 packed): the CPU's f32 pass runs every expert on every token
MOE_PARITY_CHUNK = 8


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


def ptxas_lines(source: str, names: str = r"attn_[a-z_]+", head_dims: bool = False):
    """One line per kernel of ``source`` whose name matches ``names``, from
    its build's ``ptxas -v`` report: registers at launch and the most bytes
    spilled (stores / loads) over its template instances (with
    ``head_dims``, one line per head-dim instance: K3's kernels are
    templates on D, K4's on (D, g)), and whether ptxas serialized its wgmma
    instructions for want of registers."""
    import re

    kernel = re.compile(r"\d+(" + names + r")(?:ILi(\d+)E(?:Li(\d+)E)?)?")
    seen, notes, name, spills = {}, [], None, (0, 0)
    for line in _build.ptxas_report(source).splitlines():
        m = kernel.search(line)
        if "Compiling entry function" in line and m:
            name = m.group(1)
            if head_dims and m.group(2):
                name += f" (D {m.group(2)}" + (f", g {m.group(3)})" if m.group(3) else ")")
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


def ssd_build_lines():
    """One line per SSD kernel instance (K6 / K5, heads a CTA): ptxas's
    registers and spills, and the dynamic shared memory and CTAs an SM the
    runtime counts for it; then the same for the K6 backward's two
    kernels."""
    import re

    inst = re.compile(r"(ssd_[a-z]+_kernel)ILi\d+ELi\d+ELi(\d)E")
    bwd = re.compile(r"ssd_bwd_([a-z]+)_kernel")
    out, name, spills = [], None, (0, 0)
    for line in _build.ptxas_report(ssd_chunk.SOURCE).splitlines():
        m = inst.search(line) or bwd.search(line)
        if "Compiling entry function" in line and m:
            name = m.groups()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            if len(name) == 2:
                kernel, hg = name
                ctas, smem = ssd_chunk.occupancy(int(hg), kernel[4:-7])
                what = f"{kernel} heads {hg}"
            else:
                ctas, smem = ssd_chunk.bwd_occupancy(name[0], M_H)
                what = f"ssd_bwd_{name[0]}_kernel ({M_H} heads)"
            out.append(f"{what}: {m.group(1)} registers, spill stores {spills[0]} B, loads "
                       f"{spills[1]} B, {smem} B dynamic shared memory, {ctas} CTAs an SM")
            name = None
    return out


def bound_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# K4: paged attention
# ---------------------------------------------------------------------------


def paged_scenario(rng: np.random.Generator, ctx, spans, dtype=torch.bfloat16, dims=None):
    """Pools whose slots own scattered pages, block tables, and packed
    queries: slot s has ``ctx[s]`` cached positions and ``spans[s]`` query
    tokens at its last positions.  ``dims``: (heads, KV heads, head dim,
    table blocks), qwen2.5-3b's serving run's by default."""
    h, kv, d, blocks = dims or (H, KV, D, BLOCKS)
    num_slots = len(ctx)
    num_pages = num_slots * blocks
    perm = rng.permutation(num_pages)
    tables = np.full((num_slots, blocks), num_pages, np.int32)
    for s, n in enumerate(ctx):
        nb = -(-n // PAGE)
        tables[s, :nb] = perm[s * blocks : s * blocks + nb]
    q_pos = np.concatenate([np.arange(n - m, n) for n, m in zip(ctx, spans)]).astype(np.int32)
    q_slots = np.concatenate([np.full(m, s) for s, m in enumerate(spans)]).astype(np.int32)
    t = len(q_pos)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEV, dtype)

    return dict(
        q=randn(t, h, d), k_pool=randn(num_pages, PAGE, kv, d),
        v_pool=randn(num_pages, PAGE, kv, d),
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
    num_pages, _, kv, d = a["k_pool"].shape
    row_bytes = kv * d * a["k_pool"].element_size() + (kv * 4 if "k_scale" in a else 0)
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
    return nbytes, 4.0 * d * a["q"].shape[1] * keys


def decode_scenario(rng, prompt_lens, dims=None):
    """The serving run's decode step, mid-generation: one query per slot at
    ``prompt_len + NEW_TOKENS // 2`` cached positions."""
    return paged_scenario(rng, [n + NEW_TOKENS // 2 for n in prompt_lens], [1] * len(prompt_lens),
                          dims=dims)


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


def k4_instance(a):
    """The paged kernel's instance for a scenario's (head dim, group)."""
    _, h, d = a["q"].shape
    return flash_attention.instance(d, h // a["k_pool"].shape[2])


def step_plan(a, window=0, rows=None):
    """The tile plan of a scenario, as the engine makes it for a step
    (``rows``: padded with empty tiles to that many rows)."""
    return flash_attention.tile_plan_tensor(a["q_pos"], a["q_slots"], a["k_pool"].shape[1],
                                            a["tables"].shape[1], window, rows,
                                            k4_instance(a).tile_tokens)


def packed_rows(a) -> int:
    """The plan rows of a packed step of the scenario's tokens and slots
    (``step_plan_rows``): what the engine pads its plan to."""
    return flash_attention.step_plan_rows(a["q"].shape[0], a["tables"].shape[0], True,
                                          k4_instance(a).tile_tokens)


def drop_split(a, token: int, split: int, per: int):
    """A planted K4 fault: inputs on which the plain version returns what a
    kernel whose split merge dropped ``token``'s partial of split ``split``
    (table blocks [split * per, (split + 1) * per)) would return: the token
    moves to a new slot whose table is its slot's with those blocks
    masked."""
    slot = int(a["q_slots"][token])
    tables = torch.cat([a["tables"], a["tables"][slot:slot + 1]])
    tables[-1, split * per:(split + 1) * per] = -1
    slots = a["q_slots"].clone()
    slots[token] = tables.shape[0] - 1
    return dict(a, tables=tables, q_slots=slots)


def padded_heads(g: int) -> int:
    """The first head of a group's last n8 tile that a planted fault leaves
    out: from 8 on where a second tile holds the group's last heads (g 9,
    10), else from 1 (g 2: one tile, six padding lanes)."""
    return 8 if g > 8 else 1


def without_heads(a, first: int):
    """A planted K4 fault: the scenario with each group's query heads from
    ``first`` on zeroed, which the kernel then computes as a kernel whose
    second n8 tile of heads read no Q would."""
    t, h, d = a["q"].shape
    q = a["q"].clone()
    q.view(t, a["k_pool"].shape[2], -1, d)[:, :, first:] = 0
    return dict(a, q=q)


def k4_checks(rng, prompt_lens, dims=None, max_len=MAX_LEN, windows=(100, 200, 100)):
    """K4 against its plain version, row for row within ``K4_TOL``, at
    ``dims`` (``paged_scenario``'s; qwen2.5-3b's by default) with contexts
    up to ``max_len``: bf16 and int8 pools, a window (``windows``: the
    plain case's, the unsplit grid's and the decode grid's), softcap,
    hostile tables, padding and fully masked queries, an unsplit grid, the
    decode grid split many ways; each over the wrapper's plan, the step's
    plan and the packed step's padded plan.  Planted faults that must fail
    the same check: a tile's last page skipped; at a group other than 8
    (padding heads on an n8 tile), the heads of the group's last n8 tile
    left out (``padded_heads``: from 8 on at g 9 and 10, from 1 at g 2), and
    one split's partial dropped from the merge.  Returns the largest
    absolute difference."""
    h, kv, d, blocks = dims or (H, KV, D, BLOCKS)
    g = h // kv
    inst = flash_attention.instance(d, g)
    ctx = [int(x) for x in rng.integers(PROMPT_MIN, max_len, SLOTS)]
    spans = [1, 64, 1, 9, 1, 33, 1, 1]  # decode, prefill chunks and verify-sized spans
    base = paged_scenario(rng, ctx, spans, dims=dims)
    num_pages = base["k_pool"].shape[0]
    cases = {}
    cases["bf16"] = (base, {}, None)
    kq, ks = _paged_quantize(base["k_pool"])  # the model's write-path scheme
    vq, vs = _paged_quantize(base["v_pool"])
    cases["int8"] = (dict(base, k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs), {}, None)
    cases["window"] = (base, {"window": windows[0]}, None)
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
    many = paged_scenario(rng, ctx, [CHUNK] * SLOTS, dims=dims)
    many_slots = many["q_slots"].clone()
    many_slots[::5] = -1
    cases["many_queries"] = (dict(many, q_slots=many_slots), {"window": windows[1]},
                             many_slots < 0)
    # the decode steps' grid (one query per slot, as k4_timing times it) plus
    # a padding query: the block range splits many ways, and the splits past
    # a short slot's last block are empty
    dec = decode_scenario(rng, prompt_lens, dims=dims)
    dec = {k: (torch.cat([v, v[:1]]) if k in ("q", "q_pos", "q_slots") else v)
           for k, v in dec.items()}
    dec["q_slots"][-1] = -1
    pad = dec["q_slots"] < 0
    kq, ks = _paged_quantize(dec["k_pool"])
    vq, vs = _paged_quantize(dec["v_pool"])
    cases["decode"] = (dec, {}, pad)
    cases["decode_int8"] = (dict(dec, k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs), {}, pad)
    cases["decode_window"] = (dec, {"window": windows[2]}, pad)

    max_err = 0.0
    for name, (a, kw, zero_rows) in cases.items():
        plan = step_plan(a, kw.get("window", 0))
        out = flash_attention.paged_flash_attention(**a, **kw)
        again = flash_attention.paged_flash_attention(**a, **kw, plan=plan)
        # the engine's plan: padded to a packed step's fixed rows, where the
        # scenario is shaped like one (each slot one run of tokens)
        rows = packed_rows(a)
        padded = (flash_attention.paged_flash_attention(
            **a, **kw, plan=step_plan(a, kw.get("window", 0), rows))
            if plan.shape[0] <= rows else None)
        want = ref.paged_attention_ref(**a, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"K4 {name}: the step's plan and the wrapper's differ")
        for got in (out, padded):
            if got is None:
                continue
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            check(bool(torch.isfinite(got.float()).all()), f"K4 {name}: non-finite output")
            check(torch.allclose(got.float(), want.float(), **K4_TOL),
                  f"K4 {name}: max |err| {err} beyond {K4_TOL}")
            if zero_rows is not None:
                check(int(zero_rows.sum()) > 0, f"K4 {name}: scenario has no zero rows")
                check(bool((got[zero_rows] == 0).all()), f"K4 {name}: rows not exactly zero")
        t = a["q"].shape[0]
        splits, per = flash_attention.split_blocks(plan.shape[0] * kv, blocks,
                                                   flash_attention._sm_count(0), inst.ctas_per_sm)
        if name.startswith("decode"):
            check(splits > 2, f"K4 {name}: {splits} splits, the decode grid should split > 2 ways")
        if g != 8 and name in ("bf16", "many_queries"):
            first = padded_heads(g)
            bad = flash_attention.paged_flash_attention(**without_heads(a, first), **kw)
            bad_err = (bad.float() - want.float()).abs().max().item()
            check(not torch.allclose(bad.float(), want.float(), **K4_TOL),
                  f"K4 {name}: K4_TOL lets a planted fault pass (max |err| {bad_err})")
            log(f"K4 {name}: planted fault (heads {first}-{g - 1} left out): "
                f"max|err|={bad_err:.3e}, rejected")
        if g != 8 and name == "decode":
            # the token where split 1 weighs most: the shortest context
            # that fills it
            tok = int(torch.where((a["q_slots"] >= 0) & (a["q_pos"] >= 2 * per * PAGE),
                                  a["q_pos"], 1 << 30).argmin())
            bad = ref.paged_attention_ref(**drop_split(a, tok, 1, per), **kw)
            bad_err = (bad.float() - want.float()).abs().max().item()
            check(not torch.allclose(bad.float(), want.float(), **K4_TOL),
                  f"K4 {name}: K4_TOL lets a planted fault pass (max |err| {bad_err})")
            log(f"K4 {name}: planted fault (split 1 of {splits}, blocks {per}-{2 * per - 1}, "
                f"dropped from token {tok}'s merge): max|err|={bad_err:.3e}, rejected")
        if name in ("bf16", "many_queries"):
            # the planted fault: the last page skipped of the tile where it
            # weighs most, the shortest block range (of the longest tiles)
            p = plan.cpu().numpy().astype(np.int64)
            cand = np.flatnonzero((p[:, 2] >= 0) & (p[:, 4] > p[:, 3]))
            row = p[cand[np.argmin((p[cand, 4] - p[cand, 3]) * 64 - p[cand, 1])]].tolist()
            bad = ref.paged_attention_ref(**skip_last_page(a, row), **kw)
            bad_err = (bad.float() - want.float()).abs().max().item()
            check(not torch.allclose(bad.float(), want.float(), **K4_TOL),
                  f"K4 {name}: K4_TOL lets a planted fault pass (max |err| {bad_err})")
            log(f"K4 {name}: planted fault (tile of {row[1]} tokens over {row[4] - row[3]} "
                f"blocks, its last page skipped): max|err|={bad_err:.3e}, rejected")
        log(f"K4 {name:15s} T={t:3d} tiles={plan.shape[0]:3d} splits={splits} "
            f"max|err|={err:.3e} ok"
            + (f"; padded to {rows} rows (a packed step's plan) ok" if padded is not None
               else ""))
    return max_err


def k4_timing(rng, prompt_lens, dims=None, window=0):
    """Kernel, plain version and bound at two main-path shapes: a decode
    step (one query per slot, mid-generation) and a mixed packed step (4
    prefill chunks of 64), each over the plan the engine makes (padded to
    a packed step's fixed rows; the decode step's needs no padding), the
    unpadded plan's time beside it; at ``dims`` (``paged_scenario``'s) and
    ``window`` (the layer kind's)."""
    decode = decode_scenario(rng, prompt_lens, dims=dims)
    mixed = paged_scenario(rng, [n for n in prompt_lens], [CHUNK] * 4 + [1] * 4, dims=dims)
    rows = {}
    for shape, a in (("decode", decode), ("mixed", mixed)):
        a = dict(a, window=window)
        plan = step_plan(a, window, rows=packed_rows(a))  # made once per step by the engine
        tight = step_plan(a, window)
        kern = time_ms(lambda: flash_attention.paged_flash_attention(**a, plan=plan))
        kern_tight = time_ms(lambda: flash_attention.paged_flash_attention(**a, plan=tight))
        plain = time_ms(lambda: ref.paged_attention_ref(**a), iters=10)
        nbytes, flops = paged_cost(a, window)
        b, by = bound_ms(nbytes, flops)
        rows[shape] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by,
                           T=a["q"].shape[0], unpadded_ms=kern_tight)
        log(f"K4 time {shape:6s} (D {a['q'].shape[2]}, g {a['q'].shape[1] // a['k_pool'].shape[2]}, window {window}) "
            f"T={a['q'].shape[0]:4d} plan rows={plan.shape[0]} "
            f"({tight.shape[0]} tiles): kernel {kern * 1e3:.1f} us (unpadded plan "
            f"{kern_tight * 1e3:.1f} us), plain {plain * 1e3:.1f} us, bound {b * 1e3:.2f} us "
            f"({by}), {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP")
    return rows


# ---------------------------------------------------------------------------
# K2: RMSNorm
# ---------------------------------------------------------------------------


def ulp_line(x: torch.Tensor) -> torch.Tensor:
    """A bf16 or f16 tensor's values as integers one ulp apart (both formats
    order their bit patterns by sign and magnitude)."""
    i = x.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def ulps16(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in ulps between two bf16 or two f16 tensors."""
    return int((ulp_line(a) - ulp_line(b)).abs().max().item())


def k2_plain(x, s, eps, model):
    return (ref.rmsnorm_model if model else ref.rmsnorm_ref)(x, s, eps)


def rmsnorm_without_last_vector(x, s, eps=1e-6, model=False):
    """K2's planted fault: what a kernel that leaves each row's last 16-byte
    vector out of its sum of squares (the mean still over d) would return,
    by the plain version's numerics (``tests/test_torch_parity_util.py``
    has its twin)."""
    d = x.shape[-1]
    ms = x[..., :d - 16 // x.element_size()].float().square().sum(-1, keepdim=True) / d
    inv = torch.rsqrt(ms + eps)
    if model:
        return x * inv.to(x.dtype) * s.to(x.dtype)
    return (x.float() * inv * s.float()).to(x.dtype)


def k2_model_ulps(out, x, s, eps):
    """(ulps, tie rows): the largest distance in ulps of ``out`` (bf16 or
    f16) from ``ref.rmsnorm_model``, row by row; a row whose inv is a tie
    (``K2_INV_TIE``) is also measured against the output with inv rounded
    the other way, and the nearer of the two counts (the twin of
    ``rmsnorm_model_ulps`` in ``tests/test_torch_parity_util.py``)."""
    def row_ulps(a, b):
        return (ulp_line(a) - ulp_line(b)).abs().amax(-1)

    plain_inv = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps).to(x.dtype)
    inv = torch.rsqrt(x.double().square().mean(-1, keepdim=True) + eps)
    bits = plain_inv.view(torch.int16)  # inv > 0: its neighbours are one bit pattern away
    other = torch.where(plain_inv.double() <= inv, (bits + 1).view(x.dtype),
                        (bits - 1).view(x.dtype))
    tie = ((inv - (plain_inv.double() + other.double()) / 2).abs() <= K2_INV_TIE * inv)[..., 0]
    u = row_ulps(out, ref.rmsnorm_model(x, s, eps))
    u_other = row_ulps(out, x * other * s.to(x.dtype))
    return int(torch.where(tie, torch.minimum(u, u_other), u).max().item()), int(tie.sum().item())


def k2_held(out, x, s, eps, model, tag) -> float:
    """``out`` against the plain version: f32 within ``K2_F32_TOL``, bf16
    and f16 within ``K2_BF16_ULPS`` ulps (in model mode by
    ``k2_model_ulps``).  Returns the largest absolute difference."""
    want = k2_plain(x, s, eps, model)
    err = (out.float() - want.float()).abs().max().item()
    if out.dtype == torch.float32:
        check(torch.allclose(out, want, **K2_F32_TOL), f"{tag}: max |err| {err}")
        log(f"{tag}: max|err|={err:.3e} ok")
        return err
    ulps, ties = k2_model_ulps(out, x, s, eps) if model else (ulps16(out, want), 0)
    check(ulps <= K2_BF16_ULPS, f"{tag}: {ulps} ulps apart")
    log(f"{tag}: max|err|={err:.3e} ({ulps} ulp{f'; {ties} rows of tied inv' if model else ''}) ok")
    return err


#: K2's checks, (rows, d): qwen2.5-3b's decode step, a full and a ragged
#: packed step and 3 rows; Mamba-2's training micro-batch and one row fewer;
#: a count whose stages ring through the slots (40,000 x 2048), and rows so
#: wide that a stage is one row (600 x 29,000; in f32 one slot holds it)
K2_SHAPES = ((8, 2048), (256, 2048), (3, 2048), (257, 2048), (8192, 768), (8191, 768),
             (40000, 2048), (600, 29000))


def k2_checks(rng, eps=1e-6):
    """K2's forward against its plain version at ``K2_SHAPES`` in f32, bf16
    and f16, both modes: aligned (the bulk-copy path) and as a view one
    element off 16-byte alignment (the element-wise path, which must give
    the aligned run's bits); two runs bit-identical; at Mamba-2's
    micro-batch, rows 0..7 alone equal the same rows of the whole call bit
    for bit, and the planted fault (``rmsnorm_without_last_vector``) must
    fail the bf16 check.  Returns the largest absolute difference."""
    sms = rmsnorm._sm_count(0)
    max_err = 0.0
    for rows, d in K2_SHAPES:
        s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV)
        x32 = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(DEV)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = x32.to(dtype)
            off = torch.empty(rows * d + 1, dtype=dtype, device=DEV)[1:].view(rows, d)
            off.copy_(x)
            plan = rmsnorm.fwd_partition(rows, d, x.element_size(), sms)
            on = rows == plan.ctas * plan.rows_per_cta and plan.rows_per_cta % plan.stage_rows == 0
            for model in (False, True):
                tag = (f"K2 {rows:5d} x {d:5d} ({'on' if on else 'off'} the plan: {plan.ctas} CTAs "
                       f"x {plan.rows_per_cta}, stages of {plan.stage_rows}, {plan.slots} slots) "
                       f"{str(dtype)[6:]:8s} {'model' if model else 'f32'}")
                out = rmsnorm.rmsnorm(x, s, eps=eps, model=model)
                max_err = max(max_err, k2_held(out, x, s, eps, model, tag))
                check(torch.equal(out, rmsnorm.rmsnorm(x, s, eps=eps, model=model)),
                      f"{tag}: two runs differ (no atomics: they must not)")
                check(torch.equal(rmsnorm.rmsnorm(off, s, eps=eps, model=model), out),
                      f"{tag}: the element-wise path (x off alignment) differs from the bulk path")
                if rows == 8192:
                    check(torch.equal(rmsnorm.rmsnorm(x[:8], s, eps=eps, model=model), out[:8]),
                          f"{tag}: rows 0..7 alone differ from the same rows of the whole call")
                if rows == 8192 and dtype == torch.bfloat16:
                    bad = rmsnorm_without_last_vector(x, s, eps, model)
                    ulps = (k2_model_ulps(bad, x, s, eps)[0] if model
                            else ulps16(bad, k2_plain(x, s, eps, model)))
                    check(ulps > K2_BF16_ULPS, f"{tag}: the ulp check lets a planted fault pass")
                    log(f"K2 planted fault (each row's last 16-byte vector left out of its sum) "
                        f"{'model' if model else 'f32'}: {ulps} ulps against the limit "
                        f"{K2_BF16_ULPS}: rejected")
            del x, off, out
    return max_err


def back_to_back_ms(fn, inputs, launches: int) -> float:
    """Device time a launch of ``fn`` when ``launches`` calls run back to
    back in one CUDA graph, call i on ``inputs[i % len(inputs)]`` and every
    output kept (each call writes a buffer of its own): ``replay_ms`` of
    the graph over the count."""
    outs = []

    def run():
        outs.clear()
        for i in range(launches):
            outs.append(fn(inputs[i % len(inputs)]))

    t = replay_ms(capture(run), iters=10) / launches
    outs.clear()
    return t


def k2_timing(rng, d=2048, eps=1e-6):
    """At the main paths' shapes: a decode step (8 rows), the packed mixed
    step (257 rows) and a training micro-batch (2048 rows) of qwen2.5-3b's
    width ``d``, and a Mamba-2 training micro-batch (8,192 rows of 768),
    bf16 model mode.  Per shape: one replay of one launch (``ms``, the
    record's), the kernel's own time as one graph of back-to-back launches
    over rotating inputs of at least 100 MB in all with every output its
    own (``launch_ms``) and as the profiler's device time a launch
    (``prof_ms``, None if the profiler returned nothing), the plain
    version, ``F.rms_norm`` (one replay and back to back), and the bound."""
    rows_out = {}
    for shape, rows, d in (("decode", SLOTS, d), ("mixed", BUDGET + 1, d), ("train", TRAIN_SEQ, d),
                           ("mamba_train", M_TRAIN_SEQS * TRAIN_SEQ, 768)):
        s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV)
        x = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(DEV, torch.bfloat16)
        sb = s.to(torch.bfloat16)
        nbytes = 2 * x.numel() * x.element_size() + s.numel() * 4
        n_in = max(4, -(-100_000_000 // nbytes))
        xs = x.expand(n_in, rows, d).clone()  # n_in copies of x, one buffer each
        launches = max(n_in, 32)
        kern = time_ms(lambda: rmsnorm.rmsnorm(x, s, eps=eps, model=True))
        b2b = back_to_back_ms(lambda xi: rmsnorm.rmsnorm(xi, s, eps=eps, model=True), xs, launches)
        # the only kernel the call launches (also the Triton forward's name)
        parts = kernel_split_ms(lambda: rmsnorm.rmsnorm(x, s, eps=eps, model=True),
                                {"k2": "rmsnorm"})
        prof = None if parts is None else parts["k2"]
        plain = time_ms(lambda: ref.rmsnorm_model(x, s, eps))
        lib = time_ms(lambda: torch.nn.functional.rms_norm(x, (d,), weight=sb, eps=eps))
        lib_b2b = back_to_back_ms(
            lambda xi: torch.nn.functional.rms_norm(xi, (d,), weight=sb, eps=eps), xs, launches)
        b, by = bound_ms(nbytes, 4.0 * x.numel())
        rows_out[shape] = dict(ms=kern, launch_ms=b2b, prof_ms=prof, plain_ms=plain,
                               library_ms=lib, library_launch_ms=lib_b2b, bound_ms=b,
                               bound_by=by, rows=rows)
        log(f"K2 time {shape:11s} rows={rows:4d} d={d}: kernel {kern * 1e3:.2f} us (one replay), "
            f"{b2b * 1e3:.2f} us a launch back to back ({launches} in a graph), profiler "
            f"{split_text(parts)}; plain {plain * 1e3:.1f} us; F.rms_norm {lib * 1e3:.2f} us, "
            f"{lib_b2b * 1e3:.2f} back to back; bound {b * 1e3:.2f} us ({by})")
        del xs
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


def kernel_split_ms(fn, kernels, iters: int = 10, sessions: int = 3):
    """Median device time of each of ``fn``'s kernels (``kernels``: label ->
    a substring of the kernel's name), from ``torch.profiler`` over eager
    calls with L2 flushed before each (``split_from_sessions`` reads the
    sessions)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()

    def session():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        return [(ev.name, (ev.time_range.end - ev.time_range.start) / 1e3) for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA]

    return split_from_sessions(session, kernels, iters, sessions)


def split_from_sessions(session, kernels, iters: int, sessions: int):
    """Medians by label of the device records (name, ms) that ``session()``
    returns for ``iters`` calls.  Late in a long run the profiler has
    returned only some of a session's kernel records (4-5 of 10, after
    phase 10), and none at all, not even the flush's fills (phase 11 on an
    H100): a session short of ``iters`` records of any kernel is made
    again, up to ``sessions`` times.  The last session that returned any
    device record decides: it fails the run if a kernel is missing from it.
    If no session returned one, the split is not measured and this returns
    None (``split_text`` says so), as ``longest_kernel`` does."""
    times, records = None, 0
    for _ in range(sessions):
        evs = session()
        if not evs:
            continue
        records = len(evs)
        times = {label: [ms for ev_name, ms in evs if name in ev_name]
                 for label, name in kernels.items()}
        if min(len(t) for t in times.values()) == iters:
            break
    if times is None:
        log(f"profiler: no device record in {sessions} sessions of {iters} calls; the split by "
            f"launch is not measured")
        return None
    seen = {k: len(t) for k, t in times.items()}
    check(min(seen.values()) > 0, f"the profiler saw {seen} launches of {iters} calls among "
          f"{records} device records: a kernel is missing")
    if min(seen.values()) < iters:
        log(f"profiler: {seen} records of {iters} calls' launches after {sessions} sessions; "
            f"medians of those")
    return {label: statistics.median(t) for label, t in times.items()}


def split_text(parts) -> str:
    """``kernel_split_ms``'s result for a log line, in microseconds."""
    if parts is None:
        return "not measured"
    return ", ".join(f"{n} {t * 1e3:.1f}" for n, t in parts.items()) + " us"


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
    split = split_text(parts)
    log(f"K3 time S={TRAIN_SEQ} causal: fwd kernel {fwd * 1e3:.1f} us, plain {plain_fwd * 1e3:.1f} "
        f"us, SDPA {lib_fwd * 1e3:.1f} us, bound {fb * 1e3:.1f} us ({fby}); bwd kernels "
        f"{bwd * 1e3:.1f} us (device time by launch, profiler: {split}), plain "
        f"{plain_bwd * 1e3:.1f} us, SDPA bwd alone {lib_bwd * 1e3:.1f} us (graph-captured "
        f"autograd.grad), bound {bb * 1e3:.1f} us ({bby}); fwd+bwd kernels "
        f"{(fwd + bwd) * 1e3:.1f} us, SDPA fwd+bwd {lib_both * 1e3:.1f} us (eager, events)")
    return (dict(ms=fwd, plain_ms=plain_fwd, bound_ms=fb, bound_by=fby, library_ms=lib_fwd),
            dict(ms=bwd, plain_ms=plain_bwd, bound_ms=bb, bound_by=bby, library_ms=lib_bwd))


def bert_attn_inputs(rng, b: int, h: int, s: int):
    """q, k, v, dO as transposed (B, H, S, 64) views of (B, S, H, 64) bf16
    storage: a BERT layer's attention (group 1)."""

    def t():
        x = torch.from_numpy(rng.standard_normal((b, s, h, BERT_D), dtype=np.float32))
        return x.to(DEV, torch.bfloat16).transpose(1, 2)

    return t(), t(), t(), t()


def k3_bert_checks(rng):
    """11a: K3's (64, 1) bidirectional build against its plain versions at
    ``BERT_K3_SHAPES``, row by row; the backward's two runs bit-identical;
    two planted faults the same checks must reject: the causal flag passed
    for one forward and one backward launch, and a kernel that skips the
    last 64-key step (the plain versions on that mask).  Returns (fwd
    max|err|, bwd max|err|)."""
    fwd_err = bwd_err = 0.0
    for name, (b, h, s) in BERT_K3_SHAPES.items():
        q, k, v, do = bert_attn_inputs(rng, b, h, s)
        out, lse = flash_attention.flash_attention_fwd(q, k, v, causal=False)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=False)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=False)
        again = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
        causal = [flash_attention.flash_attention_fwd(q, k, v, causal=True)[0],
                  *flash_attention.flash_attention_bwd(q, k, v, out, lse, do, causal=True)]
        mask = ref.attention_mask(s, s, False, 0, device=DEV)
        mask[..., s - 64:] = False
        skip, skip_lse = ref.flash_attention_fwd_ref(q, k, v, mask=mask)
        skip = [skip, *ref.flash_attention_bwd_ref(q, k, v, skip, skip_lse, do, mask=mask)]
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x.float()).all()) for x in (out, lse, *grads)),
              f"K3 bert {name}: non-finite output")
        errs = [row_rel_err(g, w) for g, w in zip((out, *grads), (want, *wants))]
        e_lse = (lse - want_lse).abs().max().item()
        bad = {fault: [row_rel_err(g, w) for g, w in zip(got, (want, *wants))]
               for fault, got in (("causal flag", causal), ("last key step skipped", skip))}
        log(f"K3 bert {name} (B {b}, H = KV = {h}, S {s}, D {BERT_D}, bidirectional): row rel "
            f"err out {errs[0]:.2e} (lse abs {e_lse:.1e}) dq {errs[1]:.2e} dk {errs[2]:.2e} dv "
            f"{errs[3]:.2e}; planted faults (out, dq, dk, dv): "
            + "; ".join(f"{f} {', '.join(f'{x:.2e}' for x in e)}" for f, e in bad.items()))
        check(max(errs) <= K3_ROW_TOL, f"K3 bert {name}: row relative errors {errs}")
        check(e_lse <= K3_LSE_TOL, f"K3 bert {name}: lse off by {e_lse}")
        for fault, e in bad.items():
            check(min(e) > K3_ROW_TOL, f"K3 bert {name}: the row metric lets a planted "
                  f"fault ({fault}) pass: {e}")
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"K3 bert {name}: two backward runs differ (it has no atomics: it must not)")
        fwd_err = max(fwd_err, (out.float() - want.float()).abs().max().item())
        bwd_err = max(bwd_err, max((g.float() - w.float()).abs().max().item()
                                   for g, w in zip(grads, wants)))
    return fwd_err, bwd_err


def k3_bert_timing(rng):
    """11a: K3's (64, 1) bidirectional build at ``BERT_K3_SHAPES``: one
    replay (``ms``, the record's) and back to back in one graph over
    rotating inputs of at least 100 MB, the backward also launch by launch
    (profiler); the plain versions; SDPA's forward and its backward alone
    (the library calls); the bounds.  Returns {shape: (fwd, bwd)} record
    fields."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, (b, h, s) in BERT_K3_SHAPES.items():
        q, k, v, do = bert_attn_inputs(rng, b, h, s)
        out, lse = flash_attention.flash_attention_fwd(q, k, v, causal=False)
        n_in = max(4, -(-100_000_000 // (5 * 2 * q.numel())))
        sets = [bert_attn_inputs(rng, b, h, s) for _ in range(n_in)]
        sets = [(x, y, z, d, *flash_attention.flash_attention_fwd(x, y, z, causal=False))
                for x, y, z, d in sets]
        launches = max(n_in, 32)
        fwd = time_ms(lambda: flash_attention.flash_attention_fwd(q, k, v, causal=False))
        bwd = time_ms(lambda: flash_attention.flash_attention_bwd(q, k, v, out, lse, do,
                                                                  causal=False))
        fwd_b2b = back_to_back_ms(
            lambda a: flash_attention.flash_attention_fwd(*a[:3], causal=False), sets, launches)
        bwd_b2b = back_to_back_ms(
            lambda a: flash_attention.flash_attention_bwd(a[0], a[1], a[2], a[4], a[5], a[3],
                                                          causal=False), sets, launches)
        parts = kernel_split_ms(lambda: flash_attention.flash_attention_bwd(
            q, k, v, out, lse, do, causal=False), K3_BWD_KERNELS)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=False)
        plain_fwd = time_ms_eager(lambda: ref.flash_attention_fwd_ref(q, k, v, causal=False),
                                  iters=3)
        plain_bwd = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, want, want_lse, do,
                                                                causal=False), iters=5)
        lib_fwd = time_ms(lambda: sdpa(q, k, v))
        lib_bwd = sdpa_bwd_ms(q, k, v, do, causal=False)
        del sets
        # every (query, key) pair of every head is admissible: forward 2
        # products of 2 D flops a pair, backward 5 (S again, dP, dV, dQ, dK)
        pairs = b * h * s * s
        io = 2 * 4 * q.numel()  # bf16 q, k, v, o
        fb, fby = bound_ms(io + 4 * lse.numel(), 4.0 * BERT_D * pairs)
        bb, bby = bound_ms(io + 2 * q.numel() + 4 * lse.numel() + 2 * 3 * q.numel(),
                           10.0 * BERT_D * pairs)
        split = split_text(parts)
        log(f"K3 bert time {name} (B {b}, H {h}, S {s}, D {BERT_D}, bidirectional): fwd kernel "
            f"{fwd * 1e3:.1f} us one replay, {fwd_b2b * 1e3:.1f} us back to back ({launches} in "
            f"a graph), plain {plain_fwd * 1e3:.1f} us, SDPA {lib_fwd * 1e3:.1f} us, bound "
            f"{fb * 1e3:.1f} us ({fby}); bwd kernels {bwd * 1e3:.1f} us one replay, "
            f"{bwd_b2b * 1e3:.1f} us back to back (device time by launch, profiler: {split}), "
            f"plain {plain_bwd * 1e3:.1f} us, SDPA bwd alone {lib_bwd * 1e3:.1f} us, bound "
            f"{bb * 1e3:.1f} us ({bby})")
        rows[name] = (dict(ms=fwd, plain_ms=plain_fwd, bound_ms=fb, bound_by=fby,
                           library_ms=lib_fwd),
                      dict(ms=bwd, plain_ms=plain_bwd, bound_ms=bb, bound_by=bby,
                           library_ms=lib_bwd))
    return rows


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


def sdpa_bwd_ms(q, k, v, do, causal: bool = True) -> float:
    """SDPA's backward alone (``grad_only_ms``), causal unless told, GQA."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = tuple(x.detach().requires_grad_() for x in (q, k, v))
    return grad_only_ms(lambda a, b, c: sdpa(a, b, c, is_causal=causal, enable_gqa=True),
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


def f32_spacing(t: torch.Tensor) -> torch.Tensor:
    """The distance from each f32 element to the next f32 away from zero."""
    t = t.abs()
    return torch.nextafter(t, torch.full_like(t, math.inf)) - t


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
    # the Local-SGD step, w += keep * -lr * g: the product is rounded now, and
    # the kernel may fuse it into the add (one rounding where the plain
    # version has two): the FMA limit above
    want = ref.masked_accum_ref(acc, g, 1.0, -LSGD_LR)
    got = masked_accum.masked_accum(acc.clone(), g, 1.0, -LSGD_LR)
    gap = (got - want).abs()
    limit = 2 * f32_spacing(want) + f32_spacing(float(np.float32(-LSGD_LR)) * g.float())
    err = float(gap.max())
    worst = float((gap / limit).max())
    log(f"K1 {shape} bf16 grads, local step (keep 1, scale -{LSGD_LR}): max abs err {err:.3e}; "
        f"{int((gap > 0).sum())} of {n} differ, by {worst:.2f} of the FMA limit (2 spacings "
        f"of the sum + 1 of the product) at most")
    check(worst <= 1.0, f"K1 local step: {worst} of the FMA limit from the plain version")
    del want, got, gap, limit
    kern = time_ms(lambda: masked_accum.masked_accum(acc, g, 1.0, 1.0), iters=10)
    plain = time_ms(lambda: ref.masked_accum_ref(acc, g, 1.0, 1.0), iters=5)
    library = time_ms(lambda: acc.add_(g, alpha=1.0), iters=10)
    b, by = bound_ms(n * (4 + 4 + 2), 2.0 * n)
    log(f"K1 time {n / 1e6:.0f} M elements: kernel {kern:.3f} ms, plain {plain:.3f} ms, "
        f"acc.add_ {library:.3f} ms, bound {b:.3f} ms ({by})")
    return err, dict(ms=kern, plain_ms=plain, library_ms=library, bound_ms=b, bound_by=by)


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
    """K6's planted fault: the causal mask less each row's own key tile."""
    rows = torch.arange(l, device=DEV) // ssd_chunk.ROW_TILE
    return torch.ones(l, l, dtype=torch.bool, device=DEV).tril() & (rows[:, None] != rows[None])


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def ssd_tf32(x, dt, cum, b, c, mask):
    """The SSD term of (B, NC, L, ...) inputs under ``mask`` (L, L), its
    product operands (C, B, att, x) each rounded once to TF32: what a
    single TF32 pass on the tensor cores would return."""
    s = torch.einsum("bgin,bgjn->bgij", tf32_round(c), tf32_round(b))
    diff = cum[..., :, None, :] - cum[..., None, :, :]
    m = mask[..., None]
    att = s[..., None] * torch.exp(-torch.where(m, diff, 0.0)) * m * dt[..., None, :, :]
    return torch.einsum("bgijh,bgjhp->bgihp", tf32_round(att), tf32_round(x))


def segment_mask(seg):
    """K5's admissible pairs (T, T)."""
    seg = seg.long()
    tri = torch.ones(len(seg), len(seg), dtype=torch.bool, device=seg.device).tril()
    return tri & (seg[:, None] == seg[None]) & (seg >= 0)[:, None]


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
    one and of two 256-token chunks, the serving run's 64-row and 16-row
    steps, 17 rows; the same metric on a planted fault (the diagonal 16-key
    tile skipped) and on the plain version with TF32 operands; two runs
    bit-identical."""
    max_err = 0.0
    for bs, nc, l in ((8, 1, 256), (8, 2, 256), (8, 1, 64), (8, 1, 16), (2, 1, 17)):
        a = ssd_chunk_scenario(rng, bs, nc, l)
        got = ssd_chunk.ssd_chunk(*a)
        again = ssd_chunk.ssd_chunk(*a)
        want = ref.ssd_chunk_ref(*a)
        bad = ref.ssd_chunk_ref(*a, mask=ssd_diagonal_skipped(l))
        one_pass = ssd_tf32(*a, torch.ones(l, l, dtype=torch.bool, device=DEV).tril())
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K6 B{bs} NC{nc} L{l}: non-finite output")
        check(torch.equal(got, again), f"K6 B{bs} NC{nc} L{l}: two runs differ")
        e, e_bad, e_tf32 = (row_rel_err(v, want) for v in (got, bad, one_pass))
        max_err = max(max_err, (got - want).abs().max().item())
        log(f"K6 B={bs} NC={nc} L={l}: row rel err {e:.2e} (two runs bit-identical); planted "
            f"fault (diagonal {ssd_chunk.ROW_TILE}-key tile skipped) {e_bad:.2e}; plain version "
            f"with TF32 operands {e_tf32:.2e} ({'above' if e_tf32 > SSD_ROW_TOL else 'within'} "
            f"SSD_ROW_TOL)")
        check(e <= SSD_ROW_TOL, f"K6 B{bs} NC{nc} L{l}: row relative error {e}")
        check(e_bad > SSD_ROW_TOL, f"K6: the row metric lets a planted fault pass: {e_bad}")
    return max_err


def k5_checks(rng):
    """K5 against its plain version, row by row, at the packed mixed and
    decode capacities and a padding-heavy step; padding rows exact zeros;
    the same metric on a planted fault (the segment mask dropped)."""
    max_err = 0.0
    cases = {"mixed": K5_MIXED, "decode": K5_DECODE,
             "padded": packed_segments([40, 1, 90], 126),
             "long": packed_segments([5, 200, 9], 43)}  # one segment over 13 key tiles
    for name, seg in cases.items():
        a = ssd_segment_scenario(rng, seg)
        got = ssd_chunk.ssd_segment(*a)
        again = ssd_chunk.ssd_segment(*a)
        want = ref.ssd_segment_ref(*a)
        bad = ref.ssd_segment_ref(*a[:5], segment_mask_dropped(a[5]))
        one_pass = ssd_tf32(*(v[None, None] for v in a[:5]), segment_mask(a[5]))[0, 0]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K5 {name}: non-finite output")
        check(torch.equal(got, again), f"K5 {name}: two runs differ")
        pad = a[5] < 0
        check(bool((got[pad] == 0).all()), f"K5 {name}: padding rows not exactly zero")
        e, e_bad, e_tf32 = (row_rel_err(v, want) for v in (got, bad, one_pass))
        max_err = max(max_err, (got - want).abs().max().item())
        log(f"K5 {name:6s} T={len(seg)} ({int(pad.sum())} padding): row rel err {e:.2e} (two "
            f"runs bit-identical); planted fault (segment mask dropped) {e_bad:.2e}; plain "
            f"version with TF32 operands {e_tf32:.2e} "
            f"({'above' if e_tf32 > SSD_ROW_TOL else 'within'} SSD_ROW_TOL); cum up to "
            f"{a[2].max().item():.0f}")
        check(e <= SSD_ROW_TOL, f"K5 {name}: row relative error {e}")
        check(e_bad > SSD_ROW_TOL, f"K5: the row metric lets a planted fault pass: {e_bad}")
    return max_err


def ssd_cost(pairs: int, *tensors):
    """(bytes, flops) an SSD term needs: each tensor read or written once;
    per admissible (i, j) pair 2N flops for C_i . B_j (once for every head)
    and 2P per head for att . x."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return nbytes, 2.0 * pairs * (M_N + M_P * M_H)


def ssd_bound(nbytes: float, flops: float):
    """The recorded bound of an SSD call, (ms, "bytes" or "operations"):
    its products run on the tensor cores in 3xTF32 (S alone stays on the
    FMA pipes, a few % of the operations), so three TF32 products an f32
    product over the tensor cores' rate, against its bytes."""
    return bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)


def ssd_bounds(nbytes: float, flops: float) -> str:
    """Both bounds of an SSD call, for the log: the recorded one
    (``ssd_bound``) and, beside it, every product on the FMA pipes in f32."""
    tc, tc_by = ssd_bound(nbytes, flops)
    b, by = bound_ms(nbytes, flops, F32_FLOP_PER_S)
    return (f"bound {tc * 1e3:.2f} us ({tc_by}, 3xTF32 tensor cores) / {b * 1e3:.2f} us ({by}, "
            f"all on the f32 FMA pipes); {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP")


def k6_timing(rng):
    """Kernel, plain version and bounds: the serving run's 16-row decode
    and 64-row prefill steps (8 rows of one chunk), one full 256-token
    chunk a row, and the Mamba-2 training micro-batch (4 sequences of 2048
    tokens: 32 chunks of 256)."""
    rows = {}
    for shape, (bs, nc, l) in (("decode", (8, 1, 16)), ("serve", (8, 1, 64)),
                               ("chunk256", (8, 1, 256)), ("train", (4, 8, 256))):
        a = ssd_chunk_scenario(rng, bs, nc, l)
        kern = time_ms(lambda: ssd_chunk.ssd_chunk(*a))
        plain = time_ms(lambda: ref.ssd_chunk_ref(*a), iters=10)
        nbytes, flops = ssd_cost(bs * nc * l * (l + 1) // 2, *a, a[0])
        b, by = ssd_bound(nbytes, flops)
        rows[shape] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"K6 time B={bs} NC={nc} L={l}: kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} "
            f"us, {ssd_bounds(nbytes, flops)}")
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
        b, by = ssd_bound(nbytes, flops)
        rows[shape] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"K5 time {shape:6s} T={len(seg)}: kernel {kern * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, {ssd_bounds(nbytes, flops)}")
    return rows


def norm_rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor."""
    got, want = got.float(), want.float()
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want).clamp(min=1e-30)).item()


def ssd_bwd_errs(got, want):
    """K6 backward's metrics: dx row by row, the other four by norm."""
    return [row_rel_err(got[0], want[0])] + [norm_rel_err(g, w) for g, w in zip(got[1:], want[1:])]


def ssd_bwd_scenario(rng, bs, nc, l):
    """K6's inputs as the model forms them (``ssd_chunk_scenario``), the
    forward kernel's y, and a cotangent dy."""
    a = ssd_chunk_scenario(rng, bs, nc, l)
    return a, ssd_chunk.ssd_chunk(*a), f32(rng, bs, nc, l, M_H, M_P)


def k6_bwd_checks(rng):
    """K6's backward against its plain version at the training shape (4
    sequences of 2048 tokens: B 4, NC 8, L 256) and at L 64: all five
    outputs, two runs bit-identical, and the same metrics on two planted
    faults (the plain backward without the diagonal 16-key tile, read on
    dB; dcum without its row part)."""
    max_err = 0.0
    names = ("dx", "ddt", "dcum", "db", "dc")
    for bs, nc, l in ((4, 8, 256), (4, 8, 64)):
        a, y, dy = ssd_bwd_scenario(rng, bs, nc, l)
        got = ssd_chunk.ssd_chunk_bwd(*a, y, dy)
        again = ssd_chunk.ssd_chunk_bwd(*a, y, dy)
        want = ref.ssd_chunk_bwd_ref(*a, dy)
        torch.cuda.synchronize()
        tag = f"K6 bwd B={bs} NC={nc} L={l}"
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{tag}: non-finite output")
        check(all(torch.equal(p, q) for p, q in zip(got, again)), f"{tag}: two runs differ")
        errs = ssd_bwd_errs(got, want)
        max_err = max([max_err] + [(g - w).abs().max().item() for g, w in zip(got, want)])
        bad_db = norm_rel_err(ref.ssd_chunk_bwd_ref(*a, dy, mask=ssd_diagonal_skipped(l))[3],
                              want[3])
        bad_dcum = norm_rel_err(want[2] + (dy * y).sum(-1), want[2])
        del want
        log(f"{tag}: " + ", ".join(f"{k} {e:.2e}" for k, e in zip(names, errs))
            + f" (dx row by row, the rest by norm; two runs bit-identical); planted faults: "
            f"dB without the diagonal {ssd_chunk.ROW_TILE}-key tile {bad_db:.2e}, dcum without "
            f"its row part {bad_dcum:.2e}; scratch {ssd_chunk.scratch_bytes(bs * nc, l) / 1e6:.1f} MB")
        check(max(errs) <= SSD_BWD_TOL, f"{tag}: errors {errs} against {SSD_BWD_TOL}")
        check(min(bad_db, bad_dcum) > SSD_BWD_TOL,
              f"{tag}: the metrics let a planted fault pass: dB {bad_db}, dcum {bad_dcum}")
    return max_err


def ssd_bwd_cost(bs, nc, l, tensors):
    """(bytes, flops) of K6's backward: each input (x, dt, cum, B, C, y, dy)
    read and each output (dx, ddt, dcum, dB, dC) written once; per
    admissible pair 2N flops each for S, dB and dC, and per head 2P each for
    u = S e dy and q = dy . x."""
    pairs = bs * nc * l * (l + 1) // 2
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return nbytes, 2.0 * pairs * (3 * M_N + 2 * M_P * M_H)


# the backward's launches, in order: kernel names in ssd_chunk.cu
K6_BWD_KERNELS = {"keys": "ssd_bwd_keys_kernel", "dc": "ssd_bwd_dc_kernel"}


def k6_bwd_timing(rng):
    """K6's backward at the training shape (B 4, NC 8, L 256) and at L 64:
    kernel (its launches in one graph), each launch's device time
    (profiler), plain version, both bounds (``ssd_bounds``; the record's is
    ``ssd_bound``).  Returns the training shape's record."""
    rows = {}
    for bs, nc, l in ((4, 8, 256), (4, 8, 64)):
        a, y, dy = ssd_bwd_scenario(rng, bs, nc, l)
        kern = time_ms(lambda: ssd_chunk.ssd_chunk_bwd(*a, y, dy))
        parts = kernel_split_ms(lambda: ssd_chunk.ssd_chunk_bwd(*a, y, dy), K6_BWD_KERNELS)
        plain = time_ms(lambda: ref.ssd_chunk_bwd_ref(*a, dy), iters=5)
        outs = ssd_chunk.ssd_chunk_bwd(*a, y, dy)
        nbytes, flops = ssd_bwd_cost(bs, nc, l, [*a, y, dy, *outs])
        b, by = ssd_bound(nbytes, flops)
        split = split_text(parts)
        log(f"K6 bwd time B={bs} NC={nc} L={l}: kernel {kern * 1e3:.1f} us (device time by "
            f"launch, profiler: {split}), plain {plain * 1e3:.1f} us, "
            f"{ssd_bounds(nbytes, flops)}; scratch {ssd_chunk.scratch_bytes(bs * nc, l) / 1e6:.1f} MB")
        rows[l] = dict(ms=kern, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)
        del a, y, dy, outs
    return rows[256]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def first_step_logits_check(cfg, params, prompts, max_len: int = MAX_LEN, tag: str = ""):
    """First prefill step (one 64-token chunk per slot) through the paged
    cache (CUDA kernel) and the dense cache (plain attention), slots of
    ``max_len`` positions; an MoE model's paged step takes the dense step's
    routes (``routes_pinned``), each route it would take otherwise a
    near-tie (``sound_routes``)."""
    tokens = np.stack([np.asarray(p[:CHUNK]) for p in prompts])
    pos = np.zeros(SLOTS, np.int64)
    lens = np.full(SLOTS, CHUNK, np.int64)
    paged = KVCacheSpec(num_slots=SLOTS, max_len=max_len, layout="paged",
                        page_size=PAGE).build(params, cfg)
    for i, p in enumerate(prompts):
        check(paged.admit_slot(i, p, NEW_TOKENS) == 0, "unexpected prefix sharing")
    paged.prepare_step([(i, 0, p[:CHUNK]) for i, p in enumerate(prompts)])
    dense = KVCacheSpec(num_slots=SLOTS, max_len=max_len, layout="dense").build(params, cfg)
    routes, own = [], []
    with routed_if_moe(cfg, routes):
        ld, _ = prefill_chunk(params, cfg, dense.state, tokens, pos, lens)
    with pinned_if_moe(cfg, routes, own):
        lp, _ = prefill_chunk(params, cfg, paged.state, tokens, pos, lens)
    lp, ld = lp.float(), ld.float()
    if cfg.n_experts:  # the paged step takes the dense step's routes
        sound_routes(own, routes, MOE_MODEL_TIE, f"{tag}first prefill step, paged vs dense")
    check(tuple(lp.shape) == (SLOTS, CHUNK, cfg.vocab_size), f"logits shape {tuple(lp.shape)}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(ld).all()), "non-finite logits")
    err = (lp - ld).abs().max().item()
    scale = ld.abs().max().item()
    agree = (lp.argmax(-1) == ld.argmax(-1)).float().mean().item()
    log(f"{tag}first prefill step: paged vs dense logits max|err|={err:.4f} "
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


def mode(eager: bool):
    """The context a run's mode needs: ``graphs.disable_graphs()`` for an
    eager run, nothing for the default (each step a CUDA graph)."""
    return graphs.disable_graphs() if eager else contextlib.nullcontext()


def graph_line(eng_or_acc) -> str:
    """The captures of an engine's (or accumulator's) step graphs: how
    many, the host seconds their warm-ups and captures took, the device
    memory their pool holds."""
    stats = eng_or_acc.step_graph.stats()
    return (f"{len(stats)} graphs captured in {sum(t for t, _ in stats.values()):.2f} s, "
            f"pool {sum(b for _, b in stats.values()) / 2**30:.2f} GiB")


def run_engine(eng, eager: bool):
    """Run an engine to the end in ``eager`` or graphed mode; returns its
    wall seconds, its launches and its peak device memory (GiB)."""
    before = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mode(eager):
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = ops.launch_counts()
    return wall, {k: after[k] - before[k] for k in after}, torch.cuda.max_memory_allocated() / 2**30


def step_record(eng, prompts, wall, peak) -> dict:
    decode_ms = [st.wall_time * 1e3 for st in eng.step_stats if st.prefill_tokens == 0]
    mixed_ms = [st.wall_time * 1e3 for st in eng.step_stats if st.prefill_tokens > 0]
    gen = sum(len(r.output) for r in eng.finished.values())
    return dict(steps=eng.steps, mixed_steps=len(mixed_ms), decode_ms=statistics.median(decode_ms),
                mixed_ms=statistics.median(mixed_ms), gen_tok_s=gen / wall,
                processed_tok_s=(gen + sum(map(len, prompts))) / wall, wall_s=wall, peak_gib=peak,
                step_stats=eng.step_stats,
                first_token_steps={r.first_token_step for r in eng.finished.values()})


def serve(cfg, params, prompts, packed: bool, eager: bool = False, tag: str = ""):
    """One qwen serving run, eager (``disable_graphs``) or graphed, checked;
    returns the streams, the run's launches and its numbers."""
    free_device()  # the earlier runs' engines: the peak read is this run's
    eng = engine(cfg, params, prompts, packed)
    wall, runs, peak = run_engine(eng, eager)
    tag = f"{tag or ('eager' if eager else 'graphed')} {'packed' if packed else 'unpacked'}"
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
    rec = step_record(eng, prompts, wall, peak)
    summary = eng.stats_summary()
    log(f"serve {tag}: {steps} steps ({rec['mixed_steps']} mixed, {steps - rec['mixed_steps']} "
        f"decode-only), launches/step K4={runs['paged_attention'] / steps:.0f} "
        f"K2={runs['rmsnorm'] / steps:.0f}; median step ms: decode-only "
        f"{rec['decode_ms']:.2f}, mixed {rec['mixed_ms']:.2f}; {rec['gen_tok_s']:.1f} generated "
        f"tok/s, {rec['processed_tok_s']:.1f} processed tok/s over {wall:.2f} s; peak device "
        f"memory {peak:.2f} GiB; peak pages {summary['peak_used_pages']:.0f}/"
        f"{summary['num_pages']:.0f}" + ("" if eager else f"; {graph_line(eng)}"))
    return {u: r.output for u, r in eng.finished.items()}, runs, rec


@contextlib.contextmanager
def stale_inputs(at_replay: int):
    """A planted fault: the ``at_replay``-th replay of any step graph skips
    copying its inputs into the graph's static buffers, so it recomputes
    the previous step of its shape."""
    sound = graphs.StepGraph.load_inputs
    replays = [0]

    def faulty(self, static, inputs):
        replays[0] += 1
        if replays[0] != at_replay:
            sound(self, static, inputs)

    graphs.StepGraph.load_inputs = faulty
    try:
        yield replays
    finally:
        graphs.StepGraph.load_inputs = sound


def first_token_replay(rec) -> int:
    """Which replay (counted from 1 over an unpacked run's graphs: a mixed
    and a decode step shape) is the first to emit some request's first
    token, by the run's schedule: a stale input there feeds that request's
    last prompt column another token, so its first token changes."""
    seen, replays = set(), 0
    for st in rec["step_stats"]:
        mixed = st.prefill_tokens > 0  # the step's shape: (B, CHUNK) or (B, 1)
        if mixed in seen:
            replays += 1
            if st.step in rec["first_token_steps"]:
                return replays
        seen.add(mixed)
    raise SmokeFailure("no replayed step emits a first token")


def agreement(a, b) -> int:
    """Greedy tokens on which two runs' streams agree."""
    return sum(x == y for u in a for x, y in zip(a[u], b[u]))


def same_streams(tag, graphed, eager) -> None:
    total = sum(len(v) for v in eager.values())
    same = agreement(graphed, eager)
    log(f"{tag}: graphed vs eager greedy streams: {same}/{total} tokens agree")
    check(graphed == eager, f"{tag}: the graphed streams differ from the eager ones "
                            f"({same}/{total} tokens agree)")


def qwen_serving(cfg, params, prompts):
    """qwen2.5-3b's serving runs: eager (``disable_graphs``) unpacked and
    packed, the planted stale-input fault, then the graphed runs (the main
    path, the counters' window); the streams of each layout must be
    identical, the fault's must not.  Returns the launches and, by
    ``packed``, the graphed streams (phase 14's teachers)."""
    eager = {p: serve(cfg, params, prompts, p, eager=True) for p in (False, True)}
    at = first_token_replay(eager[False][2])
    with stale_inputs(at) as replays:
        bad, _, _ = serve(cfg, params, prompts, False, tag="planted fault (stale inputs)")
    check(replays[0] >= at, f"the planted fault saw {replays[0]} replays, not {at}")
    bad_same = agreement(bad, eager[False][0])
    log(f"planted fault, the input copy of replay {at} (of {replays[0]}) skipped: "
        f"{bad_same}/{SLOTS * NEW_TOKENS} tokens agree with the eager streams, rejected")
    check(bad != eager[False][0], "the stream check lets a replay with stale inputs pass")
    ops.reset_launch_counts()  # the main path starts here
    graphed = {p: serve(cfg, params, prompts, p) for p in (False, True)}
    counts = ops.launch_counts()  # ... and ends here
    for p in (False, True):
        same_streams(f"qwen {'packed' if p else 'unpacked'}", graphed[p][0], eager[p][0])
    same = agreement(graphed[False][0], graphed[True][0])
    log(f"packed vs unpacked greedy agreement: {same}/{SLOTS * NEW_TOKENS}")
    return counts, {p: graphed[p][0] for p in graphed}


# ---------------------------------------------------------------------------
# Mamba-2 serving
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def planted_ssd_fault(kind: str):
    """Route the model's K6 (``"chunk"``: the diagonal key tile skipped)
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


def mamba_serve(cfg, params, prompts, cache: str, packed: bool, eager: bool = False):
    """One serving run of the mamba phase, eager (``disable_graphs``) or
    graphed, checked; returns the streams, the run's launches and its
    numbers."""
    free_device()  # the earlier runs' engines: the peak read is this run's
    eng = mamba_engine(cfg, params, prompts, cache, packed)
    wall, runs, peak = run_engine(eng, eager)
    tag = (f"mamba {cache} {'packed' if packed else 'unpacked'} "
           f"{'eager' if eager else 'graphed'}")
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
    rec = step_record(eng, prompts, wall, peak)
    log(f"serve {tag}: {steps} steps ({rec['mixed_steps']} mixed, "
        f"{steps - rec['mixed_steps']} decode-only), "
        f"launches/step K6={runs['ssd_chunk'] / steps:.0f} K5={runs['ssd_segment'] / steps:.0f} "
        f"K2={runs['rmsnorm'] / steps:.0f}; median step ms: decode-only {rec['decode_ms']:.2f}, "
        f"mixed {rec['mixed_ms']:.2f}; {rec['gen_tok_s']:.1f} generated tok/s, "
        f"{rec['processed_tok_s']:.1f} processed tok/s over {wall:.2f} s; peak device memory "
        f"{peak:.2f} GiB" + ("" if eager else f"; {graph_line(eng)}"))
    return {u: r.output for u, r in eng.finished.items()}, runs, rec


def decode_step_ms(cfg, params, row_tile: int) -> float:
    """Device time of one dense decode step (8 slots, one token each, over
    a carried state), by CUDA-graph replay, with short steps run as one
    chunk rounded up to ``row_tile`` rows: ``ssm.ROW_TILE`` (16) is the
    port's, 256 (``ssm_chunk``) the reference's padding."""
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
    return agreement(outs[0], outs[1])


def mamba_phase(seed: int):
    """mamba2-130m at full width and depth: the 2-layer parity first, then
    the four serving runs eager (``disable_graphs``) and graphed (the
    counters' window; streams identical), then the decode step with and
    without the shortened chunk (in turns)."""
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
    layouts = [(cache, packed) for cache in ("dense", "paged") for packed in (False, True)]
    eager = {k: mamba_serve(cfg, params, prompts, *k, eager=True)[0] for k in layouts}
    outs, recs = {}, {}
    ops.reset_launch_counts()  # the main path starts here
    for k in layouts:
        outs[k], _, recs[k] = mamba_serve(cfg, params, prompts, *k)
    counts = ops.launch_counts()  # ... and ends here
    total = SLOTS * NEW_TOKENS
    for k in layouts:
        same_streams(f"mamba {k[0]} {'packed' if k[1] else 'unpacked'}", outs[k], eager[k])
    for packed in (False, True):
        log(f"mamba dense vs paged cache ({'packed' if packed else 'unpacked'}) greedy agreement: "
            f"{agreement(outs['dense', packed], outs['paged', packed])}/{total}")
    log(f"mamba packed vs unpacked greedy agreement: "
        f"{agreement(outs['dense', False], outs['dense', True])}/{total}")
    check(counts["ssd_chunk"] > 0 and counts["ssd_segment"] > 0 and counts["rmsnorm"] > 0,
          f"mamba: kernels not run: {counts}")
    short = [decode_step_ms(cfg, params, t) for t in (ssm.ROW_TILE, cfg.ssm_chunk,
                                                      cfg.ssm_chunk, ssm.ROW_TILE)]
    log(f"mamba dense decode step (8 slots), device ms by graph replay, in turns "
        f"{ssm.ROW_TILE}-row chunk / 256-row padding / 256 / {ssm.ROW_TILE}: "
        f"{' / '.join(f'{x:.3f}' for x in short)}")
    del params
    free_device()
    log(f"mamba packed vs unpacked greedy agreement in f32 compute: "
        f"{f32_agreement(cfg, seed, prompts)}/{total}")
    return counts, recs, outs


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def launches_per_microbatch(cfg, n_leaves: int):
    """Kernel calls one kept micro-batch makes, from the code: each
    attention ('G' / 'L' / 'B') layer runs two norms and one attention, each
    'R' (RG-LRU) layer two norms (its mixer and MLP run no kernel of their
    own), each 'M' layer one norm and one K6 over all its chunks (the
    sequence is one call's worth of 256-token chunks), the final norm one
    more; a norm is K2 when ``cfg.norm`` is RMSNorm (BERT's LayerNorm is
    plain PyTorch); under remat (``transformer._apply_stack_train``) the
    backward runs each layer's forward again, the final norm's not; each
    backward call of the K2 / K3 / K6 Functions is one backward launch;
    each gradient leaf is added once by K1 (``core.accumulate_grads``)."""
    n_a = sum(1 for k in cfg.pattern if k in "GLB")
    n_m = sum(1 for k in cfg.pattern if k == "M")
    n_r = sum(1 for k in cfg.pattern if k == "R")
    norms = 2 * n_a + 2 * n_r + n_m  # the layers' own
    again_a, again_m, again_n = (n_a, n_m, norms) if cfg.remat else (0, 0, 0)
    k2 = cfg.norm == "rmsnorm"
    return {"paged_attention": 0, "flash_attention": n_a + again_a, "flash_attention_bwd": n_a,
            "rmsnorm": k2 * (norms + 1 + again_n), "rmsnorm_bwd": k2 * (norms + 1),
            "masked_accum": n_leaves, "ssd_chunk": n_m + again_m, "ssd_chunk_bwd": n_m,
            "ssd_segment": 0}


def train_setup(cfg, seed: int, seqs: int = 1, seq: int = TRAIN_SEQ, mb: int = TRAIN_MB,
                steps: int = TRAIN_STEPS):
    """The training run's data (``seqs`` packed sequences of ``seq`` tokens
    a micro-batch, ``mb`` micro-batches a worker), latency model, tau and
    the masks its numpy latency draws give over ``steps`` steps."""
    n, m = TRAIN_WORKERS, mb
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=n * m * seqs,
                      strategy="pack", seed=seed)
    latency = LatencyModel(base=0.45, noise=NoiseModel(kind="paper_lognormal"))
    # the trainer's own draws (trainer._latencies_at): tau at the median of
    # the workers' latency sums drops the last micro-batches of about half
    draws = [latency.sample_at(step, n, m, seed=seed + 1) for step in range(steps)]
    tau = float(np.median(np.stack(draws).sum(-1)))
    masks = [drop_mask(t, tau, 1).numpy() for t in draws]
    return data, latency, tau, masks


def train_config(seed: int, latency, tau: float, mb: int = TRAIN_MB, steps: int = TRAIN_STEPS,
                 optimizer: str = "adamw", **kw) -> TrainConfig:
    """The training phase's TrainConfig (``kw``: ``mesh`` and the like)."""
    return TrainConfig(steps=steps, n_workers=TRAIN_WORKERS, microbatches=mb,
                       optimizer=optimizer, lr=1e-4, clip_norm=1.0, seed=seed, latency=latency,
                       drop=DropConfig(enabled=True, tau=tau), **kw)


def train_run(cfg, seed: int, eager: bool, tau=None, seqs: int = 1, seq: int = TRAIN_SEQ,
              mb: int = TRAIN_MB, steps: int = TRAIN_STEPS, **kw):
    """One training run (3 steps unless ``steps``) from ``--seed``'s weights,
    eager or graphed, at the phase's tau unless given (``kw`` to
    ``train_config``; ``seqs`` sequences of ``seq`` tokens a micro-batch,
    ``mb`` micro-batches a worker): (result, final f32 parameters,
    launches, peak GiB, wall s)."""
    data, latency, setup_tau, _ = train_setup(cfg, seed, seqs, seq, mb, steps)
    tcfg = train_config(seed, latency, setup_tau if tau is None else tau, mb, steps, **kw)
    params = init_params(cfg, seed=seed, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    with mode(eager):
        res = train(cfg, data, tcfg, params=params, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = ops.launch_counts()
    return (res, params, {k: after[k] - before[k] for k in after},
            torch.cuda.max_memory_allocated() / 2**30, wall)


def leaf_gaps(names, got, want) -> dict:
    """Per named leaf: 0 when the two are bit-identical, else their largest
    gap over the leaf's norm (each pair moved to the card in turn)."""
    gaps = {}
    for k, g, w in zip(names, got, want):
        g, w = g.to(DEV), w.to(DEV)
        gaps[k] = 0.0 if torch.equal(g, w) else float(
            (g.float() - w.float()).abs().max() / torch.linalg.vector_norm(w.float()))
    return gaps


def check_gaps(what: str, gaps: dict) -> None:
    """Bit-identical, or else the call that differs named with its largest
    gap, which must stay below 1e-3 of its leaf's norm."""
    differ = {k: v for k, v in gaps.items() if v}
    if not differ:
        log(f"{what}: graphed and eager bit-identical ({len(gaps)} leaves)")
        return
    worst = max(differ, key=differ.get)
    log(f"{what}: graphed and eager differ in {len(differ)} of {len(gaps)} leaves; largest gap "
        f"{worst} {differ[worst]:.3e} of its norm")
    check(differ[worst] < GRAPH_LEAF_GAP, f"{what}: leaf {worst} differs by {differ[worst]}")


def train_phase(cfg, seed: int):
    """qwen2.5-3b at full depth through ``repro_torch.train.train``, eager
    (``disable_graphs``) then graphed (the counters' window): losses and
    final parameters compared, launch counters checked in both.  Returns the
    graphed run's launches and its (losses, final leaves on the host, drop
    fractions)."""
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32",
          "the training phase wants remat, bf16 compute and f32 master weights")
    n, m = TRAIN_WORKERS, TRAIN_MB
    _, _, tau, masks = train_setup(cfg, seed)
    want_drops = [1.0 - float(np.float32(k.sum()) / np.float32(k.size)) for k in masks]
    kept = int(sum(k.sum() for k in masks))
    check(0 < kept < n * m * TRAIN_STEPS and max(want_drops) > 0,
          f"tau {tau} should drop some micro-batches, not all: {want_drops}")
    n_leaves = len(tree_leaves(init_params(cfg, seed=seed, device="meta")))
    per_mb = launches_per_microbatch(cfg, n_leaves)
    want = {k: kept * v for k, v in per_mb.items()}
    kept_per_step = [int(k.sum()) for k in masks]
    runs = {}
    for eager in (True, False):
        tag = "eager" if eager else "graphed"
        if not eager:
            ops.reset_launch_counts()  # the training path starts here (read in train_run)
        res, params, counts, peak, wall = train_run(cfg, seed, eager)
        check(all(math.isfinite(x) for x in res.losses), f"{tag}: non-finite losses {res.losses}")
        check(res.drop_fractions == want_drops,
              f"{tag}: drop fractions {res.drop_fractions}, the latency draws give {want_drops}")
        check(counts == want, f"{tag} training launches {counts}, the code implies {want}")
        steps = res.metrics["step_s"]
        tok_s = [kps * TRAIN_SEQ / st for kps, st in zip(kept_per_step, steps)]
        mb_ms = [[round(t * 1e3, 1) for t in ts] for ts in res.metrics["microbatch_s"]]
        log(f"train {tag} qwen2.5-3b: {cfg.n_layers} layers, seq {TRAIN_SEQ}, {n} workers x {m} "
            f"micro-batches, tau {tau:.4f} s, drop fractions {res.drop_fractions} (kept "
            f"{kept_per_step} micro-batches), losses {res.losses}")
        log(f"train {tag}: step wall s {[round(x, 3) for x in steps]}; per kept micro-batch ms "
            f"{mb_ms}; kept tokens/s {[round(x, 1) for x in tok_s]}; peak device memory "
            f"{peak:.2f} GiB; whole call {wall:.1f} s")
        log(f"train {tag} launches over {kept} kept micro-batches: {counts} (per micro-batch "
            f"{per_mb})")
        runs[tag] = (res.losses, [x.cpu() for x in tree_leaves(params)], res.drop_fractions)
        del res, params
        free_device()
    (got, got_p, _), (want_l, want_p, _) = runs["graphed"], runs["eager"]
    same = [a == b for a, b in zip(got, want_l)]
    log(f"train: graphed vs eager losses {'bit-identical' if all(same) else 'differ'}: {got} / "
        f"{want_l}")
    if not all(same):
        step = same.index(False)
        gap = abs(got[step] - want_l[step]) / abs(want_l[step])
        log(f"train: step {step}'s loss differs by {gap:.3e} of it")
        check(gap < GRAPH_LEAF_GAP, f"train: step {step}'s loss differs by {gap}")
    names = [k for k, _ in named_leaves(init_params(cfg, seed=seed, device="meta"))]
    check_gaps("train: final parameters after 3 steps", leaf_gaps(names, got_p, want_p))
    return counts, runs["graphed"]


def grad_phase(cfg, seed: int, seqs: int = 1):
    """One step's accumulated gradient at full depth (step 0's micro-batches
    of ``seqs`` sequences, its keep mask), eager and graphed: bit-identical,
    or within ``GRAPH_LEAF_GAP`` of each leaf's norm; then the capture's
    cost."""
    data, _, _, masks = train_setup(cfg, seed, seqs)
    mbs = microbatches_at(0, data, TRAIN_WORKERS * TRAIN_MB)
    mbs = {"tokens": torch.from_numpy(mbs["tokens"]).to(DEV, torch.long),
           "weights": torch.from_numpy(mbs["weights"]).to(DEV)}
    mask = masks[0].reshape(-1)
    params = init_params(cfg, seed=seed, device=DEV)
    compute = model_lib.train_params(params, cfg)
    grad_fn = make_grad_fn(lambda p, mb: model_lib.loss_fn(p, cfg, mb))
    grads = {}
    for eager in (True, False):
        acc = Accumulator(grad_fn, compute)
        with mode(eager):
            g, loss, _ = accumulate_grads(grad_fn, compute, mbs, mask, DropConfig(),
                                          accumulator=acc)
        torch.cuda.synchronize()
        grads[eager] = (acc, float(loss))
    acc, loss = grads[False]
    log(f"grad check: {int(mask.sum())} of {mask.size} micro-batches kept; loss graphed "
        f"{loss!r} / eager {grads[True][1]!r}; {graph_line(acc)}")
    names = [k for k, _ in named_leaves(acc.tree)]
    check_gaps(f"grad check: step 0's accumulated gradient, {cfg.n_layers} layers",
               leaf_gaps(names, acc.leaves, grads[True][0].leaves))
    check(loss == grads[True][1] or abs(loss - grads[True][1]) < GRAPH_LEAF_GAP * abs(loss),
          f"grad check: loss {loss} against eager {grads[True][1]}")


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


# ---------------------------------------------------------------------------
# Local-SGD + DropCompute (appendix B.3)
# ---------------------------------------------------------------------------


def localsgd_keep(seed: int):
    """(seed used, keep mask (rounds, N, H)): fig. 12's single-server
    scenario drawn from ``seed`` and capped at tau as ``localsgd_speedup``
    caps it (``cum < tau``); the first seed from ``seed`` on whose mask
    drops a step."""
    sc = StragglerScenario(**LSGD_SCENARIO)
    for s in range(seed, seed + 1000):
        t = sc.sample(np.random.default_rng(s), LSGD_ROUNDS, LSGD_WORKERS, LSGD_H)
        keep = (np.cumsum(t, axis=-1) < LSGD_TAU).astype(np.float32)
        if 0 < keep.sum() < keep.size:
            return s, keep
    raise SmokeFailure("no seed in 1000 drops a local step")


def localsgd_batches(cfg, seed: int, seq: int, r: int, dev):
    """Round r's micro-batches: worker n's H packed sequences of ``seq``
    tokens from ``data.synthetic`` (one sequence a local step)."""
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=LSGD_H,
                      strategy="pack", seed=seed)
    out = []
    for n in range(LSGD_WORKERS):
        mbs = microbatches_at(r, data, LSGD_H, worker=n)
        out.append({"tokens": torch.from_numpy(mbs["tokens"]).to(dev, torch.long),
                    "weights": torch.from_numpy(mbs["weights"]).to(dev)})
    return out


def localsgd_run(cfg, params, keep, seed: int, seq: int, lr: float, eager: bool = False,
                 fault_leaf=None):
    """Local-SGD on ``params`` (updated in place) through
    ``core.local_sgd.LocalSGD``, the model's loss and its compute copy:
    (round losses, round wall s, per-step (kept, device ms), the state).
    ``fault_leaf`` plants a K1 fault: its local steps add with the scale's
    sign flipped."""
    dev = tree_leaves(params)[0].device

    def loss(p, mb):
        ls, w = model_lib.loss_fn(p, cfg, mb)
        return ls / w

    state = LocalSGD(loss, params, LSGD_WORKERS, LSGD_H, lr,
                     cast=lambda w, out=None: model_lib.train_params(w, cfg, out=out))
    batches = [localsgd_batches(cfg, seed, seq, r, dev) for r in range(LSGD_ROUNDS)]
    losses, walls, steps = [], [], []
    with mode(eager), flipped_scale(state, fault_leaf):
        for r in range(LSGD_ROUNDS):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            # a span a torch.profiler trace can cut rounds by (free when not profiling)
            with torch.profiler.record_function("localsgd_round"):
                losses.append(float(state.round(batches[r], keep[r])))  # syncs
            walls.append(time.perf_counter() - t0)
            steps.append([(bool(k), s.elapsed_time(e) if dev.type == "cuda" else (e - s) * 1e3)
                          for k, s, e in state.step_marks])
    return losses, walls, steps, state


@contextlib.contextmanager
def flipped_scale(state, leaf):
    """A planted K1 fault: the local steps of the working copy's leaf named
    ``leaf`` add ``+lr * g`` instead of ``-lr * g`` (S += W left sound)."""
    if leaf is None:
        yield
        return
    names = [k for k, _ in named_leaves(state.work)]
    target = state.w_leaves[names.index(leaf)]
    sound = ops.masked_accum  # what core.local_sgd calls

    def faulty(acc, grad, keep=1.0, scale=1.0):
        return sound(acc, grad, keep, -scale if acc is target and scale < 0 else scale)

    ops.masked_accum = faulty
    try:
        yield
    finally:
        ops.masked_accum = sound


def step_replay_ms(state, cfg, seed: int, keep: float, iters: int = 5) -> float:
    """Median device ms of one local step (``LocalSGD.step``; a graph
    replay once captured) on round 0's first micro-batch, between two
    events after a sync."""
    mb = {k: v[0] for k, v in localsgd_batches(cfg, seed, TRAIN_SEQ, 0, DEV)[0].items()}
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        state.step(mb, keep)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def localsgd_launches(cfg, n_leaves: int, kept: int, dropped: int) -> dict:
    """What the code implies: a kept local step is a kept micro-batch's
    launches (``launches_per_microbatch``: forward under remat, backward,
    one K1 add a leaf into W) plus the post-step loss's forward (a
    forward-only pass: per attention layer one attention and two RMSNorms,
    per 'M' layer one K6 and one RMSNorm, one more RMSNorm); a dropped step
    is that forward alone; each worker adds W into S once, one K1 launch a
    leaf."""
    n_a = sum(1 for k in cfg.pattern if k in "GL")
    n_m = sum(1 for k in cfg.pattern if k == "M")
    fwd = {"flash_attention": n_a, "rmsnorm": 2 * n_a + n_m + 1, "ssd_chunk": n_m}
    per_kept = launches_per_microbatch(cfg, n_leaves)
    out = {k: kept * v + (kept + dropped) * fwd.get(k, 0) for k, v in per_kept.items()}
    out["masked_accum"] += n_leaves * LSGD_WORKERS * LSGD_ROUNDS
    return out


def localsgd_phase(cfg, seed: int):
    """``cfg`` (qwen2.5-3b at 36 layers; mamba2-130m at ``M_LSGD_LAYERS``),
    eager then graphed (the counters' window): finite round losses, graphed
    equal to eager (losses and final parameters), the launches the code
    implies, device ms of each kept and dropped local step, the allocated
    peak."""
    mask_seed, keep = localsgd_keep(seed)
    kept, dropped = int(keep.sum()), int(keep.size - keep.sum())
    log(f"localsgd: keep mask from seed {mask_seed} (single-server scenario, tau "
        f"{LSGD_TAU:.2f}): {keep.astype(int).tolist()} ({kept} kept, {dropped} dropped)")
    names = [k for k, _ in named_leaves(init_params(cfg, seed=seed, device="meta"))]
    want = localsgd_launches(cfg, len(names), kept, dropped)
    runs = {}
    for eager in (True, False):
        tag = "eager" if eager else "graphed"
        params = init_params(cfg, seed=seed, device=DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, walls, steps, state = localsgd_run(cfg, params, keep, seed, TRAIN_SEQ,
                                                   LSGD_LR, eager)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(x) for x in losses), f"localsgd {tag}: losses {losses}")
        check(counts == want, f"localsgd {tag} launches {counts}, the code implies {want}")
        kept_ms = [round(ms, 1) for rnd in steps for k, ms in rnd if k]
        drop_ms = [round(ms, 1) for rnd in steps for k, ms in rnd if not k]
        log(f"localsgd {tag} {cfg.name}: {cfg.n_layers} layers, seq {TRAIN_SEQ}, "
            f"{LSGD_WORKERS} workers x {LSGD_H} local steps x {LSGD_ROUNDS} rounds, lr "
            f"{LSGD_LR}: round losses {losses}; round wall s {[round(w, 3) for w in walls]}")
        log(f"localsgd {tag}: device ms a kept local step {kept_ms}, a dropped step {drop_ms} "
            f"(round by round, worker by worker); allocated peak {peak:.2f} GiB"
            + ("" if eager else f"; {graph_line(state)}"))
        log(f"localsgd {tag} {cfg.name} launches: {counts} (K1: {len(names)} a kept step, 0 a "
            f"dropped step, {len(names)} a worker for S += W)")
        runs[tag] = (losses, [x.cpu() for x in tree_leaves(params)])
        if not eager:  # a replay of each graph alone: the run's first calls captured them
            log(f"localsgd graphed, each step's graph replayed alone (device ms, median of 5): "
                f"kept {step_replay_ms(state, cfg, seed, 1.0):.1f}, dropped "
                f"{step_replay_ms(state, cfg, seed, 0.0):.1f}")
        del params, state
        free_device()
    (got, got_p), (want_l, want_p) = runs["graphed"], runs["eager"]
    log(f"localsgd {cfg.name}: graphed vs eager round losses "
        f"{'bit-identical' if got == want_l else 'differ'}: {got} / {want_l}")
    for g, w in zip(got, want_l):
        check(g == w or abs(g - w) < GRAPH_LEAF_GAP * abs(w), f"localsgd: loss {g} / {w}")
    check_gaps(f"localsgd {cfg.name}: final parameters", leaf_gaps(names, got_p, want_p))
    return counts, mask_seed, keep


def localsgd_parity(cfg, seed: int, keep):
    """A 2-layer full-width model at 256 tokens: the round losses and every
    leaf's update on the card (kernels, bf16 compute) against the CPU
    (plain versions, f32), and the same metric with a planted K1 fault."""
    small = dataclasses.replace(cfg, n_layers=PARITY_LAYERS)
    cpu_cfg = dataclasses.replace(small, dtype="float32")
    start = init_params(cpu_cfg, seed=seed, device="cpu")

    def run(c, dev, fault=None):
        p = tree_map(lambda x: x.clone().to(dev), start)
        losses, _, _, _ = localsgd_run(c, p, keep, seed, PARITY_SEQ, LSGD_PARITY_LR,
                                       fault_leaf=fault)
        return losses, {k: (x.cpu().double() - s.double())
                        for (k, x), s in zip(named_leaves(p), tree_leaves(start))}

    def leaf_errs(d):
        return {k: float(torch.linalg.vector_norm(d[k] - w) / torch.linalg.vector_norm(w))
                for k, w in cpu_d.items()}

    t0 = time.perf_counter()
    cpu_l, cpu_d = run(cpu_cfg, "cpu")
    t_cpu = time.perf_counter() - t0
    card_l, card_d = run(small, DEV)
    _, bad_d = run(small, DEV, LSGD_FAULT_LEAF)
    errs, bad = leaf_errs(card_d), leaf_errs(bad_d)
    worst, bad_worst = max(errs, key=errs.get), max(bad, key=bad.get)
    el = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    log(f"localsgd parity {PARITY_LAYERS} layers seq {PARITY_SEQ} lr {LSGD_PARITY_LR}: round "
        f"losses card {card_l} / cpu {cpu_l} (rel {el:.2e}); the CPU run took {t_cpu:.1f} s")
    log("localsgd parity per-leaf ||dP_card - dP_cpu|| / ||dP_cpu||: "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    log(f"localsgd parity worst leaf {worst} {errs[worst]:.2e}; planted fault (K1 scale sign "
        f"flipped for {LSGD_FAULT_LEAF}): worst leaf {bad_worst} {bad[bad_worst]:.2e}")
    check(all(math.isfinite(x) for x in card_l + list(errs.values())), "non-finite card result")
    check(el <= PARITY_LOSS_REL_TOL, f"localsgd round loss relative difference {el}")
    check(errs[worst] <= PARITY_LEAF_REL_TOL, f"localsgd leaf {worst}: update differs by "
          f"{errs[worst]}")
    check(bad[LSGD_FAULT_LEAF] > PARITY_LEAF_REL_TOL,
          f"the per-leaf update metric lets a planted K1 sign fault pass: {bad}")


# ---------------------------------------------------------------------------
# checkpoints: save, resume, and the uninterrupted run
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timed_checkpoints():
    """The host seconds of the trainer's ``checkpoint.save`` and
    ``checkpoint.restore`` calls (the card synced around each), by name."""
    secs, sound = {}, (checkpoint.save, checkpoint.restore)

    def timed(fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[fn.__name__] = time.perf_counter() - t0
            return out
        return call

    checkpoint.save, checkpoint.restore = (timed(f) for f in sound)
    try:
        yield secs
    finally:
        checkpoint.save, checkpoint.restore = sound


def checkpoint_phase(cfg, seed: int):
    """A 2-layer full-width qwen through ``train``: run A saves at step 1,
    run B resumes from it for steps 1-2; B's losses, drop fractions, tau
    trajectory and final parameters must equal the uninterrupted run's bit
    for bit.  Prints the bytes written and the seconds to save and restore;
    the directory is deleted after."""
    small = dataclasses.replace(cfg, n_layers=CKPT_LAYERS)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      batch_size=CKPT_WORKERS * CKPT_MB, strategy="pack", seed=seed)
    latency = make_scenario("badnode", base=LatencyModel(
        base=0.45, noise=NoiseModel(kind="paper_lognormal")), seed=seed, onset=0)

    def tcfg(**kw):
        base = dict(steps=CKPT_STEPS, n_workers=CKPT_WORKERS, microbatches=CKPT_MB,
                    optimizer="adamw", lr=1e-4, clip_norm=1.0, seed=seed, latency=latency,
                    drop=DropConfig(enabled=True, tau=float("inf")), online_tau=True,
                    controller=ControllerConfig(warmup_steps=1, check_every=1))
        base.update(kw)
        return TrainConfig(**base)

    def run(**kw):
        params = init_params(small, seed=seed, device=DEV)
        t0 = time.perf_counter()
        res = train(small, data, tcfg(**kw), params=params, device=DEV)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    path = tempfile.mkdtemp(prefix="checkpoint-", dir=root)
    try:
        full, _ = run()
        with timed_checkpoints() as secs:
            part, t_a = run(steps=CKPT_AT, ckpt_dir=path, ckpt_every=CKPT_AT)
            nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            resumed, t_b = run(resume_from=path)
    finally:
        shutil.rmtree(path)
    log(f"checkpoint {CKPT_LAYERS} layers ({small.param_count() / 1e6:.0f} M parameters, AdamW "
        f"m and v): {nbytes} bytes ({nbytes / 2**30:.2f} GiB) written at step {CKPT_AT}; save "
        f"{secs['save']:.2f} s, restore into the card's tensors {secs['restore']:.2f} s; run A "
        f"{t_a:.1f} s, run B ({CKPT_STEPS - CKPT_AT} steps) {t_b:.1f} s")
    log(f"checkpoint: uninterrupted losses {full.losses}, drops {full.drop_fractions}, tau "
        f"trajectory {full.tau_trajectory}; resumed {resumed.losses}, {resumed.drop_fractions}, "
        f"{resumed.tau_trajectory}")
    check(part.losses == full.losses[:CKPT_AT], f"run A {part.losses} / {full.losses}")
    check(resumed.losses == full.losses[CKPT_AT:], "resumed losses differ")
    check(resumed.drop_fractions == full.drop_fractions[CKPT_AT:], "resumed drops differ")
    check(resumed.tau_trajectory == full.tau_trajectory and resumed.tau == full.tau,
          "resumed tau trajectory differs")
    check(len(full.tau_trajectory) > 1, f"tau never moved: {full.tau_trajectory}")
    names = [k for k, _ in named_leaves(full.params)]
    gaps = leaf_gaps(names, tree_leaves(resumed.params), tree_leaves(full.params))
    differ = [k for k, v in gaps.items() if v]
    check(not differ, f"resumed final parameters differ from the uninterrupted run's: {differ}")
    log(f"checkpoint: resumed run equals the uninterrupted one bit for bit (losses, drop "
        f"fractions, tau trajectory, {len(names)} parameter leaves)")


# ---------------------------------------------------------------------------
# data parallel: 9a one NCCL rank at full depth, 9b two gloo ranks on the card
# ---------------------------------------------------------------------------


def dp_nccl_phase(cfg, seed: int, graphed):
    """9a: the training phase's run as one rank of a one-rank NCCL group in
    this process (``mesh="1"``, graphed): losses, drop fractions and every
    final leaf must equal the training phase's graphed run bit for bit, and
    the launches those of its kept micro-batches.  Prints each step's
    All-Reduce device ms (CUDA events around the collective).  Returns the
    launches."""
    want_losses, want_leaves, want_drops = graphed
    _, _, tau, masks = train_setup(cfg, seed)
    kept = int(sum(k.sum() for k in masks))
    per_mb = launches_per_microbatch(cfg, len(want_leaves))
    want_counts = {k: kept * v for k, v in per_mb.items()}
    with procs.local_group(backend="nccl", device=DEV):
        ops.reset_launch_counts()  # the data-parallel path starts here (read in train_run)
        res, params, counts, peak, wall = train_run(cfg, seed, eager=False, mesh="1")
    nbytes = 4 * sum(x.numel() for x in tree_leaves(params)) + 12
    ar_ms = [x * 1e3 for x in res.metrics["allreduce_s"]]
    log(f"dp 9a one NCCL rank, {cfg.n_layers} layers: losses {res.losses}, drop fractions "
        f"{res.drop_fractions}, kept {res.metrics['kept_local']}; step wall s "
        f"{[round(x, 3) for x in res.metrics['step_s']]}; all-reduce device ms a step "
        f"{[round(x, 3) for x in ar_ms]} over {nbytes} bytes (15 in-place calls); peak device "
        f"memory {peak:.2f} GiB; whole call {wall:.1f} s")
    log(f"dp 9a launches over {kept} kept micro-batches: {counts}")
    check(counts == want_counts, f"dp 9a launches {counts}, the code implies {want_counts}")
    check(res.losses == want_losses, f"dp 9a losses {res.losses} / train {want_losses}")
    check(res.drop_fractions == want_drops,
          f"dp 9a drop fractions {res.drop_fractions} / train {want_drops}")
    names = [k for k, _ in named_leaves(params)]
    differ = [k for k, v in leaf_gaps(names, tree_leaves(params), want_leaves).items() if v]
    check(not differ, f"dp 9a final leaves differ from the training phase's: {differ}")
    log(f"dp 9a: one NCCL rank equals the training phase's graphed run bit for bit (losses, "
        f"drop fractions, {len(names)} final leaves)")
    return counts


def dp_tau(cfg, seed: int, seqs: int = 1):
    """(tau, masks) for 9b: the training phase's tau (the median of the
    workers' latency sums) unless some rank then drops nothing in the run;
    else the first of a few other quantiles under which every rank drops."""
    _, latency, _, _ = train_setup(cfg, seed, seqs)
    draws = np.stack([latency.sample_at(step, TRAIN_WORKERS, TRAIN_MB, seed=seed + 1)
                      for step in range(TRAIN_STEPS)])
    per = TRAIN_WORKERS // DP_RANKS
    for q in (50, 40, 60, 30, 70):
        tau = float(np.percentile(draws.sum(-1), q))
        masks = [drop_mask(t, tau, 1).numpy() for t in draws]
        if all(sum((1 - k[r * per:(r + 1) * per]).sum() for k in masks) > 0
               for r in range(DP_RANKS)):
            return tau, masks
    raise SmokeFailure("no tau drops a micro-batch on every rank")


def dp_rank_bytes(cfg, pool_gib: float) -> dict:
    """A 9b rank's device memory, reckoned: the f32 master, AdamW's m and v,
    the f32 accumulator, the bf16 compute copy (the embedding stays the
    master) and the training pool (``DP_POOL_GIB`` for qwen's 4 layers,
    ``M_DP_POOL_GIB`` for mamba2-130m)."""
    named = named_leaves(init_params(cfg, seed=0, device="meta"))
    p = sum(x.numel() for _, x in named)
    body = sum(x.numel() for k, x in named if not k.startswith("/embed/"))
    return {"f32 master": 4 * p, "AdamW m and v": 8 * p, "accumulator": 4 * p,
            "bf16 compute copy": 2 * body, "training pool": int(pool_gib * 2**30)}


def skip_first_kept_microbatch() -> None:
    """A planted fault: this process's first kept micro-batch is never
    added (its loss and weight come back 0)."""
    sound, done = Accumulator.add, []

    def add(self, mb):
        if not done:
            done.append(True)
            zero = torch.zeros((), device=self.leaves[0].device)
            return zero, zero
        return sound(self, mb)

    Accumulator.add = add


def dp_rank(rank: int, world: int, cfg, seed: int, tau: float, seqs: int = 1) -> list:
    """One 9b rank (a spawned process on GPU 0, gloo): ``dp_rank_run``
    sound, then with the planted fault (rank 1 skips its next kept
    micro-batch), one spawn's start-up serving both.  Returns the two runs'
    readings in that order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    sound = dp_rank_run(rank, world, cfg, seed, tau, seqs)
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 1:
        skip_first_kept_microbatch()
    return [sound, dp_rank_run(rank, world, cfg, seed, tau, seqs)]


def dp_rank_run(rank: int, world: int, cfg, seed: int, tau: float, seqs: int) -> dict:
    """The training phase's run at ``cfg``'s depth with ``mesh`` the 2-rank
    gloo group; returns its readings, whether its final replica equals rank
    0's (a broadcast of each leaf compared on the card) and, on rank 0, the
    final leaves."""
    dev = f"{DEV}:0"
    mesh = Distribution.from_spec(str(world), device=dev, backend="gloo")
    params = init_params(cfg, seed=seed, device=dev)
    data, latency, _, _ = train_setup(cfg, seed, seqs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train(cfg, data, train_config(seed, latency, tau, mesh=mesh), params=params, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    params, same = res.params, True
    for leaf in tree_leaves(params):
        theirs = leaf.clone()
        torch.distributed.broadcast(theirs, src=0)
        same = same and torch.equal(theirs, leaf)
    out = {"losses": res.losses, "drop_fractions": res.drop_fractions,
           "tau_trajectory": res.tau_trajectory, "step_s": res.metrics["step_s"],
           "allreduce_s": res.metrics["allreduce_s"], "kept_local": res.metrics["kept_local"],
           "counts": counts, "peak_gib": peak, "wall_s": wall, "same_as_rank0": same}
    if rank == 0:
        out["leaves"] = [x.cpu() for x in tree_leaves(params)]
    return out


@contextlib.contextmanager
def reversed_sums():
    """Each step's kept micro-batches added in the reverse order (the data-
    parallel step's ``sum_kept``): the same sums in another f32 order."""
    sound = dp_steps.sum_kept

    def reverse(acc, microbatches, keep):
        return sound(acc, {k: v.flip(0) for k, v in microbatches.items()}, keep[::-1].copy())

    dp_steps.sum_kept = reverse
    try:
        yield
    finally:
        dp_steps.sum_kept = sound


def dp_faults(got, one, masks, per_mb: dict, names, order_gaps: dict) -> dict:
    """9b's ranks (``got``) against the one-rank run (``one``: losses, drop
    fractions, tau trajectory, final leaves).  Returns the checks that fail,
    by kind: ``"ranks"``, every rank's replica, losses, drop fractions and
    tau trajectory the same as rank 0's, and each rank's kept count (from
    its masks) and the micro-batches it computed (its launches) exact;
    ``"values"``, against the one-rank run, the drop fractions and tau
    trajectory exact, the losses within ``GRAPH_LEAF_GAP`` and every final
    leaf within ``DP_ORDER_FACTOR`` times ``order_gaps`` (the one-rank run's
    own gap under another order of its sums; ``DP_ZERO_GAP_FLOOR`` where
    that gap is 0).  Prints the gaps first."""
    faults = {"ranks": [], "values": []}
    r0, per = got[0], TRAIN_WORKERS // DP_RANKS
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"]))
    gaps = leaf_gaps(names, r0["leaves"], one["leaves"])
    limits = {k: DP_ORDER_FACTOR * order_gaps[k] if order_gaps[k] > 0 else DP_ZERO_GAP_FLOOR
              for k in gaps}
    log(f"dp 9b vs one rank: losses {r0['losses']} / {one['losses']} (largest gap {loss_gap:.3e} "
        f"of the loss); final leaves, gap of its norm (the one-rank run's under reversed sums): "
        + ", ".join(f"{k} {v:.2e} ({order_gaps[k]:.2e})" for k, v in gaps.items()))
    for r, res in enumerate(got):
        own = [int(k[r * per:(r + 1) * per].sum()) for k in masks]
        want = {k: sum(own) * v for k, v in per_mb.items()}
        computed = res["counts"]["masked_accum"] / per_mb["masked_accum"]
        log(f"dp 9b rank {r}: kept {res['kept_local']} (its workers' masks {own}), computed "
            f"{computed:g} micro-batches")
        for ok, msg in (
                (res["same_as_rank0"], f"rank {r}'s final replica differs from rank 0's"),
                (all(res[k] == r0[k] for k in ("losses", "drop_fractions", "tau_trajectory")),
                 f"rank {r}'s losses, drops or tau differ from rank 0's"),
                (res["kept_local"] == own, f"rank {r} kept {res['kept_local']}, its masks {own}"),
                (res["counts"] == want, f"rank {r} launches {res['counts']}: computed "
                 f"{computed:g} micro-batches where its workers kept {sum(own)} ({want})")):
            if not ok:
                faults["ranks"].append(msg)
    if r0["drop_fractions"] != one["drop_fractions"]:
        faults["values"].append(f"drop fractions {r0['drop_fractions']} / one rank "
                                f"{one['drop_fractions']}")
    if r0["tau_trajectory"] != one["tau_trajectory"]:
        faults["values"].append("tau trajectories differ")
    if loss_gap >= GRAPH_LEAF_GAP:
        faults["values"].append(f"losses differ by {loss_gap} of the loss")
    faults["values"] += [f"leaf {k} differs by {gaps[k]:.3e} of its norm, its limit "
                         f"{limits[k]:.3e}" for k in gaps if gaps[k] >= limits[k]]
    return faults


def dp_gloo_phase(cfg, seed: int, layers: int = DP_LAYERS,
                  pool_gib: float = DP_POOL_GIB) -> None:
    """9b: ``cfg``'s widths at ``layers`` layers (qwen2.5-3b at
    ``DP_LAYERS``; mamba2-130m at ``M_DP_LAYERS``), the training phase's
    data and latencies (2 workers a rank x 2 micro-batches of one 2048-token
    sequence, 3 steps) on two gloo ranks sharing the card, against 9a's code
    at the same depth on one rank, which must pass every check of
    ``dp_faults``; then, in the same two spawned processes (``dp_rank``),
    the same with a planted fault (rank 1 skips one kept micro-batch),
    which they must reject, and the log says which did."""
    small = dataclasses.replace(cfg, n_layers=layers)
    tau, masks = dp_tau(cfg, seed)
    mode_line = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True).stdout.strip()
    log(f"dp 9b {cfg.name}: compute mode {mode_line}; tau {tau:.4f} s, masks "
        f"{[k.tolist() for k in masks]}")
    check(mode_line.splitlines()[0] == "Default",
          f"two processes on one card need compute mode Default, not {mode_line}")
    runs = {}
    for order in ("sound", "reversed"):
        with procs.local_group(backend="nccl", device=DEV), (
                reversed_sums() if order == "reversed" else contextlib.nullcontext()):
            res, params, _, peak1, wall1 = train_run(small, seed, eager=False, tau=tau, mesh="1")
        runs[order] = {"losses": res.losses, "drop_fractions": res.drop_fractions,
                       "tau_trajectory": res.tau_trajectory,
                       "leaves": [x.cpu() for x in tree_leaves(params)]}
        log(f"dp 9b {cfg.name} one rank ({order} order of the sums), {layers} layers "
            f"({small.param_count()} parameters): losses {res.losses}, drop fractions "
            f"{res.drop_fractions}; step wall s {[round(x, 3) for x in res.metrics['step_s']]}; "
            f"peak {peak1:.2f} GiB; {wall1:.1f} s")
        names = [k for k, _ in named_leaves(params)]
        del res, params
        free_device()
    one = runs["sound"]
    order_gaps = leaf_gaps(names, runs["reversed"]["leaves"], one["leaves"])
    del runs
    reckon = dp_rank_bytes(small, pool_gib)
    free, total = torch.cuda.mem_get_info()
    parts = ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in reckon.items())
    log(f"dp 9b rank memory, reckoned: {parts}; total {sum(reckon.values()) / 2**30:.2f} GiB a "
        f"rank; free on the card {free / 2**30:.2f} of {total / 2**30:.2f} GiB")
    check(free >= 2 * sum(reckon.values()),
          f"two ranks want 2 x {sum(reckon.values())} bytes, the card has {free} free")
    per_mb = launches_per_microbatch(small, len(names))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    runs = procs.spawn(dp_rank, DP_RANKS, backend="gloo", device=f"{DEV}:0",
                       timeout_s=DP_TIMEOUT_S, workdir=root, args=(small, seed, tau))
    log(f"dp 9b {cfg.name}: {DP_RANKS} ranks spawned once for the sound run and the planted "
        f"fault's, joined in {time.perf_counter() - t0:.1f} s")
    for i, plant in enumerate((False, True)):
        got = [r[i] for r in runs]
        tag = (f"{cfg.name} planted fault (rank 1 skips one kept micro-batch)" if plant
               else f"{cfg.name} sound")
        for r, g in enumerate(got):
            log(f"dp 9b {tag}, rank {r}: losses {g['losses']}, drops {g['drop_fractions']}; "
                f"step wall s {[round(x, 3) for x in g['step_s']]}; all-reduce s "
                f"{[round(x, 3) for x in g['allreduce_s']]} ({4 * small.param_count() + 12} "
                f"bytes, gloo through the host); peak {g['peak_gib']:.2f} GiB; train "
                f"{g['wall_s']:.1f} s; launches {g['counts']}")
        faults = dp_faults(got, one, masks, per_mb, names, order_gaps)
        failed = faults["ranks"] + faults["values"]
        if not plant:
            check(not failed, "; ".join(failed))
            log(f"dp 9b: two gloo ranks match one rank (drop fractions, tau trajectory and kept "
                f"counts exact; losses within {GRAPH_LEAF_GAP}, {len(names)} leaves within "
                f"{DP_ORDER_FACTOR}x their order gaps, {DP_ZERO_GAP_FLOOR:.1e} where that is 0)")
        else:
            check(bool(faults["ranks"]) and bool(faults["values"]),
                  f"dp 9b {cfg.name}: the planted skipped micro-batch passed the checks by "
                  f"launch counts ({faults['ranks'] or 'none failed'}) or by values "
                  f"({faults['values'] or 'none failed'})")
            log(f"dp 9b {cfg.name} planted fault rejected; by the ranks' own checks: "
                f"{'; '.join(faults['ranks']) or 'none'}; by the values against one rank: "
                f"{'; '.join(faults['values']) or 'none'}")
        del got
    del runs


# ---------------------------------------------------------------------------
# Mamba-2 training (phase 10)
# ---------------------------------------------------------------------------


def memory_reckoning(meta, optimizer: str = "adamw") -> dict:
    """GB of the training run's persistent trees, from the parameter tree
    (``meta`` tensors): the f32 master, the optimizer's m and v (AdamW,
    LAMB and LANS each keep two f32 moments), the f32 accumulator, and the
    bf16 compute copy of every leaf but the embedding (which the copy shares
    with the master: ``model.train_params``)."""
    total = sum(x.numel() for x in tree_leaves(meta))
    emb = meta["embed"]["embedding"].numel()
    return {"master f32": 4 * total / 1e9, f"{optimizer} m, v": 8 * total / 1e9,
            "accumulator": 4 * total / 1e9, "bf16 compute copy": 2 * (total - emb) / 1e9}


def full_train_phase(cfg, seed: int, what: str, seqs: int, seq: int = TRAIN_SEQ,
                     mb: int = TRAIN_MB, steps: int = TRAIN_STEPS, optimizer: str = "adamw"):
    """``cfg`` at its full width and depth through ``repro_torch.train.train``:
    the training phase's workers and tau rule, ``mb`` micro-batches a worker
    of ``seqs`` sequences of ``seq`` tokens, ``optimizer``, ``steps`` steps;
    eager (``disable_graphs``), then graphed (the counters' window): finite
    losses, the drop fractions of the latency draws, the launches the code
    implies a kept micro-batch (``launches_per_microbatch``), the graphed
    run's losses and final parameters against the eager run's; step walls,
    ms a kept micro-batch, kept tokens/s and the peak beside the reckoning.
    Returns the graphed run's launches."""
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32",
          f"{what}: the training phases want remat, bf16 compute, f32 master weights")
    n, m = TRAIN_WORKERS, mb
    shape = dict(seqs=seqs, seq=seq, mb=mb, steps=steps)
    _, _, tau, masks = train_setup(cfg, seed, **shape)
    want_drops = [1.0 - float(np.float32(k.sum()) / np.float32(k.size)) for k in masks]
    kept = int(sum(k.sum() for k in masks))
    check(0 < kept < n * m * steps and max(want_drops) > 0,
          f"{what}: tau {tau} should drop some micro-batches, not all: {want_drops}")
    meta = init_params(cfg, seed=seed, device="meta")
    names = [k for k, _ in named_leaves(meta)]
    per_mb = launches_per_microbatch(cfg, len(names))
    want = {k: kept * v for k, v in per_mb.items()}
    kept_per_step = [int(k.sum()) for k in masks]
    tokens_mb = seqs * seq
    reck = memory_reckoning(meta, optimizer)
    runs = {}
    for eager in (True, False):
        tag = "eager" if eager else "graphed"
        if not eager:
            ops.reset_launch_counts()  # this training path starts here
        res, params, counts, peak, wall = train_run(cfg, seed, eager, **shape,
                                                    optimizer=optimizer)
        check(all(math.isfinite(x) for x in res.losses),
              f"{what} {tag}: non-finite losses {res.losses}")
        check(res.drop_fractions == want_drops, f"{what} {tag}: drop fractions "
              f"{res.drop_fractions}, the latency draws give {want_drops}")
        check(counts == want, f"{what} {tag} launches {counts}, the code implies {want}")
        step_s = res.metrics["step_s"]
        tok_s = [kps * tokens_mb / st for kps, st in zip(kept_per_step, step_s)]
        mb_ms = [[round(t * 1e3, 2) for t in ts] for ts in res.metrics["microbatch_s"]]
        rest = peak * 2**30 / 1e9 - sum(reck.values())
        log(f"{what} {tag} {cfg.name}: {cfg.n_layers} layers, {n} workers x {m} "
            f"micro-batches of {seqs} x {seq} tokens, {optimizer}, tau {tau:.4f} s, drop "
            f"fractions {res.drop_fractions} (kept {kept_per_step}), losses {res.losses}")
        log(f"{what} {tag}: step wall s {[round(x, 3) for x in step_s]}; per kept "
            f"micro-batch ms {mb_ms}; kept tokens/s {[round(x, 1) for x in tok_s]}; whole call "
            f"{wall:.1f} s")
        log(f"{what} {tag}: peak device memory {peak:.2f} GiB ({peak * 2**30 / 1e9:.2f} GB) "
            f"against the reckoning " + ", ".join(f"{k} {v:.2f}" for k, v in reck.items())
            + f" GB, the rest (activations of one remat group and the layer inputs, gradients, "
            f"CE chunks, workspace) {rest:.2f} GB")
        log(f"{what} {tag} launches over {kept} kept micro-batches: {counts} (per "
            f"micro-batch {per_mb})")
        runs[tag] = (res.losses, [x.cpu() for x in tree_leaves(params)])
        del res, params
        free_device()
    (got, got_p), (want_l, want_p) = runs["graphed"], runs["eager"]
    same = [a == b for a, b in zip(got, want_l)]
    log(f"{what}: graphed vs eager losses {'bit-identical' if all(same) else 'differ'}: "
        f"{got} / {want_l}")
    if not all(same):
        step = same.index(False)
        gap = abs(got[step] - want_l[step]) / abs(want_l[step])
        check(gap < GRAPH_LEAF_GAP, f"{what}: step {step}'s loss differs by {gap}")
    check_gaps(f"{what}: final parameters after {steps} steps", leaf_gaps(names, got_p, want_p))
    return counts


@contextlib.contextmanager
def dcum_row_dropped():
    """A planted K6-backward fault: dcum's row part (dy . y) left out, the
    rest of the kernel's gradients sound."""
    sound = ops.ssd_chunk_bwd  # what ops.SsdChunkFn.backward calls

    def faulty(x, dt, cum, b, c, y, dy):
        dx, ddt, dcum, db, dc = sound(x, dt, cum, b, c, y, dy)
        return dx, ddt, dcum + (dy * y).sum(-1), db, dc

    ops.ssd_chunk_bwd = faulty
    try:
        yield
    finally:
        ops.ssd_chunk_bwd = sound


@contextlib.contextmanager
def bidirectional_made_causal():
    """A planted K3 fault for 'B' layers: every forward and backward launch
    made with the causal flag (and schedule) in place of bidirectional."""
    fwd, bwd = ops.flash_attention_fwd, ops.flash_attention_bwd  # what FlashAttentionFn calls

    def causal_fwd(q, k, v, causal=True, *args):
        return fwd(q, k, v, True, *args)

    def causal_bwd(q, k, v, out, lse, dout, causal=True, *args):
        return bwd(q, k, v, out, lse, dout, True, *args)

    ops.flash_attention_fwd, ops.flash_attention_bwd = causal_fwd, causal_bwd
    try:
        yield
    finally:
        ops.flash_attention_fwd, ops.flash_attention_bwd = fwd, bwd


def mamba_train_parity(seed: int):
    """``train_parity`` of mamba2-130m at 256 tokens with a planted
    K6-backward fault (dcum without its row part)."""
    cfg = get_config("mamba2_130m")
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PARITY_SEQ)))
    train_parity(cfg, seed, tokens, dcum_row_dropped, "mamba train parity",
                 "dcum without its row part", "ssd_chunk_bwd")


def train_parity(cfg, seed: int, tokens, plant, what: str, fault: str, kernel: str,
                 layers: int = PARITY_LAYERS, show: str = None):
    """A ``layers``-layer full-width ``cfg`` on ``tokens``: loss_sum and
    every gradient leaf on the card (kernels, bf16 compute) against the CPU
    (plain versions, f32); each leaf within the larger of
    PARITY_LEAF_REL_TOL and PARITY_CONTROL_FACTOR times the CPU's own bf16
    gap; the card run must go through the backward kernel ``kernel`` once
    a layer that has it; the same metric on the planted fault ``plant`` (a
    context manager; ``fault`` names it) must put some leaf over its limit.
    ``show``: the leaves whose path holds it get a log line of their own."""
    small = dataclasses.replace(cfg, n_layers=layers)
    cpu_cfg = dataclasses.replace(small, dtype="float32")
    params = init_params(cpu_cfg, seed=seed, device="cpu")

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
    _, ctl_g = run(params, small, "cpu")  # the CPU's plain versions in bf16
    control = leaf_errs(ctl_g)
    card_params = tree_map(lambda x: x.to(DEV), params)
    before = ops.launch_counts()
    card_loss, card_g = run(card_params, small, DEV)
    after = ops.launch_counts()
    with plant():
        _, bad_g = run(card_params, small, DEV)
    el = abs(card_loss - cpu_loss) / abs(cpu_loss)
    errs, bad = leaf_errs(card_g), leaf_errs(bad_g)
    limit = {k: max(PARITY_LEAF_REL_TOL, PARITY_CONTROL_FACTOR * control[k]) for k in errs}
    over = {k: e for k, e in errs.items() if e > limit[k]}
    caught = {k: e for k, e in bad.items() if e > limit[k]}
    want_launches = launches_per_microbatch(small, 0)[kernel]
    log(f"{what} {layers} layers ({small.pattern}), tokens {tuple(tokens.shape)}: loss_sum "
        f"card {card_loss:.4f} / cpu {cpu_loss:.4f} (rel {el:.2e}); the CPU f32 pass took "
        f"{t_cpu:.1f} s; launches {kernel} {after[kernel] - before[kernel]}")
    log(f"{what} per-leaf ||g_card - g_cpu|| / ||g_cpu|| (CPU bf16 control; limit): "
        + ", ".join(f"{k} {e:.2e} ({control[k]:.2e}; {limit[k]:.2e})" for k, e in errs.items()))
    if show:
        log(f"{what} {show} leaves (card gap; CPU bf16 gap): " + ", ".join(
            f"{k} {e:.2e} ({control[k]:.2e})" for k, e in errs.items() if show in k))
    log(f"{what} planted fault ({fault}): " + ", ".join(f"{k} {e:.2e}" for k, e in bad.items()))
    check(want_launches > 0 and after[kernel] - before[kernel] == want_launches,
          f"{what}: the card run did not go through {kernel} once a layer that has it "
          f"({want_launches})")
    check(math.isfinite(card_loss) and all(math.isfinite(e) for e in errs.values()),
          f"{what}: non-finite card result")
    check(el <= PARITY_LOSS_REL_TOL, f"{what}: loss_sum relative difference {el}")
    check(not over, f"{what}: leaves over their limits {over}")
    check(bool(caught), f"{what}: the metric lets a planted fault ({fault}) pass: {bad}")


def bert_phase(seed: int, rng):
    """Phase 11, the paper's own models: 11a K3's (64, 1) bidirectional
    build (``k3_bert_checks``, ``k3_bert_timing``); 11b a 2-layer
    bert-1.5b (d 1600) on 2 x 128 tokens, card against CPU
    (``train_parity``, the planted fault ``bidirectional_made_causal``);
    11c bert-1.5b at full width and ``BERT_LAYERS`` layers through the
    trainer at appendix B.1's micro-batch and accumulations with LANS
    (``full_train_phase``);
    11d bert-large at 24 layers with LAMB.  Returns (the K3 errors and
    timings, the graphed runs' launches summed over 11c and 11d)."""
    errs = k3_bert_checks(rng)
    timing = k3_bert_timing(rng)
    free_device()
    cfg = get_config("bert_1_5b")
    tokens = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, (2, BERT_SEQ)))
    train_parity(cfg, seed, tokens, bidirectional_made_causal, "bert parity",
                 "causal in place of bidirectional", "flash_attention_bwd")
    free_device()
    log(f"bert-1.5b: {cfg.param_count() / 1e6:.1f} M parameters (the reference's param_count); "
        f"11c runs {BERT_LAYERS} of its {cfg.n_layers} layers")
    counts = full_train_phase(dataclasses.replace(cfg, n_layers=BERT_LAYERS), seed,
                              "bert-1.5b train", BERT_SEQS, BERT_SEQ, BERT_MB, optimizer="lans")
    free_device()
    large = full_train_phase(get_config("bert_large"), seed, "bert-large train", BERT_SEQS,
                             BERT_SEQ, BERT_LARGE_MB, BERT_LARGE_STEPS, optimizer="lamb")
    free_device()
    return errs, timing, {k: counts[k] + large[k] for k in counts}


# ---------------------------------------------------------------------------
# recurrentgemma-2b serving (phase 12)
# ---------------------------------------------------------------------------


def k2_rg_checks(rng, eps=1e-6, d: int = 2560):
    """12a: K2's forward at recurrentgemma's width (d 2,560: 5,120-byte
    rows, the bulk-copy path in bf16; 17a: mixtral's 6,144 and
    qwen3-moe's 4,096) at the serving steps' row counts (``RG_K2_ROWS``),
    f32 and bf16, both modes, against its plain version (``k2_held``), two
    runs bit-identical, its plan printed; then timed by graph replay with
    L2 flushed, bf16 model mode (the model's call), beside its plain
    version, ``F.rms_norm`` and its bound.  Returns (the largest absolute
    difference, {rows: times})."""
    sms = rmsnorm._sm_count(0)
    s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(DEV)
    max_err, times = 0.0, {}
    for rows in RG_K2_ROWS:
        x32 = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(DEV)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            plan = rmsnorm.fwd_partition(rows, d, x.element_size(), sms)
            for model in (False, True):
                tag = (f"K2 {rows:4d} x {d} ({plan.ctas} CTAs x {plan.rows_per_cta}, stages of "
                       f"{plan.stage_rows}, {plan.slots} slots, {plan.smem} B) "
                       f"{str(dtype)[6:]:8s} {'model' if model else 'f32'}")
                out = rmsnorm.rmsnorm(x, s, eps=eps, model=model)
                max_err = max(max_err, k2_held(out, x, s, eps, model, tag))
                check(torch.equal(out, rmsnorm.rmsnorm(x, s, eps=eps, model=model)),
                      f"{tag}: two runs differ")
        x = x32.to(torch.bfloat16)
        sb = s.to(torch.bfloat16)
        kern = time_ms(lambda: rmsnorm.rmsnorm(x, s, eps=eps, model=True))
        plain = time_ms(lambda: ref.rmsnorm_model(x, s, eps))
        lib = time_ms(lambda: torch.nn.functional.rms_norm(x, (d,), weight=sb, eps=eps))
        b, by = bound_ms(2 * x.numel() * x.element_size() + d * 4, 4.0 * x.numel())
        times[rows] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
        log(f"K2 time rows={rows:4d} d={d}: kernel {kern * 1e3:.2f} us (one replay), plain "
            f"{plain * 1e3:.1f} us, F.rms_norm {lib * 1e3:.2f} us, bound {b * 1e3:.2f} us ({by})")
    return max_err, times


@contextlib.contextmanager
def planted_k4_fault():
    """Route the model's K4 calls through the kernel with the heads of each
    group's last n8 tile zeroed (``without_heads`` from ``padded_heads``:
    8 on at g 9 and 10, 1 on at g 2): what a kernel whose second n8 tile of
    heads read no Q computes, or (g 2) one that read only a group's first
    head."""
    sound = ops.paged_flash_attention  # what models.layers calls

    def faulty(q, k_pool, v_pool, *args, **kw):
        a = without_heads({"q": q, "k_pool": k_pool},
                          padded_heads(q.shape[1] // k_pool.shape[2]))
        return sound(a["q"], k_pool, v_pool, *args, **kw)

    ops.paged_flash_attention = faulty
    try:
        yield
    finally:
        ops.paged_flash_attention = sound


def first_steps(cfg, params, prompts, max_len: int = RG_MAX_LEN, chunk: int = CHUNK):
    """Logits (on the CPU, f32) of the serving run's first dense step (64
    prompt tokens in every slot) and first packed step (64 in each of the
    four oldest slots, the budget's 256; ``chunk``: the tokens a slot
    takes, 64 as the serving run's), each over a fresh paged cache of
    ``max_len`` positions a slot, so that the attention layers attend
    through K4 on the card."""
    dev = params["embed"]["embedding"].device

    def state(grants):
        kv = KVCacheSpec(num_slots=SLOTS, max_len=max_len, layout="paged",
                         page_size=PAGE).build(params, cfg)
        for i, p in enumerate(prompts):
            check(kv.admit_slot(i, p, NEW_TOKENS) == 0, "unexpected prefix sharing")
        kv.prepare_step(grants)
        return kv.state

    grants = [(i, 0, list(p[:chunk])) for i, p in enumerate(prompts)]
    tokens = np.stack([np.asarray(g[2]) for g in grants])
    dense, _ = prefill_chunk(params, cfg, state(grants), tokens, np.zeros(SLOTS, np.int64),
                             np.full(SLOTS, chunk, np.int64))
    grants = grants[:BUDGET // chunk]
    lay = pack_step(grants, BUDGET + 1)
    packed, _ = packed_prefill(params, cfg, state(grants), lay.tokens, lay.slot_ids,
                               lay.positions)
    valid = torch.from_numpy(lay.slot_ids >= 0).to(dev)
    return {"dense": dense.float().cpu(), "packed": packed[valid].float().cpu()}


def logits_parity(small, seed: int, prompts, max_len: int, what: str) -> dict:
    """A few-layer full-width model (``small``): the first dense and packed
    steps' logits (``first_steps``) on the card (kernels, bf16 compute)
    against the CPU (plain versions, f32; the f32 weights drawn on the card
    and copied), by ``row_rel_err`` within ``LOGITS_ROW_TOL``, with the
    launches the code implies (``serve_launches``); then the planted K4
    fault (``planted_k4_fault``), which must fall outside it."""
    cpu_cfg = dataclasses.replace(small, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cpu_cfg, seed=seed, device=DEV)
    card = compute_params(params, small)
    params = tree_map(lambda x: x.cpu(), params)
    want = first_steps(cpu_cfg, params, prompts, max_len)
    t_cpu = time.perf_counter() - t0
    del params

    def errs(got):
        return {k: row_rel_err(got[k], w) for k, w in want.items()}

    before = ops.launch_counts()
    sound = errs(first_steps(small, card, prompts, max_len))
    runs = {k: v - before[k] for k, v in ops.launch_counts().items()}
    check(runs == serve_launches(small, 2), f"{what} parity: launches {runs}")
    with planted_k4_fault():
        bad = errs(first_steps(small, card, prompts, max_len))
    g = small.n_heads // small.n_kv_heads
    log(f"{what} parity {small.n_layers} layers ({small.pattern}, full width): first-step "
        f"logits, row rel err card vs cpu: dense {sound['dense']:.2e}, packed "
        f"{sound['packed']:.2e} (limit {LOGITS_ROW_TOL}); planted K4 fault (heads "
        f"{padded_heads(g)}-{g - 1} of each group given zero queries) dense {bad['dense']:.2e}, "
        f"packed {bad['packed']:.2e}; the CPU pass (weights drawn on the card) took "
        f"{t_cpu:.1f} s")
    check(all(math.isfinite(e) and e <= LOGITS_ROW_TOL for e in sound.values()),
          f"{what} first-step logits differ from the CPU's: {sound}")
    check(min(bad.values()) > LOGITS_ROW_TOL,
          f"the logits metric lets a planted K4 fault pass: {bad}")
    return sound


def rg_requests(cfg, seed: int):
    """The phase's prompt lengths and prompts (its own draws): the long
    request first, then the serving run's 8 lengths of 128-512."""
    rng = np.random.default_rng(seed + 2)
    lens = [RG_LONG] + [int(n) for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS)]
    return lens, [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def rg_engine(cfg, params, prompts, packed: bool) -> ContinuousBatcher:
    """The recurrentgemma serving run's engine with every request submitted."""
    eng = ContinuousBatcher(params, cfg, batch_slots=SLOTS, max_len=RG_MAX_LEN,
                            chunk_size=CHUNK, token_budget=BUDGET, cache="paged",
                            page_size=PAGE, packed=packed)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=NEW_TOKENS))
    return eng


def serve_launches(cfg, steps: int) -> dict:
    """The launches ``steps`` engine steps (or first-step calls) imply: one
    K4 an attention layer ('G' or 'L'), two K2 a layer and the final norm
    with RMSNorm (none with LayerNorm, which is plain); nothing else."""
    want = {k: 0 for k in ops.launch_counts()}
    want["paged_attention"] = sum(k in "GL" for k in cfg.pattern) * steps
    want["rmsnorm"] = (2 * cfg.n_layers + 1) * steps if cfg.norm == "rmsnorm" else 0
    return want


def serve_run(cfg, params, prompts, packed: bool, eager: bool, make):
    """One serving run through the paged engine ``make(cfg, params, prompts,
    packed)`` builds, eager (``disable_graphs``) or graphed, checked: every
    request to full length, no prefix-shared tokens (the prompts are random
    draws), no leaked pages, and the launches the code implies
    (``serve_launches``).  Returns the streams and the run's numbers."""
    free_device()  # the earlier runs' engines: the peak read is this run's
    eng = make(cfg, params, prompts, packed)
    wall, runs, peak = run_engine(eng, eager)
    tag = f"{cfg.name} {'packed' if packed else 'unpacked'} {'eager' if eager else 'graphed'}"
    check(sorted(eng.finished) == list(range(len(prompts))), f"{tag}: unfinished requests")
    for r in eng.finished.values():
        check(len(r.output) == NEW_TOKENS and not r.truncated,
              f"{tag}: request {r.uid} has {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output), f"{tag}: token out of range")
    summary = eng.stats_summary()
    check(summary["shared_tokens"] == 0.0,
          f"{tag}: {summary['shared_tokens']} prefix-shared tokens")
    eng.kv.check_invariants()
    check(eng.kv.used_pages == 0, f"{tag}: {eng.kv.used_pages} pages leaked")
    steps = eng.steps
    want = serve_launches(cfg, steps)
    check(runs == want, f"{tag}: launches {runs} over {steps} steps, the code implies {want}")
    rec = step_record(eng, prompts, wall, peak)
    log(f"serve {tag}: {steps} steps ({rec['mixed_steps']} mixed, "
        f"{steps - rec['mixed_steps']} decode-only), launches/step "
        f"K4={runs['paged_attention'] / steps:.0f} K2={runs['rmsnorm'] / steps:.0f}; median step "
        f"ms: decode-only {rec['decode_ms']:.2f}, mixed {rec['mixed_ms']:.2f}; "
        f"{rec['gen_tok_s']:.1f} generated tok/s, {rec['processed_tok_s']:.1f} processed tok/s "
        f"over {wall:.2f} s; peak device memory {peak:.2f} GiB; peak pages "
        f"{summary['peak_used_pages']:.0f}/{summary['num_pages']:.0f}"
        + ("" if eager else f"; {graph_line(eng)}"))
    return {u: r.output for u, r in eng.finished.items()}, rec


def rg_phase(seed: int):
    """12b and 12c: the 3-layer card-vs-CPU check, then recurrentgemma-2b at
    full width and depth (random weights from ``seed``, f32 master and a
    bf16 compute copy) served unpacked and packed, eager then graphed (the
    counters' window; streams identical)."""
    cfg = get_config("recurrentgemma_2b")
    lens, prompts = rg_requests(cfg, seed)
    small = dataclasses.replace(cfg, n_layers=RG_PARITY_LAYERS)
    check(small.pattern == "RRL", f"12b wants one 'L' layer, got {small.pattern}")
    logits_parity(small, seed, prompts[:SLOTS], RG_MAX_LEN, "12b recurrentgemma")
    free_device()
    t0 = time.perf_counter()
    params = compute_params(init_params(cfg, seed=seed, device=DEV), cfg)
    torch.cuda.synchronize()
    log(f"recurrentgemma-2b: {cfg.n_layers} layers ({cfg.pattern.count('R')} 'R', "
        f"{cfg.pattern.count('L')} 'L'), d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, f32 init + bf16 compute copy in "
        f"{time.perf_counter() - t0:.1f} s; prompt lens {lens} (the first past the "
        f"{cfg.sliding_window}-token window)")
    eager = {p: serve_run(cfg, params, prompts, p, True, rg_engine)[0] for p in (False, True)}
    outs, recs = {}, {}
    ops.reset_launch_counts()  # the main path starts here
    for p in (False, True):
        outs[p], recs[p] = serve_run(cfg, params, prompts, p, False, rg_engine)
    counts = ops.launch_counts()  # ... and ends here
    for p in (False, True):
        same_streams(f"recurrentgemma {'packed' if p else 'unpacked'}", outs[p], eager[p])
    log(f"recurrentgemma packed vs unpacked greedy agreement: {agreement(outs[False], outs[True])}"
        f"/{len(prompts) * NEW_TOKENS}")
    check(counts["paged_attention"] > 0 and counts["rmsnorm"] > 0,
          f"recurrentgemma: kernels not run: {counts}")
    del params
    return counts, recs, outs


# ---------------------------------------------------------------------------
# recurrentgemma-2b training (phase 13)
# ---------------------------------------------------------------------------


def rg_attn_inputs(rng, b: int, s: int):
    """q, k, v, dO as transposed (B, heads, S, 256) views of (B, S, heads,
    256) bf16 storage: recurrentgemma-2b's local attention (10 heads on 1 KV
    head), the layout the model passes."""

    def t(heads):
        x = torch.from_numpy(rng.standard_normal((b, s, heads, RG_D), dtype=np.float32))
        return x.to(DEV, torch.bfloat16).transpose(1, 2)

    return t(RG_H), t(RG_KV), t(RG_KV), t(RG_H)


@contextlib.contextmanager
def planted_plan(edit):
    """Every K3 launch inside made with its schedule (``tile_plan``) edited
    by ``edit(kind, plan, sq)`` in a copy: a fault in the kernel's own walk."""
    sound = flash_attention._plan_tensor  # what the wrappers call

    def faulty(kind, sq, sk, causal, window, device):
        plan = flash_attention.tile_plan(kind, sq, sk, causal, window).copy()
        edit(kind, plan, sq)
        return torch.from_numpy(plan).to(device)

    flash_attention._plan_tensor = faulty
    try:
        yield
    finally:
        flash_attention._plan_tensor = sound


def window_edge_moved(kind, plan, sq):
    """The window's edge one 64-step inward in each CTA it cuts: the first
    key step of a forward or dQ CTA whose walk starts past key 0, the last
    query step of a dK/dV CTA whose walk ends before the last query."""
    if kind == "dkdv":
        plan[plan[:, 2] < sq // flash_attention.STEP, 2] -= 1
    else:
        plan[plan[:, 1] > 0, 1] += 1


def diagonal_skipped(kind, plan, sq):
    """The causal diagonal's step left out of every CTA's walk: the last key
    step (forward, dQ), the first query step (dK/dV)."""
    if kind == "dkdv":
        plan[:, 1] += 1
    else:
        plan[:, 2] -= 1


def k3_rg_checks(rng):
    """13a: K3's (256, 10) build, causal under recurrentgemma's window, at
    ``RG_K3_SHAPES``: forward (out, lse) and backward (dq, dk, dv) against
    the plain versions row by row, two backward runs bit-identical, and
    three planted faults the same metric must reject in each of out, dq,
    dk and dv: ``window=0`` passed for the launches, the window's edge moved
    one step inward in the schedule (``window_edge_moved``), the diagonal
    step skipped (``diagonal_skipped``).  Returns (fwd max|err|, bwd
    max|err|)."""
    fwd_err = bwd_err = 0.0
    for name, (b, s, w) in RG_K3_SHAPES.items():
        q, k, v, do = rg_attn_inputs(rng, b, s)
        kw = dict(causal=True, window=w)
        out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        faults = {"window 0": [flash_attention.flash_attention_fwd(q, k, v, causal=True)[0],
                               *flash_attention.flash_attention_bwd(q, k, v, out, lse, do)]}
        for fault, edit in (("window edge a step inward", window_edge_moved),
                            ("diagonal step skipped", diagonal_skipped)):
            with planted_plan(edit):
                faults[fault] = [flash_attention.flash_attention_fwd(q, k, v, **kw)[0],
                                 *flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)]
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x.float()).all()) for x in (out, lse, *grads)),
              f"K3 rg {name}: non-finite output")
        errs = [row_rel_err(g, x) for g, x in zip((out, *grads), (want, *wants))]
        e_lse = (lse - want_lse).abs().max().item()
        bad = {f: [row_rel_err(g, x) for g, x in zip(got, (want, *wants))]
               for f, got in faults.items()}
        log(f"K3 rg {name} (B {b}, H {RG_H}, KV {RG_KV}, S {s}, D {RG_D}, causal, window {w}): "
            f"row rel err out {errs[0]:.2e} (lse abs {e_lse:.1e}) dq {errs[1]:.2e} dk "
            f"{errs[2]:.2e} dv {errs[3]:.2e}; planted faults (out, dq, dk, dv): "
            + "; ".join(f"{f} {', '.join(f'{x:.2e}' for x in e)}" for f, e in bad.items()))
        check(max(errs) <= K3_ROW_TOL, f"K3 rg {name}: row relative errors {errs}")
        check(e_lse <= K3_LSE_TOL, f"K3 rg {name}: lse off by {e_lse}")
        for f, e in bad.items():
            check(min(e) > K3_ROW_TOL, f"K3 rg {name}: the row metric lets a planted fault "
                  f"({f}) pass: {e}")
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"K3 rg {name}: two backward runs differ (it has no atomics: it must not)")
        fwd_err = max(fwd_err, (out.float() - want.float()).abs().max().item())
        bwd_err = max(bwd_err, max((g.float() - x.float()).abs().max().item()
                                   for g, x in zip(grads, wants)))
        del want, wants, faults
        free_device()
    return fwd_err, bwd_err


def longest_kernel(fn, calls: int = 3, sessions: int = 3) -> str:
    """The name of the longest device kernel ``calls`` calls of ``fn`` run
    (profiler): which backend a library call took.  Late in a long run the
    profiler has returned none of a session's kernel records (phase 13 on
    an H100): a session is made again, up to ``sessions`` times.  The name labels
    a time and checks nothing, so a run whose sessions saw no kernel says
    so in its place."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if evs:
            return max(evs, key=lambda e: e.time_range.end - e.time_range.start).name[:80]
    return f"kernel not seen: the profiler returned no records in {sessions} sessions"


def k3_rg_timing(rng):
    """13a: K3's (256, 10) build at the training shape (1 x 10 heads x
    8,192, window 2,048, causal): one replay and back to back in one graph
    (8 launches over two input sets), the backward also launch by launch
    (profiler); the plain versions; SDPA with the same boolean band mask
    (GQA), forward and its backward alone, with the kernel each ran (the
    library calls); the bounds.  Returns (fwd, bwd) record fields."""
    b, s, w = RG_K3_SHAPES["train"]
    kw = dict(causal=True, window=w)
    q, k, v, do = rg_attn_inputs(rng, b, s)
    out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    fwd = time_ms(lambda: flash_attention.flash_attention_fwd(q, k, v, **kw))
    bwd = time_ms(lambda: flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    sets = [rg_attn_inputs(rng, b, s) for _ in range(2)]
    sets = [(x, y, z, d, *flash_attention.flash_attention_fwd(x, y, z, **kw)) for x, y, z, d in sets]
    fwd_b2b = back_to_back_ms(lambda a: flash_attention.flash_attention_fwd(*a[:3], **kw), sets, 8)
    bwd_b2b = back_to_back_ms(lambda a: flash_attention.flash_attention_bwd(
        a[0], a[1], a[2], a[4], a[5], a[3], **kw), sets, 8)
    del sets
    free_device()
    parts = kernel_split_ms(lambda: flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw),
                            K3_BWD_KERNELS)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    plain_fwd = time_ms_eager(lambda: ref.flash_attention_fwd_ref(q, k, v, **kw), iters=3)
    plain_bwd = time_ms_eager(lambda: ref.flash_attention_bwd_ref(q, k, v, want, want_lse, do, **kw),
                              iters=3)
    del want, want_lse
    free_device()
    band = ref.attention_mask(s, s, True, w, device=DEV)[None]  # (1, 1, S, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=band, enable_gqa=True))
    lib_fwd_kernel = longest_kernel(lambda: sdpa(q, k, v, attn_mask=band, enable_gqa=True))
    leaves = tuple(x.detach().requires_grad_() for x in (q, k, v))

    def lib(a, bb, c):
        return sdpa(a, bb, c, attn_mask=band, enable_gqa=True)

    lib_bwd = grad_only_ms(lib, leaves, do)
    lib_bwd_kernel = longest_kernel(lambda: torch.autograd.grad(lib(*leaves), leaves, do))
    del leaves
    free_device()
    pairs = b * RG_H * int(band.sum().item())  # admissible (query, key) pairs, every head
    io = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # bf16 q, k, v, o
    fb, fby = bound_ms(io + 4 * lse.numel(), 4.0 * RG_D * pairs)
    bb, bby = bound_ms(io + 2 * q.numel() + 4 * lse.numel() + 2 * (q.numel() + 2 * k.numel()),
                       10.0 * RG_D * pairs)
    split = split_text(parts)
    log(f"K3 rg time (B {b}, H {RG_H}, KV {RG_KV}, S {s}, D {RG_D}, window {w}, {pairs} "
        f"admissible pairs): fwd kernel {fwd * 1e3:.1f} us one replay, {fwd_b2b * 1e3:.1f} us "
        f"back to back, plain {plain_fwd * 1e3:.1f} us, SDPA with the band mask "
        f"{lib_fwd * 1e3:.1f} us ({lib_fwd_kernel}), bound {fb * 1e3:.1f} us ({fby}); bwd "
        f"kernels {bwd * 1e3:.1f} us one replay, {bwd_b2b * 1e3:.1f} us back to back (device "
        f"time by launch, profiler: {split}), plain {plain_bwd * 1e3:.1f} us, SDPA bwd alone "
        f"{lib_bwd * 1e3:.1f} us ({lib_bwd_kernel}), bound {bb * 1e3:.1f} us ({bby})")
    return (dict(ms=fwd, plain_ms=plain_fwd, bound_ms=fb, bound_by=fby, library_ms=lib_fwd),
            dict(ms=bwd, plain_ms=plain_bwd, bound_ms=bb, bound_by=bby, library_ms=lib_bwd))


def rg_train_phase(seed: int, rng):
    """Phase 13, training the 'R' family: 13a K3's (256, 10) build
    (``k3_rg_checks``, ``k3_rg_timing``) and K2's backward at
    recurrentgemma's width (8,192 x 2,560); 13b a 3-layer (RRL)
    recurrentgemma-2b on 2 x 256 tokens, card against CPU (``train_parity``,
    the planted fault ``one_head_dkdv``, the RG-LRU leaves printed apart);
    13c recurrentgemma-2b at full width and depth through the trainer
    (``full_train_phase``: one sequence of ``RG_TRAIN_SEQ`` tokens a
    micro-batch).  Returns (the K3 errors and timings, K2's backward's
    error and timing, the graphed run's launches)."""
    errs = k3_rg_checks(rng)
    timing = k3_rg_timing(rng)
    free_device()
    k2b = k2_bwd_checks_and_timing(rng, d=2560, rows=RG_TRAIN_SEQ)
    free_device()
    cfg = get_config("recurrentgemma_2b")
    tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(
        0, cfg.vocab_size, (2, PARITY_SEQ)))
    train_parity(cfg, seed, tokens, one_head_dkdv, "recurrentgemma train parity",
                 "dK/dV from one query head of each group", "flash_attention_bwd",
                 layers=RG_PARITY_LAYERS, show="rglru")
    free_device()
    log(f"recurrentgemma-2b: {cfg.param_count() / 1e6:.1f} M parameters (the reference's "
        f"param_count), {cfg.n_layers} layers ({cfg.pattern.count('R')} 'R', "
        f"{cfg.pattern.count('L')} 'L'); cuts: none (full width and depth, "
        f"{RG_TRAIN_SEQ}-token sequences)")
    counts = full_train_phase(cfg, seed, "recurrentgemma train", 1, RG_TRAIN_SEQ)
    free_device()
    return errs, timing, k2b, counts


# ---------------------------------------------------------------------------
# phase 14: decode_step, stochastic sampling and speculative decoding
# ---------------------------------------------------------------------------


def decode_caches(cfg, params, seqs, layouts, max_len):
    """A decode cache per layout for the teacher-forced sequences ``seqs``
    (one a slot): ``"paged"`` (a ``KVCache`` state, every slot admitted and
    its pages allocated up front), ``"linear"`` (dense slots, full-length
    sliding-window buffers) and ``"ring"`` (dense slots, ``linear=False``: a
    sliding-window layer keeps ``min(window, max_len)`` rows and wraps)."""
    out = {}
    for name in layouts:
        if name == "paged":
            kv = KVCacheSpec(num_slots=len(seqs), max_len=max_len, layout="paged",
                             page_size=PAGE).build(params, cfg)
            for i, s in enumerate(seqs):
                check(kv.admit_slot(i, s[:-1], 1) == 0, "unexpected prefix sharing")
                kv.prepare_write(i, 0, len(s))
            out[name] = kv.state
        else:
            out[name] = init_decode_cache(params, cfg, len(seqs), max_len,
                                          linear=name == "linear")
    return out


def copy_cache(cfg, params, cache, n_slots: int, max_len: int, layout: str):
    """A fresh dense cache of ``layout`` (its pools with their spare rows)
    holding ``cache``'s values: the branch a planted fault runs on."""
    fresh = init_decode_cache(params, cfg, n_slots, max_len, linear=layout == "linear")
    for dst, src in zip(tree_leaves(fresh), tree_leaves(cache)):
        dst.copy_(src)
    return fresh


def teacher_step(seqs, t: int):
    """Step ``t`` of a teacher-forced run: slot i feeds ``seqs[i][p]`` at
    p = min(t, len - 1) (a finished slot feeds its last token again, alike
    in every layout)."""
    lens = np.asarray([len(s) for s in seqs])
    pos = np.minimum(t, lens - 1).astype(np.int64)
    tok = np.asarray([[s[p]] for s, p in zip(seqs, pos)], np.int64)
    return tok, pos


def logits_gap(got, want) -> torch.Tensor:
    """max |got - want| / max |want| as a device scalar (no sync): phase 4's
    paged-against-dense metric."""
    g, w = got.float(), want.float()
    return (g - w).abs().amax() / w.abs().amax()


def row_gap(got, want) -> torch.Tensor:
    """``row_rel_err`` over the vocabulary as a device scalar (no sync)."""
    g, w = got.float(), want.float()
    den = torch.linalg.vector_norm(w, dim=-1)
    return (torch.linalg.vector_norm(g - w, dim=-1)
            / den.clamp(min=2.0 ** -12 * den.amax() + 1e-30)).amax()


def decode_run(cfg, params, seqs, layouts, ref: str, max_len: int, what: str,
               snapshot_at=None):
    """14a for one family: the teacher-forced ``seqs`` through
    ``make_serve_step`` on every layout in lockstep, graphed (the counters'
    window), each step's logits against ``ref``'s (``logits_gap``); first,
    every layout's first DECODE_EAGER_STEPS steps eagerly, on caches of
    their own, held to the graphed steps' logits bit for bit.
    ``snapshot_at``: the dense caches copied just before that step (a
    planted fault's branch).  Returns (gaps by layout, launches, greedy
    agreement with the teacher's generated tokens, the snapshot, ``ref``'s
    eager logits)."""
    eager = {}
    caches = decode_caches(cfg, params, seqs, layouts, max_len)
    with graphs.disable_graphs():
        for name in layouts:
            step = dp_steps.make_serve_step(cfg)
            eager[name] = []
            for t in range(DECODE_EAGER_STEPS):
                step(params, caches[name], *teacher_step(seqs, t))
                eager[name].append(step.logits.clone())
    del caches
    free_device()
    caches = decode_caches(cfg, params, seqs, layouts, max_len)
    steps = {name: dp_steps.make_serve_step(cfg) for name in layouts}
    gaps = {name: [] for name in layouts if name != ref}
    differ = {name: torch.zeros((), dtype=torch.long, device=DEV) for name in layouts}
    agree = torch.zeros((), dtype=torch.long, device=DEV)
    snap = None
    ops.reset_launch_counts()  # the main path starts here
    for t in range(max(map(len, seqs))):
        if t == snapshot_at:
            snap = {name: copy_cache(cfg, params, caches[name], len(seqs), max_len, name)
                    for name in layouts if name != "paged"}
        tok, pos = teacher_step(seqs, t)
        for name in layouts:
            steps[name](params, caches[name], tok, pos)
            if t < DECODE_EAGER_STEPS:
                differ[name] += (steps[name].logits != eager[name][t]).any().long()
        for name in gaps:
            gaps[name].append(logits_gap(steps[name].logits, steps[ref].logits))
        nxt = steps[ref].logits[:, -1].float().argmax(-1).cpu() if any(
            len(s) - NEW_TOKENS - 1 <= t < len(s) - 1 for s in seqs) else None
        if nxt is not None:
            agree += sum(int(nxt[i] == s[t + 1]) for i, s in enumerate(seqs)
                         if len(s) - NEW_TOKENS - 1 <= t < len(s) - 1)
    counts = ops.launch_counts()  # ... and ends here
    for name in layouts:
        check(int(differ[name]) == 0,
              f"14a {what} {name}: {int(differ[name])} of the first {DECODE_EAGER_STEPS} "
              f"graphed steps' logits differ from the eager steps'")
    return ({k: torch.stack(v).cpu() for k, v in gaps.items()}, counts, int(agree), snap,
            eager[ref])


def timed_calls(fn, calls: int = 20) -> float:
    """Device ms of one call of ``fn``, by events around ``calls`` calls
    after one off the clock (host copies and launch gaps included)."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / calls


def decode_ms(cfg, params, seqs, layouts, max_len) -> dict:
    """ms a step at the teacher's last step: ``make_serve_step`` graphed and
    eager on each layout, and the engine's decode step (``prefill_chunk``
    with (B, 1) tokens as one graph, ``ContinuousBatcher``'s decode-only
    program) on the first layout."""
    caches = decode_caches(cfg, params, seqs, layouts, max_len)
    tok, pos = teacher_step(seqs, max(map(len, seqs)) - 1)
    out = {}
    for name in layouts:
        for eager in (False, True):
            step = dp_steps.make_serve_step(cfg)
            with mode(eager):
                out[f"{name} {'eager' if eager else 'graphed'}"] = timed_calls(
                    lambda: step(params, caches[name], tok, pos))
    cache = caches[layouts[0]]
    lens = np.ones(len(seqs), np.int64)
    plans = model_lib.chunk_plans(cfg, cache, pos, lens, 1) or {}
    kinds = sorted(plans)

    def program(tokens, p, n, *pl):
        return prefill_chunk(params, cfg, cache, tokens, p, n,
                             plans=dict(zip(kinds, pl)) if pl else None)[0]

    engine_step = graphs.StepGraph(program, DEV)
    args = (tok, pos, lens, *[plans[k] for k in kinds])
    out[f"engine decode step ({layouts[0]})"] = timed_calls(lambda: engine_step("c1", *args))
    del caches, engine_step
    free_device()
    return out


@contextlib.contextmanager
def kv_written_late():
    """A planted fault: every decode step writes its K/V one row late (at
    position + 1), its queries, masks and tile plans unchanged."""
    sound = layers.step_index

    def faulty(cfg, kind, positions, cache, decode_pos=None, *args, **kw):
        index = sound(cfg, kind, positions, cache, decode_pos, *args, **kw)
        late = sound(cfg, kind, positions + 1, cache, decode_pos + 1, *args, **kw)
        return dataclasses.replace(index, write_at=late.write_at)

    layers.step_index = faulty
    try:
        yield
    finally:
        layers.step_index = sound


@contextlib.contextmanager
def ring_not_shifted():
    """A planted fault: the ring buffer's wrapped rows (those past the
    current slot) keep positions ``pos - slot + k``, not shifted back by
    ``buf_len``: they read as future keys and are masked out."""
    sound = layers._decode_index

    def faulty(cache, window, decode_pos, rope):
        index = sound(cache, window, decode_pos, rope)
        if window <= 0:
            return index
        buf_len = cache["k"].shape[1]
        kpos = torch.arange(buf_len, device=decode_pos.device)
        pos_b = decode_pos.reshape(-1)
        abs_pos = pos_b[:, None] - pos_b[:, None] % buf_len + kpos[None, :]  # no shift back
        valid = ((abs_pos >= torch.clamp(pos_b[:, None] - window + 1, min=0))
                 & (abs_pos <= pos_b[:, None]))
        return dataclasses.replace(index, mask=valid[:, None, None, :])

    layers._decode_index = faulty
    try:
        yield
    finally:
        layers._decode_index = sound


@contextlib.contextmanager
def decay_skipped():
    """A planted fault: the single-token 'M' step leaves the state's decay
    out (state + B dt x for state exp(-dt a) + B dt x)."""
    sound = ssm._apply_decode

    def faulty(xbc, dt, a, w, bconv, cfg, cache):
        return sound(xbc, dt, torch.zeros_like(a), w, bconv, cfg, cache)

    ssm._apply_decode = faulty
    try:
        yield
    finally:
        ssm._apply_decode = sound


def qwen_decode(cfg, params, prompts, streams):
    """14a, qwen2.5-3b at 36 layers: phase 4's requests teacher-forced on its
    graphed unpacked streams through ``make_serve_step``, paged (K4) against
    dense (plain attention) within LOGITS_REL_TOL at every step; the planted
    fault (K/V written one row late, paged, eager) outside it."""
    seqs = [list(p) + list(streams[i]) for i, p in enumerate(prompts)]
    gaps, counts, agree, _, dense_eager = decode_run(cfg, params, seqs, ("dense", "paged"),
                                                     "dense", MAX_LEN, "qwen")
    steps = gaps["paged"].shape[0]
    worst = float(gaps["paged"].max())
    check(math.isfinite(worst) and worst <= LOGITS_REL_TOL,
          f"14a qwen: paged vs dense decode logits gap {worst:.4f} over {LOGITS_REL_TOL}")
    want = {k: 0 for k in counts}
    want.update(paged_attention=cfg.n_layers * steps, rmsnorm=2 * (2 * cfg.n_layers + 1) * steps)
    check(counts == want, f"14a qwen: launches {counts}, the code implies {want}")
    bad_cache = decode_caches(cfg, params, seqs, ("paged",), MAX_LEN)["paged"]
    bad = 0.0
    with graphs.disable_graphs(), kv_written_late():
        for t in range(DECODE_EAGER_STEPS):
            got = model_lib.decode_step(params, cfg, bad_cache, *teacher_step(seqs, t))[0]
            bad = max(bad, float(logits_gap(got, dense_eager[t])))
    del bad_cache, dense_eager
    check(bad > LOGITS_REL_TOL, f"14a qwen: the planted fault (K/V one row late) reads "
                                f"{bad:.4f}, within {LOGITS_REL_TOL}")
    ms = decode_ms(cfg, params, seqs, ("paged", "dense"), MAX_LEN)
    log(f"14a qwen2.5-3b decode_step through make_serve_step, {steps} teacher-forced steps x "
        f"{len(seqs)} slots: paged (K4) vs dense logits gap max {worst:.4f} (limit "
        f"{LOGITS_REL_TOL}); planted fault (K/V one row late, {DECODE_EAGER_STEPS} eager "
        f"steps) {bad:.4f}, rejected; first {DECODE_EAGER_STEPS} steps eager = graphed bit for "
        f"bit; launches {counts} ({counts['paged_attention'] / steps:.0f} K4 and "
        f"{counts['rmsnorm'] / steps / 2:.0f} K2 a step a layout); greedy agreement with phase "
        f"4's streams {agree}/{len(seqs) * NEW_TOKENS}; ms a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return counts, ms


def rg_decode(cfg, params, prompts, streams):
    """14a, recurrentgemma-2b at 26 layers: phase 12c's long request and two
    of its eight, teacher-forced on 12c's graphed unpacked streams, on the
    ring layout (the 'L' buffers of RG_WINDOW rows wrap at RG_WINDOW) and
    the paged one (K4 (256, 10)), each against the linear layout within
    LOGITS_REL_TOL at every step, past the wrap too; the planted fault (the
    wrapped rows' positions not shifted back) branches from a snapshot
    just after the wrap and must fall outside the limit."""
    seqs = [list(prompts[i]) + list(streams[i]) for i in range(3)]
    at = RG_WINDOW + 16
    gaps, counts, agree, snap, _ = decode_run(cfg, params, seqs, ("linear", "ring", "paged"),
                                              "linear", RG_MAX_LEN, "recurrentgemma",
                                              snapshot_at=at)
    steps = gaps["ring"].shape[0]
    worst = {k: float(v.max()) for k, v in gaps.items()}
    after = {k: float(v[RG_WINDOW:].max()) for k, v in gaps.items()}
    check(all(math.isfinite(v) and v <= LOGITS_REL_TOL for v in worst.values()),
          f"14a recurrentgemma: decode logits gaps {worst} over {LOGITS_REL_TOL}")
    want = {k: 0 for k in counts}
    want.update(paged_attention=cfg.pattern.count("L") * steps,
                rmsnorm=3 * (2 * cfg.n_layers + 1) * steps)
    check(counts == want, f"14a recurrentgemma: launches {counts}, the code implies {want}")
    bad = 0.0
    with graphs.disable_graphs():
        for j in range(8):
            tok, pos = teacher_step(seqs, at + j)
            want_l = model_lib.decode_step(params, cfg, snap["linear"], tok, pos)[0]
            with ring_not_shifted():
                got = model_lib.decode_step(params, cfg, snap["ring"], tok, pos)[0]
            bad = max(bad, float(logits_gap(got, want_l)))
    del snap
    free_device()
    check(bad > LOGITS_REL_TOL, f"14a recurrentgemma: the planted fault (ring not shifted) "
                                f"reads {bad:.4f}, within {LOGITS_REL_TOL}")
    ms = decode_ms(cfg, params, seqs, ("paged", "ring"), RG_MAX_LEN)
    log(f"14a recurrentgemma-2b decode_step through make_serve_step, {steps} teacher-forced "
        f"steps x 3 slots (lens {[len(s) for s in seqs]}): logits gap against the linear "
        f"layout max " + ", ".join(f"{k} {v:.4f} ({after[k]:.4f} past the wrap at {RG_WINDOW})"
                                   for k, v in worst.items())
        + f" (limit {LOGITS_REL_TOL}); planted fault (ring not shifted, 8 steps from {at}) "
        f"{bad:.4f}, rejected; launches {counts} ({counts['paged_attention'] / steps:.0f} K4 "
        f"a step on the paged layout); greedy agreement with 12c's streams {agree}/"
        f"{3 * NEW_TOKENS}; ms a step: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return counts, ms


def leaves_gap(got, want) -> torch.Tensor:
    """The largest ||got - want|| / ||want|| over two cache trees' leaves
    (a device scalar, no sync)."""
    return torch.stack([torch.linalg.vector_norm(g.float() - w.float())
                        / torch.linalg.vector_norm(w.float()).clamp(min=1e-30)
                        for g, w in zip(tree_leaves(got), tree_leaves(want))]).amax()


def mamba_free_f32(cfg, seed: int, seqs):
    """14a's free-running check: mamba2-130m with f32 compute copies (its
    f32 master weights from ``seed``), ``decode_step`` through
    ``make_serve_step`` and the engine's step, ``prefill_chunk`` with C = 1
    (K6), each on its own cache for all of ``seqs``'s teacher-forced steps.
    Returns the largest logits ``row_gap`` over the steps, the
    ``leaves_gap`` at the end, and the planted fault's (the state's decay
    skipped over the first DECODE_EAGER_STEPS steps, eager, on a cache of
    its own) largest logits gap and its leaves gap after those steps; then
    the sound logits gap at the first step and the largest over the last
    DECODE_EAGER_STEPS steps (a gap that builds up shows as a tail above
    the start)."""
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = compute_params(init_params(c32, seed=seed, device=DEV), c32)
    n, t_total = len(seqs), max(map(len, seqs))
    lens = np.ones(n, np.int64)
    dec, ref, bad = (init_decode_cache(params, c32, n, MAX_LEN, linear=True) for _ in range(3))
    step = dp_steps.make_serve_step(c32)
    chunk = graphs.StepGraph(
        lambda tok, pos, ln: prefill_chunk(params, c32, ref, tok, pos, ln)[0], DEV)
    errs, bad_rows = [], []
    for t in range(t_total):
        tok, pos = teacher_step(seqs, t)
        step(params, dec, tok, pos)
        want = chunk("c1", tok, pos, lens)[:, 0]
        errs.append(row_gap(step.logits[:, 0], want))
        if t < DECODE_EAGER_STEPS:
            with graphs.disable_graphs(), decay_skipped():
                out = model_lib.decode_step(params, c32, bad, tok, pos)[0][:, 0]
            bad_rows.append(row_gap(out, want))
            if t == DECODE_EAGER_STEPS - 1:
                bad_leaf = leaves_gap(bad, ref)
    got = (float(torch.stack(errs).max()), float(leaves_gap(dec, ref)),
           float(torch.stack(bad_rows).max()), float(bad_leaf), float(errs[0]),
           float(torch.stack(errs[-DECODE_EAGER_STEPS:]).max()))
    del params, dec, ref, bad, step, chunk
    free_device()
    return got


def mamba_decode(cfg, params, prompts, streams, seed: int):
    """14a, mamba2-130m at 24 layers: ``decode_step`` (the reference's
    single-token recurrence, no SSD kernel) teacher-forced on phase 5's
    graphed dense unpacked streams through ``make_serve_step`` (the
    counters' window), then held against the engine's step,
    ``prefill_chunk`` with C = 1 (K6), two ways.  In bf16 compute, step by
    step from the engine's own carried state (before each step the engine's
    cache is copied into the decode cache): the step's logits (``row_gap``)
    within MAMBA_LOGITS_ROW_TOL, every cache leaf after it (``leaves_gap``)
    within MAMBA_DECODE_LEAF_TOL.  In f32 compute, each path on its own
    state for the whole run (``mamba_free_f32``): logits and final leaves
    within MAMBA_F32_DECODE_TOL, so that an error which builds up in the
    state shows.  The planted fault (the state's decay skipped) must fall
    outside every limit.  Run free in bf16, the two paths drift apart
    through 24 layers of random weights (printed, not held)."""
    seqs = [list(p) + list(streams[i]) for i, p in enumerate(prompts)]
    n, t_total = len(seqs), max(map(len, seqs))
    lens = np.ones(n, np.int64)
    free_cache = init_decode_cache(params, cfg, n, MAX_LEN, linear=True)
    step = dp_steps.make_serve_step(cfg)
    free = []
    ops.reset_launch_counts()  # the main path starts here
    for t in range(t_total):
        step(params, free_cache, *teacher_step(seqs, t))
        free.append(step.logits[:, 0].clone())
    counts = ops.launch_counts()  # ... and ends here
    want = {k: 0 for k in counts}
    want["rmsnorm"] = (cfg.n_layers + 1) * t_total
    check(counts == want, f"14a mamba: launches {counts}, the code implies {want}")
    check(all(bool(torch.isfinite(x).all()) for x in free[::64]), "14a mamba: non-finite logits")
    ref, shared, bad = (init_decode_cache(params, cfg, n, MAX_LEN, linear=True) for _ in range(3))
    chunk = graphs.StepGraph(
        lambda tok, pos, ln: prefill_chunk(params, cfg, ref, tok, pos, ln)[0], DEV)
    errs, leaf_errs, drift, bad_rows, bad_leaves = [], [], [], [], []
    for t in range(t_total):
        tok, pos = teacher_step(seqs, t)
        for dst, src in zip(tree_leaves(shared) + (tree_leaves(bad) if t < DECODE_EAGER_STEPS
                                                    else []),
                            tree_leaves(ref) * (2 if t < DECODE_EAGER_STEPS else 1)):
            dst.copy_(src)
        step(params, shared, tok, pos)
        if t < DECODE_EAGER_STEPS:
            with graphs.disable_graphs(), decay_skipped():
                out = model_lib.decode_step(params, cfg, bad, tok, pos)[0][:, 0]
        want_t = chunk("c1", tok, pos, lens)[:, 0]
        errs.append(row_gap(step.logits[:, 0], want_t))
        leaf_errs.append(leaves_gap(shared, ref))
        drift.append(row_gap(free[t], want_t))
        if t < DECODE_EAGER_STEPS:
            bad_rows.append(row_gap(out, want_t))
            bad_leaves.append(leaves_gap(bad, ref))
    worst, worst_leaf = float(torch.stack(errs).max()), float(torch.stack(leaf_errs).max())
    bad_row, bad_leaf = float(torch.stack(bad_rows).max()), float(torch.stack(bad_leaves).max())
    drift = float(torch.stack(drift).max())
    del free, ref, shared, bad, chunk, free_cache
    free_device()
    f32_row, f32_leaf, f32_bad_row, f32_bad_leaf, f32_first, f32_tail = mamba_free_f32(
        cfg, seed, seqs)
    check(worst <= MAMBA_LOGITS_ROW_TOL and worst_leaf <= MAMBA_DECODE_LEAF_TOL,
          f"14a mamba: decode_step vs the C = 1 step from the same state, logits row rel err "
          f"{worst:.3e} (limit {MAMBA_LOGITS_ROW_TOL}), cache leaves {worst_leaf:.3e} (limit "
          f"{MAMBA_DECODE_LEAF_TOL})")
    check(bad_row > MAMBA_LOGITS_ROW_TOL and bad_leaf > MAMBA_DECODE_LEAF_TOL,
          f"14a mamba: the planted fault (decay skipped) reads logits {bad_row:.3e}, leaves "
          f"{bad_leaf:.3e}, within a limit")
    check(f32_row <= MAMBA_F32_DECODE_TOL and f32_leaf <= MAMBA_F32_DECODE_TOL,
          f"14a mamba: decode_step vs the C = 1 step run free in f32, logits row rel err "
          f"{f32_row:.3e}, final cache leaves {f32_leaf:.3e}, over {MAMBA_F32_DECODE_TOL}")
    check(min(f32_bad_row, f32_bad_leaf) > MAMBA_F32_DECODE_TOL,
          f"14a mamba: the planted fault (decay skipped) run free in f32 reads logits "
          f"{f32_bad_row:.3e}, leaves {f32_bad_leaf:.3e}, within {MAMBA_F32_DECODE_TOL}")
    ms = decode_ms(cfg, params, seqs, ("linear",), MAX_LEN)
    log(f"14a mamba2-130m decode_step through make_serve_step, {t_total} teacher-forced steps x "
        f"{n} slots, graphed; against the engine's C = 1 step (K6) from the same state each "
        f"step (bf16): logits row rel err max {worst:.3e} (limit {MAMBA_LOGITS_ROW_TOL}), cache "
        f"leaves max {worst_leaf:.3e} (limit {MAMBA_DECODE_LEAF_TOL}); planted fault (decay "
        f"skipped, {DECODE_EAGER_STEPS} eager steps) logits {bad_row:.3e}, leaves "
        f"{bad_leaf:.3e}, rejected; each path run free on its own state in f32 compute: logits "
        f"row rel err max {f32_row:.3e} (first step {f32_first:.3e}, last "
        f"{DECODE_EAGER_STEPS} steps {f32_tail:.3e}), final cache leaves {f32_leaf:.3e} (limit "
        f"{MAMBA_F32_DECODE_TOL}), planted fault logits {f32_bad_row:.3e}, leaves "
        f"{f32_bad_leaf:.3e}, rejected; run free in bf16 the logits drift to {drift:.3e} "
        f"(not held); launches {counts}; ms a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return counts, ms


# --- 14b: the sampler alone ---


def sampler_rows(combos, seed: int, oidx_max: int = 2 ** 20):
    """Per-row host arrays of one 8-row sampler step: row r takes
    ``combos[r % len(combos)]`` (temperature, top-k, top-p); row 3 greedy;
    seeds 0, 2^32 - 1 and others from ``seed``; output indices up to
    ``oidx_max``."""
    rows = SAMPLER_ROWS
    seeds = np.asarray([0, 2 ** 32 - 1, seed, 7, 12345, 2 ** 31, 99 + seed, 3], np.int64)[:rows]
    oidx = np.asarray([0, 1, oidx_max, 5, 31, 1000, oidx_max // 2, 17], np.int64)[:rows]
    t = np.asarray([combos[r % len(combos)][0] for r in range(rows)], np.float32)
    k = np.asarray([combos[r % len(combos)][1] for r in range(rows)], np.int64)
    p = np.asarray([combos[r % len(combos)][2] for r in range(rows)], np.float32)
    t[3] = 0.0
    return seeds, oidx, t, k, p


def sampler_phase(rng, seed: int):
    """14b: the sampler on f32 logits from ``rng`` at 8 x V for qwen's and
    recurrentgemma's vocabularies: the card's 32-bit words equal the CPU
    port's bit for bit (the CPU tests hold those to ``jax.random``), the
    Gumbel draws within GUMBEL_TOL, and every step's tokens (temperatures
    {0, 0.7, 1.3} x top-k {0, 1, 50} x top-p {1, 0.9, 1e-6}, spread over
    the rows of four steps, an untruncated step and an all-greedy one)
    equal to the CPU port's; then graph replays of an all-greedy, an
    untruncated and a top-k + top-p step at 8 x 151,936, beside argmax
    alone."""
    combos = [(t, k, p) for t in (0.7, 1.3) for k in (0, 1, 50) for p in (1.0, 0.9, 1e-6)]
    steps = [combos[i:i + SAMPLER_ROWS] for i in range(0, len(combos), SAMPLER_ROWS)]
    steps += [[(0.9, 0, 1.0)], [(0.0, 0, 1.0)]]
    ms = {}
    for v in SAMPLER_VOCABS:
        lg = torch.from_numpy(rng.normal(size=(SAMPLER_ROWS, v)).astype(np.float32) * 3)
        card = lg.to(DEV)
        seeds, oidx = sampler_rows(steps[0], seed)[:2]
        keys = [sampling.fold_in(sampling.prng_key(torch.from_numpy(seeds).to(d)),
                                 torch.from_numpy(oidx).to(d)) for d in (DEV, "cpu")]
        words = [sampling.random_bits(k, v) for k in keys]
        check(torch.equal(words[0].cpu(), words[1]),
              f"14b V {v}: the card's PRNG words differ from the CPU port's")
        g_card, g_cpu = (sampling.gumbel_from_bits(w).cpu() for w in words)
        gap = (g_card - g_cpu).abs()
        within = bool((gap <= GUMBEL_TOL[0] + GUMBEL_TOL[1] * g_cpu.abs()).all())
        check(within, f"14b V {v}: Gumbel draws card vs CPU up to {float(gap.max()):.3e}")
        differ = []
        for combo in steps:
            rows = sampler_rows(combo, seed)
            mode_ = sampling.sample_mode(*rows[2:])
            got = sampling.sample_rows(card, *sampling.sampler_inputs(*rows, device=DEV),
                                       mode_).cpu()
            want = sampling.sample_rows(lg, *sampling.sampler_inputs(*rows), mode_)
            for r in np.flatnonzero((got != want).numpy()):
                top2 = torch.topk(lg[r] / max(float(rows[2][r]), 1e-30) + g_cpu[r], 2).values
                differ.append(f"row {r} {combo[r % len(combo)]}: card {int(got[r])} cpu "
                              f"{int(want[r])}, score gap {float(top2[0] - top2[1]):.3e}")
        ratio = float((gap / (GUMBEL_TOL[0] + GUMBEL_TOL[1] * g_cpu.abs())).max())
        log(f"14b sampler V {v}: words equal ({SAMPLER_ROWS} x {v}), Gumbel card vs CPU max gap "
            f"{float(gap.max()):.3e}, at most {ratio:.3f} of its limit (atol, rtol "
            f"{GUMBEL_TOL}); tokens of {len(steps)} steps x "
            f"{SAMPLER_ROWS} rows equal" + (f" except {differ}" if differ else ""))
        check(not differ, f"14b V {v}: tokens differ from the CPU port's: {differ}")
        if v == SAMPLER_VOCABS[0]:
            for name, combo in (("all greedy", [(0.0, 0, 1.0)]), ("untruncated", [(0.9, 0, 1.0)]),
                                ("top-k + top-p", [(0.8, 50, 0.95)])):
                rows = sampler_rows(combo, seed)
                rows[2][:] = combo[0][0]
                inputs = sampling.sampler_inputs(*rows, device=DEV)
                mode_ = sampling.sample_mode(*rows[2:])
                ms[name] = time_ms(lambda: sampling.sample_rows(card, *inputs, mode_))
            ms["argmax alone"] = time_ms(lambda: card.argmax(-1))
    log(f"14b sampler at {SAMPLER_ROWS} x {SAMPLER_VOCABS[0]}, device ms a step by graph replay "
        f"(L2 flushed): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return ms


# --- 14c / 14d: sampled and speculative serving ---


def sampled_params(i: int, seed: int, sampled: bool = True):
    """Request i's sampling params in 14c and 14d: requests 2 and 5 greedy,
    the other six at temperature 0.8, top-p 0.95 (top-k 50 on 0, 3, 6),
    seeds from ``seed``."""
    if not sampled or i in (2, 5):
        return SamplingParams()
    return SamplingParams(temperature=0.8, top_p=0.95, top_k=50 if i % 3 == 0 else 0,
                          seed=seed * 1000 + i)


class _Rejected(Exception):
    """The replay check found a step's tokens wrong: a planted fault's run
    stops there."""


class ReplayCheck:
    """The structural check of 14c and 14d, on an eager engine: after every
    step, each slot that took tokens is replayed from the step's own logits
    rows (those the step sampled, ``ContinuousBatcher._picks``;
    ``sampling.sample_one`` for the request's params and each column's true
    output index; the verify columns through the sound
    ``spec.accept_sampled`` with the granted drafts) and must emit what the
    engine emitted.  ``fault``: ``"step_counter"`` (the sampler folds the
    engine's step counter in place of each row's output index) or
    ``"accept_past"`` (one draft accepted past the first mismatch), planted
    in the engine's own path; the check then stops the run at its first
    rejection (``_Rejected``)."""

    def __init__(self, eng, fault=None):
        self.eng, self.fault = eng, fault
        self.replayed = 0
        self.acted = 0  # steps or acceptances the planted fault changed
        self.rejected = None

    @contextlib.contextmanager
    def installed(self):
        eng, rec = self.eng, {}
        sound_rows, sound_accept = scheduler.sample_rows, scheduler.accept_sampled
        sound_step, sound_propose, sound_schedule = eng.step, eng._propose, eng._schedule
        sound_picks = eng._picks

        def rows(logits, seeds, out_idx, *rest):
            rec["logits"] = logits
            if self.fault == "step_counter" and out_idx is not None:
                out_idx = torch.full_like(torch.as_tensor(out_idx, device=logits.device),
                                          eng.steps)
                self.acted += 1
            return sound_rows(logits, seeds, out_idx, *rest)

        def picks(*args):
            out = sound_picks(*args)
            rec["at"] = out[1]  # slot -> [(column, row of the sampled rows)]
            return out

        def accept(draft, sampled):
            a, emitted = sound_accept(draft, sampled)
            if self.fault == "accept_past" and a < len(draft):
                self.acted += 1
                a += 1
                emitted = [int(t) for t in draft[:a]] + [int(sampled[a])]
            return a, emitted

        def propose():
            rec["drafts"] = sound_propose()
            return rec["drafts"]

        def schedule(drafts):
            rec["n"] = sound_schedule(drafts)
            return rec["n"]

        def step():
            rec.clear()
            before = {i: (s.req, s.pos, len(s.req.output), s.prefilling)
                      for i, s in enumerate(eng.slots) if not s.free}
            sound_step()
            self.check(rec, before)

        scheduler.sample_rows, scheduler.accept_sampled = rows, accept
        eng.step, eng._propose, eng._schedule, eng._picks = step, propose, schedule, picks
        try:
            yield self
        finally:
            scheduler.sample_rows, scheduler.accept_sampled = sound_rows, sound_accept
            del eng.step, eng._propose, eng._schedule, eng._picks

    def check(self, rec, before):
        logits, n, drafts = rec["logits"], rec["n"], rec.get("drafts", {})
        for i, (r, pos0, out0, prefilling) in before.items():
            if n[i] == 0:
                continue
            emitted = r.output[out0:]
            base = pos0 + 1 - len(r.prompt)  # the output index of column 0's prediction
            row_of = dict(rec["at"][i])  # the step's logits rows it sampled, by column

            def replay(j):
                self.replayed += 1
                return sampling.sample_one(logits[row_of[j]], r.sampling, base + j)

            if prefilling:
                want = [replay(n[i] - 1)] if pos0 + n[i] >= len(r.prompt) else []
            else:
                draft = list(drafts.get(i, []))[: n[i] - 1]
                want = spec_lib.accept_sampled(draft, [replay(j) for j in range(n[i])])[1]
                want = want[: r.max_new_tokens - out0]
            if emitted != want:
                self.rejected = (f"step {self.eng.steps - 1}, request {r.uid}: emitted "
                                 f"{emitted}, the replay {want}")
                if self.fault is not None:
                    raise _Rejected(self.rejected)
                raise SmokeFailure(f"replay check: {self.rejected}")


class JunkProposer(spec_lib.Proposer):
    """Drafts that are almost never the target's tokens (a function of the
    history's length): the planted acceptance fault's proposer."""

    name = "junk"

    def __init__(self, vocab: int):
        self.vocab = vocab

    def propose_batch(self, asks):
        return {s: [(7919 * len(h) + j) % self.vocab for j in range(k)] for s, h, k in asks}


def spec_engine(cfg, params, prompts, packed: bool, sampled: bool, seed: int, spec=None):
    eng = ContinuousBatcher(params, cfg, batch_slots=SLOTS, max_len=MAX_LEN, chunk_size=CHUNK,
                            token_budget=BUDGET, cache="paged", page_size=PAGE, packed=packed,
                            spec=spec)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=NEW_TOKENS,
                           sampling=sampled_params(i, seed, sampled)))
    return eng


def sampled_serve(cfg, params, prompts, packed: bool, sampled: bool, seed: int, eager=False,
                  spec=None, fault=None, tag=""):
    """One 14c / 14d serving run of qwen2.5-3b (paged), checked: full-length
    streams, no leaked page, the allocator's invariants, one K4 a layer and
    73 K2 a step (plus 73 a draft-model step); eager runs under the replay
    check (``ReplayCheck``).  Returns (streams, launches, record, summary,
    replays checked); a planted fault's run returns its rejection."""
    eng = spec_engine(cfg, params, prompts, packed, sampled, seed, spec() if spec else None)
    checker = ReplayCheck(eng, fault) if eager else None
    with (checker.installed() if checker else contextlib.nullcontext()):
        try:
            wall, runs, peak = run_engine(eng, eager)
        except _Rejected as e:
            return str(e)
    if fault is not None:
        check(checker.acted > 0, f"{tag}: the planted fault never acted")
        return None
    check(sorted(eng.finished) == list(range(SLOTS)), f"{tag}: unfinished requests")
    for r in eng.finished.values():
        check(len(r.output) == NEW_TOKENS and not r.truncated,
              f"{tag}: request {r.uid} has {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output), f"{tag}: token out of range")
    eng.kv.check_invariants()
    check(eng.kv.used_pages == 0, f"{tag}: {eng.kv.used_pages} pages leaked")
    draft_steps = getattr(eng.spec.proposer, "steps", 0) if eng.spec else 0
    want = {k: 0 for k in runs}
    want["paged_attention"] = cfg.n_layers * eng.steps
    want["rmsnorm"] = (2 * cfg.n_layers + 1) * (eng.steps + draft_steps)
    check(runs == want, f"{tag}: launches {runs} over {eng.steps} steps ({draft_steps} draft "
                        f"steps), the code implies {want}")
    rec = step_record(eng, prompts, wall, peak)
    summary = eng.stats_summary()
    verify = [st for st in eng.step_stats if st.draft_tokens > 0 and st.prefill_tokens == 0]
    rec["verify_ms"] = statistics.median(st.wall_time * 1e3 for st in verify) if verify else None
    # per verify step (all its slots) and per verify grant (a decode slot's)
    rec["accepted_per_verify"] = (sum(st.accepted_tokens for st in verify) / len(verify)
                                  if verify else None)
    rec["accepted_per_grant"] = (sum(st.accepted_tokens for st in verify)
                                 / sum(st.decode_tokens for st in verify) if verify else None)
    rec["tokens_per_step"] = summary["generated_tokens"] / eng.steps
    # the run's wall less the host seconds its graphs' warm-ups and captures
    # took (each engine captures its own): the rate of a warm engine
    graphs_of = [eng.step_graph] + ([eng.spec.proposer.step_graph]
                                    if eng.spec and hasattr(eng.spec.proposer, "step_graph")
                                    else [])
    capture_s = sum(t for g in graphs_of for t, _ in g.stats().values())
    rec["warm_tok_s"] = summary["generated_tokens"] / (wall - capture_s)
    log(f"{tag}: {eng.steps} steps, launches {runs}; "
        + (f"drafts {summary['draft_tokens']:.0f}, accepted {summary['accepted_tokens']:.0f} "
           f"({summary['acceptance_rate']:.3f}), {rec['accepted_per_verify']:.2f} accepted a "
           f"verify step ({rec['accepted_per_grant']:.2f} a slot's grant), median verify step "
           f"{rec['verify_ms']:.2f} ms, "
           if verify else "")
        + f"{rec['tokens_per_step']:.2f} tokens a step, {rec['gen_tok_s']:.1f} generated tok/s "
        f"over {wall:.2f} s ({rec['warm_tok_s']:.1f} with the captures left out); peak "
        f"{peak:.2f} GiB"
        + (f"; {checker.replayed} columns replayed" if checker else f"; {graph_line(eng)}"))
    out = ({u: r.output for u, r in eng.finished.items()}, runs, rec, summary,
           checker.replayed if checker else 0)
    del eng
    free_device()  # the engine's graphs (a reference cycle) and their pool
    return out


def sampled_phase(cfg, params, prompts, seed: int, greedy_streams):
    """14c: sampled serving (six sampled requests, two greedy), unpacked
    then packed: eager under the replay check, then graphed twice (the
    counters' window): graphed = eager, the second graphed run = the first,
    the greedy rows = phase 4's streams in the same layout; then the planted
    fault (the step counter folded in place of the output index), which the
    replay check must reject."""
    outs, recs, counts = {}, {}, {k: 0 for k in ops.launch_counts()}
    for packed in (False, True):
        tag = f"14c sampled {'packed' if packed else 'unpacked'}"
        eager = sampled_serve(cfg, params, prompts, packed, True, seed, eager=True,
                              tag=f"{tag} eager")[0]
        ops.reset_launch_counts()  # the main path starts here
        g1 = sampled_serve(cfg, params, prompts, packed, True, seed, tag=f"{tag} graphed")
        g2 = sampled_serve(cfg, params, prompts, packed, True, seed, tag=f"{tag} graphed again")
        for k, v in ops.launch_counts().items():  # ... and ends here
            counts[k] += v
        same_streams(tag, g1[0], eager)
        check(g2[0] == g1[0], f"{tag}: a second graphed run gave other streams")
        for i in [i for i in (2, 5) if i in g1[0]]:
            check(g1[0][i] == greedy_streams[packed][i],
                  f"{tag}: greedy request {i} differs from phase 4's stream")
        outs[packed], recs[packed] = g1[0], g1[2]
    why = sampled_serve(cfg, params, prompts, False, True, seed, eager=True, fault="step_counter",
                        tag="14c planted fault")
    check(why is not None, "14c: the replay check lets the step counter in place of the output "
                           "index pass")
    log(f"14c planted fault (the step counter folded in place of the output index): rejected, "
        f"{why}")
    diff = [i for i in range(SLOTS) if outs[False][i] != greedy_streams[False][i]]
    log(f"14c sampled packed vs unpacked agreement {agreement(outs[False], outs[True])}/"
        f"{SLOTS * NEW_TOKENS}; sampled requests whose streams differ from the greedy run: {diff}")
    return counts, outs, recs


def spec_phase(cfg, params, prompts, seed: int, greedy_streams, sampled_streams, sampled_recs):
    """14d: speculation on the paged unpacked engine, ``NGramProposer`` and
    ``DraftModelProposer`` with the target's own parameters (k = 4), greedy
    then with 14c's sampling: eager under the replay check (every emitted
    token what ``accept_sampled`` gives on the verify step's own columns),
    then graphed (the counters' window), graphed = eager, no leaked page,
    36 K4 a step; then the planted fault (a draft accepted past the first
    mismatch), which the replay check must reject."""
    proposers = {"ngram": lambda: SpecConfig(NGramProposer(), k=SPEC_K),
                 "self-draft": lambda: SpecConfig(DraftModelProposer(params, cfg, SLOTS, MAX_LEN),
                                                  k=SPEC_K)}
    counts = {k: 0 for k in ops.launch_counts()}
    readings = {}
    # the greedy baseline without speculation, on the same engine (14c's
    # sampled runs are the sampled one)
    greedy_rec = sampled_serve(cfg, params, prompts, False, False, seed,
                               tag="14d greedy without speculation, graphed")[2]
    for name, spec in proposers.items():
        for sampled in (False, True):
            tag = f"14d {name} {'sampled' if sampled else 'greedy'}"
            eager = sampled_serve(cfg, params, prompts, False, sampled, seed, eager=True,
                                  spec=spec, tag=f"{tag} eager")[0]
            ops.reset_launch_counts()  # the main path starts here
            got, runs, rec, summary, _ = sampled_serve(cfg, params, prompts, False, sampled, seed,
                                                       spec=spec, tag=f"{tag} graphed")
            for k, v in ops.launch_counts().items():  # ... and ends here
                counts[k] += v
            same_streams(tag, got, eager)
            plain = sampled_streams if sampled else greedy_streams
            base = sampled_recs if sampled else greedy_rec
            readings[tag] = rec
            log(f"{tag}: agreement with the streams without speculation "
                f"{agreement(got, plain)}/{SLOTS * NEW_TOKENS}; generated tok/s with the "
                f"captures left out {rec['warm_tok_s']:.1f} against {base['warm_tok_s']:.1f} "
                f"without, {rec['tokens_per_step']:.2f} tokens a step against "
                f"{base['tokens_per_step']:.2f}")
    # planted on a run whose drafts are junk, so that mismatches (where the
    # fault acts) come at once
    why = sampled_serve(cfg, params, prompts, False, False, seed, eager=True,
                        spec=lambda: SpecConfig(JunkProposer(cfg.vocab_size), k=SPEC_K),
                        fault="accept_past", tag="14d planted fault")
    check(why is not None, "14d: the replay check lets a draft accepted past the first mismatch "
                           "pass")
    log(f"14d planted fault (a draft accepted past the first mismatch): rejected, {why}")
    return counts, readings


def phase14(seed: int, rng, prompts, qwen_streams, rg_streams, mamba_streams):
    """Phase 14: 14a ``decode_step`` at full width for qwen2.5-3b, then 14b
    the sampler alone, 14c sampled serving and 14d speculation on qwen;
    then 14a for recurrentgemma-2b and mamba2-130m.  Returns the launches of
    each main path (qwen's, recurrentgemma's, mamba's) and the readings."""
    cfg = get_config("qwen2_5_3b")
    params = compute_params(init_params(cfg, seed=seed, device=DEV), cfg)
    qwen_counts, qwen_ms = qwen_decode(cfg, params, prompts, qwen_streams[False])
    free_device()
    sampler_ms = sampler_phase(rng, seed)
    free_device()
    c_counts, sampled_streams, sampled_recs = sampled_phase(cfg, params, prompts, seed,
                                                            qwen_streams)
    free_device()
    d_counts, spec_readings = spec_phase(cfg, params, prompts, seed, qwen_streams[False],
                                         sampled_streams[False], sampled_recs[False])
    del params
    free_device()
    rcfg = get_config("recurrentgemma_2b")
    _, rprompts = rg_requests(rcfg, seed)
    params = compute_params(init_params(rcfg, seed=seed, device=DEV), rcfg)
    rg_counts, rg_ms = rg_decode(rcfg, params, rprompts, rg_streams)
    del params
    free_device()
    mcfg = get_config("mamba2_130m")
    _, mprompts = mamba_requests(mcfg, seed)
    params = compute_params(init_params(mcfg, seed=seed, device=DEV), mcfg)
    m_counts, m_ms = mamba_decode(mcfg, params, mprompts, mamba_streams, seed)
    del params
    free_device()
    qwen_total = {k: qwen_counts[k] + c_counts[k] + d_counts[k] for k in qwen_counts}
    log(f"launches, phase 14: qwen decode_step (14a) {qwen_counts}; sampled serving (14c) "
        f"{c_counts}; speculation (14d) {d_counts}; recurrentgemma decode_step (14a) "
        f"{rg_counts}; mamba decode_step (14a) {m_counts}")
    return qwen_total, rg_counts, m_counts


# ---------------------------------------------------------------------------
# the dense zoo (phase 15): internlm2-1.8b, starcoder2-7b, gemma3-27b
# ---------------------------------------------------------------------------


def zoo_config(name: str):
    """The served config at full width and depth, with bf16 parameters as
    the HTTP example serves it (gemma3-27b's f32 masters, 100.6 GiB, would
    not fit the card; the init draws in f32 and casts, so bf16 leaves are
    the values a compute copy of f32 masters would hold)."""
    return dataclasses.replace(get_config(name), param_dtype="bfloat16")


def long_prompt(cfg) -> int:
    """The long request's length for a zoo or MoE model with a sliding
    window: past its window (``ZOO_LONG``, ``MOE_LONG``)."""
    return MOE_LONG if cfg.n_experts else ZOO_LONG


def zoo_requests(cfg, seed: int, index: int):
    """A zoo (or, from index ``len(ZOO)`` on, an MoE) model's prompt
    lengths and prompts (its own draws): with a sliding window, the long
    request first (past the window), then the serving run's 8 lengths of
    128-512."""
    rng = np.random.default_rng(seed + 15 + index)
    lens = ([long_prompt(cfg)] if "L" in cfg.pattern else []) + [
        int(n) for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS)]
    return lens, [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def zoo_max_len(cfg) -> int:
    return (long_prompt(cfg) if "L" in cfg.pattern else PROMPT_MAX) + NEW_TOKENS


def zoo_dims(cfg):
    """``paged_scenario``'s dims at a zoo model's widths and slot length."""
    return cfg.n_heads, cfg.n_kv_heads, cfg.hd, -(-zoo_max_len(cfg) // PAGE)


def window_edge_check(cfg, params, prompt, max_len: int) -> None:
    """A prompt past the sliding window, prefilled chunk by chunk in one
    slot through the paged cache (K4) and the dense cache (plain
    attention): every chunk's logits within phase 4's ``LOGITS_REL_TOL``
    of the largest logit (the worst past the window's edge printed); an MoE
    model's paged steps take the dense steps' routes, as in
    ``first_step_logits_check``."""
    kvs = {}
    for layout in ("paged", "dense"):
        kv = KVCacheSpec(num_slots=1, max_len=max_len, layout=layout,
                         page_size=PAGE).build(params, cfg)
        if layout == "paged":
            check(kv.admit_slot(0, prompt, NEW_TOKENS) == 0, "unexpected prefix sharing")
        kvs[layout] = kv
    worst, worst_past, reads = 0.0, 0.0, []
    for p0 in range(0, len(prompt), CHUNK):
        chunk = prompt[p0:p0 + CHUNK]
        out, routes, own = {}, [], []
        for layout in ("dense", "paged"):  # an MoE model's paged step takes the dense routes
            kv = kvs[layout]
            if layout == "paged":
                kv.prepare_step([(0, p0, chunk)])
            with (routed_if_moe(cfg, routes) if layout == "dense"
                  else pinned_if_moe(cfg, routes, own)):
                logits, kv.state = prefill_chunk(params, cfg, kv.state, np.asarray([chunk]),
                                                 np.asarray([p0]), np.asarray([len(chunk)]))
            out[layout] = logits.float()
        if cfg.n_experts:
            _, read, why = route_flips(own, routes, MOE_MODEL_TIE, f"{cfg.name}: chunk at {p0}")
            check(why is None, why)
            reads.append(read)
        ratio = ((out["paged"] - out["dense"]).abs().max() / out["dense"].abs().max()).item()
        check(math.isfinite(ratio) and ratio <= LOGITS_REL_TOL,
              f"{cfg.name}: chunk at {p0}: paged vs dense logits ratio {ratio}")
        worst = max(worst, ratio)
        if p0 + len(chunk) > cfg.sliding_window:
            worst_past = max(worst_past, ratio)
    log(f"{cfg.name}: a {len(prompt)}-token prompt in {CHUNK}-token chunks, paged (K4) vs dense "
        f"logits, largest ratio {worst:.4f}, past the {cfg.sliding_window}-token window's edge "
        f"{worst_past:.4f} (limit {LOGITS_REL_TOL})"
        + (f"; the paged steps take the dense steps' routes, and would route "
           f"{sum(r['flips'] for r in reads)} token(s) elsewhere, at most "
           f"{max(r['share'] for r in reads):.3f} of a chunk's at a layer, largest gap of a flip "
           f"{max(r['gap'] for r in reads):.3e} (near-tie under {MOE_MODEL_TIE}), router logits "
           f"within {max(r['logits'] for r in reads):.2e}" if cfg.n_experts else ""))


def zoo_engine(cfg, params, prompts, packed: bool, **kw) -> ContinuousBatcher:
    """A zoo or MoE model's serving engine (the qwen run's), requests
    submitted."""
    eng = ContinuousBatcher(params, cfg, batch_slots=SLOTS, max_len=zoo_max_len(cfg),
                            chunk_size=CHUNK, token_budget=BUDGET, cache="paged",
                            page_size=PAGE, packed=packed, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=NEW_TOKENS))
    return eng


def zoo_model(name: str, index: int, seed: int, keep: bool = False):
    """One zoo model: the 2-layer card-vs-CPU check, then the full model
    (random weights from ``seed``): paged vs dense first-step logits (and,
    with a window, a prompt past it chunk by chunk), served unpacked and
    packed, eager then graphed (the counters' window); streams identical.
    Returns (the graphed runs' launches, their records, and with ``keep``
    the parameters and prompts, for the front-end phase)."""
    cfg = zoo_config(name)
    lens, prompts = zoo_requests(cfg, seed, index)
    # 2 layers at full width: gemma3-27b's as 'LG', so that both kinds run
    pattern = "LG" if "L" in cfg.pattern else cfg.layer_pattern
    logits_parity(dataclasses.replace(cfg, n_layers=ZOO_PARITY_LAYERS, layer_pattern=pattern),
                  seed, prompts[-SLOTS:], zoo_max_len(cfg), cfg.name)
    free_device()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=DEV)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    weights = sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 2**30
    log(f"{cfg.name}: {cfg.n_layers} layers ({cfg.layer_pattern}"
        f"{f', window {cfg.sliding_window}' if 'L' in cfg.pattern else ''}), d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B parameters, "
        f"bf16 init in {time.perf_counter() - t0:.1f} s: {weights:.2f} GiB of weights, init peak "
        f"{init_peak:.2f} GiB; full width and depth; prompt lens {lens}")
    first_step_logits_check(cfg, params, prompts[-SLOTS:], zoo_max_len(cfg), f"{cfg.name} ")
    if "L" in cfg.pattern:
        window_edge_check(cfg, params, prompts[0], zoo_max_len(cfg))
    free_device()
    eager = {p: serve_run(cfg, params, prompts, p, True, zoo_engine)[0] for p in (False, True)}
    outs, recs = {}, {}
    ops.reset_launch_counts()  # the main path starts here
    for p in (False, True):
        outs[p], recs[p] = serve_run(cfg, params, prompts, p, False, zoo_engine)
    counts = ops.launch_counts()  # ... and ends here
    for p in (False, True):
        same_streams(f"{cfg.name} {'packed' if p else 'unpacked'}", outs[p], eager[p])
    log(f"{cfg.name} packed vs unpacked greedy agreement: "
        f"{agreement(outs[False], outs[True])}/{len(prompts) * NEW_TOKENS}")
    check(counts["paged_attention"] > 0, f"{cfg.name}: K4 not run: {counts}")
    if not keep:
        return counts, recs, None
    return counts, recs, (cfg, params, prompts)


# ---------------------------------------------------------------------------
# the front-end on the card (phase 16)
# ---------------------------------------------------------------------------


def http_example():
    """``examples/serve_http_torch.py`` as a module (its server and its
    self-test)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "serve_http_torch.py")
    spec = importlib.util.spec_from_file_location("serve_http_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class EngineSchedule:
    """What the front-end did to an engine, in order: each ``submit`` that
    the engine accepted and each ``cancel``, with the engine step it came
    before; and whether a step was running (``busy``) when each front-end
    submission arrived; and the host-clock span of each step that captured
    a new step graph (``captures``).  ``replay`` drives another engine
    synchronously through the same schedule."""

    def __init__(self, eng):
        self.eng, self.ops, self.running = eng, [], threading.Event()
        self.captures = []
        submit, cancel, step = eng.submit, eng.cancel, eng.step

        def recording_submit(req):
            submit(req)  # raises AdmissionError when the queue is full
            self.ops.append((eng.steps, "submit", req))

        def recording_cancel(uid):
            self.ops.append((eng.steps, "cancel", uid))
            return cancel(uid)

        def running_step():
            self.running.set()
            graphs_before, t0 = len(eng.step_graph.keys), time.perf_counter()
            try:
                step()
            finally:
                self.running.clear()
                if len(eng.step_graph.keys) > graphs_before:
                    self.captures.append((t0, time.perf_counter()))

        eng.submit, eng.cancel, eng.step = recording_submit, recording_cancel, running_step

    def replay(self, eng) -> dict:
        """Drive ``eng`` through the recorded schedule (stepping it only
        while it is busy, as the front-end's driver does); returns every
        request's output (finished or cancelled)."""
        ops_ = list(self.ops)
        while True:
            while ops_ and ops_[0][0] == eng.steps:
                _, op, x = ops_.pop(0)
                if op == "submit":
                    eng.submit(Request(uid=x.uid, prompt=list(x.prompt),
                                       max_new_tokens=x.max_new_tokens, sampling=x.sampling))
                else:
                    eng.cancel(x)
            if not eng.busy:
                check(not ops_, f"the schedule replay stalled at step {eng.steps}: {ops_[:2]}")
                break
            eng.step()
        return {u: r.output for u, r in {**eng.finished, **eng.cancelled}.items()}


@contextlib.contextmanager
def published_token_dropped(uid: int, index: int):
    """A planted front-end fault: request ``uid``'s ``index``-th token is
    never published to its stream (the engine still produced it)."""
    sound = frontend.RequestStream._push

    def faulty(self, toks):
        toks = list(toks)
        seen = self._published  # tokens of this stream published before these
        if self.uid == uid and seen <= index < seen + len(toks):
            del toks[index - seen]
        sound(self, toks)

    frontend.RequestStream._push = faulty
    try:
        yield
    finally:
        frontend.RequestStream._push = sound


def fe_streams_check(tag: str, streams, want) -> None:
    """Every stream's published tokens equal the synchronous replay's
    output of its request, token for token (a cancelled one's as far as it
    went); a dropped stream's are empty."""
    for s in streams:
        got = s.tokens
        ref_ = want.get(s.uid, [])
        check(got == ref_, f"{tag}: stream {s.uid} ({s.status}) published {len(got)} tokens, "
                           f"the synchronous engine {len(ref_)}; first difference at "
                           f"{next((i for i, (a, b) in enumerate(zip(got, ref_)) if a != b), min(len(got), len(ref_)))}")


async def fe_scenario(cfg, eng, prompts, seed: int, full: bool = True):
    """The front-end scenario on one engine: staggered submissions while
    steps run (the first while the first, capturing, step runs), greedy and
    seeded sampled requests, and unless ``full`` is off a cancel mid-flight
    (the long prompt, past the window), a waiting-room overflow
    (``AdmissionError``) and a request dropped at its deadline.  Returns the
    front-end, the engine's schedule, the streams, the cancelled and the
    dropped stream, (AdmissionErrors, burst requests accepted) and the
    submissions made while a step ran."""
    sched = EngineSchedule(eng)
    fe = AsyncEngine(eng, waiting_room=FE_WAITING_ROOM)
    streams, mid_step, rejected, accepted = [], [], 0, 0
    long_prompt = prompts[0]

    async def mid_step_wait(after: int = -1):
        # until a step later than step ``after`` runs (or nothing is left in
        # flight to step): one submission a step, so the waiting room stays
        # short however long a step (a capture) takes
        while fe.in_flight and not (sched.running.is_set() and eng.steps > after):
            await asyncio.sleep(0.0005)

    async def submit(i, prompt, max_new, **kw):
        s = await fe.submit(prompt, max_new, sampling=sampled_params(i, seed), **kw)
        if sched.running.is_set():
            mid_step.append((s.uid, eng.steps))
        streams.append(s)
        return s

    async with fe:
        for i in range(3):  # the first wave: the driver's first step captures
            await submit(i, prompts[1 + i], NEW_TOKENS)
        await mid_step_wait()
        await submit(3, prompts[4], NEW_TOKENS)  # during the capturing step
        if not full:
            await asyncio.gather(*(s.collect() for s in streams))
            return fe, sched, streams, None, None, 0, mid_step
        await mid_step_wait(eng.steps)
        victim = await submit(4, long_prompt, NEW_TOKENS)
        for i in range(5, 8):  # staggered: one every few steps
            await asyncio.sleep(0.05)
            await mid_step_wait(eng.steps)
            await submit(i, prompts[(i % SLOTS) + 1], NEW_TOKENS // 2)
        got = 0
        async for _ in victim:  # cancel the long one once it streams
            got += 1
            if got == 4:
                victim.cancel()
        # a deadline no first token can meet: dropped at the driver's next turn
        doomed = await submit(100, prompts[3], NEW_TOKENS, deadline_s=0.0)
        # the waiting room: a burst with no await point between submits
        burst = prompts[2][:FE_BURST_PROMPT]
        try:
            for j in range(4 * FE_WAITING_ROOM):
                await submit(8 + j, burst, 4)
                accepted += 1
        except AdmissionError:
            rejected += 1
        # (the victim's stream has ended: its iterator is exhausted)
        await asyncio.gather(*(s.collect() for s in streams if s is not victim))
    return fe, sched, streams, victim, doomed, (rejected, accepted), mid_step


def ttft_line(streams, captures) -> str:
    """p50 / p99 TTFT (ms, from the user's submit) of the requests whose
    wait (submit to first token) overlapped no step that captured a graph
    -- the steady-serving metric -- beside the same over every request
    that got a first token, captures included."""
    def spans_capture(r):
        return any(r.submitted_at < t1 and t0 < r.first_token_at for t0, t1 in captures)

    def pct(xs):
        return (f"p50 {np.percentile(xs, 50) * 1e3:.1f} ms, p99 {np.percentile(xs, 99) * 1e3:.1f}"
                f" ms over {len(xs)}" if xs else "none")

    reqs = [s.request for s in streams if s.ttft is not None]
    steady = [r.ttft for r in reqs if not spans_capture(r)]
    return (f"TTFT from the submit, requests that waited through no capture (the metric): "
            f"{pct(steady)}; every request, {len(captures)} capturing steps included: "
            f"{pct([r.ttft for r in reqs])}")


def frontend_phase(cfg, params, prompts, seed: int):
    """Phase 16a: gemma3-27b through ``AsyncEngine`` over the paged, packed
    engine, graphed (the counters' window): the scenario (``fe_scenario``),
    every stream token-identical to the same engine driven synchronously
    through the same schedule of submissions and cancels (a new engine:
    ``EngineSchedule.replay``); a planted fault (one published token
    dropped) that the check must reject."""
    def engine():
        return ContinuousBatcher(params, cfg, batch_slots=SLOTS, max_len=zoo_max_len(cfg),
                                 chunk_size=CHUNK, token_budget=BUDGET, cache="paged",
                                 page_size=PAGE, packed=True, max_queue=FE_MAX_QUEUE)

    eng = engine()
    ops.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    fe, sched, streams, victim, doomed, (rejected, accepted), mid_step = asyncio.run(
        fe_scenario(cfg, eng, prompts, seed))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()  # ... and ends here (the synchronous replays are not in it)
    steps_async = eng.steps
    check(counts == serve_launches(cfg, steps_async),
          f"front-end launches {counts} over {steps_async} steps")
    check(victim.status == "cancelled" and 4 <= len(victim.tokens) < NEW_TOKENS,
          f"the cancelled stream: {victim.status}, {len(victim.tokens)} tokens")
    check(doomed.status == "dropped" and doomed.events[-1].detail == "deadline"
          and doomed.tokens == [], f"the deadline drop: {doomed.status} {doomed.events[-1]}")
    check(rejected == 1 and accepted < 4 * FE_WAITING_ROOM,
          "the waiting room took the whole burst: no AdmissionError")
    check(any(step == 0 for _, step in mid_step),
          f"no submission arrived during the first (capturing) step: {mid_step}")
    check(len(mid_step) >= 3, f"too few submissions arrived mid-step: {mid_step}")
    finished = [s for s in streams if s.status == "finished"]
    check(len(finished) == len(streams) - 2, f"unfinished streams: "
                                             f"{[(s.uid, s.status) for s in streams]}")
    for s in finished:
        check(len(s.tokens) == s.request.max_new_tokens, f"stream {s.uid}: {len(s.tokens)} tokens")
    eng.kv.check_invariants()
    check(eng.kv.used_pages == 0, f"front-end: {eng.kv.used_pages} pages leaked")
    summ = fe.summary()
    replay = engine()
    want = sched.replay(replay)
    fe_streams_check("front-end vs the synchronous engine", streams, want)
    n_tok = sum(len(s.tokens) for s in streams)
    sampled = sum(1 for s in streams if s.request.sampling.temperature > 0)
    log(f"16 front-end over {cfg.name} (paged, packed, graphed): {len(streams)} requests "
        f"({sampled} sampled, seeds from --seed), {len(mid_step)} submitted while a step ran "
        f"(first during step {mid_step[0][1]}, the capturing step), a waiting-room burst cut "
        f"at {accepted} by AdmissionError, one cancelled after "
        f"{len(victim.tokens)} tokens, one dropped at its deadline ({doomed.events[-1].detail}); "
        f"{steps_async} engine steps, {n_tok} tokens streamed in {wall:.2f} s "
        f"(captures included); {ttft_line(streams, sched.captures)} (the engine's summary, "
        f"finished requests, captures included: p50 {summ['p50_ttft'] * 1e3:.1f} ms, p99 "
        f"{summ['p99_ttft'] * 1e3:.1f} ms); every stream equals the synchronous engine's through the same "
        f"schedule ({replay.steps} steps, {len(want)} requests); {graph_line(eng)}")
    check(replay.steps == steps_async, f"the replay took {replay.steps} steps, the front-end "
                                       f"{steps_async}")
    del replay
    # the planted fault: one published token dropped, in a short run
    small = engine()
    with published_token_dropped(uid=1, index=2):
        _, psched, pstreams, *_ = asyncio.run(fe_scenario(cfg, small, prompts, seed, full=False))
    pwant = psched.replay(engine())
    try:
        fe_streams_check("planted", pstreams, pwant)
    except SmokeFailure as e:
        log(f"16 planted fault (request 1's third token never published): rejected: {e}")
    else:
        raise SmokeFailure("the stream check lets a dropped published token pass")
    del small, pstreams
    return counts


#: the HTTP example's card command (README), run in process with its self-test
HTTP_ARGV = ("--config", "gemma3_27b", "--max-len", "2048", "--port", "0", "--self-test")


def http_phase() -> dict:
    """Phase 16b: ``examples/serve_http_torch.py`` as a user runs it on the
    card (``main`` with ``HTTP_ARGV``): it builds gemma3-27b at full width
    and depth with bf16 parameters, serves it on 127.0.0.1 at port 0 and
    runs its self-test against the server; the launches its engine's steps
    imply, no leaked pages."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    eng = http_example().main(list(HTTP_ARGV))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()  # ... and ends here
    check(counts == serve_launches(eng.cfg, eng.steps),
          f"HTTP launches {counts} over {eng.steps} steps")
    eng.kv.check_invariants()
    check(eng.kv.used_pages == 0, f"HTTP example: {eng.kv.used_pages} pages leaked")
    log(f"16b HTTP example `{' '.join(HTTP_ARGV)}` ({eng.cfg.name}, {eng.cfg.n_layers} layers, "
        f"bf16 parameters, init included): self-test passed in {wall:.2f} s, {eng.steps} engine "
        f"steps, K4 {counts['paged_attention']} ({sum(k in 'GL' for k in eng.cfg.pattern)} a "
        f"step), K2 {counts['rmsnorm']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {graph_line(eng)}")
    return counts


# ---------------------------------------------------------------------------
# the MoE family (phase 17): mixtral-8x22b, qwen3-moe-235b-a22b
# ---------------------------------------------------------------------------


def moe_config(name: str, layers: int = MOE_LAYERS):
    """The published config (bf16 parameter storage, as published) cut to
    ``layers`` layers: every width as published."""
    return dataclasses.replace(get_config(name), n_layers=layers)


@contextlib.contextmanager
def router_not_renormalised():
    """A planted fault: the router's top-k probabilities used as they come
    out of the softmax, without the Mixtral renormalisation to sum 1."""
    sound = moe._router

    def faulty(p, x2d, cfg):
        _, top_i, aux = sound(p, x2d, cfg)
        probs = torch.softmax(moe.router_logits(p, x2d), dim=-1)
        return torch.gather(probs, 1, top_i), top_i, aux

    moe._router = faulty
    try:
        yield
    finally:
        moe._router = sound


@contextlib.contextmanager
def router_in_bf16():
    """A planted fault: the router's logits computed in bf16 (its input and
    weights rounded to bf16, the product a bf16 tensor)."""
    sound = moe.router_logits
    moe.router_logits = lambda p, x2d: (x2d.to(torch.bfloat16)
                                        @ p["router"].to(torch.bfloat16)).float()
    try:
        yield
    finally:
        moe.router_logits = sound


@contextlib.contextmanager
def router_off_by_one():
    """A planted fault: each token's k-th choice replaced by its (k+1)-th,
    weighed by its own probability, renormalised."""
    sound = moe._router

    def faulty(p, x2d, cfg):
        _, _, aux = sound(p, x2d, cfg)
        probs = torch.softmax(moe.router_logits(p, x2d), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).indices
        ids = torch.cat([top[:, :cfg.top_k - 1], top[:, cfg.top_k:]], dim=1)
        top_p = torch.gather(probs, 1, ids)
        return top_p / top_p.sum(dim=-1, keepdim=True), ids, aux

    moe._router = faulty
    try:
        yield
    finally:
        moe._router = sound


def route_record(ids, logits, k: int):
    """One router call's record on the host: its ids (T, k), the gap between
    its k-th and (k+1)-th logits (T,) and its logits (T, E)."""
    z = logits.sort(dim=-1, descending=True).values
    return ids.cpu(), (z[:, k - 1] - z[:, k]).cpu(), logits.cpu()


@contextlib.contextmanager
def router_calls(record: list):
    """Record each router call (``route_record``)."""
    sound = moe._router

    def spy(p, x2d, cfg):
        out = sound(p, x2d, cfg)
        record.append(route_record(out[1], moe.router_logits(p, x2d), cfg.top_k))
        return out

    moe._router = spy
    try:
        yield
    finally:
        moe._router = sound


@contextlib.contextmanager
def routes_pinned(pinned: list, own: list):
    """Each router call takes its top-k ids from ``pinned`` (another run's
    ``router_calls`` records, in call order) and weighs them by its own
    probabilities, renormalised as the router does; its own ids and gaps
    go to ``own``.  Two runs that should differ only by their attention
    (the card's kernels against the CPU's plain versions, or the paged
    kernel against plain attention) then route alike, so a near-tie that
    rounds the other way in one of them does not send a token elsewhere
    and carry its difference through every later layer."""
    sound = moe._router
    calls = iter(pinned)

    def forced(p, x2d, cfg):
        _, mine, aux = sound(p, x2d, cfg)
        logits = moe.router_logits(p, x2d)
        own.append(route_record(mine, logits, cfg.top_k))
        ids = next(calls)[0].to(x2d.device)
        top_p = torch.gather(torch.softmax(logits, dim=-1), 1, ids)
        return top_p / top_p.sum(dim=-1, keepdim=True), ids, aux

    moe._router = forced
    try:
        yield
    finally:
        moe._router = sound


def route_flips(own, pinned, tie: float, what: str, rows=None,
                logits_tol: float = LOGITS_REL_TOL):
    """The routes a run would take otherwise: the tokens (the first
    ``rows``: a packed step's real ones) whose own expert set differs from
    the pinned one at some layer (``own`` and ``pinned``: ``route_record``s,
    layer by layer).  The rules, layer by layer: the router logits agree
    within ``logits_tol`` of their largest; every token routed elsewhere has
    a pinned gap between its k-th and (k+1)-th logits under ``tie``; at
    most ``MOE_FLIP_SHARE`` of the tokens are routed elsewhere; and the
    gap lies under twice the token's largest logit change (else one of the
    two top-k's is not the top-k of its logits: a consistency check, which
    any two correct top-k's pass).  Returns (the tokens' mask, the
    readings: flips, the largest share of a layer, the largest gap of a
    token routed elsewhere, the largest logit change relative to the
    largest logit; the first rule broken, or None)."""
    if len(own) != len(pinned):
        return None, {}, f"{what}: {len(own)} router calls, {len(pinned)} pinned"
    rows = rows or own[0][0].shape[0]
    out = torch.zeros(rows, dtype=torch.bool)
    read = {"flips": 0, "share": 0.0, "gap": 0.0, "logits": 0.0}
    why = None
    for layer, ((ids_a, _, z_a), (ids_b, gap, z_b)) in enumerate(zip(own, pinned)):
        dz = (z_a[:rows] - z_b[:rows]).abs().max(dim=1).values
        rel = dz.max().item() / z_b[:rows].abs().max().item()
        differ = (ids_a[:rows].sort(dim=1).values != ids_b[:rows].sort(dim=1).values).any(1)
        g = gap[:rows][differ]
        share = differ.float().mean().item()
        worst = g.max().item() if g.numel() else 0.0
        read = {"flips": read["flips"] + int(differ.sum()), "share": max(read["share"], share),
                "gap": max(read["gap"], worst), "logits": max(read["logits"], rel)}
        rules = ((rel <= logits_tol, f"router logits differ by {rel:.3e} of their largest "
                                     f"(limit {logits_tol})"),
                 (worst < tie, f"{g.numel()} token(s) routed elsewhere at a logit gap up to "
                               f"{worst:.3e} (a near-tie is under {tie})"),
                 (share <= MOE_FLIP_SHARE, f"{share:.3f} of the tokens routed elsewhere "
                                           f"(limit {MOE_FLIP_SHARE})"),
                 (bool((g <= 2 * dz[differ]).all()), "a top-k that is not its logits' top-k"))
        why = why or next((f"{what}: layer {layer}: {msg}" for ok, msg in rules if not ok), None)
        out |= differ
    return out, read, why


def route_readings(read: dict) -> str:
    """``route_flips``'s readings, for the log."""
    return (f"{read['flips']} flips, at most {read['share']:.3f} of a layer's tokens, largest "
            f"gap of a flip {read['gap']:.3e}, router logits within {read['logits']:.2e}")


def sound_routes(own, pinned, tie: float, what: str, **kw) -> torch.Tensor:
    """``route_flips`` of a sound run: fails on a broken rule; returns the
    mask and logs the readings."""
    flips, read, why = route_flips(own, pinned, tie, what, **kw)
    check(why is None, why)
    log(f"{what}: routes the run would take otherwise: {route_readings(read)} (near-tie "
        f"under {tie})")
    return flips


def faulty_routes(own, pinned, tie: float, what: str, **kw) -> None:
    """``route_flips`` of a run with a planted router fault: fails unless a
    rule rejects it; logs the readings and the rule."""
    _, read, why = route_flips(own, pinned, tie, what, **kw)
    check(why is not None, f"{what}: the route checks let a planted router fault pass: "
                           f"{route_readings(read)}")
    log(f"{what}: rejected ({why}); {route_readings(read)}")


def pinned_if_moe(cfg, pinned: list, own: list):
    """``routes_pinned`` for an MoE config, nothing for another."""
    return routes_pinned(pinned, own) if cfg.n_experts else contextlib.nullcontext()


def routed_if_moe(cfg, record: list):
    """``router_calls`` for an MoE config, nothing for another."""
    return router_calls(record) if cfg.n_experts else contextlib.nullcontext()


@contextlib.contextmanager
def first_moe_input(box: list):
    """Keep the first MoE layer call's input (x, params) of the block."""
    sound = moe.apply_moe

    def spy(p, x, cfg, impl="sort", valid=None):
        if not box:
            box.append((x.detach().clone(), p))
        return sound(p, x, cfg, impl=impl, valid=valid)

    moe.apply_moe = spy
    try:
        yield
    finally:
        moe.apply_moe = sound


def moe_layer_check(card_x, card_p, cpu_p, card_cfg, cpu_cfg) -> dict:
    """17c: one MoE layer on the card's own input (the first layer's, the
    card's bf16 hidden states; the CPU takes them in f32, its weights the
    f32 masters): the card's routes against the CPU's (``route_flips`` with
    ``MOE_LAYER_TIE`` and ``MOE_LAYER_LOGITS``: both routers read the same
    f32 input and f32 weights, so only summation order moves a logit), a
    planted bf16 router rejected by the same rules; the outputs of the
    tokens routed alike row by row within ``MOE_ROW_TOL`` in the dense
    dispatch and the capacity dispatch at cf 1.25 and inf (the overflow
    counts equal when no token flips); cf inf against the dense dispatch on
    the card, bits or the largest gap; a planted router fault (no
    renormalisation) must fall outside the row limit."""
    b, s, d = card_x.shape
    x_cpu = card_x.float().cpu()
    what = f"{card_cfg.name} MoE layer"

    def routes(p, x, cfg):
        rec = []
        with router_calls(rec):
            moe._router(p, x.reshape(b * s, d), cfg)
        return rec

    cpu_routes = routes(cpu_p, x_cpu, cpu_cfg)
    flips = sound_routes(routes(card_p, card_x, card_cfg), cpu_routes, MOE_LAYER_TIE, what,
                         logits_tol=MOE_LAYER_LOGITS)
    with router_in_bf16():
        faulty_routes(routes(card_p, card_x, card_cfg), cpu_routes, MOE_LAYER_TIE,
                      f"{what}, planted bf16 router", logits_tol=MOE_LAYER_LOGITS)
    keep = ~flips.reshape(b, s)
    out = {"flips": int(flips.sum())}
    ys, cpu = {}, {}
    for name, impl, cf in (("dense", "dense", None), ("cf 1.25", "capacity", 1.25),
                           ("cf inf", "capacity", math.inf)):
        kc = card_cfg if cf is None else dataclasses.replace(card_cfg, capacity_factor=cf)
        kp = cpu_cfg if cf is None else dataclasses.replace(cpu_cfg, capacity_factor=cf)
        y, _, ovf = moe.apply_moe(card_p, card_x, kc, impl=impl)
        # at cf inf the CPU's capacity form gives its dense form's bits
        # (tests/test_torch_moe.py): the dense result stands for it
        cpu[name] = (cpu["dense"] if name == "cf inf"
                     else moe.apply_moe(cpu_p, x_cpu, kp, impl=impl))
        yc, _, ovfc = cpu[name]
        ys[name] = y
        err = row_rel_err(y.float().cpu()[keep], yc[keep])
        check(math.isfinite(err) and err <= MOE_ROW_TOL,
              f"{card_cfg.name} MoE layer {name}: row rel err {err} over {MOE_ROW_TOL}")
        if not out["flips"]:
            check(int(ovf) == int(ovfc), f"{card_cfg.name} MoE layer {name}: overflow "
                                         f"{int(ovf)} on the card, {int(ovfc)} on the CPU")
        out[name] = (err, int(ovf))
    with router_not_renormalised():
        bad, _, _ = moe.apply_moe(card_p, card_x, card_cfg, impl="dense")
    out["planted"] = row_rel_err(bad.float().cpu()[keep], cpu["dense"][0][keep])
    check(out["planted"] > MOE_ROW_TOL,
          f"{card_cfg.name} MoE layer: the limit lets a router fault pass: {out['planted']}")
    out["inf_vs_dense"] = (ys["cf inf"].float() - ys["dense"].float()).abs().max().item()
    log(f"{card_cfg.name} MoE layer 0 on the card's own input ({b} x {s} tokens): "
        f"{out['flips']} routing flips (near-tie under {MOE_LAYER_TIE}); "
        f"row rel err card vs cpu: dense {out['dense'][0]:.2e}, cf 1.25 {out['cf 1.25'][0]:.2e} "
        f"(overflow {out['cf 1.25'][1]}), cf inf {out['cf inf'][0]:.2e} (limit {MOE_ROW_TOL}); "
        f"planted router fault (top-k not renormalised) {out['planted']:.2e}, rejected; cf inf "
        f"vs dense on the card: largest gap {out['inf_vs_dense']:.3e}"
        + (" (the same bits)" if out["inf_vs_dense"] == 0 else ""))
    return out


def moe_parity(small, seed: int, prompts, max_len: int) -> dict:
    """17c: a 2-layer full-width MoE model, card (kernels, bf16 compute)
    against the CPU (plain versions, f32 masters drawn on the card and
    copied), at ``MOE_PARITY_CHUNK`` tokens a slot: the first layer's MoE
    on the card's own input (``moe_layer_check``); the first dense and
    packed steps' logits (``first_steps``) row by row within
    ``LOGITS_ROW_TOL``, the card's routes pinned to the CPU's
    (``routes_pinned``) and each route the card would take otherwise a
    near-tie under ``MOE_MODEL_TIE`` (``sound_routes``; a router off by one,
    ``router_off_by_one``, must be rejected), with the launches the code
    implies; then two planted faults, K4's (``planted_k4_fault``, routes
    pinned) and the router's (``router_not_renormalised``), which must fall
    outside the limit."""
    cpu_cfg = dataclasses.replace(small, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cpu_cfg, seed=seed, device=DEV)
    card = compute_params(params, small)
    params = tree_map(lambda x: x.cpu(), params)
    cpu_recs = []
    with router_calls(cpu_recs):
        want = first_steps(cpu_cfg, params, prompts, max_len, MOE_PARITY_CHUNK)
    t_cpu = time.perf_counter() - t0
    cpu_moe0 = {k: v[0] for k, v in params["stack"]["groups"][0]["moe"].items()}
    del params

    def card_steps(pin: bool, own: list):
        with routes_pinned(cpu_recs, own) if pin else contextlib.nullcontext():
            return first_steps(small, card, prompts, max_len, MOE_PARITY_CHUNK)

    def errs(run):
        return {k: row_rel_err(run[k].reshape(-1, w.shape[-1]), w.reshape(-1, w.shape[-1]))
                for k, w in want.items()}

    own, box = [], []
    before = ops.launch_counts()
    with first_moe_input(box):
        got = card_steps(True, own)
    runs = {k: v - before[k] for k, v in ops.launch_counts().items()}
    check(runs == serve_launches(small, 2), f"{small.name} parity: launches {runs}")
    layer_out = moe_layer_check(box[0][0], box[0][1], cpu_moe0, small, cpu_cfg)
    n = small.n_layers
    flips = {"dense": sound_routes(own[:n], cpu_recs[:n], MOE_MODEL_TIE,
                                   f"{small.name} parity, dense step"),
             "packed": sound_routes(own[n:], cpu_recs[n:], MOE_MODEL_TIE,
                                    f"{small.name} parity, packed step",
                                    rows=want["packed"].shape[0])}
    bad_routes = []
    with router_off_by_one(), router_calls(bad_routes):
        card_steps(False, [])
    faulty_routes(bad_routes[:n], cpu_recs[:n], MOE_MODEL_TIE,
                  f"{small.name} parity, dense step, planted router off by one")
    sound = errs(got)
    with planted_k4_fault():
        bad_k4 = errs(card_steps(True, []))
    with router_not_renormalised():
        bad_router = errs(card_steps(False, []))
    g = small.n_heads // small.n_kv_heads
    log(f"{small.name} parity {small.n_layers} layers ({small.pattern}, full width, "
        f"{MOE_PARITY_CHUNK} tokens a slot): first-step logits, row rel err card vs cpu with the "
        f"card's routes pinned to the CPU's: dense {sound['dense']:.2e}, packed "
        f"{sound['packed']:.2e} (limit {LOGITS_ROW_TOL}); tokens the card would route elsewhere "
        f"(near-ties under {MOE_MODEL_TIE}): dense {int(flips['dense'].sum())} of "
        f"{flips['dense'].numel()}, packed {int(flips['packed'].sum())} of "
        f"{flips['packed'].numel()}; planted K4 fault (heads {padded_heads(g)}-{g - 1} of each "
        f"group given zero queries) dense {bad_k4['dense']:.2e}, packed {bad_k4['packed']:.2e}; "
        f"planted router fault (top-k not renormalised, routes its own) dense "
        f"{bad_router['dense']:.2e}, packed {bad_router['packed']:.2e}; the CPU pass (weights "
        f"drawn on the card) took {t_cpu:.1f} s")
    check(all(math.isfinite(e) and e <= LOGITS_ROW_TOL for e in sound.values()),
          f"{small.name} first-step logits differ from the CPU's: {sound}")
    for what, bad in (("K4", bad_k4), ("router", bad_router)):
        check(min(bad.values()) > LOGITS_ROW_TOL,
              f"the logits metric lets a planted {what} fault pass: {bad}")
    return dict(sound, layer=layer_out, flips={k: int(v.sum()) for k, v in flips.items()})


class OverflowRecount:
    """Recounts each capacity dispatch's dropped routes plainly, from its
    own router ids and padding mask: per expert, the routed choices of the
    real tokens past the capacity, summed over the layers of an engine step
    (``on_step``, a step callback).  Eager runs only (it reads the host)."""

    def __init__(self):
        self.steps: list = []
        self._pending = 0

    def __enter__(self):
        self._sound = moe.apply_moe_capacity

        def spy(p, x, cfg, valid=None):
            b, s, d = x.shape
            _, ids, _ = moe._router(p, x.reshape(b * s, d), cfg)
            real = (torch.ones(b * s, dtype=torch.bool, device=x.device) if valid is None
                    else torch.broadcast_to(valid, (b, s)).reshape(b * s))
            counts = torch.bincount(ids[real].reshape(-1), minlength=cfg.n_experts).cpu().numpy()
            self._pending += int(np.maximum(counts - moe.capacity(cfg, b * s), 0).sum())
            return self._sound(p, x, cfg, valid=valid)

        moe.apply_moe_capacity = spy
        return self

    def __exit__(self, *exc):
        moe.apply_moe_capacity = self._sound

    def on_step(self, stats) -> None:
        self.steps.append(self._pending)
        self._pending = 0


def moe_model(name: str, index: int, seed: int):
    """One MoE model: the 2-layer card-vs-CPU check (``moe_parity``), then
    the model at ``MOE_LAYERS`` layers and full width (bf16 weights drawn on
    the card from ``seed``): paged vs dense first-step logits (and, with a
    window, the long prompt chunk by chunk past it), then served unpacked
    and packed in the dense dispatch and at the config's capacity factor,
    eager then graphed (the counters' window): streams identical, each
    step's overflow equal to the eager run's plain recount
    (``OverflowRecount``).  Returns (the graphed runs' launches, their
    records by (dispatch, packed))."""
    cfg = moe_config(name)
    lens, prompts = zoo_requests(cfg, seed, len(ZOO) + index)
    free_device()
    moe_parity(moe_config(name, MOE_PARITY_LAYERS), seed, prompts[-SLOTS:], zoo_max_len(cfg))
    free_device()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=DEV)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    weights = sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 2**30
    log(f"{cfg.name}: {cfg.n_layers} of {get_config(name).n_layers} layers ({cfg.layer_pattern}"
        f"{f', window {cfg.sliding_window}' if 'L' in cfg.pattern else ''}), d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, {cfg.n_experts} "
        f"experts top-{cfg.top_k} of d_ff {cfg.expert_d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, bf16 init in {time.perf_counter() - t0:.1f} "
        f"s: {weights:.2f} GiB of weights, init peak {init_peak:.2f} GiB; full width; prompt "
        f"lens {lens}")
    first_step_logits_check(cfg, params, prompts[-SLOTS:], zoo_max_len(cfg), f"{cfg.name} ")
    if "L" in cfg.pattern:
        window_edge_check(cfg, params, prompts[0], zoo_max_len(cfg))
    free_device()
    counts = {k: 0 for k in ops.launch_counts()}
    recs = {}
    for cf in (None, cfg.capacity_factor):
        dispatch = "dense" if cf is None else f"capacity {cf}"
        eager, recounts = {}, {}
        for packed in (False, True):
            recount = OverflowRecount()

            def make(c, p, pr, pk, recount=recount, cf=cf):
                eng = zoo_engine(c, p, pr, pk, capacity_factor=cf)
                eng.add_step_callback(recount.on_step)
                return eng

            with recount:
                eager[packed], rec = serve_run(cfg, params, prompts, packed, True, make)
            recounts[packed] = recount.steps
            got = [st.expert_overflow for st in rec["step_stats"]]
            check(got == recount.steps, f"{cfg.name} {dispatch}: overflow a step {got}, the "
                                        f"plain recount {recount.steps}")
        ops.reset_launch_counts()  # the main path starts here
        for packed in (False, True):
            outs, rec = serve_run(cfg, params, prompts, packed, False,
                                  lambda c, p, pr, pk, cf=cf: zoo_engine(c, p, pr, pk,
                                                                         capacity_factor=cf))
            tag = f"{cfg.name} {dispatch} {'packed' if packed else 'unpacked'}"
            same_streams(tag, outs, eager[packed])
            ovf = [st.expert_overflow for st in rec["step_stats"]]
            check(ovf == recounts[packed], f"{tag}: graphed overflow {ovf}, eager "
                                           f"{recounts[packed]}")
            if cf is None:
                check(not any(ovf), f"{tag}: the dense dispatch dropped routes")
            rec["overflow"] = ovf
            recs[dispatch, packed] = rec
        for k, v in ops.launch_counts().items():  # ... and ends here
            counts[k] += v
        log(f"{cfg.name} {dispatch}: overflow a step, unpacked: mean "
            f"{statistics.mean(recounts[False]):.1f}, max {max(recounts[False])}; packed: mean "
            f"{statistics.mean(recounts[True]):.1f}, max {max(recounts[True])} (each step's equal "
            f"to its plain recount from its own router ids)")
    check(counts["paged_attention"] > 0, f"{cfg.name}: K4 not run: {counts}")
    for (dispatch, packed), r in recs.items():
        log(f"{cfg.name} {dispatch} {'packed' if packed else 'unpacked'} graphed: decode "
            f"{r['decode_ms']:.2f} ms, mixed {r['mixed_ms']:.2f} ms, {r['gen_tok_s']:.1f} "
            f"generated tok/s, peak {r['peak_gib']:.2f} GiB beside {weights:.2f} GiB of weights")
    del params
    return counts, recs


def moe_phase(seed: int, rng) -> dict:
    """Phase 17: K4's (128, 6) and (128, 16) builds and K2 at d 6144 and
    4096 against their plain versions, timed (17a); per model the 2-layer
    card-vs-CPU check (17c) and the served model (17b)."""
    out = {"k4": {}, "k2": {}, "counts": {}, "recs": {}}
    for i, name in enumerate(MOE):
        cfg = moe_config(name)
        lens = zoo_requests(cfg, seed, len(ZOO) + i)[0][:SLOTS]
        win = cfg.sliding_window if "L" in cfg.pattern else 100
        g = cfg.n_heads // cfg.n_kv_heads
        err = k4_checks(rng, lens, dims=zoo_dims(cfg), max_len=zoo_max_len(cfg),
                        windows=(100, win, win))
        free_device()
        t = k4_timing(rng, lens, dims=zoo_dims(cfg),
                      window=cfg.sliding_window if "L" in cfg.pattern else 0)
        out["k4"][cfg.hd, g] = (err, t)
        free_device()
        out["k2"][cfg.d_model] = k2_rg_checks(rng, d=cfg.d_model)
        free_device()
    for i, name in enumerate(MOE):
        out["counts"][name], out["recs"][name] = moe_model(name, i, seed)
        free_device()
    return out


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
    t_start = time.perf_counter()

    def phase_done(phase: str) -> None:
        log(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

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
               ssd_chunk.load_library, rmsnorm.load_library)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for b in [pool.submit(f) for f in loaders]:
            b.result()
    sources = {flash_attention.SOURCE: r"paged_attention_[a-z]+",
               flash_attention.TRAIN_SOURCE: r"attn_[a-z_]+", ssd_chunk.SOURCE: None,
               rmsnorm.SOURCE: r"rmsnorm_(?:fwd|bwd)_[a-z]+"}
    for src in sources:
        log(f"build: {src} (nvcc sm_90a) -> "
            f"{_build.library_path(src).relative_to(_build.BUILD_DIR.parents[1])}")
    log(f"build: {len(loaders)} CUDA sources in {time.perf_counter() - t0:.1f} s")
    for src, names in sources.items():
        lines = (ptxas_lines(src, names, head_dims=src in (flash_attention.TRAIN_SOURCE,
                                                           flash_attention.SOURCE)) if names
                 else ssd_build_lines())
        for line in lines:
            log(f"build: ptxas -v, {src}: {line}")
    sms = rmsnorm._sm_count(0)
    for what, rows, d in (("decode", SLOTS, 2048), ("mixed", BUDGET + 1, 2048),
                          ("train", TRAIN_SEQ, 2048), ("mamba_train", M_TRAIN_SEQS * TRAIN_SEQ, 768)):
        plan = rmsnorm.fwd_partition(rows, d, 2, sms)
        log(f"build: rmsnorm_fwd_rows at {what} ({rows} x {d} bf16): {plan.smem} B dynamic "
            f"shared memory, {plan.ctas} CTAs of {plan.rows_per_cta} rows, stages of "
            f"{plan.stage_rows} rows through {plan.slots} slots")
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        masked_accum.masked_accum(torch.zeros(4096, device="cuda"),
                                  torch.ones(4096, device="cuda", dtype=dtype), 1.0)
    torch.cuda.synchronize()
    log(f"build: Triton JIT (masked_accum) {time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain versions
    rng = np.random.default_rng(args.seed)
    cfg = get_config("qwen2_5_3b")
    prompt_lens = [int(n) for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]
    k4_err = k4_checks(rng, prompt_lens)
    k2_err = k2_checks(rng)
    free_device()
    k3_fwd_err, k3_bwd_err = k3_checks(rng)
    k2b_err, k2b_t = k2_bwd_checks_and_timing(rng)
    k1_err, k1_t = k1_checks_and_timing(rng)
    free_device()
    k6_err = k6_checks(rng)
    k5_err = k5_checks(rng)
    free_device()
    k6b_err = k6_bwd_checks(rng)
    free_device()
    # K2's backward at mamba2-130m's width (8,192 rows: a training micro-batch)
    k2b768_err, k2b768_t = k2_bwd_checks_and_timing(rng, d=768, rows=M_TRAIN_SEQS * TRAIN_SEQ)
    free_device()
    k4_t = k4_timing(rng, prompt_lens)
    k2_t = k2_timing(rng)
    k3f_t, k3b_t = k3_timing(rng)
    k6_t = k6_timing(rng)
    k5_t = k5_timing(rng)
    free_device()
    k6b_t = k6_bwd_timing(rng)
    free_device()
    # K4's (128, 2) and (128, 9) builds at gemma3-27b's and starcoder2-7b's
    # widths (phase 15's main paths), on their own stream of inputs; timed at
    # each zoo model's decode and mixed steps
    zrng = np.random.default_rng(args.seed + 15)
    zcfg = {n: zoo_config(n) for n in ZOO}
    zlens = {n: zoo_requests(zcfg[n], args.seed, i)[0][:SLOTS] for i, n in enumerate(ZOO)}
    g3 = zcfg["gemma3_27b"]
    k4_g2_err = k4_checks(zrng, zlens["gemma3_27b"], dims=zoo_dims(g3),
                          max_len=zoo_max_len(g3),
                          windows=(100, g3.sliding_window, g3.sliding_window))
    free_device()
    k4_g9_err = k4_checks(zrng, zlens["starcoder2_7b"], dims=zoo_dims(zcfg["starcoder2_7b"]))
    free_device()
    k4_zoo_t = {"gemma3_27b local": k4_timing(zrng, zlens["gemma3_27b"], dims=zoo_dims(g3),
                                              window=g3.sliding_window),
                "gemma3_27b global": k4_timing(zrng, zlens["gemma3_27b"], dims=zoo_dims(g3)),
                "internlm2_1_8b": k4_timing(zrng, zlens["internlm2_1_8b"],
                                            dims=zoo_dims(zcfg["internlm2_1_8b"])),
                "starcoder2_7b": k4_timing(zrng, zlens["starcoder2_7b"],
                                           dims=zoo_dims(zcfg["starcoder2_7b"]))}
    free_device()
    phase_done("3")

    # 4. serving at full width
    t0 = time.perf_counter()
    params = compute_params(init_params(cfg, seed=args.seed, device=DEV), cfg)
    torch.cuda.synchronize()
    log(f"qwen2.5-3b: {cfg.param_count() / 1e9:.3f} B parameters, f32 init + bf16 "
        f"compute copy in {time.perf_counter() - t0:.1f} s; prompt lens {prompt_lens}")
    first_step_logits_check(cfg, params, prompts)
    serve_counts, qwen_streams = qwen_serving(cfg, params, prompts)
    check(serve_counts["paged_attention"] > 0 and serve_counts["rmsnorm"] > 0,
          f"kernels not run: {serve_counts}")
    del params
    free_device()
    phase_done("4")

    # 5. Mamba-2 serving at full width and depth
    mamba_counts, _, mamba_streams = mamba_phase(args.seed)
    free_device()
    phase_done("5")

    # 6. training at full depth, then the 2-layer card-vs-CPU parity
    train_counts, train_graphed = train_phase(cfg, args.seed)
    free_device()
    grad_phase(cfg, args.seed)
    free_device()
    parity_phase(cfg, args.seed)
    free_device()
    phase_done("6")

    # 7. Local-SGD at full depth, then the 2-layer card-vs-CPU check; then
    # mamba2-130m through the same path (K6's backward in the local steps)
    localsgd_counts, _, keep = localsgd_phase(cfg, args.seed)
    free_device()
    localsgd_parity(cfg, args.seed, keep)
    free_device()
    mcfg = get_config("mamba2_130m")
    m_localsgd_counts, _, _ = localsgd_phase(
        dataclasses.replace(mcfg, n_layers=M_LSGD_LAYERS), args.seed)
    free_device()
    phase_done("7")

    # 8. checkpoints: save, resume, and the uninterrupted run
    checkpoint_phase(cfg, args.seed)
    free_device()
    phase_done("8")

    # 9. data parallel: one NCCL rank at full depth, then two gloo ranks
    dp_counts = dp_nccl_phase(cfg, args.seed, train_graphed)
    del train_graphed
    free_device()
    dp_gloo_phase(cfg, args.seed)
    free_device()
    dp_gloo_phase(mcfg, args.seed, layers=M_DP_LAYERS, pool_gib=M_DP_POOL_GIB)
    free_device()
    phase_done("9")

    # 10. Mamba-2 training at full depth, its step-0 gradient, then the 2-layer
    # card-vs-CPU gradient parity
    mamba_train_counts = full_train_phase(get_config("mamba2_130m"), args.seed, "mamba train",
                                          M_TRAIN_SEQS)
    free_device()
    grad_phase(get_config("mamba2_130m"), args.seed, seqs=M_TRAIN_SEQS)
    free_device()
    mamba_train_parity(args.seed)
    free_device()
    phase_done("10")

    # 11. the paper's BERT models: K3's (64, 1) build, the 2-layer card-vs-CPU
    # check, bert-1.5b at appendix B.1's setting, bert-large
    (k3d_fwd_err, k3d_bwd_err), k3d_t, bert_counts = bert_phase(args.seed, rng)
    check(bert_counts["flash_attention"] > 0 and bert_counts["flash_attention_bwd"] > 0
          and bert_counts["masked_accum"] > 0, f"bert: kernels not run: {bert_counts}")
    free_device()
    phase_done("11")

    # 12. recurrentgemma-2b serving: K4's (256, 10) build and K2 at d 2560
    # (12a), the 3-layer card-vs-CPU check (12b), the full model (12c)
    rg_lens = rg_requests(get_config("recurrentgemma_2b"), args.seed)[0][:SLOTS]
    k4_rg_err = k4_checks(rng, rg_lens, dims=RG_DIMS, max_len=RG_MAX_LEN,
                          windows=(100, RG_WINDOW, RG_WINDOW))
    free_device()
    k2_rg_err, k2_rg_t = k2_rg_checks(rng)
    k4_rg_t = k4_timing(rng, rg_lens, dims=RG_DIMS, window=RG_WINDOW)
    free_device()
    rg_counts, _, rg_streams = rg_phase(args.seed)
    free_device()
    phase_done("12")

    # 13. training the 'R' family: K3's (256, 10) build and K2's backward at d
    # 2560 (13a), the 3-layer card-vs-CPU gradient check (13b), recurrentgemma-2b
    # at full width and depth through DropCompute (13c)
    (k3r_fwd_err, k3r_bwd_err), k3r_t, (k2b2560_err, k2b2560_t), rg_train_counts = \
        rg_train_phase(args.seed, rng)
    check(rg_train_counts["flash_attention"] > 0 and rg_train_counts["flash_attention_bwd"] > 0
          and rg_train_counts["rmsnorm_bwd"] > 0 and rg_train_counts["masked_accum"] > 0,
          f"recurrentgemma train: kernels not run: {rg_train_counts}")
    free_device()
    phase_done("13")

    # 14. decode_step at full width (14a), the sampler alone (14b), sampled
    # serving (14c) and speculation (14d)
    p14_qwen, p14_rg, p14_mamba = phase14(args.seed, rng, prompts, qwen_streams,
                                          rg_streams[False], mamba_streams["dense", False])
    check(p14_qwen["paged_attention"] > 0 and p14_rg["paged_attention"] > 0
          and p14_mamba["rmsnorm"] > 0, f"phase 14: kernels not run: {p14_qwen}, {p14_rg}, "
                                        f"{p14_mamba}")
    free_device()
    phase_done("14")

    # 15. the dense zoo at full width and depth: internlm2-1.8b, starcoder2-7b,
    # gemma3-27b (kept for 16)
    zoo_counts, zoo_recs = {}, {}
    for i, n in enumerate(ZOO):
        zoo_counts[n], zoo_recs[n], kept = zoo_model(n, i, args.seed, keep=n == "gemma3_27b")
        free_device()
    phase_done("15")

    # 16. the front-end over gemma3-27b: AsyncEngine (a), then the HTTP
    # example's card command (b), after the kept parameters are dropped
    fe_counts = frontend_phase(*kept, args.seed)
    del kept
    free_device()
    http_counts = http_phase()
    fe_counts = {k: v + http_counts[k] for k, v in fe_counts.items()}
    free_device()
    phase_done("16")

    # 17. the MoE family: K4's (128, 6) and (128, 16) builds and K2 at d 6144
    # and 4096 (17a), then per model the 2-layer card-vs-CPU check (17c) and
    # the model at 12 layers, full width, in both dispatches (17b)
    p17 = moe_phase(args.seed, np.random.default_rng(args.seed + 17))
    moe_counts = p17["counts"]
    free_device()
    phase_done("17")

    # K3's (128, 8) records keep the earlier paths' launches; the (64, 1)
    # build's records take phase 11's, the (256, 10) build's phase 13's; K4's
    # (128, 8) record keeps the earlier paths' and phase 14's qwen paths',
    # the (256, 10) build's takes phase 12's and 14a's recurrentgemma path's
    # K4's (128, 2) build's record takes internlm2-1.8b's and gemma3-27b's
    # serving (15) and the front-end (16), its (128, 9) build's starcoder2-7b's
    k3_own = ("flash_attention", "flash_attention_bwd")
    # K4's (128, 6) build's record takes mixtral-8x22b's serving (17), its
    # (128, 16) build's qwen3-moe-235b-a22b's
    zoo = {k: sum(c[k] for c in zoo_counts.values()) + fe_counts[k]
           + sum(c[k] for c in moe_counts.values()) for k in fe_counts}
    launches = {k: serve_counts[k] + mamba_counts[k] + train_counts[k] + localsgd_counts[k]
                + m_localsgd_counts[k] + dp_counts[k] + mamba_train_counts[k]
                + (0 if k in k3_own else bert_counts[k] + rg_train_counts[k])
                + (0 if k == "paged_attention" else rg_counts[k] + p14_rg[k] + zoo[k])
                + p14_qwen[k] + p14_mamba[k]
                for k in serve_counts}
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
        dict(name="paged_attention_d256_g10", route="cuda",
             source="src/repro_torch/kernels/paged_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:238",
             launches=rg_counts["paged_attention"] + p14_rg["paged_attention"],
             max_abs_err=k4_rg_err,
             **{k: k4_rg_t["decode"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="paged_attention_d128_g2", route="cuda",
             source="src/repro_torch/kernels/paged_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:238",
             launches=(zoo_counts["internlm2_1_8b"]["paged_attention"]
                       + zoo_counts["gemma3_27b"]["paged_attention"]
                       + fe_counts["paged_attention"]),
             max_abs_err=k4_g2_err,
             **{k: k4_zoo_t["gemma3_27b local"]["decode"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="paged_attention_d128_g9", route="cuda",
             source="src/repro_torch/kernels/paged_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:238",
             launches=zoo_counts["starcoder2_7b"]["paged_attention"], max_abs_err=k4_g9_err,
             **{k: k4_zoo_t["starcoder2_7b"]["decode"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        *[dict(name=f"paged_attention_d128_g{g}", route="cuda",
               source="src/repro_torch/kernels/paged_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:238",
               launches=moe_counts[n]["paged_attention"], max_abs_err=p17["k4"][128, g][0],
               **{k: p17["k4"][128, g][1]["decode"][k]
                  for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_ms=None)
          for g, n in ((6, "mixtral_8x22b"), (16, "qwen3_moe_235b_a22b"))],
        dict(name="rmsnorm", route="cuda", source="src/repro_torch/kernels/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:27",
             launches=launches["rmsnorm"], max_abs_err=k2_err,
             **{k: k2_t["mamba_train"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="rmsnorm_bwd", route="cuda", source="src/repro_torch/kernels/rmsnorm.cu",
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
        dict(name="flash_attention_d64_g1", route="cuda",
             source="src/repro_torch/kernels/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:91",
             launches=bert_counts["flash_attention"], max_abs_err=k3d_fwd_err,
             **k3d_t["bert_1_5b"][0]),
        dict(name="flash_attention_bwd_d64_g1", route="cuda",
             source="src/repro_torch/kernels/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:91",
             launches=bert_counts["flash_attention_bwd"], max_abs_err=k3d_bwd_err,
             **k3d_t["bert_1_5b"][1]),
        dict(name="flash_attention_d256_g10", route="cuda",
             source="src/repro_torch/kernels/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:91",
             launches=rg_train_counts["flash_attention"], max_abs_err=k3r_fwd_err, **k3r_t[0]),
        dict(name="flash_attention_bwd_d256_g10", route="cuda",
             source="src/repro_torch/kernels/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:91",
             launches=rg_train_counts["flash_attention_bwd"], max_abs_err=k3r_bwd_err,
             **k3r_t[1]),
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
        dict(name="ssd_chunk_bwd", route="cuda", source="src/repro_torch/kernels/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk.py:104",
             launches=launches["ssd_chunk_bwd"], max_abs_err=k6b_err, **k6b_t),
    ]
    log(f"K2 bwd at d 768 (8,192 rows): max abs err {k2b768_err:.3e}, {k2b768_t}")
    log(f"K2 fwd at d 2560 (recurrentgemma): max abs err {k2_rg_err:.3e}, {k2_rg_t}")
    log(f"K2 bwd at d 2560 (8,192 rows): max abs err {k2b2560_err:.3e}, {k2b2560_t}")
    for d, (err, t) in p17["k2"].items():
        log(f"K2 fwd at d {d} (17a): max abs err {err:.3e}, {t}")
    log(f"launches, qwen serving: {serve_counts}; mamba serving: {mamba_counts}; "
        f"training: {train_counts}; Local-SGD: {localsgd_counts}; Mamba-2 Local-SGD: "
        f"{m_localsgd_counts}; data parallel (9a): {dp_counts}; Mamba-2 training: "
        f"{mamba_train_counts}; BERT training (11c, 11d): {bert_counts}; recurrentgemma "
        f"serving (12c): {rg_counts}; recurrentgemma training (13c): {rg_train_counts}; phase "
        f"14: qwen {p14_qwen}, recurrentgemma {p14_rg}, mamba {p14_mamba}; dense zoo (15): "
        f"{zoo_counts}; front-end (16): {fe_counts}; MoE serving (17): {moe_counts}")
    for n, t in k4_zoo_t.items():
        log(f"K4 at {n}'s steps: " + "; ".join(
            f"{shape} {r['ms'] * 1e3:.1f} us (bound {r['bound_ms'] * 1e3:.2f}, plain "
            f"{r['plain_ms'] * 1e3:.1f})" for shape, r in t.items()))
    for (d, g), (_, t) in p17["k4"].items():
        log(f"K4 ({d}, {g}) at its MoE model's steps: " + "; ".join(
            f"{shape} {r['ms'] * 1e3:.1f} us (bound {r['bound_ms'] * 1e3:.2f}, plain "
            f"{r['plain_ms'] * 1e3:.1f})" for shape, r in t.items()))
    for n, recs in zoo_recs.items():
        log(f"{n} graphed: " + "; ".join(
            f"{'packed' if p else 'unpacked'} decode {r['decode_ms']:.2f} ms, mixed "
            f"{r['mixed_ms']:.2f} ms, {r['gen_tok_s']:.1f} generated tok/s, peak "
            f"{r['peak_gib']:.2f} GiB" for p, r in recs.items()))
    for k in kernels:
        check(all(isinstance(k[f], float) and math.isfinite(k[f])
                  for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")), f"bad record {k}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
