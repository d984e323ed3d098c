"""Wrappers of the CUDA attention kernels: ``paged_flash_attention`` (serving)
and ``flash_attention_fwd`` / ``flash_attention_bwd`` (training).

Port of the TPU kernel ``repro.kernels.flash_attention.paged_flash_attention``
(src/repro/kernels/flash_attention.py:238, body ``_paged_attn_kernel``
:166).  The kernel itself is ``paged_attention.cu``, built for the (head
dim, group) pairs of ``INSTANCES``: one CTA per (tile, KV head), a tile
being a run of up to the instance's ``tile_tokens`` consecutive query
tokens of one slot (``paged_tile_plan``), its pages staged in shared
memory and its products on tensor cores; the block range is split over more
CTAs when the grid is too small for the card.  This module builds the tile plan
(padded to a row count fixed by the step's shape, ``step_plan_rows``: the
serving engine makes it on the host once per step and layer kind; or here,
with a host round trip, when the caller passes none), checks the
arguments, picks the split, allocates the output and the split's scratch,
and launches it on PyTorch's current stream (so a CUDA graph captures it).  It takes CUDA tensors only: the plain version for the CPU is
``kernels.ref.paged_attention_ref``, chosen by ``kernels.ops`` from the
tensors' device.

``paged_flash_attention.launches`` counts launches (nothing else adds to
it), so a run can show that the serving path went through the kernel.

The training kernels are ports of the TPU kernel
``repro.kernels.flash_attention.flash_attention`` (:91, body
``_attn_kernel`` :29) and a backward the Pallas package never had; their
source is ``flash_attention.cu`` (TMA loads into an mbarrier ring,
``wgmma`` products), their plain versions ``ref.flash_attention_fwd_ref``
/ ``ref.flash_attention_bwd_ref``.  They take (B, H, S, D) tensors of any
strides with D contiguous (the model passes transposed views of its
(B, S, H, D) activations), so nothing is copied; outputs and gradients
come back in the inputs' layouts.  Their schedule, which tiles each CTA
visits, which of those skip the mask and the CTAs' launch order, is
``tile_plan``, made here once per shape and read by the kernels as a
device table.  ``flash_attention_fwd.launches`` /
``flash_attention_bwd.launches`` count calls (the backward's four
launches count as one call).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build

SOURCE = "paged_attention.cu"
TRAIN_SOURCE = "flash_attention.cu"


class Instance(NamedTuple):
    """How the paged kernel is cut for one (head dim, group) (``Inst`` in
    the source): query tokens a tile holds at most (4 warps of
    ``tokens_per_warp``), key positions a ring stage, and CTAs an SM
    (``__launch_bounds__``, within the shared memory a CTA takes)."""

    tile_tokens: int
    tokens_per_warp: int
    stage_keys: int
    ctas_per_sm: int


#: (head dim, H / KV) -> the instance the source builds: the configs the
#: port serves
INSTANCES = {
    (128, 8): Instance(8, 2, 64, 3),  # qwen2.5-3b: 128 threads of at most 170 registers
    (256, 10): Instance(4, 1, 32, 2),  # recurrentgemma-2b: ~97 KB of shared memory a CTA
    (128, 2): Instance(8, 2, 64, 3),  # internlm2-1.8b, gemma3-27b: (128, 8)'s cut, 6 idle heads
    (128, 9): Instance(4, 1, 64, 2),  # starcoder2-7b: two n8 tiles, Q in shared memory, ~81 KB
    (128, 6): Instance(8, 2, 64, 3),  # mixtral-8x22b: (128, 8)'s cut, 2 idle heads
    (128, 16): Instance(4, 1, 64, 2),  # qwen3-moe-235b-a22b: (128, 9)'s cut, no idle head
}
SERVED = set(INSTANCES)
#: the (128, 8) instance's tile tokens and CTAs an SM, the defaults of the
#: plan's functions
TILE_TOKENS = INSTANCES[128, 8].tile_tokens
CTAS_PER_SM = INSTANCES[128, 8].ctas_per_sm
#: columns of a tile plan row: first token, tokens, slot, block lo, block hi
PLAN_COLS = 5
#: the fewest table blocks a split takes (64 key positions at the served
#: page size of 16: one stage of the (128, 8) instance, two of (256, 10))
SPLIT_MIN_BLOCKS = 4


def tile_tokens(head_dim: int, group: int) -> int:
    """The tile tokens a serving step's plans take for (head dim, group):
    the instance's, or ``TILE_TOKENS`` for a pair the kernel is not built
    for (a plan only the CPU's plain path, which reads none, is given)."""
    inst = INSTANCES.get((head_dim, group))
    return TILE_TOKENS if inst is None else inst.tile_tokens


def instance(head_dim: int, group: int) -> Instance:
    """The paged kernel's instance for (head dim, group); raises for one the
    source does not build."""
    try:
        return INSTANCES[head_dim, group]
    except KeyError:
        raise ValueError(f"head dim {head_dim} and group H/KV = {group}: the paged kernel is "
                         f"built for (head dim, group) in {sorted(SERVED)}") from None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 11 + [_I] * 12 + [_F, _F] + [_I, _I] + [_P]


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; sets the C signature."""
    lib = _build.load(SOURCE)
    fn = lib.repro_paged_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_blocks(ctas: int, num_blocks: int, sms: int, ctas_per_sm: int = CTAS_PER_SM):
    """(splits, blocks_per_split) for a grid of ``ctas`` (tile, KV head)
    CTAs over ``num_blocks`` table blocks: split the block range only when
    the grid would not fill the card's ``ctas_per_sm`` CTAs an SM (the
    instance's; decode, mixed steps), and never below ``SPLIT_MIN_BLOCKS``
    blocks a split, so every split fills a stage."""
    splits = 1
    full = ctas_per_sm * sms
    if ctas < full:
        splits = min(-(-full // ctas), max(-(-num_blocks // SPLIT_MIN_BLOCKS), 1))
    per = -(-num_blocks // splits)
    return -(-num_blocks // per), per


def plan_rows(tokens: int, runs: int, tile_tokens: int = TILE_TOKENS) -> int:
    """The most tiles ``paged_tile_plan`` cuts ``tokens`` tokens into when
    they form at most ``runs`` runs of one slot: a run of n tokens gives
    ceil(n / tile_tokens) = 1 + (n - 1) // tile_tokens tiles, so the runs
    give at most runs + (tokens - runs) // tile_tokens; never more than
    ``tokens``."""
    runs = max(min(runs, tokens), 1)
    return min(tokens, runs + (tokens - runs) // tile_tokens)


def step_plan_rows(tokens: int, batch: int, packed: bool, tile_tokens: int = TILE_TOKENS) -> int:
    """The fixed row count of a serving step's plan (``paged_tile_plan``'s
    ``rows``), set by the step's shape alone, so the kernel's grid and
    split (``split_blocks``) are too and the step can be captured in a CUDA
    graph.  Unpacked, ``tokens`` = B x C: each of the ``batch`` rows is its
    slot's run of granted tokens and a run of padding (at most 2 runs of C
    tokens; merging runs never adds tiles).  Packed, ``tokens`` = the
    capacity: each of the ``batch`` slots is one contiguous run and the
    padding one more.  ``tile_tokens`` is the instance's."""
    if packed:
        return plan_rows(tokens, batch + 1, tile_tokens)
    return batch * plan_rows(tokens // batch, 2, tile_tokens)


def paged_tile_plan(q_pos, q_slots, page_size: int, num_blocks: int,
                    window: int = 0, rows: int = None,
                    tile_tokens: int = TILE_TOKENS) -> np.ndarray:
    """The paged kernel's tiles for one step: (tiles, ``PLAN_COLS``) int32
    rows (first token, tokens, slot, block lo, block hi), the longest block
    range first.

    A tile is a run of at most ``tile_tokens`` (the instance's,
    ``INSTANCES``) consecutive tokens (in the step's token order) of one
    slot, cut where the slot changes, so every token lies in exactly one
    tile whatever the order (interleaved slots give short tiles; padding
    tokens, slot < 0, form tiles of their own with an empty range).  Its block range is the union of its tokens'
    admissible block ranges (their hull; the kernel masks each token by its
    own position), empty when every token's range is.

    ``rows`` pads the plan with empty tiles (no tokens, slot -1, lo = hi
    = 0: their CTAs return at once) to that many rows
    (``step_plan_rows``); a plan with more tiles raises ``ValueError``."""
    q_slots = np.asarray(q_slots, np.int64)
    t = len(q_slots)
    if t == 0:
        return np.zeros((0, PLAN_COLS), np.int32)
    # each token's admissible blocks [lo, hi) by the TPU kernel's formula
    # (src/repro/kernels/flash_attention.py:184-188, floor division)
    q_pos = np.asarray(q_pos, np.int64)
    hi = np.where(q_slots >= 0, np.minimum(q_pos // page_size + 1, num_blocks), 0)
    lo = (np.maximum((q_pos - window + 1) // page_size, 0) if window > 0
          else np.zeros_like(q_pos))
    idx = np.arange(t)
    run = np.r_[True, q_slots[1:] != q_slots[:-1]]
    run_start = np.maximum.accumulate(np.where(run, idx, 0))
    starts = np.flatnonzero(run | ((idx - run_start) % tile_tokens == 0))
    some = hi > lo
    big = np.iinfo(np.int64).max
    t_lo = np.minimum.reduceat(np.where(some, lo, big), starts)
    t_hi = np.maximum.reduceat(np.where(some, hi, 0), starts)
    empty = t_hi == 0
    plan = np.stack([starts, np.diff(np.r_[starts, t]), q_slots[starts],
                     np.where(empty, 0, t_lo), t_hi], axis=1).astype(np.int32)
    plan = plan[np.argsort(-(plan[:, 4] - plan[:, 3]), kind="stable")]
    if rows is None:
        return plan
    if len(plan) > rows:
        raise ValueError(f"the step cuts into {len(plan)} tiles, more than its plan's "
                         f"{rows} rows (step_plan_rows)")
    pad = np.zeros((rows - len(plan), PLAN_COLS), np.int32)
    pad[:, 2] = -1
    return np.concatenate([plan, pad])


def tile_plan_tensor(q_pos: torch.Tensor, q_slots: torch.Tensor, page_size: int,
                     num_blocks: int, window: int = 0, rows: int = None,
                     tile_tokens: int = TILE_TOKENS) -> torch.Tensor:
    """``paged_tile_plan`` of device tensors, as an int32 tensor on
    ``q_pos``'s device: one copy to the host and one back, so a step that
    makes its plan this way cannot be captured in a CUDA graph (the serving
    engine makes its plans on the host from its numpy inputs instead)."""
    plan = paged_tile_plan(q_pos.cpu().numpy(), q_slots.cpu().numpy(), page_size, num_blocks,
                           window, rows, tile_tokens)
    return torch.from_numpy(plan).to(q_pos.device)


def _ptr(x) -> int:
    return x.data_ptr() if x is not None else 0


def paged_flash_attention(
    q: torch.Tensor,  # (T, H, D) bf16
    k_pool: torch.Tensor,  # (num_pages, page_size, KV, D) bf16 | int8
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # (num_slots, num_blocks) int
    q_pos: torch.Tensor,  # (T,) int
    q_slots: torch.Tensor,  # (T,) int; < 0 = padding
    window: int = 0,
    softcap: float = 0.0,
    k_scale: torch.Tensor = None,  # (num_pages, page_size, KV) f32, int8 pools
    v_scale: torch.Tensor = None,
    plan: torch.Tensor = None,  # (rows, PLAN_COLS) int32: paged_tile_plan
) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take.

    The pools are never copied: they must be contiguous in their native
    layout and 16-byte aligned (the engine's pools are).  ``tables``/
    ``q_pos``/``q_slots`` are cast to contiguous int32 (a few hundred
    bytes).  ``plan`` must be ``paged_tile_plan`` of these ``q_pos``,
    ``q_slots``, the pools' page size, the tables' width, ``window`` and the
    instance's tile tokens (padded or not) on the device; without one it is
    made here
    (``tile_plan_tensor``: a host round trip, so such a call cannot be
    captured in a CUDA graph)."""
    if q.device.type != "cuda":
        raise ValueError(f"the paged-attention kernel takes CUDA tensors, got {q.device}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables),
                    ("q_pos", q_pos), ("q_slots", q_slots)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q (T, H, D) and equal pools (P, ps, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    t, h, d = q.shape
    num_pages, page_size, kvh, dk = k_pool.shape
    if dk != d or h % kvh or (d, h // kvh) not in SERVED:
        raise ValueError(f"head dim {d} (pool {dk}) and group H/KV = {h}/{kvh}: the kernel "
                         f"is built for (head dim, group) in {sorted(SERVED)}")
    inst = INSTANCES[d, h // kvh]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q must be bfloat16, got {q.dtype}")
    quantized = k_pool.dtype == torch.int8
    if (k_scale is not None) != (v_scale is not None) or quantized != (k_scale is not None):
        raise ValueError("int8 pools need both k_scale and v_scale; float pools neither")
    if not quantized and k_pool.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} must be bfloat16 or int8")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k and v pools must share a dtype")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (the kernel reads their native layout)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (the kernel reads rows in 16-byte loads)")
    if quantized:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (s.dtype != torch.float32 or tuple(s.shape) != (num_pages, page_size, kvh)
                    or not s.is_contiguous() or s.device != q.device):
                raise ValueError(f"{name} must be contiguous f32 (P, ps, KV) on {q.device}")
    num_slots, num_blocks = tables.shape
    if q_pos.shape != (t,) or q_slots.shape != (t,):
        raise ValueError("q_pos and q_slots must have shape (T,)")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()  # a fresh allocation is aligned
    tables = tables.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    q_slots = q_slots.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if t == 0:
        return out
    if plan is None:
        plan = tile_plan_tensor(q_pos, q_slots, page_size, num_blocks, int(window),
                                tile_tokens=inst.tile_tokens)
    if (plan.dtype != torch.int32 or plan.dim() != 2 or plan.shape[1] != PLAN_COLS
            or not 0 < plan.shape[0] <= t or plan.device != q.device):
        raise ValueError(f"plan must be (tiles, {PLAN_COLS}) int32 on {q.device} with 1..{t} "
                         f"rows (paged_tile_plan), got {tuple(plan.shape)} {plan.dtype}")
    plan = plan.contiguous()
    tiles = plan.shape[0]
    splits, per_split = split_blocks(tiles * kvh, num_blocks, _sm_count(q.device.index),
                                     inst.ctas_per_sm)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((t, kvh, splits, h // kvh, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((t, kvh, splits, h // kvh, 2), dtype=torch.float32,
                              device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_attention(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(k_scale), _ptr(v_scale),
            _ptr(tables), _ptr(q_pos), _ptr(plan), _ptr(out), _ptr(part_acc),
            _ptr(part_ml), t, tiles, h, kvh, d, num_pages, page_size, num_slots, num_blocks,
            splits, per_split, int(window), float(softcap), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), int(quantized), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged-attention kernel launch failed (code {err})")
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0


# ---------------------------------------------------------------------------
# training: flash attention forward and backward
# ---------------------------------------------------------------------------

#: (head dim, H / KV) the training source is built and held for: its
#: kernels are templates on the head dim (64, 128 and 256 instantiated) and
#: take any group; these are the configs the port trains
TRAINED = {(128, 8), (64, 1), (256, 10)}  # qwen2.5-3b; the BERT models; recurrentgemma-2b
_LL = ctypes.c_longlong
#: tile sizes of ``flash_attention.cu``: a forward / dQ CTA takes 128 query
#: rows (two warpgroups of 64) and walks 64-key steps; a dK/dV CTA takes 64
#: keys and walks 64-row query steps
TILE, STEP = 128, 64
#: kinds of schedule: (outer, inner) tile sizes, the outer axis a CTA owns
#: and the inner axis it walks (``"fwd"``: query tiles over key tiles;
#: ``"dkdv"``: key tiles over query steps; ``"dq"``: query tiles over key steps)
PLAN_KINDS = {"fwd": (TILE, STEP), "dkdv": (STEP, STEP), "dq": (TILE, STEP)}


def load_train_library() -> ctypes.CDLL:
    """Build (first use) and load ``flash_attention.cu``; sets the C signatures."""
    lib = _build.load(TRAIN_SOURCE)
    if getattr(lib, "_signed", False):
        return lib
    lib._signed = True
    lib.repro_flash_attention_fwd.argtypes = [_P] * 8 + [_I] * 6 + [_P, _I, _I, _F, _P]
    lib.repro_flash_attention_bwd.argtypes = [_P] * 16 + [_I] * 6 + [_P, _I, _I, _F, _P]
    lib.repro_flash_attention_fwd.restype = ctypes.c_int
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    return lib


class UnbuiltShapeError(ValueError):
    """A shape or dtype that a kernel is not built for: training attention
    at a head dim, group, dtype or sequence length ``flash_attention.cu``
    does not take, or SSD inputs at a state size, head dim, dtype or chunk
    length ``ssd_chunk.cu`` does not take (``kernels.ssd_chunk`` raises this
    class too, so one ``except`` covers both)."""


def _length_ok(s: int) -> bool:
    return s > 0 and s % 64 == 0 and (s <= 128 or s % 128 == 0)


def require_trained(head_dim: int, group: int, dtype: torch.dtype, *lengths: int) -> None:
    """Raise ``UnbuiltShapeError`` unless the training kernels take attention
    with this head dim, group (H / KV), dtype and query / key lengths."""
    if (head_dim, group) not in TRAINED:
        raise UnbuiltShapeError(f"head dim {head_dim} and group H/KV = {group}: the kernels "
                                f"are built for (head dim, group) in {sorted(TRAINED)}")
    if dtype != torch.bfloat16:
        raise UnbuiltShapeError(f"the kernels take bfloat16 q, k, v, not {dtype}")
    if not all(_length_ok(s) for s in lengths):
        raise UnbuiltShapeError(f"sequence lengths {lengths}: the kernels take multiples "
                                f"of 64, and of 128 above 128")


def _key_ranges(sq: int, sk: int, causal: bool, window: int):
    """Per query row, the admissible keys ``[lo, hi)`` by the causal and
    window terms (right-aligned positions; empty when hi <= lo)."""
    qpos = np.arange(sq) + sk - sq
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return lo, np.maximum(hi, lo)


def _query_ranges(sq: int, sk: int, causal: bool, window: int):
    """Per key, the query rows ``[lo, hi)`` that admit it."""
    kpos = np.arange(sk) - (sk - sq)  # the row whose position is the key's
    lo = np.clip(kpos, 0, sq) if causal else np.zeros(sk, np.int64)
    hi = np.clip(kpos + window, 0, sq) if window > 0 else np.full(sk, sq)
    return lo, np.maximum(hi, lo)


@functools.lru_cache(maxsize=None)
def tile_plan(kind: str, sq: int, sk: int, causal: bool, window: int) -> np.ndarray:
    """The schedule a training kernel reads: one row per CTA, in launch
    order (the longest walk first, so the causal triangle's heavy tiles do
    not run in the last wave), of six int32 columns

        (outer start, inner lo, inner hi, free lo, free hi, inner end)

    A CTA owns ``outer`` elements from ``outer start`` (query rows for
    ``"fwd"`` / ``"dq"``, keys for ``"dkdv"``) and walks inner tiles
    ``[inner lo, inner hi)`` (indices in units of ``PLAN_KINDS[kind][1]``);
    tiles in ``[free lo, free hi)`` hold only admissible pairs by the causal
    and window terms and skip the mask (with segment ids every tile is
    masked); inner elements at or past ``inner end`` are out of range.

    ``"fwd"`` walks the TPU kernel's visited range at its default 128/128
    blocks (``src/repro/kernels/flash_attention.py:45-53``), so a query
    with no admissible key gets the mean of the same values; the backward
    plans walk every tile holding an admissible pair, and only those."""
    outer_n, inner = PLAN_KINDS[kind]
    n_outer, n_inner = (sk, sq) if kind == "dkdv" else (sq, sk)
    lo, hi = (_query_ranges if kind == "dkdv" else _key_ranges)(sq, sk, causal, window)
    rows = []
    for start in range(0, n_outer, outer_n):
        a, b = lo[start:start + outer_n], hi[start:start + outer_n]
        end = n_inner
        if kind == "fwd":  # _attn_kernel's lo / hi for the block holding these rows
            bq, bk = min(128, sq), min(128, sk)
            t_hi = sk // bk
            if causal:
                t_hi = min((start + bq - 1 + sk - sq) // bk + 1, t_hi)
            t_lo = max((start + sk - sq - window + 1) // bk, 0) if window > 0 else 0
            end = max(t_hi, 0) * bk
            s_lo, s_hi = t_lo * bk // inner, -(-end // inner)
        else:
            some = b > a
            s_lo = int(a[some].min()) // inner if some.any() else 0
            s_hi = -(-int(b[some].max()) // inner) if some.any() else 0
        f_lo = -(-int(a.max()) // inner)
        f_hi = min(int(b.min()), end) // inner
        f_lo, f_hi = max(f_lo, s_lo), min(f_hi, s_hi)
        if f_hi <= f_lo:
            f_lo = f_hi = s_lo
        rows.append((start, s_lo, max(s_hi, s_lo), f_lo, f_hi, end))
    plan = np.array(rows, dtype=np.int32).reshape(-1, 6)
    order = np.argsort(-(plan[:, 2] - plan[:, 1]), kind="stable")
    plan = plan[order]
    plan.flags.writeable = False
    return plan


@functools.lru_cache(maxsize=None)
def _plan_tensor(kind: str, sq: int, sk: int, causal: bool, window: int,
                 device: torch.device) -> torch.Tensor:
    """``tile_plan`` on the device, made once per shape (so a CUDA-graph
    capture of a later call allocates nothing)."""
    return torch.from_numpy(tile_plan(kind, sq, sk, causal, window).copy()).to(device)


def _check_train(q, k, v, q_segment_ids, kv_segment_ids):
    """Raise on anything the training kernels do not take; return
    (b, h, kvh, sq, sk, d) and the segment ids as contiguous, 16-byte
    aligned int32 (the kernels copy them to shared memory in bulk)."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernels take CUDA tensors, got {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, H, Sq, D) and equal k, v (B, KV, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kb, kvh, sk, dk = k.shape
    if kb != b or dk != d or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair: want equal "
                         f"batch and head dim, and H a multiple of KV")
    require_trained(d, h // kvh, q.dtype, sq, sk)
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    if q_segment_ids is not None:
        if q_segment_ids.shape != (b, sq) or kv_segment_ids.shape != (b, sk):
            raise ValueError("segment ids must have shapes (B, Sq) and (B, Sk)")
        q_segment_ids = _aligned(q_segment_ids.to(q.device, torch.int32).contiguous())
        kv_segment_ids = _aligned(kv_segment_ids.to(q.device, torch.int32).contiguous())
    return (b, h, kvh, sq, sk, d), q_segment_ids, kv_segment_ids


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` when it starts on a 16-byte boundary, else a fresh copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows are D contiguous elements at 16-byte
    aligned addresses (every stride of an axis longer than 1 a positive
    multiple of 8 elements: what a TMA tensor map takes), else a
    contiguous copy."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s, n in zip(x.stride()[:-1], x.shape) if n > 1)):
        return x
    return x.contiguous()


def _strides(*xs):
    """(batch, head, position) element strides of each (B, heads, S, D)
    tensor; an axis of length 1 gets its contiguous stride (it is never
    stepped along, and the tensor map wants a positive multiple of 16 bytes)."""
    flat = []
    for x in xs:
        for i in range(3):
            flat.append(x.stride(i) if x.shape[i] > 1 else math.prod(x.shape[i + 1:]))
    return (_LL * len(flat))(*flat)


def flash_attention_fwd(q, k, v, causal=True, window=0, q_segment_ids=None,
                        kv_segment_ids=None):
    """(out (B, H, Sq, D), lse (B, H, Sq) f32) from the CUDA forward kernel.

    ``out`` is laid out as (B, Sq, H, D) in memory (a transposed view is
    returned), the model's activation layout."""
    dims, qs, ks = _check_train(q, k, v, q_segment_ids, kv_segment_ids)
    b, h, kvh, sq, sk, d = dims
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    plan = _plan_tensor("fwd", sq, sk, bool(causal), int(window), q.device)
    lib = load_train_library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(qs), _ptr(ks), _ptr(plan),
            b, h, kvh, sq, sk, d, _strides(q, k, v, out), int(causal), int(window),
            1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash-attention forward launch failed (code {err})")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=0,
                        q_segment_ids=None, kv_segment_ids=None):
    """(dq, dk, dv), each in its input's layout, from the CUDA backward:
    delta = rowsum(dO * O); dK, dV per (key tile, query head) as f32
    partials, summed over each group in a fixed order; dQ by a second pass.
    Deterministic, no atomics."""
    dims, qs, ks = _check_train(q, k, v, q_segment_ids, kv_segment_ids)
    b, h, kvh, sq, sk, d = dims
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError("out and dout must have q's shape, lse (B, H, Sq)")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("out and dout must have q's dtype, lse float32")
    q, k, v, out, dout = (_rows(x) for x in (q, k, v, out, dout))
    lse = _aligned(lse.contiguous())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.stride() != q.stride() or dk.stride() != k.stride() or dv.stride() != v.stride():
        raise RuntimeError("gradient buffers must share their inputs' strides")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dk_part = torch.empty((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv_part = torch.empty_like(dk_part)
    plans = [_plan_tensor(kind, sq, sk, bool(causal), int(window), q.device)
             for kind in ("dkdv", "dq")]
    lib = load_train_library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse), _ptr(delta),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dk_part), _ptr(dv_part), _ptr(qs), _ptr(ks),
            _ptr(plans[0]), _ptr(plans[1]), b, h, kvh, sq, sk, d,
            _strides(q, k, v, out, dout), int(causal), int(window), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash-attention backward launch failed (code {err})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
