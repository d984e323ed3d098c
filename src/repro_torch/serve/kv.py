"""The KV-cache API (port of ``repro.serve.kv``).

    spec = KVCacheSpec(num_slots=8, max_len=512, layout="paged")
    kv = spec.build(params, cfg)            # -> KVCache (host handle)
    logits, kv.state = prefill_chunk(params, cfg, kv.state, ...)

``KVCache.state`` is a :class:`KVState` the model paths accept wherever
they accept the dense cache dict.  Two interchangeable layouts:

* :class:`DenseSlots` — one worst-case ``(max_len,)`` row per slot; the
  parity oracle.
* :class:`Paged` — a flat ``(num_pages, page_size, KV, D)`` pool per layer
  plus per-slot block tables (``serve.block_table``), with ref-counted
  prefix sharing and copy-on-write.  ``kv_dtype="int8"`` stores pages as
  int8 with per-(row, kv head) f32 scales.

'R' (RG-LRU) and 'M' (Mamba-2) layers carry slot-indexed ``{"rglru":
{"conv", "h"}}`` and ``{"ssd": {"conv", "state"}}`` leaves in both
layouts, beside the page pools and never addressed through the block
tables: admission zeroes a slot's rows, prefix sharing is off
(a shared page would skip the prompt tokens the carried state must scan)
and ``trim_slot`` refuses (the state has consumed the trimmed tokens).

Pools live on the parameters' device and are updated in place by the
model paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from ..models import layers as L
from ..models.config import torch_dtype
from ..models.model import (
    UnsupportedPatternError,
    init_decode_cache,
    params_device,
    require_chunkable,
)
from ..models.transformer import _unit_and_groups, init_block_cache, tree_leaves, tree_map
from .block_table import PagedTables

Tree = Any


@dataclasses.dataclass(frozen=True)
class KVState:
    """Device KV state: the per-layer cache tree plus, for the paged
    layout, the block-table tensor.  ``page_size == 0`` means dense slots
    (``tables`` is ``None`` and ``data`` is the dense cache dict)."""

    data: Tree
    tables: Optional[torch.Tensor] = None  # (num_slots, num_blocks) int32
    page_size: int = 0

    @property
    def is_paged(self) -> bool:
        return self.page_size > 0


#: the per-layer cache keys of recurrent state: slot-indexed, never paged
RECURRENT_KEYS = ("rglru", "ssd")


def _layer_leaves(data: Tree, recurrent: bool):
    """(leaf, grouped) for the recurrent (``recurrent=True``) or the
    attention leaves of a cache tree; ``grouped`` leaves carry a leading
    ``n_groups`` dim ahead of the page or slot axis."""
    stack = data["stack"]
    for grouped, layers in ((True, stack["groups"]), (False, stack["tail"])):
        for layer in layers:
            for key, sub in layer.items():
                if (key in RECURRENT_KEYS) == recurrent:
                    yield from ((x, grouped) for x in tree_leaves(sub))


def copy_pages_state(state: KVState, ops: Sequence[Tuple[int, int]]) -> KVState:
    """Apply ``(src, dst)`` page copies to every pool leaf, in place (the
    device half of copy-on-write).  Recurrent leaves are slot-indexed,
    not page-indexed, and pass through untouched."""
    if not ops:
        return state
    dev = state.tables.device
    src = torch.tensor([s for s, _ in ops], dtype=torch.long, device=dev)
    dst = torch.tensor([d for _, d in ops], dtype=torch.long, device=dev)
    for x, grouped in _layer_leaves(state.data, recurrent=False):
        if grouped:  # (n_groups, num_pages, ...)
            x[:, dst] = x[:, src]
        else:  # (num_pages, ...)
            x[dst] = x[src]
    return state


def reset_recurrent_state(data: Tree, slots) -> Tree:
    """Zero the recurrent rows of ``slots`` in a cache tree (the dense dict
    or ``KVState.data``), in place: a freed slot's conv window and SSM
    state must not seed its next tenant.  Attention leaves are untouched
    (their rows are position-masked)."""
    for x, grouped in _layer_leaves(data, recurrent=True):
        if grouped:  # (n_groups, num_slots, ...)
            x[:, list(slots)] = 0
        else:
            x[list(slots)] = 0
    return data


def copy_recurrent_state(data: Tree, src: int, dst: int) -> Tree:
    """Copy slot ``src``'s recurrent rows onto ``dst``, in place (the fork
    path: an eager copy, since the next step rewrites the row anyway)."""
    for x, grouped in _layer_leaves(data, recurrent=True):
        if grouped:
            x[:, dst] = x[:, src]
        else:
            x[dst] = x[src]
    return data


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


class DenseSlots:
    """One ``(max_len,)`` row of KV per slot — the worst-case layout and
    the parity oracle for :class:`Paged`."""

    name = "dense"

    @staticmethod
    def build_data(spec: "KVCacheSpec", params: Tree, cfg) -> Tree:
        return init_decode_cache(params, cfg, spec.num_slots, spec.max_len, linear=True)

    @staticmethod
    def index(slot, position):
        """(slot, position) -> physical (row, column): the identity."""
        return slot, position


class Paged:
    """Flat page pool + block tables; ``index`` is the translation the
    attention paths use."""

    name = "paged"
    index = staticmethod(L.paged_index)

    @staticmethod
    def build_data(spec: "KVCacheSpec", params: Tree, cfg) -> Tree:
        require_chunkable(cfg, "the paged KV layout")
        num_pages, ps = spec.resolve_pages(cfg), spec.page_size
        kv, hd = cfg.n_kv_heads, cfg.hd
        dtype = spec.resolved_kv_dtype(cfg)
        dev = params_device(params)

        def one_layer(kind, lead):
            if kind in ("R", "M"):
                # recurrent state is O(1) per slot: the dense layout's
                # slot-indexed rows, beside the page pools
                one = init_block_cache(cfg, kind, spec.num_slots, 1, device=dev)
                return tree_map(lambda x: x.expand(lead + tuple(x.shape)).clone(), one)
            # one spare page past each layer's pool (index num_pages, the
            # tables' unallocated sentinel, so K4 masks it and never reads
            # it): the writes the reference drops land there
            layer = {name: L.pool_with_spare(lead, num_pages, (ps, kv, hd), dtype, dev)
                     for name in ("k", "v")}
            if spec.kv_dtype == "int8":
                # per-row dequant scales (1.0 = the all-zero rows' identity
                # scale, matching the write path's convention)
                for name in ("k_scale", "v_scale"):
                    layer[name] = L.pool_with_spare(lead, num_pages, (ps, kv), torch.float32,
                                                    dev, fill=1.0)
            return {"attn": layer}

        unit, n_groups, tail = _unit_and_groups(cfg)
        groups = tuple(one_layer(kind, (n_groups,)) for kind in unit)
        tail_cs = [one_layer(cfg.pattern[n_groups * len(unit) + i], ()) for i in range(tail)]
        return {"stack": {"groups": groups, "tail": tail_cs}}


_LAYOUTS = {DenseSlots.name: DenseSlots, Paged.name: Paged}


# ---------------------------------------------------------------------------
# Spec + host handle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Declarative description of a serving KV cache (see the reference's
    ``KVCacheSpec``): ``num_slots`` concurrent requests, ``max_len``
    positions per slot, ``layout`` dense|paged, ``page_size``,
    ``num_pages`` (None = worst case ``num_slots * blocks_per_slot``) and
    ``kv_dtype`` (paged only: None = compute dtype, "int8" = quantized
    pages with per-row scales, or a float dtype name)."""

    num_slots: int
    max_len: int
    layout: str = "dense"
    page_size: int = 16
    num_pages: Optional[int] = None
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        if self.layout not in _LAYOUTS:
            raise ValueError(f"unknown KV layout {self.layout!r}; want dense|paged")
        if self.num_slots < 1 or self.max_len < 1 or self.page_size < 1:
            raise ValueError(  # typed, not assert: must survive python -O
                f"KVCacheSpec sizes must be >= 1: num_slots={self.num_slots}, "
                f"max_len={self.max_len}, page_size={self.page_size}"
            )
        if self.kv_dtype is not None:
            if self.layout != "paged":
                raise ValueError("kv_dtype is a paged-layout knob; dense slots "
                                 "always use the compute dtype")
            torch_dtype(self.kv_dtype)  # raises on unknown dtype strings

    @property
    def layout_cls(self):
        return _LAYOUTS[self.layout]

    def buffer_len(self, cfg) -> int:
        """Logical per-slot buffer length: sliding-window layers need
        ``window + 1`` rows even when ``max_len`` is shorter."""
        buf = self.max_len
        if "L" in cfg.pattern:
            buf = max(buf, cfg.sliding_window + 1)
        return buf

    def blocks_per_slot(self, cfg) -> int:
        return -(-self.buffer_len(cfg) // self.page_size)

    def resolve_pages(self, cfg) -> int:
        if self.num_pages is not None:
            return self.num_pages
        return self.num_slots * self.blocks_per_slot(cfg)

    def resolved_kv_dtype(self, cfg) -> torch.dtype:
        return torch_dtype(self.kv_dtype) if self.kv_dtype is not None else cfg.compute_dtype

    def bytes_per_token(self, cfg) -> int:
        """Pool bytes one cached token costs across all attention layers
        (k + v rows, plus the per-row f32 scales for int8 pages)."""
        itemsize = torch.empty((), dtype=self.resolved_kv_dtype(cfg)).element_size()
        per_tok = 2 * cfg.n_kv_heads * cfg.hd * itemsize
        if self.kv_dtype == "int8":
            per_tok += 2 * cfg.n_kv_heads * 4
        n_attn = sum(1 for k in cfg.pattern if k in "GLB")
        return per_tok * n_attn

    def bytes_per_page(self, cfg) -> int:
        return self.page_size * self.bytes_per_token(cfg)

    def pages_for_bytes(self, cfg, budget_bytes: int) -> int:
        return budget_bytes // self.bytes_per_page(cfg)

    def memory_bytes(self, cfg) -> int:
        """Cache bytes this spec allocates (all layers)."""
        if self.layout == "paged":
            return self.resolve_pages(cfg) * self.bytes_per_page(cfg)
        return self.num_slots * self.buffer_len(cfg) * self.bytes_per_token(cfg)

    def build(self, params: Tree, cfg) -> "KVCache":
        return KVCache(self, params, cfg)


class KVCache:
    """Host handle pairing a :class:`KVState` with its page bookkeeping.

    The engine calls the mutators (``admit_slot`` / ``share`` /
    ``prepare_step`` / ``free_slot`` / ``fork_slot``) between steps; each
    keeps the device block tables in sync (uploaded lazily, once per
    ``state`` read).  For the dense layout they are no-ops."""

    def __init__(self, spec: KVCacheSpec, params: Tree, cfg):
        self.spec = spec
        self.cfg = cfg
        self.device = params_device(params)
        self._dirty = False
        data = spec.layout_cls.build_data(spec, params, cfg)
        if spec.layout == "paged":
            self.tables: Optional[PagedTables] = PagedTables(
                spec.num_slots, spec.blocks_per_slot(cfg), spec.resolve_pages(cfg),
                spec.page_size,
            )
            tables = torch.as_tensor(self.tables.device_tables(), device=self.device)
            self._state = KVState(data=data, tables=tables, page_size=spec.page_size)
        else:
            self.tables = None
            self._state = KVState(data=data, tables=None, page_size=0)

    @property
    def state(self) -> KVState:
        """Device KV state; host table mutations are uploaded here, once
        per read after any number of mutations, into the one device tables
        tensor the cache keeps (a step captured in a CUDA graph reads it at
        a fixed address)."""
        if self._dirty:
            self._state.tables.copy_(torch.from_numpy(self.tables.device_tables()))
            self._dirty = False
        return self._state

    @state.setter
    def state(self, new: KVState) -> None:
        self._state = new

    @property
    def has_recurrent(self) -> bool:
        """True when the pattern carries per-slot recurrent state leaves."""
        return bool(set(self.cfg.pattern) & {"R", "M"})

    @property
    def page_size(self) -> int:
        return self.spec.page_size if self.tables is not None else 0

    @property
    def num_pages(self) -> int:
        return self.tables.num_pages if self.tables is not None else 0

    @property
    def used_pages(self) -> int:
        return self.tables.used_pages if self.tables is not None else 0

    def memory_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(self._state.data))

    def sync(self) -> None:
        """Mark the device block tables stale (no-op for dense)."""
        if self.tables is not None:
            self._dirty = True

    def reset_accounting(self) -> None:
        """Rebaseline ``touched_pages`` without dropping live or cached pages."""
        if self.tables is not None:
            self.tables.reset_touched()

    def check_invariants(self) -> None:
        """Page-accounting invariants (``PagedTables.check_invariants``)."""
        if self.tables is not None:
            self.tables.check_invariants()

    # -- mutators (no-ops for DenseSlots) -----------------------------------

    def admit_slot(self, slot: int, prompt, max_new: int) -> Optional[int]:
        """Reserve pages for a request; returns prompt tokens covered by
        shared prefix pages, or None when the pool cannot hold it yet.
        The slot's recurrent rows are zeroed in both layouts (the previous
        tenant's state must not seed the new request)."""
        if self.tables is None:
            if self.has_recurrent:
                reset_recurrent_state(self._state.data, [slot])
            return 0
        shared = self.tables.admit(slot, prompt, max_new)
        if shared is not None:
            if self.has_recurrent:
                reset_recurrent_state(self._state.data, [slot])
            self.sync()
        return shared

    def probe_shared(self, prompt) -> int:
        """Prompt tokens the prefix cache could supply right now (never
        any for recurrent patterns: sharing is attention-only)."""
        if self.tables is None or self.has_recurrent:
            return 0
        return self.tables.probe_shareable(prompt)

    def share(self, slot: int, prompt, pos: int) -> int:
        """Map prefix-cache pages covering ``prompt`` from ``pos`` on.
        Disabled for recurrent patterns: a shared page lets the engine skip
        prefilling those tokens, but the carried state must scan every
        prompt token, so nothing is shared (or published, see
        ``register_prompt_pages``)."""
        if self.tables is None or self.has_recurrent:
            return 0
        n = self.tables.try_share(slot, prompt, pos)
        if n:
            self.sync()
        return n

    def prepare_step(self, grants) -> None:
        """Allocate/COW the pages the step's grants will write, apply any
        copy-on-write page copies on the device, sync the tables."""
        if self.tables is None:
            return
        ops = []
        for slot, pos0, toks in grants:
            ops += self.tables.prepare_write(slot, pos0, len(toks))
        if ops:
            copy_pages_state(self._state, ops)
        self.sync()

    def prepare_write(self, slot: int, start: int, n: int) -> None:
        self.prepare_step([(slot, start, [0] * n)])

    def register_prompt_pages(self, slot: int, prompt, upto: int) -> None:
        """Publish fully-written prompt pages into the prefix cache
        (nothing for recurrent patterns: an empty prefix cache is what keeps
        ``admit`` from mapping shared pages for them)."""
        if self.tables is not None and not self.has_recurrent:
            self.tables.register_prompt_pages(slot, prompt, upto)

    def trim_slot(self, slot: int, keep_tokens: int) -> int:
        """Drop the blocks of ``slot`` past ``keep_tokens`` positions.
        Recurrent patterns refuse: the carried state has already consumed
        the trimmed tokens and cannot roll back."""
        if self.has_recurrent:
            raise UnsupportedPatternError(
                "trim_slot cannot roll back recurrent state ('R'/'M' layers): the "
                "carried state already consumed the trimmed tokens; rollback is "
                "attention-only")
        if self.tables is None:
            return 0
        n = self.tables.trim(slot, keep_tokens)
        if n:
            self.sync()
        return n

    def free_slot(self, slot: int) -> None:
        if self.tables is not None:
            self.tables.free_slot(slot)
            self.sync()

    def fork_slot(self, parent: int, child: int) -> None:
        """Share every page of ``parent`` with ``child`` (copy-on-write on
        the next write); recurrent rows are copied eagerly.  Dense layout:
        unsupported."""
        if self.tables is None:
            raise NotImplementedError("fork_slot requires the paged layout")
        self.tables.fork(parent, child)
        if self.has_recurrent:
            copy_recurrent_state(self._state.data, parent, child)
        self.sync()
