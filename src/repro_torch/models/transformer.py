"""Block assembly for G/L attention, 'B' encoder, 'R' (RG-LRU) and 'M'
(Mamba-2) stacks (port of ``repro.models.transformer``).

Layers are organised as in the reference (``transformer.py:188-206``):

    n_groups repetitions of the pattern unit   (params stacked on dim 0)
  + a tail of (n_layers % unit) explicit layers

so the parameter and cache trees have the reference's ``groups`` tuple
plus ``tail`` list.  The reference's ``lax.scan`` over groups becomes a
loop over the stacked slices (views, so cache writes land in the stacked
storage).  Serving has no remat; training (no caches) rematerialises each
group under ``cfg.remat`` (``transformer.py:269``, ``:298``) with
``torch.utils.checkpoint``, and slices a stacked leaf with one ``unbind``
so its gradient is stacked once, not summed from per-layer full-size
zeros.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import rglru as RG
from . import ssm as SSD
from .config import ModelConfig
from .recurrent import packed_step

Tree = Any


def tree_map(fn, tree: Tree) -> Tree:
    """Apply ``fn`` to every tensor leaf of a dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Tree) -> list:
    """Tensor leaves in the order ``tree_map`` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template: Tree, leaves) -> Tree:
    """The tree shaped like ``template`` with its leaves, in ``tree_leaves``
    order, replaced by ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def init_block(gen, cfg: ModelConfig, kind: str, device=None) -> Tree:
    if kind == "M":  # ``transformer.py:88-89``: one norm and the SSD mixer
        return {"norm1": L.init_norm(cfg, device=device),
                "ssd": SSD.init_ssd(gen, cfg, device=device)}
    if kind == "R":  # ``transformer.py:84-87``: the RG-LRU mixer and an MLP
        key, init_mixer = "rglru", RG.init_rglru
    elif kind in ("G", "L", "B"):  # ``transformer.py:73-83``: 'B' has 'G''s tree
        key, init_mixer = "attn", L.init_attention
    else:
        raise ValueError(f"the port builds 'G'/'L'/'B'/'R'/'M' blocks, got {kind!r}")
    return {
        "norm1": L.init_norm(cfg, device=device),
        key: init_mixer(gen, cfg, device=device),
        "norm2": L.init_norm(cfg, device=device),
        "mlp": L.init_mlp(gen, cfg, device=device),
    }


def apply_block(p: Tree, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor, cache: Tree, decode_pos=None,
                seq_lens=None, slot_ids=None, page_tables=None,
                page_size: int = 0, index=None, rope=None) -> Tuple[torch.Tensor, Tree]:
    """Returns (x, cache); the cache is updated in place.  ``index`` is the
    step's ``layers.step_index`` for a 'G'/'L' kind (made here when None),
    its ``recurrent.packed_step`` for 'R' and 'M' on a packed step.
    ``cache=None`` runs the training path (``rope``: the sequence's RoPE
    angles, made once per forward); a 'B' block runs only there, as 'G'
    does but with bidirectional attention (``transformer.py:114-143``)."""
    h = L.apply_norm(p["norm1"], x, cfg)
    if kind == "M":  # ``transformer.py:156-167``
        y, _ = SSD.apply_ssd(p["ssd"], h, cfg, None if cache is None else cache["ssd"],
                             seq_lens=seq_lens, slot_ids=slot_ids, step=index)
        return x + y, cache
    if kind == "R":  # ``transformer.py:144-155``
        y, _ = RG.apply_rglru(p["rglru"], h, cfg, None if cache is None else cache["rglru"],
                              seq_lens=seq_lens, slot_ids=slot_ids, step=index)
    else:
        y, _ = L.apply_attention(
            p["attn"], h, cfg, kind, positions, None if cache is None else cache["attn"],
            decode_pos=decode_pos, seq_lens=seq_lens, slot_ids=slot_ids,
            page_tables=page_tables, page_size=page_size, index=index, rope=rope,
        )
    x = x + y
    h = L.apply_norm(p["norm2"], x, cfg)
    x = x + L.apply_mlp(p["mlp"], h, cfg)
    return x, cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     linear: bool = False, device=None, lead: Tuple[int, ...] = ()) -> Tree:
    """One block's serving cache (``lead``: leading dims, a group's stacked
    layers)."""
    if kind in ("R", "M"):  # slot-indexed conv window and recurrence state
        key, init = ("rglru", RG.init_rglru_cache) if kind == "R" else ("ssd", SSD.init_ssd_cache)
        one = init(cfg, batch, device="meta")
        return {key: tree_map(lambda x: torch.zeros(lead + tuple(x.shape), dtype=x.dtype,
                                                    device=device), one)}
    return {"attn": L.init_attention_cache(cfg, kind, batch, seq_len, linear=linear,
                                           device=device, lead=lead)}


def _unit_and_groups(cfg: ModelConfig) -> Tuple[str, int, int]:
    unit = cfg.layer_pattern
    n_groups = cfg.n_layers // len(unit)
    tail = cfg.n_layers % len(unit)
    return unit, n_groups, tail


def _stacked(make, n: int) -> Tree:
    """Stack ``n`` trees from ``make()`` on a new dim 0, one at a time (the
    stacked storage is allocated once; no list of n trees is held)."""
    first = make()
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    for i in range(n):
        one = first if i == 0 else make()
        for dst, src in zip(tree_leaves(out), tree_leaves(one)):
            dst[i].copy_(src)
    return out


def init_stack(gen, cfg: ModelConfig, device=None) -> Tree:
    unit, n_groups, tail = _unit_and_groups(cfg)
    groups = tuple(
        _stacked(lambda kind=kind: init_block(gen, cfg, kind, device=device), n_groups)
        for kind in unit
    )
    tail_ps = [
        init_block(gen, cfg, cfg.pattern[n_groups * len(unit) + i], device=device)
        for i in range(tail)
    ]
    return {"groups": groups, "tail": tail_ps}


def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     linear: bool = False, device=None) -> Tree:
    unit, n_groups, tail = _unit_and_groups(cfg)
    groups = tuple(
        init_block_cache(cfg, kind, batch, seq_len, linear=linear, device=device,
                         lead=(n_groups,))
        for kind in unit
    )
    tail_cs = [
        init_block_cache(cfg, cfg.pattern[n_groups * len(unit) + i], batch, seq_len,
                         linear=linear, device=device)
        for i in range(tail)
    ]
    return {"groups": groups, "tail": tail_cs}


def _apply_stack_train(params: Tree, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor) -> torch.Tensor:
    """Every layer without caches (training / plain forward).  Under
    ``cfg.remat`` with grad enabled, each group's blocks run inside one
    ``checkpoint`` (as the reference's ``jax.checkpoint(group_body)``) and
    each tail block in its own: only the group inputs stay alive, and the
    backward runs each group's forward again.  No block draws random
    numbers (no dropout), so the recomputation needs no saved RNG state
    (``preserve_rng_state=False``: saving it would read the generator's
    state, which a CUDA-graph capture of the step refuses)."""
    unit, n_groups, _ = _unit_and_groups(cfg)
    rope = (L.rope_angles(positions, cfg.hd, cfg.rope_theta) if cfg.pos == "rope" else None)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(x_, blocks, kinds):
        for p, kind in zip(blocks, kinds):
            x_ = apply_block(p, x_, cfg, kind, positions, None, rope=rope)[0]
        return x_

    # one unbind per stacked leaf: its backward stacks the layers' gradients
    # once (indexing each layer would add a full-size zeros tensor per layer)
    slices = [[leaf.unbind(0) for leaf in tree_leaves(g)] for g in params["groups"]]
    for gi in range(n_groups):
        blocks = [tree_unflatten(params["groups"][j], [u[gi] for u in slices[j]])
                  for j in range(len(unit))]
        x = (checkpoint(run, x, blocks, unit, use_reentrant=False, preserve_rng_state=False)
             if remat else run(x, blocks, unit))
    for i, p in enumerate(params["tail"]):
        kinds = cfg.pattern[n_groups * len(unit) + i]
        x = (checkpoint(run, x, [p], kinds, use_reentrant=False, preserve_rng_state=False)
             if remat else run(x, [p], kinds))
    return x


def apply_stack(params: Tree, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, caches: Optional[Tree] = None, decode_pos=None,
                seq_lens=None, slot_ids=None, page_tables=None,
                page_size: int = 0, plans=None) -> Tuple[torch.Tensor, Tree]:
    """Apply every layer.  Over a serving cache, returns (x, caches) with
    the caches updated in place (group slices are views), the step's
    addressing (``layers.step_index``, given ``plans[kind]``, the paged
    kernel's tile plan of each attention kind, when ``plans`` is a dict;
    for 'R' and 'M' on a packed step, ``recurrent.packed_step``) made once
    per layer kind.  With ``caches=None`` (training), returns (x, None)."""
    if caches is None:
        return _apply_stack_train(params, x, cfg, positions), None
    unit, n_groups, tail = _unit_and_groups(cfg)
    kw = dict(decode_pos=decode_pos, seq_lens=seq_lens, slot_ids=slot_ids,
              page_tables=page_tables, page_size=page_size)
    indices = {}

    def block(p, kind, c, x):
        if kind not in indices:
            if kind in ("R", "M"):
                slots, k = ((c["rglru"]["h"].shape[0], cfg.rglru_conv) if kind == "R"
                            else (c["ssd"]["state"].shape[0], cfg.ssm_conv))
                indices[kind] = None if slot_ids is None else packed_step(slot_ids, slots, k)
            else:
                indices[kind] = L.step_index(cfg, kind, positions, c["attn"], **kw,
                                             plan=(plans or {}).get(kind))
        return apply_block(p, x, cfg, kind, positions, c, index=indices[kind], **kw)[0]

    for gi in range(n_groups):
        for j, kind in enumerate(unit):
            p = tree_map(lambda t: t[gi], params["groups"][j])
            c = tree_map(lambda t: t[gi], caches["groups"][j])
            x = block(p, kind, c, x)
    for i, p in enumerate(params["tail"]):
        x = block(p, cfg.pattern[n_groups * len(unit) + i], caches["tail"][i], x)
    return x, caches
