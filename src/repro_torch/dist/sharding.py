"""Path-based sharding rules: one table for params, optimizer state, caches
(port of ``repro.dist.sharding``).

Every parameter leaf is addressed by its tree path (``stack/groups/0/attn/
wq``) and matched against a table of *logical* rules keyed by the trailing
path segments (``attn/wq``).  Rules are written for the un-stacked layer
shape and **right-aligned** against the actual leaf rank, so the stacked
variants (``groups/<i>/...`` with a leading n_groups dim) get the same spec
plus a leading ``None``, and optimizer moments, whose paths are the
parameter paths under an ``m`` / ``v`` / ``mu`` prefix, match the same
suffixes (ZeRO sharding falls out of the table).

A spec is a plain tuple, one entry a dimension: ``None`` (not split), an
axis name, or a tuple of names (split over their product).  A one-name
tuple is written as its name, as ``jax.sharding.PartitionSpec`` normalises
it, so a spec here equals ``tuple()`` of the reference's.  A tree's
placements are a tree of specs of the same structure.

Logical axes:

* ``FSDP = ("data",)``: parameter and optimizer storage is split over the
  data axis (ZeRO); "pod" is deliberately excluded: the pod axis is the
  pure-DP DropCompute All-Reduce domain, params are replicated across it.
* ``"model"``: tensor parallelism (d_model on "model").  The port refuses
  a model axis above 1 (``api.UnsupportedDistError``); a size-1 axis
  splits nothing.

``_fit_spec`` is the legality pass: any mesh axis (or axis group) that
does not evenly divide its dimension is dropped (outermost first, so
("pod", "data") degrades to ("data",) before giving up), and an axis is
never used twice in one spec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from .mesh import axes_size, dp_axes

Tree = Any
Spec = Tuple

FSDP: Tuple[str, ...] = ("data",)

# (path suffix, logical axes for the un-stacked shape), first match wins.
# Leaves with no matching rule are replicated.
RULES: Tuple[Tuple[str, Tuple], ...] = (
    # attention projections: (d, h, hd) / (h, hd, d)
    ("attn/wq", (FSDP, "model", None)),
    ("attn/wk", (FSDP, "model", None)),
    ("attn/wv", (FSDP, "model", None)),
    ("attn/wo", ("model", None, FSDP)),
    ("attn/bq", ("model", None)),
    ("attn/bk", ("model", None)),
    ("attn/bv", ("model", None)),
    ("cross_attn/wq", (FSDP, "model", None)),
    ("cross_attn/wk", (FSDP, "model", None)),
    ("cross_attn/wv", (FSDP, "model", None)),
    ("cross_attn/wo", ("model", None, FSDP)),
    # dense MLP: (d, f) / (f, d)
    ("mlp/w_in", (FSDP, "model")),
    ("mlp/w_gate", (FSDP, "model")),
    ("mlp/w_out", ("model", FSDP)),
    # MoE router: (d, e), d-sharded like the reference's apply_moe_spmd
    ("moe/router", ("model", None)),
    # embeddings: (V, d) / (d, V)
    ("embed/embedding", (FSDP, "model")),
    ("embed/unembed", (FSDP, "model")),
    ("embed/pos_embedding", (None, "model")),
    ("encoder/pos_embedding", (None, "model")),
    # RG-LRU (recurrentgemma): (d, dr) / (dr, d) / per-channel vectors
    ("rglru/w_branch", (FSDP, "model")),
    ("rglru/w_gate_branch", (FSDP, "model")),
    ("rglru/w_out", ("model", FSDP)),
    ("rglru/conv_w", (None, "model")),
    ("rglru/conv_b", ("model",)),
    ("rglru/gate_a_w", ("model",)),
    ("rglru/gate_a_b", ("model",)),
    ("rglru/gate_x_w", ("model",)),
    ("rglru/gate_x_b", ("model",)),
    ("rglru/lam", ("model",)),
    # Mamba-2 SSD: (d, proj) / (di, d) / per-channel vectors
    ("ssd/w_in", (FSDP, "model")),
    ("ssd/w_out", ("model", FSDP)),
    ("ssd/conv_w", (None, "model")),
    ("ssd/conv_b", ("model",)),
    ("ssd/norm_scale", ("model",)),
)


def _moe_expert_axes(leaf: str, shape: Sequence[int]) -> Optional[Tuple]:
    """Expert-TP factorization, shape-selected as the reference's
    ``apply_moe_spmd``: f < d (qwen3-like) shards d, f >= d (mixtral-like)
    shards f; the model axis lands on the larger of the two trailing dims,
    the expert dim is FSDP storage."""
    if len(shape) < 3:
        return None
    if leaf in ("w_in", "w_gate"):  # (e, d, f)
        d, f = shape[-2], shape[-1]
        return (FSDP, None, "model") if f >= d else (FSDP, "model", None)
    if leaf == "w_out":  # (e, f, d)
        f, d = shape[-2], shape[-1]
        return (FSDP, "model", None) if f >= d else (FSDP, None, "model")
    return None


def _logical_axes(segs: Sequence[str], shape: Sequence[int]) -> Optional[Tuple]:
    if len(segs) >= 2 and segs[-2] == "moe":
        axes = _moe_expert_axes(segs[-1], shape)
        if axes is not None:
            return axes
    for key, axes in RULES:
        ks = key.split("/")
        if len(segs) >= len(ks) and list(segs[-len(ks):]) == ks:
            return axes
    return None


def _fit_spec(shape: Sequence[int], axes: Sequence, mesh) -> Spec:
    """Drop mesh axes that don't divide their dim (outermost first) or were
    already used by an earlier dim; a group left with one name is written
    as that name."""
    used: set = set()
    out = []
    for dim, entry in zip(shape, axes):
        if entry is None:
            out.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        names = tuple(n for n in names if n in mesh.shape and n not in used)
        while names and dim % axes_size(mesh, names) != 0:
            names = names[1:]
        if not names:
            out.append(None)
            continue
        out.append(names[0] if len(names) == 1 else names)
        used.update(names)
    return tuple(out)


def spec_for_path(path: str, shape: Sequence[int], mesh) -> Spec:
    """The spec of one leaf, from its tree path and shape: the rule's
    logical axes right-aligned against ``shape`` (leading dims get
    ``None``: stacked ``groups/<i>/...`` leaves) and fitted to the mesh by
    ``_fit_spec``; ``()`` (replicated) where no rule matches."""
    segs = [s for s in str(path).split("/") if s]
    axes = _logical_axes(segs, shape)
    if axes is None:
        return ()
    axes = tuple(axes)
    if len(axes) >= len(shape):
        axes = axes[len(axes) - len(shape):]
    else:
        axes = (None,) * (len(shape) - len(axes)) + axes
    return _fit_spec(shape, axes, mesh)


# ---------------------------------------------------------------------------
# Tree-level placements
# ---------------------------------------------------------------------------


def _shape(x) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, ``()`` for a Python number (the
    optimizer's step count)."""
    return tuple(getattr(x, "shape", ()))


def map_with_path(fn, tree: Tree, prefix: str = "") -> Tree:
    """``fn(path, leaf)`` over a dict / tuple / list tree, the path joined
    by ``/`` as the reference's ``_path_str`` writes JAX's key paths (a
    dict level its key, a sequence level its index)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def zip_map(fn, tree: Tree, specs: Tree) -> Tree:
    """``fn(leaf, spec)`` over ``tree`` and its tree of specs, walked by
    ``tree``'s structure (a spec is itself a tuple)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def leaf_specs(tree: Tree, mesh) -> list:
    """The spec of every leaf of ``tree``, in ``tree_leaves`` order."""
    out: list = []
    map_with_path(lambda path, x: out.append(spec_for_path(path, _shape(x), mesh)), tree)
    return out


def tree_shardings(tree: Tree, mesh) -> Tree:
    """The spec of every leaf of ``tree`` (tensors, meta tensors, or Python
    numbers) by ``spec_for_path``; leaves no rule matches are ``()``."""
    return map_with_path(lambda path, x: spec_for_path(path, _shape(x), mesh), tree)


def param_shardings(params: Tree, mesh) -> Tree:
    return tree_shardings(params, mesh)


def opt_shardings(opt_state: Tree, mesh) -> Tree:
    """Optimizer-state placements (ZeRO): moment trees mirror the parameter
    paths under an ``m`` / ``v`` / ``mu`` prefix, so the same suffix rules
    apply; the step count falls through to replicated."""
    return tree_shardings(opt_state, mesh)


def cache_shardings(cache: Tree, mesh, shard_seq: bool = False):
    """Decode-cache placements (``sharding.py:175-253`` of the reference).

    Default: batch (dim 0) over the data axes, heads / channels over
    "model" (KV leaves ``k`` / ``v`` are (B, S, kv_heads, hd)); recurrent
    and conv states get "model" on their channel dim.  ``shard_seq=True``
    shards the KV sequence dim over "data" instead of the batch, for
    long-context decode where the global batch is below the dp size.

    Takes the dense cache dict or a ``serve.kv.KVState`` and returns the
    same container (duck-typed on ``data`` / ``tables``).  A paged cache's
    KV pools ``(num_pages, page_size, kv_heads, hd)`` put the page dim on
    the data axes and heads on "model"; its block tables stay replicated.
    Serving under a ``Distribution`` is not ported: these are the
    placements that path will consume."""
    dp = dp_axes(mesh)
    tables = getattr(cache, "tables", None)
    data = getattr(cache, "data", cache)
    paged = tables is not None

    def leaf(path, x):
        name = path.rsplit("/", 1)[-1]
        shape = _shape(x)
        nd = len(shape)
        if paged and name in ("k", "v") and nd >= 4:
            # (..., num_pages, page_size, kv_heads, hd); group-stacked
            # leaves carry a leading n_groups dim: right-align
            axes = (None,) * (nd - 4) + (dp, None, "model", None)
        elif paged and name in ("k_scale", "v_scale") and nd >= 3:
            # int8 dequant scales (..., num_pages, page_size, kv_heads),
            # co-placed with their pools
            axes = (None,) * (nd - 3) + (dp, None, "model")
        elif name in ("k", "v") and nd == 4:
            axes = (None, ("data",), "model", None) if shard_seq else (dp, None, "model", None)
        elif name == "state" and nd >= 4:
            # SSD state (..., num_slots, n_heads, N, head_p): slots over the
            # data axes, heads over "model"
            axes = (None,) * (nd - 4) + (dp, "model", None, None)
        elif name == "h" and nd >= 2:
            # RG-LRU hidden state (..., num_slots, d_r)
            axes = (None,) * (nd - 2) + (dp, "model")
        elif name == "conv" and nd >= 3:
            # conv windows (..., num_slots, K-1, channels), rglru and ssd
            axes = (None,) * (nd - 3) + (dp, None, "model")
        elif nd >= 2:
            axes = (dp,) + (None,) * (nd - 2) + ("model",)
        else:
            axes = (dp,)
        return _fit_spec(shape, axes, mesh)

    data_sh = map_with_path(leaf, data)
    if hasattr(cache, "data"):
        return dataclasses.replace(cache, data=data_sh, tables=() if paged else None)
    return data_sh


def batch_spec(mesh, global_batch: int) -> Spec:
    """Leading-dim spec for the global batch: over ("pod", "data") when the
    pod axis exists, degrading outermost-first until it divides."""
    dp = dp_axes(mesh)
    while dp and global_batch % axes_size(mesh, dp) != 0:
        dp = dp[1:]
    if not dp:
        return (None,)
    return (dp[0] if len(dp) == 1 else dp,)
