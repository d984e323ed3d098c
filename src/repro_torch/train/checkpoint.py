"""Checkpointing: tree save/restore with step metadata (port of
``repro.train.checkpoint``, in the same files and format).

A checkpoint is a directory holding ``arrays{shard_suffix}.npz`` (one
array per leaf) and ``meta.json`` (``{"step", "extra", "keys"}``).  Each
leaf's key is its path as ``jax.tree_util.tree_flatten_with_path`` names
it, joined by ``/``: a dict level writes its key, a list or tuple level
``[i]`` (so the stacked ``groups`` tuple gives ``params/stack/groups/[0]/...``).
bf16 leaves are stored as their ``uint16`` bits (npz has no bfloat16), and
a Python ``int`` leaf (the optimizer's step ``count``, a host int in the
port) as the 0-d ``int32`` array the reference stores.  So a checkpoint
written by either package loads in the other.

In a multi-host deployment each process saves its addressable shards
under a process-indexed name — the seam is ``shard_suffix``.  ``restore``
validates structure and shapes against a template tree and copies into
the template's tensors in place: a captured CUDA graph holds the
parameters' and the optimizer state's addresses.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import tree_unflatten

Tree = Any
_SEP = "/"


def _paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf, dict levels by key, sequence levels as
    ``[i]``, as JAX's path keys print."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (f"[{i}]",))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz can't store bfloat16: its bits
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    raise TypeError(f"checkpoint leaves are tensors or ints, got {type(leaf).__name__}")


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def save(path: str, tree: Tree, step: int, extra: Optional[dict] = None, shard_suffix: str = ""):
    os.makedirs(path, exist_ok=True)
    arrays = _flatten(tree)
    np.savez(os.path.join(path, f"arrays{shard_suffix}.npz"), **arrays)
    meta = {"step": int(step), "extra": extra or {}, "keys": sorted(arrays)}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, default=float)  # numpy scalars in extra


def _restore_leaf(key: str, leaf, arr: np.ndarray):
    shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
    if arr.shape != shape:
        raise ValueError(f"{key}: shape {arr.shape} != template {shape}")
    if not isinstance(leaf, torch.Tensor):
        return int(arr)
    if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        src = torch.from_numpy(arr)
    with torch.no_grad():
        leaf.copy_(src)
    return leaf


def restore(path: str, template: Tree, shard_suffix: str = "") -> Tuple[Tree, int]:
    """(tree, step): the checkpoint's arrays copied into ``template``'s
    tensors in place (converted to each tensor's dtype and device), int
    leaves replaced by the stored values; returns the template's tree.  A
    key the checkpoint lacks raises ``KeyError``, a shape that differs
    ``ValueError``."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, f"arrays{shard_suffix}.npz")) as data:
        leaves = []
        for key, leaf in _paths(template):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            leaves.append(_restore_leaf(key, leaf, data[key]))
    return tree_unflatten(template, leaves), meta["step"]


def latest_step(path: str) -> Optional[int]:
    meta = os.path.join(path, "meta.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)["step"]


def load_extra(path: str) -> Optional[dict]:
    """The ``extra`` metadata dict saved alongside the arrays (``None`` if
    no checkpoint exists).  The trainer keeps its tau-controller state here
    — current tau, tau trajectory, telemetry summary — so a restarted run
    resumes with its *adapted* threshold instead of re-calibrating."""
    meta = os.path.join(path, "meta.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f).get("extra") or {}


def resilience_state(path: str) -> Optional[dict]:
    """Convenience accessor for the tau-controller/telemetry state blob
    (see ``trainer.train``'s checkpoint writes)."""
    extra = load_extra(path)
    if not extra:
        return None
    return extra.get("resilience")
