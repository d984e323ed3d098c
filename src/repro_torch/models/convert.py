"""Map a reference (JAX) parameter tree onto the port's parameters.

``params_from_jax(np_tree, cfg, device)`` takes the tree of
``repro.models.model.init_params`` with its leaves turned into numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's tree:
same path names, the stacked ``groups`` tuple plus the ``tail`` list
(``transformer.py:195-206``); an enc-dec tree's ``encoder`` (``blocks``,
``final_norm``, ``pos_embedding``) and its tail-only decoder's
``cross_norm`` / ``cross_attn`` come across the same way.  Each leaf is checked against the port's own
initializer (run on the ``meta`` device) for shape and dtype, so a tree
from another config fails here and not as a shape error mid-step.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import resolve_device
from .config import ModelConfig
from .model import init_params
from .transformer import tree_map

Tree = Any


def _walk(src, ref, path):
    if isinstance(ref, dict):
        if not isinstance(src, dict) or set(src) != set(ref):
            got = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"{path or 'params'}: keys {got} != {sorted(ref)}")
        return {k: _walk(src[k], ref[k], f"{path}.{k}" if path else k) for k in ref}
    if isinstance(ref, (tuple, list)):
        if not isinstance(src, (tuple, list)) or len(src) != len(ref):
            raise ValueError(f"{path}: want a sequence of {len(ref)}, got {src!r:.80}")
        out = [_walk(s, r, f"{path}[{i}]") for i, (s, r) in enumerate(zip(src, ref))]
        return tuple(out) if isinstance(ref, tuple) else out
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{path}: shape {arr.shape} != {tuple(ref.shape)}")
    # via f32: numpy has no native bfloat16, and every reference dtype
    # (f32, bf16, f16) round-trips exactly through it
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(ref.dtype)


def params_from_jax(np_tree: Tree, cfg: ModelConfig, device=None) -> Tree:
    """The reference's parameters (numpy leaves) as the port's tree on
    ``device`` (CUDA unless the caller passes another)."""
    dev = resolve_device(device)
    out = _walk(np_tree, init_params(cfg, device="meta"), "")
    return tree_map(lambda x: x.to(dev), out)
