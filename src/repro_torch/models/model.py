"""Public model API for training and serving (port of ``repro.models.model``).

    params = init_params(cfg, seed=0)                      # CUDA by default
    logits, aux = forward(params, cfg, batch)              # train / prefill
    loss_sum, w = loss_fn(params, cfg, batch)              # DropCompute GradFn
    cache = init_decode_cache(params, cfg, batch, L, linear=True)
    logits, cache = prefill_chunk(params, cfg, cache, tokens, pos, lens)
    logits, cache = packed_prefill(params, cfg, cache, tokens, slots, positions)

``batch`` is a dict: ``tokens`` (B, S) int, optional ``weights`` (B, S)
per-token loss weights.  The port trains and serves decoder-only 'G'/'L'
stacks; other families raise ``UnsupportedPatternError``.

Parameters are nested dicts with the reference's path names and shapes
(``models.convert.params_from_jax`` maps a JAX tree onto them).  Caches are
the reference's dict or a ``repro_torch.serve.kv.KVState`` and are updated
in place; the functions return them for the reference's call shape.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..kernels import flash_attention as _fa
from . import layers as L
from .config import ModelConfig
from .transformer import apply_stack, init_stack, init_stack_cache

Tree = Any


class UnsupportedPatternError(NotImplementedError):
    """A serving path was asked for a model it cannot run.

    Typed (and raised unconditionally, not ``assert``-ed) so callers can
    catch it.  The port serves decoder-only 'G'/'L' stacks; recurrent,
    MoE, enc-dec and VLM models raise it."""


def require_chunkable(cfg: ModelConfig, what: str = "chunked prefill") -> None:
    """Raise ``UnsupportedPatternError`` unless the port can run ``cfg``
    through multi-token serving steps: decoder-only 'G'/'L' attention
    stacks without experts or a VLM prefix."""
    if not set(cfg.pattern) <= {"G", "L"}:
        raise UnsupportedPatternError(
            f"{what} supports 'G'/'L' layer patterns in the PyTorch port, got "
            f"{cfg.pattern!r}"
        )
    if cfg.is_encdec:
        raise UnsupportedPatternError(f"{what} does not support enc-dec models")
    if cfg.n_experts > 0:
        raise UnsupportedPatternError(f"{what} does not support MoE models in the port yet")
    if cfg.prefix_len > 0:
        raise UnsupportedPatternError(f"{what} does not support VLM prefixes in the port yet")


def require_trainable(cfg: ModelConfig, seq_len: int, device: torch.device) -> None:
    """Raise before any work what the training path would raise at its
    first attention call: ``logit_softcap`` (not ported), and on the card
    attention that the training kernels are not built for
    (``kernels.flash_attention.UnbuiltShapeError``: head dim, group,
    compute dtype, sequence length)."""
    L.require_no_softcap(cfg)
    if torch.device(device).type == "cuda":
        _fa.require_trained(cfg.hd, cfg.n_heads // cfg.n_kv_heads, cfg.compute_dtype, seq_len)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Tree:
    """Random parameters drawn from ``torch.Generator(seed)`` on ``device``
    (CUDA unless the caller passes another; ``"meta"`` allocates nothing).
    Same tree as ``repro.models.model.init_params``; different numbers
    (the two frameworks' generators differ)."""
    cfg.validate()
    require_chunkable(cfg, "the PyTorch port")
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    return {
        "embed": L.init_embedding(gen, cfg, device=dev),
        "stack": init_stack(gen, cfg, device=dev),
        "final_norm": L.init_norm(cfg, device=dev),
    }


#: leaves the reference reads in f32 whatever the compute dtype
_F32_LEAVES = ("q_norm", "k_norm")


def compute_params(params: Tree, cfg: ModelConfig) -> Tree:
    """The tree with every leaf the reference casts to ``cfg.dtype`` at use
    already cast, made once (a serving engine calls this at construction).
    Leaves read in f32 (QK-norm scales, LayerNorm affine) stay as they are.
    The cast is deterministic, so outputs are unchanged; for the f32
    master / bf16 compute recipe it halves the bytes each step reads.
    Idempotent: casting a cast tree returns the same tensors."""
    cd = cfg.compute_dtype
    keep_norms = cfg.norm == "layernorm"

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, key) for v in node)
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if key in _F32_LEAVES or (keep_norms and key in ("scale", "bias")):
            return node
        return node.to(cd)

    return walk(params)


def train_params(params: Tree, cfg: ModelConfig) -> Tree:
    """The compute copy a training step differentiates: ``compute_params``
    except the ``embed`` leaves, which stay the f32 master tensors (shared,
    not copied).  The reference casts each parameter at use, so its f32
    gradient is the compute-dtype cotangent cast up, which the gradient
    of a compute-dtype copy gives as well, at half the bytes.  The
    exception is a leaf read more than once: the (tied) embedding table
    is read by ``embed``'s gather and by each CE chunk's ``unembed``, and
    JAX sums those cotangents in f32.  Kept in f32, its gradient sums in
    f32 here too (the gather's scatter-add included); the casts to the
    compute dtype happen at use, inside each CE chunk, as in the reference."""
    return {k: (v if k == "embed" else compute_params(v, cfg)) for k, v in params.items()}


def params_device(params: Tree) -> torch.device:
    return params["embed"]["embedding"].device


def _cache_parts(cache):
    """Split a decode cache into (data, page_tables, page_size): a plain
    dict is dense; a ``KVState`` carries its tables (duck-typed on
    ``data`` so ``models`` never imports ``serve``)."""
    data = getattr(cache, "data", cache)
    return data, getattr(cache, "tables", None), getattr(cache, "page_size", 0)


def _cache_rebuild(cache, new_data):
    """Rewrap updated cache data in the caller's container type."""
    if hasattr(cache, "data"):
        return dataclasses.replace(cache, data=new_data)
    return new_data


def init_decode_cache(params: Tree, cfg: ModelConfig, batch: int, seq_len: int,
                      linear: bool = False) -> Tree:
    """Pre-allocated dense KV cache on the parameters' device.
    ``linear=True`` (full-length sliding-window buffers) is what
    ``prefill_chunk``/``packed_prefill`` need; the ring layout is kept for
    the reference's shape but the port has no ring-buffer decode path."""
    require_chunkable(cfg, "init_decode_cache")
    return {"stack": init_stack_cache(cfg, batch, seq_len, linear=linear,
                                      device=params_device(params))}


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def prefill_chunk(params: Tree, cfg: ModelConfig, cache: Tree, tokens, pos, seq_lens):
    """Process up to C prompt tokens per slot in one step (chunked prefill).

    Slot i consumes ``tokens[i, :seq_lens[i]]`` at absolute positions
    ``pos[i]..pos[i]+seq_lens[i]-1``, writing its KV rows there; padding
    columns write nothing.  Returns (logits (B, C, V), cache).  With C == 1
    and seq_lens in {0, 1} this is a decode step that skips idle slots."""
    require_chunkable(cfg, "chunked prefill")
    data, tables, page_size = _cache_parts(cache)
    dev = params_device(params)
    tokens = _long(tokens, dev)
    pos = _long(pos, dev)
    c = tokens.shape[1]
    positions = pos[:, None] + torch.arange(c, device=dev)[None, :]  # (B, C)
    x = L.embed(params["embed"], tokens, cfg, positions)
    x, new_stack = apply_stack(
        params["stack"], x, cfg, positions, data["stack"], decode_pos=pos,
        seq_lens=_long(seq_lens, dev), page_tables=tables, page_size=page_size,
    )
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, _cache_rebuild(cache, {"stack": new_stack})


def packed_prefill(params: Tree, cfg: ModelConfig, cache: Tree, tokens, slot_ids,
                   positions):
    """Token-packed engine step: one row per granted token, ``slot_ids[j] <
    0`` marks padding.  Each token writes its K/V at (slot, position) and
    attends only within its own slot.  Returns (logits (P, V), cache)."""
    require_chunkable(cfg, "packed prefill")
    data, tables, page_size = _cache_parts(cache)
    dev = params_device(params)
    tokens = _long(tokens, dev)[None]  # (1, P)
    pos2 = _long(positions, dev)[None]  # (1, P)
    x = L.embed(params["embed"], tokens, cfg, pos2)
    x, new_stack = apply_stack(
        params["stack"], x, cfg, pos2, data["stack"], slot_ids=_long(slot_ids, dev),
        page_tables=tables, page_size=page_size,
    )
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[0], _cache_rebuild(cache, {"stack": new_stack})


# ---------------------------------------------------------------------------
# Forward and loss (training; no caches)
# ---------------------------------------------------------------------------


def forward_features(params: Tree, cfg: ModelConfig, batch: Dict[str, Any]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, d), aux loss scalar) — ``model.py:100-140``
    for G/L decoders: embed, the stack without caches (remat per group
    under ``cfg.remat``), the final norm."""
    require_chunkable(cfg, "training")
    dev = params_device(params)
    tokens = _long(batch["tokens"], dev)
    positions = torch.arange(tokens.shape[1], device=dev)
    x = L.embed(params["embed"], tokens, cfg, positions)
    x, _ = apply_stack(params["stack"], x, cfg, positions)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=dev)


def forward(params: Tree, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, V), aux loss scalar)."""
    x, aux = forward_features(params, cfg, batch)
    return L.unembed(params["embed"], x, cfg), aux


_CE_CHUNK = 1024  # sequence positions per unembed+CE chunk


def _ce_once(params, cfg, x, targets, w):
    logits = L.unembed(params["embed"], x, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.sum((lse - tgt) * w), torch.sum(w)


def _ce_sums(params, cfg, x, targets, w):
    """(loss_sum, weight_sum) from final hiddens, chunked over the sequence
    (``model.py:161-194``): above ``_CE_CHUNK`` positions each chunk is
    checkpointed (when grads are on), so its f32 logits (B, chunk, V) are
    transient and rebuilt in the backward."""
    b, s, d = x.shape
    if s <= _CE_CHUNK:
        return _ce_once(params, cfg, x, targets, w)
    pad = (-s) % _CE_CHUNK
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    remat = torch.is_grad_enabled()
    loss_parts, w_parts = [], []
    for c in range(0, s + pad, _CE_CHUNK):
        args = (x[:, c:c + _CE_CHUNK], targets[:, c:c + _CE_CHUNK], w[:, c:c + _CE_CHUNK])
        if remat:
            ls, ws = checkpoint(_ce_once, params, cfg, *args, use_reentrant=False)
        else:
            ls, ws = _ce_once(params, cfg, *args)
        loss_parts.append(ls)
        w_parts.append(ws)
    return torch.stack(loss_parts).sum(), torch.stack(w_parts).sum()


def _targets_weights(batch, dev):
    tokens = _long(batch["tokens"], dev)
    targets = tokens[:, 1:]
    w = batch.get("weights")
    if w is None:
        w = torch.ones(targets.shape, dtype=torch.float32, device=dev)
    else:
        w = torch.as_tensor(w, device=dev)[:, 1:].float()
    return targets, w


def loss_fn(params: Tree, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE as (loss_sum, token_weight_sum) — ``model.py:197``.
    The port's families have no router, so the reference's aux term is 0."""
    x, _ = forward_features(params, cfg, batch)
    targets, w = _targets_weights(batch, x.device)
    return _ce_sums(params, cfg, x[:, :-1], targets, w)


def per_token_losses(params: Tree, cfg: ModelConfig, batch: Dict[str, Any]):
    """(B, S-1) CE, weights and aux — for the per-example-weight step."""
    logits, aux = forward(params, cfg, batch)
    targets, w = _targets_weights(batch, logits.device)
    lg = logits[:, :-1].float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    return lse - tgt, w, aux


__all__ = [
    "UnsupportedPatternError",
    "compute_params",
    "forward",
    "forward_features",
    "loss_fn",
    "per_token_losses",
    "train_params",
    "init_decode_cache",
    "init_params",
    "packed_prefill",
    "prefill_chunk",
    "require_chunkable",
    "require_trainable",
]
