"""Public model API for training and serving (port of ``repro.models.model``).

    params = init_params(cfg, seed=0)                      # CUDA by default
    logits, aux = forward(params, cfg, batch)              # train / prefill
    loss_sum, w = loss_fn(params, cfg, batch)              # DropCompute GradFn
    cache = init_decode_cache(params, cfg, batch, L, linear=True)
    cache = init_decode_cache(params, cfg, batch, L, enc_out=encode(params, cfg, frames))  # enc-dec
    logits, cache = prefill_chunk(params, cfg, cache, tokens, pos, lens)
    logits, cache, aux = prefill_chunk(..., moe_impl="capacity", return_aux=True)
    logits, cache = packed_prefill(params, cfg, cache, tokens, slots, positions)
    logits, cache = decode_step(params, cfg, cache, token, pos)   # (B, 1) tokens
    logits, cache = verify_step(params, cfg, cache, tokens, pos, lens)

A serving step reads the host only through its inputs: with a paged cache
the caller passes the paged kernel's tile plans (``chunk_plans`` /
``packed_plans`` / ``decode_plans``, made on the host), so the step can be
captured in a CUDA graph (``repro_torch.graphs``).

``batch`` is a dict: ``tokens`` (B, S) int, optional ``weights`` (B, S)
per-token loss weights, for an enc-dec model ``frames`` (B, F, d), the
encoder's stub front-end embeddings, and for a VLM ``prefix`` (B, P, d),
the stub vision front-end's patch embeddings, which the training forward
places before the text (``forward_features``).  The port trains and serves decoder-only stacks of
'G'/'L' attention, 'R' (RG-LRU) and 'M' (Mamba-2) layers, and trains encoder
stacks of 'B' (bidirectional) blocks, the paper's BERT models, which have
no decode shapes and so are never served.  'G'/'L' blocks with experts
(``n_experts > 0``, ``models.moe``) are trained and served (dispatch
``moe_impl``: ``"sort"`` by default for ``forward`` and ``loss_fn``, whose
loss adds the router's load-balancing term, ``"dense"`` for the serving
steps, ``"capacity"`` for the engine's capacity factor); other families
raise ``UnsupportedPatternError``.  Enc-dec models (whisper-tiny: a 'B'
encoder over the frames, a decoder of 'G' blocks with cross-attention)
train and serve through ``decode_step`` on a dense cache
(``init_decode_cache(..., enc_out=encode(...))``, which holds each decoder
layer's cross K/V); the engine, the prefill steps and the paged layout
refuse them, as the reference's do.  VLM models (internvl2-1b) train and
prefill with their patch prefix and serve text-only, as the reference's
engine does.  On the card, training refuses shapes
its kernels are not built for (``require_trainable``).

Parameters are nested dicts with the reference's path names and shapes
(``models.convert.params_from_jax`` maps a JAX tree onto them).  Caches are
the reference's dict or a ``repro_torch.serve.kv.KVState`` and are updated
in place; the functions return them for the reference's call shape.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..kernels import flash_attention as _fa
from ..kernels import ssd_chunk as _ssd
from . import layers as L
from .config import ModelConfig
from .ssm import chunk_len
from .transformer import apply_stack, init_block, init_stack, init_stack_cache, tree_leaves

Tree = Any


class UnsupportedPatternError(NotImplementedError):
    """A serving or training path was asked for a model it cannot run.

    Typed (and raised unconditionally, not ``assert``-ed) so callers can
    catch it.  The port serves and trains decoder-only 'G'/'L'/'R'/'M'
    stacks, with or without experts or a VLM prefix (served text-only),
    trains 'B' encoder stacks, and trains and decodes enc-dec models;
    serving a 'B' stack and multi-token serving steps of an enc-dec model
    raise it."""


#: the decoder layer kinds the port builds and serves
_DECODER = {"G", "L", "R", "M"}


def require_chunkable(cfg: ModelConfig, what: str = "chunked prefill") -> None:
    """Raise ``UnsupportedPatternError`` unless the port can run ``cfg``
    through multi-token serving steps: decoder-only stacks of 'G'/'L'
    attention (with or without experts), 'R' (RG-LRU) and 'M' (Mamba-2)
    layers without an encoder.  A VLM is served text-only: its serving
    steps take no prefix, as the reference's (``model.py:238-250``).
    A 'B' encoder stack has no decode shapes and is refused here (the
    serving engine, the paged layout, ``init_decode_cache`` and the
    prefill steps all ask); so is an enc-dec model, which serves through
    ``decode_step`` alone (``model.py:249-250``)."""
    if not set(cfg.pattern) <= _DECODER:
        raise UnsupportedPatternError(
            f"{what} supports 'G'/'L'/'R'/'M' layer patterns in the PyTorch port, got "
            f"{cfg.pattern!r}"
        )
    if cfg.is_encdec:
        raise UnsupportedPatternError(f"{what} does not support enc-dec models")


def require_stack(cfg: ModelConfig, what: str = "the PyTorch port") -> None:
    """Raise ``UnsupportedPatternError`` unless the port can build ``cfg``
    and run it without caches (initialisation, the training forward): the
    serving stacks of ``require_chunkable``, an encoder stack of 'B'
    blocks alone (bidirectional attention: the BERT models), or an enc-dec
    model whose decoder is 'G' blocks (its encoder is 'B' blocks and each
    decoder block adds cross-attention: whisper-tiny)."""
    pattern = set(cfg.pattern)
    if cfg.is_encdec and pattern != {"G"}:
        raise UnsupportedPatternError(
            f"{what} supports enc-dec decoders of 'G' layers in the PyTorch port, got "
            f"{cfg.pattern!r}")
    if not (pattern <= _DECODER or pattern == {"B"}):
        raise UnsupportedPatternError(
            f"{what} supports 'G'/'L'/'R'/'M' decoder or 'B' encoder layer patterns in the "
            f"PyTorch port, got {cfg.pattern!r}"
        )


def require_trainable(cfg: ModelConfig, seq_len: int, device: torch.device) -> None:
    """Raise before any work what the training path would raise at its
    first layer: a family the port does not run or train
    (``UnsupportedPatternError``),
    ``logit_softcap`` (not ported), and on the card a shape the training
    kernels are not built for (``kernels.flash_attention.UnbuiltShapeError``):
    for 'G'/'L'/'B' layers attention's head dim, group, compute dtype and
    sequence length (an 'L' layer's window is any); for 'M' layers the SSD
    kernels' (state, head dim) and the chunk length the scan runs at
    ``seq_len`` (``ssm.chunk_len``), which the K6 backward takes as a
    multiple of its row tile up to its limit.  'R' (RG-LRU) layers run no
    kernel of their own (their scan and gates are plain PyTorch), so they
    need only their stack's attention and norms.  An enc-dec model's
    attention runs at three shapes: the encoder's ``cfg.enc_seq`` frames,
    the decoder's ``seq_len`` tokens, and cross-attention's (``seq_len``,
    ``cfg.enc_seq``).

    For a VLM ``seq_len`` is the attention length, the ``cfg.prefix_len``
    patch rows and the text after them, as the reference's
    ``InputShape.seq_len`` counts it (``steps.py:64``: a batch holds
    ``seq_len - prefix_len`` text tokens); K3 runs at ``seq_len``, and a
    ``seq_len`` that leaves fewer than two text tokens (no next-token
    target) raises ``ValueError``."""
    require_stack(cfg, "training")
    L.require_no_softcap(cfg)
    if cfg.prefix_len and seq_len - cfg.prefix_len < 2:
        raise ValueError(f"seq_len {seq_len} counts the {cfg.prefix_len} prefix rows: it leaves "
                         f"{seq_len - cfg.prefix_len} text tokens, fewer than 2")
    if torch.device(device).type != "cuda":
        return
    if set(cfg.pattern) & {"G", "L", "B"}:
        shapes = [(seq_len,)]
        if cfg.is_encdec:
            shapes += [(cfg.enc_seq,), (seq_len, cfg.enc_seq)]
        for lengths in shapes:
            _fa.require_trained(cfg.hd, cfg.n_heads // cfg.n_kv_heads, cfg.compute_dtype,
                                *lengths)
    if "M" in cfg.pattern:
        _ssd.require_built(cfg.ssm_state, cfg.ssm_head_dim)
        chunk = chunk_len(seq_len, cfg.ssm_chunk)
        if chunk % _ssd.ROW_TILE or chunk > _ssd.BWD_MAX_LEN:
            raise _fa.UnbuiltShapeError(
                f"chunk length {chunk} (ssm_chunk {cfg.ssm_chunk} at {seq_len} tokens): the SSD "
                f"backward takes multiples of {_ssd.ROW_TILE} up to {_ssd.BWD_MAX_LEN}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Tree:
    """Random parameters drawn from ``torch.Generator(seed)`` on ``device``
    (CUDA unless the caller passes another; ``"meta"`` allocates nothing).
    Same tree as ``repro.models.model.init_params``; different numbers
    (the two frameworks' generators differ).  An enc-dec model's decoder
    is the ``tail`` of ``n_layers`` 'G' blocks with cross-attention, and
    its ``encoder`` holds ``enc_layers`` 'B' blocks, a final norm and
    learned positions of ``enc_seq`` rows (``model.py:50-63``)."""
    cfg.validate()
    require_stack(cfg, "the PyTorch port")
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    p = {
        "embed": L.init_embedding(gen, cfg, device=dev),
        "stack": init_stack(gen, cfg, device=dev),
        "final_norm": L.init_norm(cfg, device=dev),
    }
    if cfg.is_encdec:
        p["encoder"] = {
            "blocks": [init_block(gen, cfg, "B", device=dev) for _ in range(cfg.enc_layers)],
            "final_norm": L.init_norm(cfg, device=dev),
            "pos_embedding": L.dense_init(gen, (cfg.enc_seq, cfg.d_model), in_axis=1,
                                          dtype=cfg.params_dtype, device=dev),
        }
    return p


def encode(params: Tree, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames (B, F, d), the stub front-end's embeddings, -> the encoder's
    output (B, F, d) in the compute dtype (``model.py:72-85``): learned
    positions added, the 'B' blocks (bidirectional attention through K3,
    each block checkpointed under ``cfg.remat``), the final norm."""
    enc = params["encoder"]
    dev = params_device(params)
    cd = cfg.compute_dtype
    x = torch.as_tensor(frames, device=dev).to(cd)
    x = x + enc["pos_embedding"][None, :x.shape[1]].to(cd)
    positions = torch.arange(x.shape[1], device=dev)
    # the encoder is a tail-only stack of 'B' blocks
    enc_cfg = dataclasses.replace(cfg, layer_pattern="B", n_layers=cfg.enc_layers)
    x, _, _, _ = apply_stack({"groups": (), "tail": enc["blocks"]}, x, enc_cfg, positions)
    return L.apply_norm(enc["final_norm"], x, cfg)


def _cross_kv(blk: Tree, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder block's cross-attention K and V (B, F, KV, D) from the
    encoder's output (``model.py:88-92``: the projections alone, no bias)."""
    cd = cfg.compute_dtype
    return (L._proj(enc_out, blk["cross_attn"]["wk"], cd),
            L._proj(enc_out, blk["cross_attn"]["wv"], cd))


#: leaves the reference reads in f32 whatever the compute dtype (QK-norm
#: scales; the SSD block's decay, step bias, skip and gated-norm scale; the
#: RG-LRU block's gates and decay; the MoE router, ``moe.py:47``)
_F32_LEAVES = ("q_norm", "k_norm", "a_log", "dt_bias", "d_skip", "norm_scale",
               "gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b", "lam", "router")


def compute_params(params: Tree, cfg: ModelConfig) -> Tree:
    """The tree with every leaf the reference casts to ``cfg.dtype`` at use
    already cast, made once (a serving engine calls this at construction).
    Leaves read in f32 (QK-norm scales, LayerNorm affine, the SSD block's
    ``a_log``, ``dt_bias``, ``d_skip``, ``norm_scale``, the RG-LRU block's
    gates and ``lam``, the MoE router) stay as they are.
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


def train_params(params: Tree, cfg: ModelConfig, out: Optional[Tree] = None) -> Tree:
    """The compute copy a training step differentiates: ``compute_params``
    except the ``embed`` leaves, which stay the f32 master tensors (shared,
    not copied).  The reference casts each parameter at use, so its f32
    gradient is the compute-dtype cotangent cast up, which the gradient
    of a compute-dtype copy gives as well, at half the bytes.  The
    exception is a leaf read more than once: the (tied) embedding table
    is read by ``embed``'s gather and by each CE chunk's ``unembed``, and
    JAX sums those cotangents in f32.  Kept in f32, its gradient sums in
    f32 here too (the gather's scatter-add included); the casts to the
    compute dtype happen at use, inside each CE chunk, as in the reference.

    ``out``, an earlier result for the same ``params``, is refilled in place
    and returned: its tensors keep their addresses, which a training step
    captured in a CUDA graph reads."""
    if out is None:
        return {k: (v if k == "embed" else compute_params(v, cfg)) for k, v in params.items()}
    for dst, src in zip(tree_leaves(out), tree_leaves(params)):
        if dst is not src:
            dst.copy_(src)
    return out


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
                      enc_out: Optional[torch.Tensor] = None, linear: bool = False) -> Tree:
    """Pre-allocated dense KV cache on the parameters' device ('R' and 'M'
    layers: slot-indexed conv windows and recurrence states).
    ``linear=True`` (full-length sliding-window buffers) is what
    ``prefill_chunk``/``packed_prefill`` need; the default ring layout gives
    a sliding-window layer ``min(window, seq_len)`` rows (and the spare
    row), which only ``decode_step`` takes.

    An enc-dec model's cache (``model.py:292-309``) mirrors its tail-only
    decoder (one self-attention cache a layer) and holds ``cross_kv``,
    each layer's (K, V) of the encoder's output ``enc_out`` (B, F, d),
    made here once and read by every ``decode_step``; without ``enc_out``
    it raises ``ValueError``."""
    if cfg.is_encdec:
        require_stack(cfg, "init_decode_cache")
        if enc_out is None:
            raise ValueError("enc-dec decode needs encoder output (enc_out)")
        dev = params_device(params)
        return {"stack": init_stack_cache(cfg, batch, seq_len, linear=linear, device=dev),
                "cross_kv": [_cross_kv(blk, enc_out.to(dev), cfg)
                             for blk in params["stack"]["tail"]]}
    require_chunkable(cfg, "init_decode_cache")
    return {"stack": init_stack_cache(cfg, batch, seq_len, linear=linear,
                                      device=params_device(params))}


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _attention_kinds(cfg: ModelConfig):
    return sorted(set(cfg.pattern) & {"G", "L"})


def _step_plans(cfg: ModelConfig, cache: Tree, q_pos, q_slots, batch: int,
               packed: bool) -> Optional[Dict[str, np.ndarray]]:
    """The paged kernel's tile plan of a serving step for each attention
    kind (``kernels.flash_attention.paged_tile_plan``), made on the host
    from the step's query positions and slots (numpy, in the step's token
    order) at the kernel instance's tile tokens and padded to the row count
    its shape fixes (``step_plan_rows``);
    None for a dense cache, which needs none."""
    _, tables, page_size = _cache_parts(cache)
    if tables is None:
        return None
    tt = _fa.tile_tokens(cfg.hd, cfg.n_heads // cfg.n_kv_heads)
    rows = _fa.step_plan_rows(len(q_pos), batch, packed, tt)
    return {kind: _fa.paged_tile_plan(q_pos, q_slots, page_size, tables.shape[-1],
                                      cfg.sliding_window if kind == "L" else 0, rows, tt)
            for kind in _attention_kinds(cfg)}


def chunk_plans(cfg: ModelConfig, cache: Tree, pos, seq_lens, chunk: int):
    """``_step_plans`` of a ``prefill_chunk`` step of (B, ``chunk``) tokens
    from its numpy ``pos`` and ``seq_lens``: slot i's queries at ``pos[i]``
    on, its columns past ``seq_lens[i]`` padding."""
    pos, lens = np.asarray(pos, np.int64), np.asarray(seq_lens, np.int64)
    offs = np.arange(chunk)
    q_pos = (pos[:, None] + offs[None, :]).reshape(-1)
    q_slots = np.where(offs[None, :] < lens[:, None], np.arange(len(pos))[:, None], -1)
    return _step_plans(cfg, cache, q_pos, q_slots.reshape(-1), len(pos), packed=False)


def packed_plans(cfg: ModelConfig, cache: Tree, slot_ids, positions):
    """``_step_plans`` of a ``packed_prefill`` step from its numpy
    ``slot_ids`` and ``positions``."""
    _, tables, _ = _cache_parts(cache)
    if tables is None:
        return None
    return _step_plans(cfg, cache, np.asarray(positions, np.int64),
                      np.asarray(slot_ids, np.int64), tables.shape[0], packed=True)


def decode_plans(cfg: ModelConfig, cache: Tree, pos):
    """``_step_plans`` of a paged ``decode_step`` from its numpy per-slot
    ``pos``: the chunked step with C = 1 and every slot active
    (``layers.step_index``)."""
    pos = np.asarray(pos, np.int64).reshape(-1)
    return chunk_plans(cfg, cache, pos, np.ones_like(pos), 1)


def _device_plans(plans, device):
    return None if plans is None else {k: torch.as_tensor(v, device=device)
                                       for k, v in plans.items()}


def _device_scalar(v, dtype, dev) -> torch.Tensor:
    """``apply_stack``'s aux or overflow total as a device scalar: a tensor
    (an MoE stack's) cast, a Python number (a stack without experts) filled
    in on the device (a fill kernel, where ``as_tensor`` would copy from the
    host, which a CUDA-graph capture refuses)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=dev)


def _step_aux(overflow, dev) -> Dict[str, torch.Tensor]:
    """A serving step's stats (``return_aux``): the MoE routes dropped past
    capacity, a device int64 scalar (0 without a capacity dispatch)."""
    return {"expert_overflow": _device_scalar(overflow, torch.long, dev)}


def prefill_chunk(params: Tree, cfg: ModelConfig, cache: Tree, tokens, pos, seq_lens,
                  plans=None, moe_impl: str = "dense", return_aux: bool = False):
    """Process up to C prompt tokens per slot in one step (chunked prefill).

    Slot i consumes ``tokens[i, :seq_lens[i]]`` at absolute positions
    ``pos[i]..pos[i]+seq_lens[i]-1``, writing its KV rows there; padding
    columns write nothing.  Returns (logits (B, C, V), cache).  With C == 1
    and seq_lens in {0, 1} this is a decode step that skips idle slots.
    ``plans`` (paged cache): ``chunk_plans`` of this step, made on the host;
    without them the step makes them from its device tensors.  ``moe_impl``
    is the MoE layers' dispatch (``"capacity"``: padding columns take no
    expert capacity); ``return_aux=True`` adds a third element, the step's
    stats (``{"expert_overflow"}``, ``model.py:320-370``)."""
    require_chunkable(cfg, "chunked prefill")
    data, tables, page_size = _cache_parts(cache)
    dev = params_device(params)
    tokens = _long(tokens, dev)
    pos = _long(pos, dev)
    c = tokens.shape[1]
    positions = pos[:, None] + torch.arange(c, device=dev)[None, :]  # (B, C)
    x = L.embed(params["embed"], tokens, cfg, positions)
    x, new_stack, _, overflow = apply_stack(
        params["stack"], x, cfg, positions, data["stack"], decode_pos=pos,
        seq_lens=_long(seq_lens, dev), page_tables=tables, page_size=page_size,
        plans=_device_plans(plans, dev), moe_impl=moe_impl,
    )
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    out_cache = _cache_rebuild(cache, {"stack": new_stack})
    if return_aux:
        return logits, out_cache, _step_aux(overflow, dev)
    return logits, out_cache


def verify_step(params: Tree, cfg: ModelConfig, cache: Tree, tokens, pos, seq_lens,
                plans=None, moe_impl: str = "dense"):
    """Speculative decoding's verify step (``model.py:374-409``): row i
    carries ``[t_last, d_1, .., d_k]`` at the slot's absolute positions and
    column j of the (B, 1 + k, V) logits is the next-token distribution
    after the row through column j.  It *is* ``prefill_chunk``: the drafts'
    K/V lands in the cache, and the rejected positions are the caller's
    rollback (a position-mask trim for dense slots, ``KVCache.trim_slot``
    for the paged layout).  ``plans``: ``chunk_plans`` of the step."""
    return prefill_chunk(params, cfg, cache, tokens, pos, seq_lens, plans=plans,
                         moe_impl=moe_impl)


def decode_step(params: Tree, cfg: ModelConfig, cache: Tree, token, pos, plans=None,
                moe_impl: str = "dense"):
    """One token per slot (``model.py:463-501``), the reference's
    single-token oracle: ``token`` (B, 1) at ``pos``, a scalar (a lockstep
    batch) or (B,) per-slot positions; every slot writes its K/V row and
    advances its recurrent state.  A dense cache may be the ring layout
    (``init_decode_cache(linear=False)``) or the linear one; a paged cache
    (``KVState``) needs per-slot positions and runs K4 over the chunked
    addressing with C = 1.  Returns (logits (B, 1, V), cache).  ``plans``
    (paged cache): ``decode_plans`` of this step, made on the host, which a
    captured step needs.  An enc-dec model (``model.py:476-490``) runs its
    decoder blocks over the cache ``init_decode_cache(..., enc_out=)`` made,
    each with its layer's ``cross_kv``; a paged cache raises
    ``UnsupportedPatternError``, as the reference's does."""
    data, tables, page_size = _cache_parts(cache)
    if cfg.is_encdec:
        if tables is not None:
            raise UnsupportedPatternError("paged KV does not support enc-dec models")
        require_stack(cfg, "decode_step")
    else:
        require_chunkable(cfg, "decode_step")
    dev = params_device(params)
    pos = _long(pos, dev)
    positions = pos[:, None] if pos.dim() else pos.reshape(1)
    x = L.embed(params["embed"], _long(token, dev), cfg, positions)
    cross = data.get("cross_kv")
    x, new_stack, _, _ = apply_stack(
        params["stack"], x, cfg, positions, data["stack"], decode_pos=pos,
        page_tables=tables, page_size=page_size, plans=_device_plans(plans, dev),
        moe_impl=moe_impl, enc_kv=None if cross is None else (lambda i, _: cross[i]),
    )
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, _cache_rebuild(cache, {**data, "stack": new_stack})


def packed_prefill(params: Tree, cfg: ModelConfig, cache: Tree, tokens, slot_ids,
                   positions, plans=None, moe_impl: str = "dense", return_aux: bool = False):
    """Token-packed engine step: one row per granted token, ``slot_ids[j] <
    0`` marks padding.  Each token writes its K/V at (slot, position) and
    attends only within its own slot.  Returns (logits (P, V), cache).
    ``plans`` (paged cache): ``packed_plans`` of this step; ``moe_impl``
    and ``return_aux`` as in ``prefill_chunk`` (padding rows take no
    expert capacity)."""
    require_chunkable(cfg, "packed prefill")
    data, tables, page_size = _cache_parts(cache)
    dev = params_device(params)
    tokens = _long(tokens, dev)[None]  # (1, P)
    pos2 = _long(positions, dev)[None]  # (1, P)
    x = L.embed(params["embed"], tokens, cfg, pos2)
    x, new_stack, _, overflow = apply_stack(
        params["stack"], x, cfg, pos2, data["stack"], slot_ids=_long(slot_ids, dev),
        page_tables=tables, page_size=page_size, plans=_device_plans(plans, dev),
        moe_impl=moe_impl,
    )
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    out_cache = _cache_rebuild(cache, {"stack": new_stack})
    if return_aux:
        return logits[0], out_cache, _step_aux(overflow, dev)
    return logits[0], out_cache


# ---------------------------------------------------------------------------
# Forward and loss (training; no caches)
# ---------------------------------------------------------------------------


def forward_features(params: Tree, cfg: ModelConfig, batch: Dict[str, Any],
                     moe_impl: str = "sort") -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, d), aux loss scalar) — ``model.py:100-140``
    for G/L/R/M decoders and 'B' encoders: embed (learned positions where
    ``cfg.pos`` says so), the stack without caches (remat per group under
    ``cfg.remat``; 'R' and 'M' layers run their cache-free scans, 'B' layers
    bidirectional attention, MoE layers the ``moe_impl`` dispatch), the
    final norm.  The aux loss is the MoE layers' summed load-balancing
    term (0 without experts).  An enc-dec model (``model.py:118-133``)
    encodes ``batch["frames"]`` and runs each decoder block with its
    cross K/V of the encoder's output (the K/V projections and the block
    checkpointed together under ``cfg.remat``).  A VLM
    (``model.py:110-115``, ``:138-139``) embeds the text at its own
    positions, places ``batch["prefix"]`` (B, ``prefix_len``, d), cast to
    the compute dtype, before it, runs the stack at RoPE positions over
    prefix and text, and strips the prefix rows after the final norm, so S
    is the text's length (a VLM batch without ``prefix`` raises
    ``KeyError``, as the reference's)."""
    require_stack(cfg, "training")
    dev = params_device(params)
    tokens = _long(batch["tokens"], dev)
    positions = torch.arange(tokens.shape[1], device=dev)
    x = L.embed(params["embed"], tokens, cfg, positions)
    if cfg.prefix_len > 0:
        prefix = torch.as_tensor(batch["prefix"], device=dev).to(cfg.compute_dtype)
        x = torch.cat([prefix, x], dim=1)
        positions = torch.arange(x.shape[1], device=dev)
    enc_kv = None
    if cfg.is_encdec:
        enc_out = encode(params, cfg, batch["frames"])

        def enc_kv(i, blk):
            return _cross_kv(blk, enc_out, cfg)

    x, _, aux, _ = apply_stack(params["stack"], x, cfg, positions, moe_impl=moe_impl,
                               enc_kv=enc_kv)
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.prefix_len > 0:
        x = x[:, cfg.prefix_len:]
    return x, _device_scalar(aux, torch.float32, dev)


def forward(params: Tree, cfg: ModelConfig, batch: Dict[str, Any], moe_impl: str = "sort"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, V), aux loss scalar); a VLM's S is its text's."""
    x, aux = forward_features(params, cfg, batch, moe_impl=moe_impl)
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
        if remat:  # no random numbers drawn: no RNG state to save (see transformer)
            ls, ws = checkpoint(_ce_once, params, cfg, *args, use_reentrant=False,
                                preserve_rng_state=False)
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


def loss_fn(params: Tree, cfg: ModelConfig, batch: Dict[str, Any], moe_impl: str = "sort"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE as (loss_sum, token_weight_sum) — ``model.py:197-212``:
    an MoE model's loss_sum adds ``router_aux_weight * aux * w_sum``, its
    layers' load-balancing term (``moe_impl``: their dispatch); without
    experts the term is 0 and is not added."""
    x, aux = forward_features(params, cfg, batch, moe_impl=moe_impl)
    targets, w = _targets_weights(batch, x.device)
    loss_sum, w_sum = _ce_sums(params, cfg, x[:, :-1], targets, w)
    if cfg.n_experts:
        loss_sum = loss_sum + cfg.router_aux_weight * aux * w_sum
    return loss_sum, w_sum


def per_token_losses(params: Tree, cfg: ModelConfig, batch: Dict[str, Any],
                     moe_impl: str = "sort"):
    """(B, S-1) CE, weights and the aux loss (``model.py:215-222``) — for
    the per-example-weight step, which weighs the aux term itself."""
    logits, aux = forward(params, cfg, batch, moe_impl=moe_impl)
    targets, w = _targets_weights(batch, logits.device)
    lg = logits[:, :-1].float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    return lse - tgt, w, aux


__all__ = [
    "UnsupportedPatternError",
    "chunk_plans",
    "compute_params",
    "decode_plans",
    "decode_step",
    "encode",
    "forward",
    "forward_features",
    "loss_fn",
    "per_token_losses",
    "train_params",
    "init_decode_cache",
    "init_params",
    "packed_plans",
    "packed_prefill",
    "prefill_chunk",
    "require_chunkable",
    "require_stack",
    "require_trainable",
    "verify_step",
]
