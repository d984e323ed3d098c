"""Shared helpers for serving recurrent layers statefully (port of
``repro.models.recurrent``; the port serves 'M' layers, ``models.ssm``).

A recurrent layer carries two kinds of per-slot state through the engine:
a causal-conv window (the last K-1 inputs) and the recurrence state.  This
module holds the layout machinery of the two multi-token steps:

* dense chunked prefill — a ``(B, C)`` step where row ``i`` consumes
  ``seq_lens[i]`` tokens (0 for idle slots): each row's conv window ends at
  its own length, not at C;
* token-packed steps — a ``(P,)`` vector of tokens with per-token slot ids
  (``serve.packing.PAD_SLOT`` on padding), segments contiguous: each token
  needs its segment-relative offset to know which conv taps come from the
  packed vector and which from the slot's carried window, and
  segment-start / segment-last flags gate carried-state injection and
  write-back.

Scatters to a slot: the reference remaps padding to the out-of-range slot
``num_slots`` and drops it with ``mode="drop"``.  On the card an
out-of-range index is a device assert, and filtering the rows first
(``nonzero``) costs a host sync per step, so the port scatters into
``num_slots + 1`` rows and drops the spare last one.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class SegmentInfo(NamedTuple):
    """Per-token segment geometry of one packed step (all shapes (P,))."""

    valid: torch.Tensor  # bool: not padding
    start: torch.Tensor  # bool: first token of its segment
    last: torch.Tensor  # bool: last token of its segment
    start_idx: torch.Tensor  # packed index of the segment's first token
    offset: torch.Tensor  # segment-relative position (0 at segment start)
    safe_slot: torch.Tensor  # slot id with padding clamped to 0 (gather-safe)
    write_slot: torch.Tensor  # slot id with padding -> num_slots (the spare row)
    last_slot: torch.Tensor  # slot id at seg-last tokens, else num_slots


def segment_info(slot_ids: torch.Tensor, num_slots: int) -> SegmentInfo:
    """Segment flags and indices of a packed step's slot ids
    (``recurrent.py:47-63``); no host sync."""
    slot_ids = slot_ids.long()
    p = slot_ids.shape[0]
    idx = torch.arange(p, device=slot_ids.device)
    valid = slot_ids >= 0
    edge = torch.full((1,), -2, dtype=slot_ids.dtype, device=slot_ids.device)
    prev = torch.cat([edge, slot_ids[:-1]])
    nxt = torch.cat([slot_ids[1:], edge])
    start = valid & (slot_ids != prev)
    last = valid & (slot_ids != nxt)
    start_idx = torch.cummax(torch.where(start, idx, -1), 0).values
    offset = idx - start_idx
    safe_slot = torch.where(valid, slot_ids, 0)
    write_slot = torch.where(valid, slot_ids, num_slots)
    last_slot = torch.where(last, slot_ids, num_slots)
    return SegmentInfo(valid, start, last, start_idx, offset, safe_slot, write_slot, last_slot)


def scatter_rows(rows: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``rows`` (num_slots, ...) with ``rows[index[t]] = values[t]`` for
    every ``index[t] < num_slots``; entries at ``num_slots`` are dropped
    (the reference's ``.at[index].set(values, mode="drop")``).  Written
    through a spare last row, so no index is ever out of range."""
    spare = torch.cat([rows, rows[:1]])
    spare[index] = values.to(rows.dtype)
    return spare[:-1]


def conv_tap_index(info: SegmentInfo, k: int) -> torch.Tensor:
    """(K, P): the row each conv tap of each packed token reads from the
    stacked source ``cat([x, window rows])`` of ``packed_conv`` — tap ``i``
    of token ``j`` is segment-relative position ``offset_j - (K-1) + i``:
    the packed token ``j - (K-1) + i`` when that position is >= 0 (same
    segment: segments are contiguous), else row ``virt + K-1`` of the
    slot's carried window (``recurrent.py:88-94``, clipped the same way).
    The same for every layer of a step."""
    p = info.offset.shape[0]
    idx = torch.arange(p, device=info.offset.device)
    tap = torch.arange(k, device=idx.device)[:, None]
    virt = info.offset[None, :] - (k - 1) + tap  # (K, P)
    tok = (idx[None, :] - (k - 1) + tap).clamp(0, p - 1)
    hist = p + idx[None, :] * (k - 1) + (virt + (k - 1)).clamp(0, k - 2)
    return torch.where(virt >= 0, tok, hist)


class PackedStep(NamedTuple):
    """What every 'M' layer of one packed step shares (made once a step)."""

    info: SegmentInfo
    conv_index: torch.Tensor  # (K, P): ``conv_tap_index``


def packed_step(slot_ids: torch.Tensor, num_slots: int, k: int) -> PackedStep:
    info = segment_info(slot_ids, num_slots)
    return PackedStep(info, conv_tap_index(info, k))


def packed_conv(
    x: torch.Tensor,  # (P, C) packed conv inputs
    w: torch.Tensor,  # (K, C) depthwise taps
    b: torch.Tensor,  # (C,) bias
    state: torch.Tensor,  # (num_slots, K-1, C) carried windows
    info: SegmentInfo,
    index: torch.Tensor = None,  # (K, P) ``conv_tap_index``; made here when None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over a packed step with per-slot history
    (``recurrent.py:66-107``).

    Each tap reads the packed vector itself or the slot's carried window
    (``conv_tap_index``); all K taps come from one gather.  Returns the
    pre-activation output (P, C) and the new per-slot windows: each
    segment's last token writes its trailing K-1 inputs (taps 1..K-1);
    slots absent from this step keep theirs."""
    k = w.shape[0]
    ch = x.shape[1]
    if index is None:
        index = conv_tap_index(info, k)
    win = state.to(x.dtype)[info.safe_slot].reshape(-1, ch)  # (P * (K-1), C)
    taps = torch.cat([x, win])[index]  # (K, P, C)
    out = w[0] * taps[0]
    for i in range(1, k):
        out = out + w[i] * taps[i]
    out = out + b
    return out, scatter_rows(state, info.last_slot, taps[1:].transpose(0, 1))


def chunked_conv_state(
    xp: torch.Tensor,  # (B, K-1+C, C_feat): carried window ++ this chunk
    seq_lens: torch.Tensor,  # (B,) tokens consumed per row this step
    k: int,
) -> torch.Tensor:
    """Per-row conv windows after a dense chunked step, (B, K-1, C_feat)
    (``recurrent.py:110-124``): row ``i``'s new window is the K-1 inputs
    ending at its own length, ``xp[i, L_i : L_i + K-1]``, so an idle row
    (L_i = 0) keeps exactly its old window."""
    idx = seq_lens[:, None].long() + torch.arange(k - 1, device=xp.device)
    return torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[-1]))


def final_segment_decay(
    cum: torch.Tensor,  # (P, H) cumulative log-decay over the packed axis
    da: torch.Tensor,  # (P, H) per-token log-decay
    info: SegmentInfo,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decay bookkeeping for carried-state injection and write-back
    (``recurrent.py:127-155``).  Returns ``(ent, w_end)``, both (P, H):

    * ``ent[j]`` — log-decay from *before* the segment start through token
      ``j``: ``cum_j - cum[start] + da[start]``; the carried state's weight
      at token j is ``exp(-ent_j)``;
    * ``w_end[j]`` — ``exp(-(cum[end] - cum_j))``, the weight of token j's
      update in its segment's final state."""
    p = cum.shape[0]
    si = info.start_idx.clamp(0, p - 1)
    ent = cum - cum[si] + da[si]
    last_at = torch.where(info.last, torch.arange(p, device=cum.device), p)
    end_idx = torch.cummin(last_at.flip(0), 0).values.flip(0)
    w_end = torch.exp(-(cum[end_idx.clamp(0, p - 1)] - cum))
    return ent, w_end
