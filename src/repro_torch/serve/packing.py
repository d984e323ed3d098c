"""Token-packed step layout: flatten granted (slot, position) tokens.

Carried over unchanged from ``repro.serve.packing`` (numpy only);
``tests/test_torch_serve.py`` pins it to the reference.

The dense engine step computes a full ``(B, chunk_size)`` shape no matter
how many tokens the budget actually granted, so its wall time is bounded
but not *proportional* to the budget.  This module is the layout pass of
the token-packed step program (vLLM-style flattened batch): every token
granted this iteration — one per decode slot, up to a chunk per prefill
slot — is packed into a fixed-capacity ``(capacity,)`` vector together
with its cache-slot id and absolute position.  Granted tokens alone then
determine the compute of the packed model path
(``repro_torch.models.model.packed_prefill``), which is what turns the per-step
token budget (the serving ``tau``) into a genuine per-step compute bound.

Invariants:

* at most ``capacity`` entries; ``pack_step`` raises ``ValueError`` on
  overflow rather than silently truncating;
* scatter destinations ``(slot, position)`` are unique — the packed KV
  write is race-free;
* positions are contiguous per slot, starting at the slot's write
  cursor;
* every granted token appears exactly once, in grant order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: slot id marking padding entries; scatter drops them (out-of-range write
#: position) and the packed attention masks them out.
PAD_SLOT = -1

#: Grant = (slot index, first absolute position, tokens to consume).
Grant = Tuple[int, int, Sequence[int]]


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """One engine iteration's granted tokens, flattened.

    Arrays all have length ``capacity``; entries past ``n_tokens`` are
    padding (``slot_ids == PAD_SLOT``, ``positions == 0``, ``tokens == 0``).
    """

    tokens: np.ndarray  # (capacity,) int32
    slot_ids: np.ndarray  # (capacity,) int32; PAD_SLOT on padding
    positions: np.ndarray  # (capacity,) int32 absolute cache positions
    #: (n_segments + 1,) packed offset of each grant's first token —
    #: diagnostic/telemetry only; the model path derives segment
    #: isolation from slot_ids alone (per-token slot gather)
    segment_starts: np.ndarray
    #: slot -> (first packed index, token count) of its grant — the
    #: speculative verifier reads every granted column; a plain decode
    #: consumer reads the span's last (``start + count - 1``)
    spans: Dict[int, Tuple[int, int]]
    #: (capacity,) int32 per-token *output index* — which generated token
    #: of its request each entry's next-token prediction would be, the
    #: ``fold_in`` data of the sampler's per-position PRNG key
    #: (``serve.sampling``).  Prefill entries before a request's final
    #: prompt token predict tokens that are never emitted; their indices
    #: are clamped to 0 (a key is still derived, the sample discarded).
    #: Padding entries are 0.  All zeros unless ``pack_step`` was given
    #: ``out_base``.
    out_idx: np.ndarray
    n_tokens: int
    capacity: int


def packed_capacity(batch_slots: int, chunk_size: int, token_budget,
                    draft_k: int = 0) -> int:
    """Compiled packed-program length for an engine configuration.

    The scheduler can exceed ``token_budget`` in exactly two ways: decode
    slots are unconditional (up to ``batch_slots`` tokens even when the
    budget is smaller) and the starvation guard grants one extra prefill
    token when decodes alone exhaust the budget — hence
    ``max(batch_slots, token_budget) + 1``.  Speculative draft tokens
    (``draft_k`` per decode slot) are *not* unconditional — they compete
    under the budget like prefill chunks — so they leave the budgeted
    bound unchanged.  With no budget every prefilling slot may take a
    full chunk and every decode slot a full verify window:
    ``batch_slots * max(chunk_size, draft_k + 1)``.
    """
    if token_budget is None:
        return batch_slots * max(chunk_size, draft_k + 1)
    return max(batch_slots, token_budget) + 1


def pack_step(grants: Sequence[Grant], capacity: int,
              out_base: "Dict[int, int] | None" = None) -> PackedLayout:
    """Flatten this iteration's grants into a fixed-capacity layout.

    ``grants`` is the scheduler's output: for each active slot, the slot
    index, the slot's current write cursor (first absolute position), and
    the tokens it consumes this step (one for decode, up to a chunk for
    prefill).  Zero-token grants are allowed and occupy no entries.

    ``out_base`` optionally maps slot -> the output index of the grant's
    *first* entry's prediction (may be negative mid-prefill, where early
    columns predict nothing that is emitted); entry ``j`` of a grant gets
    ``out_base[slot] + j``, clamped at 0, in ``PackedLayout.out_idx``.
    """
    total = sum(len(toks) for _, _, toks in grants)
    if total > capacity:
        raise ValueError(
            f"packed layout overflow: {total} granted tokens > capacity "
            f"{capacity}; the scheduler and packed_capacity() disagree"
        )
    tokens = np.zeros((capacity,), np.int32)
    slot_ids = np.full((capacity,), PAD_SLOT, np.int32)
    positions = np.zeros((capacity,), np.int32)
    out_idx = np.zeros((capacity,), np.int32)
    starts: List[int] = [0]
    spans: Dict[int, Tuple[int, int]] = {}
    cursor = 0
    for slot, pos0, toks in grants:
        m = len(toks)
        if m == 0:
            continue
        tokens[cursor : cursor + m] = toks
        slot_ids[cursor : cursor + m] = slot
        positions[cursor : cursor + m] = np.arange(pos0, pos0 + m)
        if out_base is not None:
            base = out_base.get(slot, 0)
            out_idx[cursor : cursor + m] = np.maximum(
                base + np.arange(m), 0
            )
        spans[slot] = (cursor, m)
        cursor += m
        starts.append(cursor)
    return PackedLayout(
        tokens=tokens,
        slot_ids=slot_ids,
        positions=positions,
        segment_starts=np.asarray(starts, np.int32),
        spans=spans,
        out_idx=out_idx,
        n_tokens=total,
        capacity=capacity,
    )
