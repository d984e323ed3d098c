"""Speculative decoding on the serving engine (port of ``repro.serve.spec``).

A cheap **proposer** guesses ``k`` tokens per decode slot, the target model
**verifies** all of them in one bounded step (the chunked step at the
slot's absolute positions, ``models.model.verify_step``; K4 on the paged
layout), and the engine keeps the prefix the target's per-column samples
confirm plus one bonus token.  The speculation is the decode-side analogue
of DropCompute's tau: a bounded verify step and a random acceptance count.
Every emitted token is the target's own sample (its argmax when greedy)
given the accepted history, so the streams are the non-speculative
engine's whatever the proposer guessed.

Rollback of rejected drafts: dense slots need nothing (rows past the
position cursor are never attended), the paged layout drops the overshot
blocks with ``KVCache.trim_slot``.

Two proposers: :class:`NGramProposer` (prompt lookup: the continuation of
the history's trailing n-gram's latest earlier occurrence) and
:class:`DraftModelProposer` (a second model on its own dense cache, one
slot per engine slot; its steps are the port's ``prefill_chunk``, on the
card each step shape one captured CUDA graph).  The engine drives either
through ``propose_batch`` before scheduling and ``free_slot`` when a
request leaves its slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..graphs import StepGraph
from ..models.config import ModelConfig
from ..models.model import (compute_params, init_decode_cache, params_device, prefill_chunk,
                            require_chunkable)
from .sampling import greedy_tokens

#: one proposer ask: (slot index, token history = prompt + output, max k)
Ask = Tuple[int, List[int], int]


def accept_sampled(draft: Sequence[int], sampled: Sequence[int]) -> Tuple[int, List[int]]:
    """Rejection-sampling acceptance against the verify step's sampled
    columns (``spec.py:59-103``): ``sampled[j]`` is the token the target
    draws after the grant through column j, with the request's params and
    the key of output index ``base + j``.  Draft j is accepted iff it equals
    ``sampled[j]``; the first mismatching (or final) column supplies the
    bonus token.  Returns ``(n_accepted, sampled[: n_accepted + 1])``.  For
    a deterministic proposer (a point-mass draft distribution) this is the
    rejection-sampling rule, and it keeps the streams realization-identical
    to the non-speculative engine's; with greedy params it is the argmax
    prefix match."""
    a = 0
    while a < len(draft) and int(draft[a]) == int(sampled[a]):
        a += 1
    return a, [int(t) for t in sampled[: a + 1]]


def accept_greedy(draft: Sequence[int], greedy: Sequence[int]) -> Tuple[int, List[int]]:
    """The longest draft prefix matching the verify step's per-column
    argmax, plus the bonus token: ``accept_sampled`` at temperature 0."""
    return accept_sampled(draft, greedy)


class Proposer:
    """Draft-token source: ``propose_batch`` gets every decode slot's ask
    for the coming step and returns per-slot drafts (possibly fewer than
    asked, or none); ``free_slot`` is called when a request leaves a slot."""

    name = "null"

    def bind_engine(self, batch_slots: int, max_len: int) -> None:
        """Called once at engine construction with its geometry; a stateful
        proposer refuses one it cannot cover."""

    def propose_batch(self, asks: Sequence[Ask]) -> Dict[int, List[int]]:
        return {}

    def free_slot(self, slot: int) -> None:
        pass


class NGramProposer(Proposer):
    """Prompt-lookup decoding: the continuation of the most recent earlier
    occurrence of the history's trailing n-gram, longest n first
    (``spec.py:146-181``).  No model, no state."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got {min_ngram}..{max_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose_batch(self, asks: Sequence[Ask]) -> Dict[int, List[int]]:
        return {slot: self.propose(hist, k) for slot, hist, k in asks if k > 0}

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        n_hist = len(hist)
        for n in range(min(self.max_ngram, n_hist - 1), self.min_ngram - 1, -1):
            suffix = hist[n_hist - n:]
            for start in range(n_hist - n - 1, -1, -1):
                if hist[start:start + n] == suffix:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return [int(t) for t in cont]
        return []


class DraftModelProposer(Proposer):
    """Draft tokens from a second model on its own dense cache, one slot per
    engine slot (``spec.py:192-340``).  Each ``propose_batch`` first catches
    up (chunk-prefills the history the draft cache has not seen), then runs
    ahead up to k one-token steps, all slots together.  The run-ahead rows
    are speculative: the cursor stays at the history length, so whatever the
    target accepts arrives as the next catch-up and overwrites them.

    Its steps are ``prefill_chunk`` followed by the f32 argmax; on the card
    each step shape, (B, chunk_size) and (B, 1), is one captured CUDA graph
    (``graphs.StepGraph``).  ``params`` are cast to the compute dtype once
    (``compute_params``: the target's own cast tree is reused as it is)."""

    name = "draft"

    def __init__(self, params, cfg: ModelConfig, batch_slots: int, max_len: int,
                 chunk_size: int = 32):
        require_chunkable(cfg, "DraftModelProposer")
        if batch_slots < 1 or max_len < 1 or chunk_size < 1:
            raise ValueError("batch_slots, max_len, chunk_size must be >= 1")
        self.params = compute_params(params, cfg)
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.chunk_size = chunk_size
        self.cache = init_decode_cache(self.params, cfg, batch_slots, max_len, linear=True)
        self._pos = [0] * batch_slots  # history tokens the draft cache holds
        # the tokens those rows were written from: the recycled-slot guard
        self._hist: List[List[int]] = [[] for _ in range(batch_slots)]
        self.step_graph = StepGraph(self._program, params_device(self.params))
        self.steps = 0  # draft-model steps run

    def _program(self, tokens, pos, lens):
        # the draft runs the dense MoE dispatch whatever the target's
        # (``serve/spec.py:186``)
        logits, _ = prefill_chunk(self.params, self.cfg, self.cache, tokens, pos, lens,
                                  moe_impl="dense")
        return greedy_tokens(logits)

    def _step(self, tokens, pos, lens) -> np.ndarray:
        self.steps += 1
        return self.step_graph(tokens.shape, tokens, pos, lens).cpu().numpy()

    def bind_engine(self, batch_slots: int, max_len: int) -> None:
        if batch_slots > self.batch_slots or max_len > self.max_len:
            raise ValueError(
                f"DraftModelProposer(batch_slots={self.batch_slots}, "
                f"max_len={self.max_len}) cannot cover an engine with "
                f"batch_slots={batch_slots}, max_len={max_len}"
            )

    def free_slot(self, slot: int) -> None:
        # the rows need no clearing: the next request's catch-up overwrites
        # from position 0 and the position mask hides the rest
        self._pos[slot] = 0
        self._hist[slot] = []

    def propose_batch(self, asks: Sequence[Ask]) -> Dict[int, List[int]]:
        asks = [(s, h, min(k, self.max_len - len(h)))
                for s, h, k in asks if k > 0 and len(h) < self.max_len]
        asks = [(s, h, k) for s, h, k in asks if k > 0]
        if not asks:
            return {}
        for s, h, _ in asks:
            # rewind the cursor to the longest prefix of h the rows were
            # really written from (a recycled slot, a divergent history)
            held = self._hist[s]
            m = 0
            limit = min(self._pos[s], len(held), len(h))
            while m < limit and held[m] == h[m]:
                m += 1
            if m < self._pos[s]:
                self._pos[s] = m
                self._hist[s] = held[:m]

        b = self.batch_slots
        # 1) catch up; the chunk holding a slot's last history token gives
        # its first draft token
        seed: Dict[int, int] = {}
        while True:
            tokens = np.zeros((b, self.chunk_size), np.int64)
            pos = np.zeros((b,), np.int64)
            lens = np.zeros((b,), np.int64)
            finishing: List[int] = []
            for s, h, _ in asks:
                delta = len(h) - self._pos[s]
                if delta == 0:
                    continue
                n = min(delta, self.chunk_size)
                tokens[s, :n] = h[self._pos[s]:self._pos[s] + n]
                pos[s] = self._pos[s]
                lens[s] = n
                self._pos[s] += n
                self._hist[s] = list(h[:self._pos[s]])
                if n == delta:
                    finishing.append(s)
            if not lens.any():
                break
            nxt = self._step(tokens, pos, lens)  # (B, C)
            for s in finishing:
                seed[s] = int(nxt[s, int(lens[s]) - 1])

        # 2) run ahead: up to max(k) - 1 one-token steps, all slots together
        drafts: Dict[int, List[int]] = {s: [seed[s]] for s, _, _ in asks}
        max_k = max(k for _, _, k in asks)
        cursor = {s: len(h) for s, h, _ in asks}
        for _ in range(max_k - 1):
            active = [(s, k) for s, _, k in asks
                      if len(drafts[s]) < k and cursor[s] < self.max_len]
            if not active:
                break
            tokens = np.zeros((b, 1), np.int64)
            pos = np.zeros((b,), np.int64)
            lens = np.zeros((b,), np.int64)
            for s, _ in active:
                tokens[s, 0] = drafts[s][-1]
                pos[s] = cursor[s]
                lens[s] = 1
            nxt = self._step(tokens, pos, lens)
            for s, _ in active:
                drafts[s].append(int(nxt[s, 0]))
                cursor[s] += 1
        return drafts


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding knobs for ``ContinuousBatcher``: the
    ``proposer`` and ``k``, the most drafts verified per decode slot a step
    (scheduled under the engine's token budget, below the decode baselines
    and above prefill)."""

    proposer: Proposer
    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")
        if not isinstance(self.proposer, Proposer):
            raise TypeError(
                f"proposer must be a repro_torch.serve.spec.Proposer, got "
                f"{type(self.proposer).__name__}"
            )


__all__ = [
    "Ask",
    "DraftModelProposer",
    "NGramProposer",
    "Proposer",
    "SpecConfig",
    "accept_greedy",
    "accept_sampled",
]
