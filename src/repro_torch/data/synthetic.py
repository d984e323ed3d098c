"""Deterministic synthetic data pipeline with realistic length variability.

Carried over from ``repro.data.synthetic`` unchanged (numpy only: the port keeps its own
copy); ``tests/test_torch_core.py`` pins it to exact equality.

The paper's compute-variance story is driven by *dynamic sequence lengths*
(appendix A.1/B.1): user-post lengths follow a log-normal distribution
[Sobkowicz et al. 2013].  This pipeline generates token streams whose
document lengths are log-normal, and offers the two standard batching
strategies the paper discusses:

  * ``pad``  — one document per row, padded to seq_len (wasted compute,
    but per-row compute varies with true length -> compute variance);
  * ``pack`` — documents concatenated and chunked to fixed seq_len
    [Kosec et al. 2021] (uniform compute, the "engineering fix" whose
    cost DropCompute avoids).

Data is sampled from a Zipf-ish unigram distribution with a deterministic
per-(epoch, step, worker) PRNG so every worker/shard regenerates its exact
shard without any coordination — the pipeline is stateless and resumable
from a step counter (checkpoint-friendly).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 512
    batch_size: int = 8  # per-step global batch
    strategy: str = "pack"  # pack | pad
    # log-normal document lengths (tokens)
    len_mean: float = 180.0
    len_sigma: float = 1.0
    seed: int = 0
    # learnable-structure knob: 0 = iid unigrams, >0 = kth-order repeats so
    # tiny models actually have something to learn in convergence tests.
    structure: float = 0.5


def _doc_lengths(rng: np.random.Generator, n: int, cfg: DataConfig) -> np.ndarray:
    sig2 = np.log(1.0 + cfg.len_sigma)
    mu = np.log(cfg.len_mean) - sig2 / 2
    return np.clip(rng.lognormal(mu, np.sqrt(sig2), size=n).astype(np.int64), 4, cfg.seq_len)


def _sample_tokens(rng: np.random.Generator, n: int, cfg: DataConfig) -> np.ndarray:
    # Zipf unigram over the vocab
    ranks = np.arange(1, cfg.vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=n, p=probs)
    if cfg.structure > 0:
        # Make token t+1 depend on t for a fraction of positions: y = (x*7+3)%V
        dep = rng.random(n) < cfg.structure
        toks[1:] = np.where(dep[1:], (toks[:-1] * 7 + 3) % cfg.vocab_size, toks[1:])
    return toks.astype(np.int32)


def batch_at(step: int, cfg: DataConfig, worker: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic batch for (step, worker): {'tokens', 'weights', 'lengths'}."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, worker, step]))
    b, s = cfg.batch_size, cfg.seq_len
    if cfg.strategy == "pack":
        tokens = _sample_tokens(rng, b * s, cfg).reshape(b, s)
        weights = np.ones((b, s), np.float32)
        lengths = np.full((b,), s, np.int64)
    else:
        lengths = _doc_lengths(rng, b, cfg)
        tokens = np.zeros((b, s), np.int32)
        weights = np.zeros((b, s), np.float32)
        for i, ln in enumerate(lengths):
            tokens[i, :ln] = _sample_tokens(rng, int(ln), cfg)
            weights[i, :ln] = 1.0
    return {"tokens": tokens, "weights": weights, "lengths": lengths}


def microbatches_at(step: int, cfg: DataConfig, m: int, worker: int = 0) -> Dict[str, np.ndarray]:
    """Batch reshaped to M micro-batches: leaves get leading dim M."""
    assert cfg.batch_size % m == 0, (cfg.batch_size, m)
    b = batch_at(step, cfg, worker)
    mb = cfg.batch_size // m
    return {
        "tokens": b["tokens"].reshape(m, mb, cfg.seq_len),
        "weights": b["weights"].reshape(m, mb, cfg.seq_len),
    }


def compute_cost_proxy(lengths: np.ndarray, seq_len: int, strategy: str) -> float:
    """Relative compute of a batch (1.0 = fully packed).  With 'pad', true
    compute tracks sum(lengths)/(B*S) — the source of compute variance."""
    if strategy == "pack":
        return 1.0
    return float(lengths.sum() / (lengths.shape[0] * seq_len))


class DataStream:
    """Iterator facade used by the trainer."""

    def __init__(self, cfg: DataConfig, microbatches: Optional[int] = None, worker: int = 0):
        self.cfg = cfg
        self.m = microbatches
        self.worker = worker
        self.step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.m is None:
            b = batch_at(self.step, self.cfg, self.worker)
        else:
            b = microbatches_at(self.step, self.cfg, self.m, self.worker)
        self.step += 1
        return b
