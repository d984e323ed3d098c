"""Per-request stochastic decode for the engine (port of
``repro.serve.sampling``).

A frozen :class:`SamplingParams` per request (temperature / top-k / top-p /
seed) and one sampler, :func:`sample_rows`, that every step program (dense
``(B, C)``, packed ``(capacity,)``, paged) feeds its logits through.  The
reference's contract holds token for token:

* **Per-request, per-position keys.**  Output token ``i`` of a request with
  seed ``s`` is drawn with JAX's ``fold_in(PRNGKey(s), i)``: a pure function
  of the seed and the output index, so streams replay across engine
  restarts, step programs and speculation.
* **``temperature == 0`` is greedy**: the f32 argmax of the raw logits,
  selected per row, so the default params give the greedy engine's tokens.
* **The host picks the program.**  The per-row parameters are host arrays
  built from request fields, so the sampler specialises on them without a
  device read (``sample_mode``): an all-greedy step is one argmax, a sampled
  step without truncation skips the threshold search, and only steps where
  some sampled row asks for top-k / top-p run it.  Which program serves a
  row never changes its token.

Sampling is Gumbel-max over the masked, temperature-scaled logits.  Top-k
and top-p reduce to per-row value thresholds (ties with the boundary kept),
found by a 32-step bisection over the monotone unsigned encoding of the f32
scores (``_sort_key``, ``_bisect_threshold``) instead of a sort.

JAX's bits without JAX.  The threefry-2x32 hash (20 rounds in JAX's
rotation schedule), ``PRNGKey`` (the pair (0, seed) of a 32-bit seed),
``fold_in`` (threefry of the count (0, data)), the partitionable random
bits (threefry of the 64-bit element index split in two 32-bit halves, the
two output words XORed: ``jax.config.jax_threefry_partitionable``, JAX's
default since 0.5), the uniform (the top 23 bits as a mantissa in [1, 2),
minus 1) and the Gumbel draw in mode ``'low'`` (``-log(-log(u))`` with u
floored at the smallest normal) are written out in int64 arithmetic masked
to 32 bits, exact on the CPU and on the card (torch's uint32 support on
CUDA is partial).  The words and the uniforms are integer and exact
arithmetic and equal JAX's bit for bit; the two ``log`` calls are the
library's and may differ from XLA's by an ulp (``tests/test_torch_sampling.py``
holds both).

:func:`residual_sample` is the rejection-sampling residual
``norm(max(p - q, 0))`` for a proposer that exposes its full draft
distribution; the shipped proposers are deterministic, for which the
coupled form in ``spec.accept_sampled`` is exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal f32, the uniform's floor in JAX's Gumbel draw
_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode knobs (same fields and checks as the reference):
    ``temperature`` (0 = greedy argmax), ``top_k`` (0 = off), ``top_p``
    (1 = off; the top token always survives), ``seed`` (output token ``i``
    is drawn with ``fold_in(PRNGKey(seed), i)``)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        # raised, never assert-ed (asserts vanish under python -O)
        if not (isinstance(self.temperature, (int, float))
                and math.isfinite(self.temperature) and self.temperature >= 0):
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature!r}"
            )
        if not (isinstance(self.top_k, (int, np.integer)) and self.top_k >= 0):
            raise ValueError(f"top_k must be an int >= 0, got {self.top_k!r}")
        if not (isinstance(self.top_p, (int, float)) and 0 < self.top_p <= 1):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p!r}")
        if not isinstance(self.seed, (int, np.integer)):
            raise ValueError(f"seed must be an int, got {self.seed!r}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0

    def with_seed(self, seed: int) -> "SamplingParams":
        return dataclasses.replace(self, seed=int(seed))


#: the default params — argmax decode
GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# JAX's threefry PRNG, in int64 tensors holding uint32 values
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counts (x1, x2) under the key (k1, k2),
    all int64 tensors of uint32 values (broadcast together):
    ``jax._src.prng._threefry2x32_lowering`` unrolled."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of 32-bit seeds: (..., 2) int64, the
    pair (0, seed) (the high word of a 32-bit seed is 0)."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _M32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the count (0, data)
    under ``key`` (..., 2); ``data`` broadcasts against the key's lead."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for keys (R, 2) (a key's row each):
    (R, n) int64 words, threefry of each element's 64-bit index (high and
    low halves) with the two output words XORed (the partitionable bits)."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[:, 0, None], key[:, 1, None], idx >> 32, idx & _M32)
    return b0 ^ b1


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0) -> torch.Tensor:
    """JAX's f32 uniform on [minval, 1) from 32-bit words: the top 23 bits
    as the mantissa of a float in [1, 2), minus 1, scaled and floored at
    ``minval`` (``jax._src.random._uniform``)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    scale = float(np.float32(1.0) - np.float32(minval))
    return torch.clamp(f * scale + np.float32(minval), min=float(np.float32(minval)))


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``'low'``) from its words:
    ``-log(-log(u))``, u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform_from_bits(bits, _TINY)))


def row_gumbel(seeds: torch.Tensor, out_idx: torch.Tensor, v: int) -> torch.Tensor:
    """(R, v) Gumbel noise, row r drawn with ``fold_in(PRNGKey(seeds[r]),
    out_idx[r])`` (``sampling.py:125-127`` vmapped over rows)."""
    return gumbel_from_bits(random_bits(fold_in(prng_key(seeds), out_idx), v))


# ---------------------------------------------------------------------------
# Top-k / top-p keep masks by threshold bisection
# ---------------------------------------------------------------------------


def _sort_key(scaled: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> uint32 encoding (int64 values): ``a < b`` iff
    ``key(a) < key(b)``; ``+ 0.0`` first makes -0.0 +0.0."""
    b = (scaled + 0.0).view(torch.int32).to(torch.int64) & _M32
    return torch.where((b >> 31) == 1, (~b) & _M32, b | 0x80000000)


def _bisect_threshold(u: torch.Tensor, predicate) -> torch.Tensor:
    """Largest key ``s`` per row with ``predicate(u >= s)`` true (or 0), by
    32 bisection steps; ``predicate`` maps the (R, V) at-or-above mask to
    (R,) bools and must be true at 0 and fall as ``s`` grows."""
    lo = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
    hi = torch.full_like(lo, _M32)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        ok = predicate(u >= mid[:, None])
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def _keep_mask(scaled, tk, tp, use_topk: bool, use_topp: bool) -> torch.Tensor:
    """The rows' top-k / top-p keep masks (``sampling.py:153-197``): top-k
    keeps the scores at or above the k-th largest, top-p those at or above
    the smallest score whose at-or-above probability mass still reaches
    ``top_p``; a filter no row uses is skipped (the static flags)."""
    v = scaled.shape[-1]
    u = _sort_key(scaled)
    keep = torch.ones(scaled.shape, dtype=torch.bool, device=scaled.device)
    if use_topk:
        k = torch.clamp(tk, 1, v)
        kth = _bisect_threshold(u, lambda m: m.sum(dim=-1) >= k)
        keep &= (u >= kth[:, None]) | (tk <= 0)[:, None]
    if use_topp:
        probs = torch.softmax(scaled, dim=-1)
        pth = _bisect_threshold(
            u, lambda m: torch.where(m, probs, 0.0).sum(dim=-1) >= tp)
        keep &= u >= pth[:, None]
    return keep


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis in f32 (bf16 logits upcast exactly, so the
    argmax is that of the raw logits; ties go to the first index, as in
    JAX).  Returns int64 tokens with the leading shape."""
    return logits.float().argmax(dim=-1)


def sample_mode(temperature, top_k, top_p) -> str:
    """The sampler program a step's host-side per-row parameters need:
    ``"greedy"`` (no sampled row), ``"plain"`` (sampled, untruncated), or
    ``"topk"``, ``"topp"``, ``"topk+topp"`` (a sampled row asks for that
    filter).  ``sampling.py:252-261``."""
    sampled = np.asarray(temperature) > 0
    if not sampled.any():
        return "greedy"
    filters = [name for name, used in (("topk", (np.asarray(top_k) > 0)),
                                       ("topp", (np.asarray(top_p) < 1.0)))
               if (sampled & used).any()]
    return "+".join(filters) or "plain"


def sample_rows(logits, seeds, out_idx, temperature, top_k, top_p, mode: str) -> torch.Tensor:
    """One token per logits row (``sampling.py:200-227``), every argument a
    tensor (or numpy array) with the logits' leading shape: ``seeds``
    and ``out_idx`` int64 (uint32 values: the row's key is
    ``fold_in(PRNGKey(seed), out_idx)``), ``temperature`` and ``top_p`` f32,
    ``top_k`` int64.  ``mode`` is ``sample_mode`` of the host arrays these
    were made from.  Rows with temperature 0 give the raw argmax; the others
    Gumbel-max over the masked, scaled logits.  Returns int64 tokens with
    the leading shape.  No host read: a captured step can run it."""
    if mode == "greedy":
        return greedy_tokens(logits)
    seeds, out_idx, temperature, top_k, top_p = (
        torch.as_tensor(x, device=logits.device)
        for x in (seeds, out_idx, temperature, top_k, top_p))
    lead, v = logits.shape[:-1], logits.shape[-1]
    lg = logits.reshape(-1, v).float()
    t = temperature.reshape(-1).float()
    greedy_tok = lg.argmax(dim=-1)
    scaled = lg / torch.where(t > 0, t, 1.0)[:, None]
    if mode != "plain":
        keep = _keep_mask(scaled, top_k.reshape(-1), top_p.reshape(-1).float(),
                          "topk" in mode, "topp" in mode)
        scaled = torch.where(keep, scaled, -math.inf)
    g = row_gumbel(seeds.reshape(-1), out_idx.reshape(-1), v)
    stoch = (scaled + g).argmax(dim=-1)
    return torch.where(t > 0, stoch, greedy_tok).reshape(lead)


def sampler_inputs(seeds, out_idx, temperature, top_k, top_p, device=None):
    """The host per-row arrays as ``sample_rows``' tensors (seeds masked to
    32 bits, output indices clamped at 0)."""
    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return (dev(np.asarray(seeds, np.int64) & _M32, torch.int64),
            dev(np.maximum(np.asarray(out_idx, np.int64), 0), torch.int64),
            dev(temperature, torch.float32), dev(top_k, torch.int64),
            dev(top_p, torch.float32))


def sample_tokens(logits, seeds, out_idx, temperature, top_k, top_p) -> torch.Tensor:
    """Sample one token per logits row, engine-style (``sampling.py:230-264``):
    ``logits`` (..., V); the per-row params host arrays with the leading
    shape.  The host arrays pick the program (``sample_mode``)."""
    mode = sample_mode(temperature, top_k, top_p)
    return sample_rows(logits, *sampler_inputs(seeds, out_idx, temperature, top_k, top_p,
                                               logits.device), mode)


def sample_one(logits, params: SamplingParams, out_idx: int) -> int:
    """Output token ``out_idx`` from one (V,) logits row exactly as the
    engine draws it: the single-request reference (``sampling.py:267-281``)."""
    row = torch.as_tensor(logits).reshape(1, -1)
    tok = sample_tokens(row, [params.seed & _M32], [max(int(out_idx), 0)],
                        [params.temperature], [params.top_k], [params.top_p])
    return int(tok[0])


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` with one key (2,):
    the argmax of logits plus Gumbel noise drawn over the flattened
    (..., V) shape."""
    n = logits.numel()
    bits = random_bits(key.reshape(1, 2).to(torch.int64), n).reshape(logits.shape)
    return (gumbel_from_bits(bits) + logits).argmax(dim=-1)


def residual_sample(target_logits, draft_probs, key) -> torch.Tensor:
    """A draw from the rejection-sampling residual ``norm(max(p - q, 0))``
    (``sampling.py:284-313``): ``target_logits`` (..., V) raw, ``draft_probs``
    (..., V) the proposer's distribution, ``key`` a (2,) PRNG key (uint32
    values).  A zero residual (``q == p``) samples ``p`` itself."""
    tl = torch.as_tensor(target_logits)
    key = torch.as_tensor(np.asarray(key, np.int64) if not isinstance(key, torch.Tensor)
                          else key, device=tl.device)
    p = torch.softmax(tl.float(), dim=-1)
    r = torch.clamp(p - torch.as_tensor(draft_probs, device=tl.device).float(), min=0.0)
    z = r.sum(dim=-1, keepdim=True)
    r = torch.where(z > 0, r / torch.where(z > 0, z, 1.0), p)
    logr = torch.where(r > 0, torch.log(torch.clamp(r, min=1e-38)), -math.inf)
    return categorical(key, logr)


__all__ = [
    "GREEDY",
    "SamplingParams",
    "categorical",
    "fold_in",
    "greedy_tokens",
    "prng_key",
    "random_bits",
    "residual_sample",
    "row_gumbel",
    "sample_mode",
    "sample_one",
    "sample_rows",
    "sample_tokens",
    "sampler_inputs",
    "threefry2x32",
]
