"""The port's speculative decoding and sampled serving against the JAX
package's engine, on the CPU in f32.

* ``accept_greedy`` / ``accept_sampled`` and ``NGramProposer.propose``
  exactly against the reference on seeded drafts and histories;
* the engine with ``spec=`` (n-gram and self-draft, dense and paged,
  unpacked and packed, greedy and sampled) giving the reference engine's
  streams, step counts and draft / accepted counts, exactly;
* sampled streams identical across dense, paged + packed, ``token_budget=1``
  and speculation (the reference's ``tests/test_serve_sampling.py``
  contract), and equal to ``sample_one`` replayed on a single-request
  ``decode_step`` loop;
* rejected drafts rolled back on the paged layout: no page leaked, the
  allocator's invariants after every step;
* spec on 'R' / 'M' stacks refused with "roll back".
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import DraftModelProposer as JDraft  # noqa: E402
from repro.serve import NGramProposer as JNGram  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JParams  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.serve import spec as jspec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import UnsupportedPatternError, model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    DraftModelProposer,
    NGramProposer,
    Proposer,
    Request,
    SamplingParams,
    SpecConfig,
    accept_greedy,
    accept_sampled,
    sample_one,
)

torch.set_num_threads(1)

#: the reference spec suite's model (``tests/test_serve_spec.py``)
FIELDS = dict(name="serve-spec-t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
              vocab_size=101, layer_pattern="LG", sliding_window=6, dtype="float32",
              remat=False)
JCFG, CFG = JConfig(**FIELDS), ModelConfig(**FIELDS)
PROMPT_LENS = (3, 5, 12, 4, 8)
MAX_NEW, MAX_LEN = 8, 32
SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=0)


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def make_prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in lens]
    prompts[2] = prompts[2][:6] * 2  # a repeating prompt: the n-gram proposer drafts
    return prompts


def sampling_of(i, sampled):
    """Request i's params: greedy, or sampled with a per-request seed (every
    third also top-k 20; request 1 stays greedy, a mixed batch)."""
    if not sampled or i == 1:
        return {}
    return dict(SAMPLED, seed=1000 + i, top_k=20 if i % 3 == 0 else 0)


def run(batcher, request, params_cls, p, cfg, prompts, sampled=False, check=None, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_size", 16)
    eng = batcher(p, cfg, **kw)
    for i, pr in enumerate(prompts):
        eng.submit(request(uid=i, prompt=list(pr), max_new_tokens=MAX_NEW,
                           sampling=params_cls(**sampling_of(i, sampled))))
    while eng.busy:
        eng.step()
        if check is not None:
            check(eng)
    return eng


def outputs(eng):
    return {u: r.output for u, r in sorted(eng.finished.items())}


def counts(eng):
    return [(s.decode_tokens, s.prefill_tokens, s.draft_tokens, s.accepted_tokens)
            for s in eng.step_stats]


def kv_invariants(eng):
    if eng.kv is not None:
        eng.kv.check_invariants()


# ---------------------------------------------------------------------------
# acceptance and the n-gram proposer
# ---------------------------------------------------------------------------


def test_acceptance_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        k = int(rng.integers(0, 6))
        sampled = rng.integers(0, 4, k + 1).tolist()
        draft = [t if rng.random() < 0.7 else (t + 1) % 4 for t in sampled[:k]]
        assert accept_sampled(draft, sampled) == jspec.accept_sampled(draft, sampled)
        assert accept_greedy(draft, sampled) == jspec.accept_greedy(draft, sampled)


@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_proposer_matches_reference(max_ngram, min_ngram):
    rng = np.random.default_rng(max_ngram * 10 + min_ngram)
    ours, ref = NGramProposer(max_ngram, min_ngram), JNGram(max_ngram, min_ngram)
    for _ in range(200):
        hist = rng.integers(0, 5, int(rng.integers(1, 30))).tolist()
        k = int(rng.integers(1, 6))
        assert ours.propose(hist, k) == ref.propose(hist, k)
    asks = [(0, [1, 2, 3, 1, 2], 3), (1, [4], 2), (3, [7, 7, 7], 0)]
    assert ours.propose_batch(asks) == ref.propose_batch(asks)


def test_config_checks():
    with pytest.raises(ValueError):
        NGramProposer(2, 3)
    with pytest.raises(ValueError):
        SpecConfig(NGramProposer(), k=0)
    with pytest.raises(TypeError):
        SpecConfig(object())


# ---------------------------------------------------------------------------
# the engine with spec=, against the reference's
# ---------------------------------------------------------------------------


ENGINE_MATRIX = [
    ("ngram", "dense", False, None), ("ngram", "paged", False, None),
    ("ngram", "paged", True, 6), ("ngram", "dense", True, None),
    ("draft", "dense", False, None), ("draft", "paged", True, None),
]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("proposer,cache,packed,budget", ENGINE_MATRIX)
def test_spec_engine_matches_reference(params, proposer, cache, packed, budget, sampled):
    jp, tp = params
    prompts = make_prompts()
    if proposer == "ngram":
        jprop, tprop = JNGram(), NGramProposer()
    else:  # the reference tests' self-draft: the target drafts for itself
        jprop = JDraft(jp, JCFG, batch_slots=2, max_len=MAX_LEN)
        tprop = DraftModelProposer(tp, CFG, batch_slots=2, max_len=MAX_LEN)
    kw = dict(cache=cache, packed=packed, token_budget=budget, page_size=4)
    je = run(JBatcher, JRequest, JParams, jp, JCFG, prompts, sampled,
             spec=JSpecConfig(jprop, k=4), **kw)
    te = run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts, sampled,
             check=kv_invariants, spec=SpecConfig(tprop, k=4), **kw)
    assert outputs(te) == outputs(je)
    assert te.steps == je.steps
    assert counts(te) == counts(je)
    assert sum(s.accepted_tokens for s in te.step_stats) > 0
    if te.kv is not None:
        assert te.kv.used_pages == 0
    summary = te.stats_summary()
    assert summary["draft_tokens"] == je.stats_summary()["draft_tokens"]


class JunkProposer(Proposer):
    """Deterministic junk drafts (~0% acceptance): every verify step rolls
    its whole tail back."""

    name = "junk"

    def propose_batch(self, asks):
        return {s: [(7 * len(h) + j) % CFG.vocab_size for j in range(k)] for s, h, k in asks}


@pytest.mark.parametrize("packed", [False, True])
def test_junk_drafts_roll_back_without_leaking_pages(params, packed):
    jp, tp = params
    prompts = make_prompts(seed=3)
    oracle = run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts, sampled=True)
    te = run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts, sampled=True,
             check=kv_invariants, cache="paged", page_size=4, packed=packed,
             spec=SpecConfig(JunkProposer(), k=3))
    assert outputs(te) == outputs(oracle)
    assert sum(s.draft_tokens for s in te.step_stats) > sum(
        s.accepted_tokens for s in te.step_stats)
    assert te.kv.used_pages == 0


# ---------------------------------------------------------------------------
# sampled serving: one stream whatever the step program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache,packed,budget", [("dense", False, None),
                                                 ("paged", True, None),
                                                 ("paged", False, 6)])
def test_sampled_engine_matches_reference(params, cache, packed, budget):
    jp, tp = params
    prompts = make_prompts(seed=5)
    kw = dict(cache=cache, packed=packed, token_budget=budget, page_size=4)
    je = run(JBatcher, JRequest, JParams, jp, JCFG, prompts, sampled=True, **kw)
    te = run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts, sampled=True, **kw)
    assert outputs(te) == outputs(je)
    assert te.steps == je.steps


def test_sampled_streams_identical_across_step_programs(params):
    _, tp = params
    prompts = make_prompts(seed=7)
    base = run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts, sampled=True)
    greedy = run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts)
    for kw in (dict(cache="paged", packed=True, page_size=4), dict(token_budget=1),
               dict(cache="paged", page_size=4, spec=SpecConfig(NGramProposer(), k=4)),
               dict(chunk_size=1)):
        assert outputs(run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts,
                           sampled=True, **kw)) == outputs(base), kw
    differs = [u for u in outputs(base) if outputs(base)[u] != outputs(greedy)[u]]
    assert differs and 1 not in differs  # request 1 is greedy in both runs


def test_sampled_stream_replays_sample_one(params):
    """Each emitted token is ``sample_one`` of the logits row a
    single-request ``decode_step`` loop gives at that point, for the
    request's seed and output index."""
    _, tp = params
    prompts = make_prompts(seed=9)[:3]
    eng = run(ContinuousBatcher, Request, SamplingParams, tp, CFG, prompts, sampled=True,
              cache="paged", page_size=4, packed=True)
    for i, prompt in enumerate(prompts):
        sp = SamplingParams(**sampling_of(i, True))
        cache = model.init_decode_cache(tp, CFG, 1, MAX_LEN, linear=True)
        cur, out = list(prompt), []
        for t in range(len(prompt) + MAX_NEW - 1):
            lg, cache = model.decode_step(tp, CFG, cache, [[cur[t]]], [t])
            if t >= len(prompt) - 1:
                tok = sample_one(lg[0, 0], sp, len(out))
                cur.append(tok)
                out.append(tok)
        assert eng.finished[i].output == out


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hybrid_tiny", "mamba2_tiny"])
def test_spec_on_recurrent_stacks_refused(name):
    cfg = get_config(name)
    tp = model.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(UnsupportedPatternError, match="roll back"):
        ContinuousBatcher(tp, cfg, batch_slots=2, max_len=16,
                          spec=SpecConfig(NGramProposer(), k=2))
    with pytest.raises(UnsupportedPatternError, match="roll back"):
        ContinuousBatcher(tp, cfg, batch_slots=2, max_len=16, spec=NGramProposer())


def test_draft_proposer_refuses_a_larger_engine(params):
    _, tp = params
    prop = DraftModelProposer(tp, CFG, batch_slots=2, max_len=16)
    with pytest.raises(ValueError, match="cannot cover"):
        ContinuousBatcher(tp, CFG, batch_slots=3, max_len=16, spec=SpecConfig(prop))
    assert dataclasses.is_dataclass(SpecConfig(prop))
