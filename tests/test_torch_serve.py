"""The port's serving engine against the JAX package's, on the CPU in f32.

Same requests through both ``ContinuousBatcher``s (the ``qwen2_5_3b`` smoke
config, JAX-initialised weights) over {dense, paged} x {packed, not} x
budgets {None, 4, 16}: greedy streams, step counts, per-step scheduling
stats, block tables after every step and prefix-shared token counts must
be identical.  int8 pages must reach the reference's >= 90% token-match
tier.  The numpy carry-overs (``PagedTables``, ``pack_step``) must equal
the reference's on seeded op sequences.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import PagedTables as JTables  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import pack_step as jpack_step  # noqa: E402
from repro.serve import packed_capacity as jpacked_capacity  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    InvalidRequestError,
    PagedTables,
    PageError,
    Request,
    SamplingParams,
    UnsupportedDistError,
    pack_step,
    packed_capacity,
)

torch.set_num_threads(1)

JCFG, CFG = jget_smoke("qwen2_5_3b"), get_smoke_config("qwen2_5_3b")
SCHED_FIELDS = ("step", "decode_tokens", "prefill_tokens", "deferred_tokens",
                "shared_tokens", "used_pages", "queued_requests", "budget_overshoot")


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def make_prompts(seed=0):
    """Mixed lengths through 3 slots (slot reuse, mixed decode+prefill
    steps), two requests sharing a 9-token prefix (prefix pages at
    page_size 4) and one identical to another (in-flight dedup)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, CFG.vocab_size, 9).tolist()
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n in (3, 14, 6)]
    prompts += [prefix + [1, 2], prefix + [3, 4, 5, 6], list(prompts[1]), [7]]
    return prompts


def run(batcher, request, p, cfg, prompts, cancel_uid=None, **kw):
    eng = batcher(p, cfg, batch_slots=3, max_len=32, chunk_size=4, **kw)
    tables = []
    eng.add_step_callback(
        lambda st: tables.append(None if eng.kv is None else eng.kv.tables.device_tables()))
    for i, pr in enumerate(prompts):
        eng.submit(request(uid=i, prompt=list(pr), max_new_tokens=5))
    if cancel_uid is not None:
        for _ in range(3):
            eng.step()
        assert eng.cancel(cancel_uid)
    eng.run()
    return eng, tables


def assert_same_engine(je, jt, te, tt):
    assert {u: r.output for u, r in je.finished.items()} == {
        u: r.output for u, r in te.finished.items()}
    assert {u: r.ttft_steps for u, r in je.finished.items()} == {
        u: r.ttft_steps for u, r in te.finished.items()}
    assert sorted(je.cancelled) == sorted(te.cancelled)
    assert je.steps == te.steps
    for a, b in zip(je.step_stats, te.step_stats):
        assert [getattr(a, f) for f in SCHED_FIELDS] == [getattr(b, f) for f in SCHED_FIELDS]
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert (a is None and b is None) or np.array_equal(a, b)
    js, ts = je.stats_summary(), te.stats_summary()
    for key in ("shared_tokens", "peak_used_pages", "touched_pages", "generated_tokens",
                "deferred_tokens", "budget_overshoot_tokens", "max_step_tokens"):
        assert js.get(key) == ts.get(key), key


@pytest.mark.parametrize("budget", [None, 4, 16])
@pytest.mark.parametrize("packed", [False, True], ids=["dense_step", "packed_step"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_matches_jax(params, cache, packed, budget):
    jp, tp = params
    kw = dict(cache=cache, packed=packed, token_budget=budget)
    if cache == "paged":
        kw["page_size"] = 4
    prompts = make_prompts()
    je, jt = run(JBatcher, JRequest, jp, JCFG, prompts, **kw)
    te, tt = run(ContinuousBatcher, Request, tp, CFG, prompts, **kw)
    assert_same_engine(je, jt, te, tt)
    assert len(te.finished) == len(prompts)
    if cache == "paged":
        te.kv.check_invariants()
        assert te.kv.used_pages == 0
        assert te.stats_summary()["shared_tokens"] > 0  # prefix sharing fired


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_cancel_matches_jax(params, cache):
    jp, tp = params
    kw = dict(cache=cache, packed=True, token_budget=6, page_size=4)
    prompts = make_prompts(seed=1)
    je, jt = run(JBatcher, JRequest, jp, JCFG, prompts, cancel_uid=1, **kw)
    te, tt = run(ContinuousBatcher, Request, tp, CFG, prompts, cancel_uid=1, **kw)
    assert_same_engine(je, jt, te, tt)
    assert 1 in te.cancelled
    assert te.kv is None or te.kv.used_pages == 0


def test_int8_pages_token_match_tier(params):
    """int8 pages are allclose, not bit-identical: same stream lengths as
    the reference's dense oracle and >= 90% of tokens equal."""
    jp, tp = params
    prompts = make_prompts(seed=2)
    je, _ = run(JBatcher, JRequest, jp, JCFG, prompts)
    te, _ = run(ContinuousBatcher, Request, tp, CFG, prompts, cache="paged", page_size=4,
                packed=True, kv_dtype="int8")
    oracle = {u: r.output for u, r in je.finished.items()}
    got = {u: r.output for u, r in te.finished.items()}
    assert set(got) == set(oracle)
    assert all(len(got[u]) == len(oracle[u]) for u in oracle)
    total = sum(len(v) for v in oracle.values())
    same = sum(a == b for u in oracle for a, b in zip(got[u], oracle[u]))
    assert same / total >= 0.9, f"token match {same}/{total}"
    assert te.kv.used_pages == 0


def test_typed_refusals(params):
    """The engine's typed refusals; sampling and ``spec=``, which earlier
    slices refused, are served now: a sampled request runs to its length,
    and ``spec`` must be a ``SpecConfig`` or a ``Proposer``."""
    _, tp = params
    eng = ContinuousBatcher(tp, CFG, batch_slots=2, max_len=16)
    eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=2,
                       sampling=SamplingParams(temperature=0.7, seed=1)))
    with pytest.raises(InvalidRequestError, match="SamplingParams"):
        eng.submit(Request(uid=4, prompt=[1, 2], max_new_tokens=2, sampling=object()))
    with pytest.raises(InvalidRequestError, match="too long"):
        eng.submit(Request(uid=1, prompt=[1] * 10, max_new_tokens=10))
    with pytest.raises(InvalidRequestError, match="empty prompt"):
        eng.submit(Request(uid=2, prompt=[], max_new_tokens=1))
    with pytest.raises(UnsupportedDistError):
        ContinuousBatcher(tp, CFG, batch_slots=2, max_len=16, dist=object())
    with pytest.raises(TypeError, match="SpecConfig"):
        ContinuousBatcher(tp, CFG, batch_slots=2, max_len=16, spec=object())
    with pytest.raises(ValueError, match="n_experts=0"):
        ContinuousBatcher(tp, CFG, batch_slots=2, max_len=16, capacity_factor=1.25)
    # greedy params with top-k/top-p knobs are still greedy: accepted
    eng.submit(Request(uid=3, prompt=[1, 2], max_new_tokens=2,
                       sampling=SamplingParams(top_k=5, top_p=0.9)))
    done = eng.run()
    assert len(done[3].output) == 2 and len(done[0].output) == 2


def test_paged_tables_match_reference_on_seeded_ops():
    """The carried-over allocator replays a random op sequence exactly like
    the reference: same return values (or exception types), tables,
    refcounts, free/cached lists and reservations after every op."""
    rng = np.random.default_rng(0)
    args = (4, 6, 14, 4)
    ja, ta = JTables(*args), PagedTables(*args)
    base = rng.integers(0, 50, 8).tolist()
    prompts = {}

    def apply(t, op, slot, prompt, n):
        try:
            if op == "admit":
                return t.admit(slot, prompt, 2)
            if op == "write":
                return t.prepare_write(slot, len(t.tables[slot]) * t.page_size, n)
            if op == "register":
                return t.register_prompt_pages(slot, prompts.get(slot, prompt), 8)
            if op == "share":
                return t.try_share(slot, prompts.get(slot, prompt), 0)
            if op == "trim":
                return t.trim(slot, n)
            if op == "fork":
                return t.fork(slot, (slot + 1) % 4)
            return t.free_slot(slot)
        except Exception as e:  # both sides must raise the same way
            return type(e).__name__

    for _ in range(400):
        op = str(rng.choice(["admit", "write", "register", "share", "trim", "fork", "free"]))
        slot, n = int(rng.integers(0, 4)), int(rng.integers(1, 6))
        prompt = base[: int(rng.integers(0, 9))] + rng.integers(0, 50, n).tolist()
        got = [apply(t, op, slot, prompt, n) for t in (ja, ta)]
        if op == "admit":
            prompts[slot] = prompt
        assert got[0] == got[1], op
        np.testing.assert_array_equal(ja.device_tables(), ta.device_tables())
        assert ja.ref == ta.ref and ja._free == ta._free
        assert list(ja._cached) == list(ta._cached) and ja._reserved == ta._reserved
        assert ja.touched_pages == ta.touched_pages
    assert issubclass(PageError, RuntimeError)


def test_pack_step_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(50):
        slots = rng.permutation(6)[: int(rng.integers(1, 6))]
        grants = [(int(s), int(rng.integers(0, 20)),
                   rng.integers(0, 100, int(rng.integers(0, 5))).tolist()) for s in slots]
        cap = sum(len(t) for _, _, t in grants) + int(rng.integers(0, 3))
        base = {int(s): int(rng.integers(-3, 5)) for s in slots}
        a, b = jpack_step(grants, cap, out_base=base), pack_step(grants, cap, out_base=base)
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb, f.name
    for args in ((4, 16, None), (4, 16, 3), (8, 64, 256), (2, 4, 1)):
        assert jpacked_capacity(*args) == packed_capacity(*args)
    with pytest.raises(ValueError, match="overflow"):
        pack_step([(0, 0, [1, 2, 3])], 2)
