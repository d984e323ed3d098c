"""The port's RG-LRU ('R') serving path against the JAX package on the CPU.

Same numpy inputs (or JAX-initialised weights carried across by
``params_from_jax``) through both packages, in f32:

* ``init_rglru``'s tree, shapes and dtypes; ``_conv`` and
  ``_decay_and_update`` to ``TOL["kernel_f32"]``;
* the log-depth scan (``rglru._scan``) against
  ``jax.lax.associative_scan(_combine, ...)`` over both axes the block
  scans, lengths 1 to 257, to ``TOL["ssd_f32"]`` (the products are ordered
  differently from XLA's tree, so not to bits);
* ``apply_rglru``'s cache-free, chunked (ragged ``seq_lens``, a carried
  state, an idle row) and packed (several seeds, padding) branches, and an
  'R' block, to ``TOL["model_f32"]``; the decode branch refused;
* ``prefill_chunk`` / ``packed_prefill`` logits after every step and the
  carried rows for ``hybrid_tiny`` and ``recurrentgemma_2b``'s smoke config,
  over dense and paged caches;
* the ``ContinuousBatcher`` greedy streams against the JAX engine, exactly,
  over {dense, paged} x {dense step, packed step} x budgets, with slot
  reuse, and after a cancel;
* the recurrent-state lifecycle (admission zeroes, fork copies, sharing off,
  trim refuses), the weight carry-over, the configs, and which 'R' configs
  ``require_trainable`` takes on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import KVCacheSpec as JSpec  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import pack_step as jpack_step  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import UnbuiltShapeError  # noqa: E402
from repro_torch.models import UnsupportedPatternError, model  # noqa: E402
from repro_torch.models import rglru, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request  # noqa: E402
from test_torch_parity_util import assert_close, tree_np  # noqa: E402

torch.set_num_threads(1)

CONFIGS = {
    "hybrid_tiny": (jget_config("hybrid_tiny"), get_config("hybrid_tiny")),
    "recurrentgemma_smoke": (jget_smoke("recurrentgemma_2b"),
                             get_smoke_config("recurrentgemma_2b")),
}


def t(x):
    return torch.from_numpy(np.array(x))


def jnp_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jc, tc = CONFIGS[request.param]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def layouts(seed=0, cap=24):
    """``pack_step`` layouts of mixed grants over 4 slots (one idle), with
    padding past the granted tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        slots = rng.permutation(4)[: int(rng.integers(1, 4))]
        grants = [(int(s), int(rng.integers(0, 9)), [1] * int(rng.integers(1, 7)))
                  for s in slots]
        out.append(jpack_step(grants, cap))
    return out


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_rglru_tree(name):
    jc, tc = CONFIGS[name]
    want = jrg.init_rglru(jax.random.PRNGKey(0), jc)
    gen = torch.Generator().manual_seed(0)
    got = rglru.init_rglru(gen, tc, device="cpu")
    assert list(got) == ["w_branch", "w_gate_branch", "conv_w", "conv_b", "gate_a_w",
                         "gate_a_b", "gate_x_w", "gate_x_b", "lam", "w_out"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for k in ("conv_b", "gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
        assert not got[k].any(), k
    np.testing.assert_allclose(got["lam"].numpy(), np.asarray(want["lam"]), rtol=1e-6)
    dr = int(tc.rglru_expand * tc.d_model)
    for k in ("w_branch", "w_gate_branch"):  # truncated at 2 sigma of fan-in d
        assert float(got[k].abs().max()) <= 2.0 / np.sqrt(tc.d_model) + 1e-6
    assert float(got["w_out"].abs().max()) <= 2.0 / np.sqrt(dr) + 1e-6
    cache = rglru.init_rglru_cache(tc, 3, device="cpu")
    jcache = jrg.init_rglru_cache(jc, 3)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}


@pytest.mark.parametrize("carried", [False, True])
def test_conv_has_no_activation(carried):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32) if carried else None
    want = jrg._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     None if st is None else jnp.asarray(st))
    got = rglru._conv(t(x), t(w), t(b), None if st is None else t(st))
    for g, wnt in zip(got, want):
        assert_close(g, wnt, "kernel_f32")
    assert (got[0] < 0).any()  # no SiLU: negative outputs stay


def test_decay_and_update():
    rng = np.random.default_rng(2)
    x, r, i = (rng.normal(size=(2, 7, 5)).astype(np.float32) for _ in range(3))
    r, i = 1 / (1 + np.exp(-r)), 1 / (1 + np.exp(-i))
    lam = np.linspace(-1.0, 6.9, 5).astype(np.float32)
    want = jrg._decay_and_update(*map(jnp.asarray, (x, r, i, lam)))
    got = rglru._decay_and_update(*map(t, (x, r, i, lam)))
    for g, w in zip(got, want):
        assert_close(g, w, "kernel_f32")


@pytest.mark.parametrize("n", [1, 2, 7, 64, 257])
@pytest.mark.parametrize("axis", [0, 1])
def test_scan_matches_associative_scan(n, axis):
    rng = np.random.default_rng(n + axis)
    shape = (n, 6) if axis == 0 else (3, n, 6)
    a = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    wa, wb = jax.lax.associative_scan(jrg._combine, (jnp.asarray(a), jnp.asarray(b)), axis=axis)
    ga, gb = rglru._scan(t(a), t(b), dim=axis)
    assert_close(ga, wa, "ssd_f32")
    assert_close(gb, wb, "ssd_f32")
    # the sequential recurrence it stands for
    h = np.zeros(np.take(b, 0, axis=axis).shape, np.float64)
    for s in range(n):
        h = np.take(a, s, axis=axis) * h + np.take(b, s, axis=axis)
    np.testing.assert_allclose(np.take(gb.numpy(), n - 1, axis=axis), h, rtol=1e-5, atol=1e-5)


def block_params(cfg, seed):
    """Reference 'R' mixer parameters with non-trivial gates and conv bias,
    and the same tree for the port."""
    jp = jrg.init_rglru(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
        jp[k] = jnp.asarray(rng.normal(scale=0.5, size=jp[k].shape).astype(np.float32))
    return jp, {k: t(np.asarray(v)) for k, v in jp.items()}


def block_cache(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    jc = jrg.init_rglru_cache(cfg, batch)
    return {k: rng.normal(scale=0.5, size=v.shape).astype(np.float32) for k, v in jc.items()}


class TestApplyRglru:
    """``apply_rglru``'s cache-free, dense chunked and packed branches."""

    @pytest.fixture(params=sorted(CONFIGS))
    def cfgs(self, request):
        return CONFIGS[request.param]

    def test_cache_free(self, cfgs):
        jc, tc = cfgs
        jp, tp = block_params(jc, 1)
        x = np.random.default_rng(2).normal(size=(2, 21, jc.d_model)).astype(np.float32)
        wy, _ = jrg.apply_rglru(jp, jnp.asarray(x), jc)
        gy, gc = rglru.apply_rglru(tp, t(x), tc)
        assert gc is None
        assert_close(gy, wy, "model_f32")

    def test_chunked(self, cfgs):
        jc, tc = cfgs
        jp, tp = block_params(jc, 3)
        cache = block_cache(jc, 3, 4)
        x = np.random.default_rng(5).normal(size=(3, 11, jc.d_model)).astype(np.float32)
        lens = np.asarray([11, 0, 6], np.int32)
        wy, wc = jrg.apply_rglru(jp, jnp.asarray(x), jc, jnp_tree(cache),
                                 seq_lens=jnp.asarray(lens))
        tcache = {k: t(v) for k, v in cache.items()}
        gy, _ = rglru.apply_rglru(tp, t(x), tc, tcache, seq_lens=t(lens))
        for i, n in enumerate(lens):
            assert_close(gy[i, :n], np.asarray(wy)[i, :n], "model_f32")
        for k in ("conv", "h"):
            assert_close(tcache[k], wc[k], "model_f32")  # updated in place
            np.testing.assert_array_equal(tcache[k][1].numpy(), cache[k][1])  # idle row

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_packed(self, cfgs, seed):
        jc, tc = cfgs
        jp, tp = block_params(jc, 6 + seed)
        for lay in layouts(seed, cap=20):
            cache = block_cache(jc, 4, seed)
            p = lay.slot_ids.shape[0]
            x = np.random.default_rng(seed).normal(size=(1, p, jc.d_model)).astype(np.float32)
            wy, wc = jrg.apply_rglru(jp, jnp.asarray(x), jc, jnp_tree(cache),
                                     slot_ids=jnp.asarray(lay.slot_ids))
            tcache = {k: t(v) for k, v in cache.items()}
            gy, _ = rglru.apply_rglru(tp, t(x), tc, tcache, slot_ids=t(lay.slot_ids))
            valid = lay.slot_ids >= 0
            assert_close(gy[0, valid], np.asarray(wy)[0, valid], "model_f32")
            for k in ("conv", "h"):
                assert_close(tcache[k], wc[k], "model_f32")
            absent = sorted(set(range(4)) - set(lay.slot_ids[valid].tolist()))
            for s in absent:  # slots absent from the step keep their rows
                np.testing.assert_array_equal(tcache["h"][s].numpy(), cache["h"][s])

    def test_decode_branch_is_not_ported(self, cfgs):
        """The single-token branch (``decode_step``'s), which earlier slices
        refused, against the reference's over several steps from a carried
        state: outputs and both cache leaves."""
        jc, tc = cfgs
        jp, tp = block_params(jc, 0)
        cache = block_cache(jc, 3, 0)
        tcache = {k: t(v) for k, v in cache.items()}
        jcache = jnp_tree(cache)
        rng = np.random.default_rng(4)
        for _ in range(5):
            x = rng.normal(size=(3, 1, jc.d_model)).astype(np.float32)
            wy, jcache = jrg.apply_rglru(jp, jnp.asarray(x), jc, jcache)
            gy, _ = rglru.apply_rglru(tp, t(x), tc, tcache)
            assert_close(gy, wy, "model_f32")
            for k in ("conv", "h"):
                assert_close(tcache[k], jcache[k], "model_f32")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_r_block_matches_jax(name):
    """One 'R' block (norm, RG-LRU, residual, norm, GeGLU MLP), cache-free
    and as a chunked step over a carried cache."""
    jc, tc = CONFIGS[name]
    jp = jtf.init_block(jax.random.PRNGKey(3), jc, "R")
    tp = {k: {kk: t(np.asarray(vv)) for kk, vv in v.items()} for k, v in jp.items()}
    gen = torch.Generator().manual_seed(0)
    shapes = transformer.init_block(gen, tc, "R", device="cpu")
    assert jax.tree.map(np.shape, jp) == {
        k: {kk: tuple(vv.shape) for kk, vv in v.items()} for k, v in shapes.items()}
    x = np.random.default_rng(4).normal(size=(2, 9, jc.d_model)).astype(np.float32)
    pos = jnp.arange(9)
    wy = jtf.apply_block(jp, jnp.asarray(x), jc, "R", pos)[0]
    gy, _, _, _ = transformer.apply_block(tp, t(x), tc, "R", torch.arange(9), None)
    assert_close(gy, wy, "model_f32")
    cache = block_cache(jc, 2, 5)
    lens = np.asarray([9, 4], np.int32)
    wy, wc, _, _ = jtf.apply_block(jp, jnp.asarray(x), jc, "R", pos,
                                   cache={"rglru": jnp_tree(cache)}, seq_lens=jnp.asarray(lens))
    tcache = {"rglru": {k: t(v) for k, v in cache.items()}}
    gy, _, _, _ = transformer.apply_block(tp, t(x), tc, "R", torch.arange(9), tcache,
                                          seq_lens=t(lens))
    assert_close(gy[0], np.asarray(wy)[0], "model_f32")
    assert_close(gy[1, :4], np.asarray(wy)[1, :4], "model_f32")
    for k in ("conv", "h"):
        assert_close(tcache["rglru"][k], wc["rglru"][k], "model_f32")


# ---------------------------------------------------------------------------
# the model's serving steps
# ---------------------------------------------------------------------------

B, MAX_LEN, PAGE, CAPACITY = 3, 64, 4, 40
# (slot, first position, tokens) per step: uneven prefill chunks (past the
# smoke config's window of 16), a slot decoding while others prefill, an
# idle slot, then a pure decode step
STEPS = [
    [(0, 0, 13), (1, 0, 5), (2, 0, 16)],
    [(0, 13, 16), (1, 5, 1), (2, 16, 3)],
    [(1, 6, 1), (2, 19, 16)],
    [(0, 29, 1), (1, 7, 1), (2, 35, 1)],
]


def build(jc, tc, jp, tp, layout):
    if layout == "dense":
        return (jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=True),
                model.init_decode_cache(tp, tc, B, MAX_LEN, linear=True), None, None)
    jkv = JSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(jp, jc)
    tkv = KVCacheSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(tp, tc)
    for s in range(B):
        prompt = list(range(100 + s, 150 + s))
        assert jkv.admit_slot(s, prompt, 0) == tkv.admit_slot(s, prompt, 0) == 0
    return None, None, jkv, tkv


@pytest.mark.parametrize("packed", [False, True], ids=["chunked", "packed"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serving_steps_match_jax(pair, layout, packed):
    jc, tc, jp, tp = pair
    jcache, tcache, jkv, tkv = build(jc, tc, jp, tp, layout)
    rng = np.random.default_rng(1)
    for step in STEPS:
        grants = [(s, p, rng.integers(0, jc.vocab_size, n).tolist()) for s, p, n in step]
        if layout == "paged":
            jkv.prepare_step(grants)
            tkv.prepare_step(grants)
            jcache, tcache = jkv.state, tkv.state
        if packed:
            lay = jpack_step(grants, CAPACITY)
            jl, jcache = jmodel.packed_prefill(jp, jc, jcache, jnp.asarray(lay.tokens),
                                               jnp.asarray(lay.slot_ids),
                                               jnp.asarray(lay.positions))
            tl, tcache = model.packed_prefill(tp, tc, tcache, lay.tokens, lay.slot_ids,
                                              lay.positions)
            valid = lay.slot_ids >= 0
            jl, tl = np.asarray(jl)[valid], tl[valid]
        else:
            c = max(len(tk) for _, _, tk in grants)
            tokens = np.zeros((B, c), np.int32)
            pos = np.zeros(B, np.int32)
            lens = np.zeros(B, np.int32)
            for s, p, tk in grants:
                tokens[s, : len(tk)], pos[s], lens[s] = tk, p, len(tk)
            jl, jcache = jmodel.prefill_chunk(jp, jc, jcache, jnp.asarray(tokens),
                                              jnp.asarray(pos), jnp.asarray(lens))
            tl, tcache = model.prefill_chunk(tp, tc, tcache, tokens, pos, lens)
            mask = np.arange(c)[None, :] < lens[:, None]
            jl, tl = np.asarray(jl)[mask], tl[torch.from_numpy(mask)]
        assert_close(tl, jl, "model_f32")
        if layout == "paged":
            jkv.state, tkv.state = jcache, tcache
    jleaves = [np.asarray(x) for x in jax.tree.leaves(getattr(jcache, "data", jcache))]
    tleaves = tree_leaves(getattr(tcache, "data", tcache))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):  # the recurrent rows and the attention pools
        assert a.shape == tuple(b.shape)
        assert_close(b, a, "model_f32")


def test_forward_matches_jax(pair):
    """The cache-free forward (``model.forward``, no grad) on a ragged length."""
    jc, tc, jp, tp = pair
    tokens = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 19)).astype(np.int32)
    want, _ = jmodel.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = model.forward(tp, tc, {"tokens": t(tokens)})
    assert float(aux) == 0.0
    assert_close(got, want, "model_f32")


def test_params_from_jax_carries_the_r_tree(pair):
    jc, tc, jp, tp = pair
    assert len(jax.tree.leaves(jp)) == len(tree_leaves(tp))
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(g, np.asarray(w, np.float32)),
                 jp, tree_np(tp))
    r = tp["stack"]["groups"][tc.layer_pattern.index("R")]
    assert set(r) == {"norm1", "rglru", "norm2", "mlp"}
    assert set(r["rglru"]) == {"w_branch", "w_gate_branch", "conv_w", "conv_b", "gate_a_w",
                               "gate_a_b", "gate_x_w", "gate_x_b", "lam", "w_out"}
    assert r["rglru"]["w_branch"].shape[0] == jc.n_layers // len(jc.layer_pattern)


def test_compute_params_keeps_the_rglru_f32_leaves():
    cfg = get_config("recurrentgemma_2b")
    small = dataclasses.replace(cfg, n_layers=1, d_model=64, n_heads=1, head_dim=64,
                                d_ff=32, vocab_size=16)
    params = model.init_params(small, device="cpu")
    rg = model.compute_params(params, small)["stack"]["groups"][0]["rglru"]
    for k in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b", "lam"):
        assert rg[k].dtype == torch.float32, k
    for k in ("w_branch", "w_gate_branch", "conv_w", "conv_b", "w_out"):
        assert rg[k].dtype == torch.bfloat16, k


def test_configs_match_reference():
    assert "recurrentgemma_2b" in ARCHITECTURES and "hybrid_tiny" not in ARCHITECTURES
    for name in ("recurrentgemma_2b", "hybrid_tiny"):
        for jget, tget in ((jget_config, get_config), (jget_smoke, get_smoke_config)):
            jc, tc = jget(name), tget(name)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert jc.param_count() == tc.param_count()
    full = get_config("recurrentgemma_2b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.hd, full.d_ff,
            full.vocab_size, full.sliding_window, full.layer_pattern) == (
        26, 2560, 10, 1, 256, 7680, 256_000, 2048, "RRL")
    assert full.pattern.count("R") == 18 and full.pattern.count("L") == 8


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_MAX_LEN = 32
SCHED_FIELDS = ("step", "decode_tokens", "prefill_tokens", "deferred_tokens",
                "shared_tokens", "used_pages", "queued_requests", "budget_overshoot")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engine_pair(request):
    jc, tc = CONFIGS[request.param]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def prompts(vocab, n=5, seed=0):
    """5 requests of 3-11 tokens through 2 slots (slot reuse)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=k).tolist() for k in rng.integers(3, 12, size=n)]


def run(batcher, request, params, cfg, prs, cancel_uid=None, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("chunk_size", 4)
    eng = batcher(params, cfg, max_len=ENGINE_MAX_LEN, **kw)
    if cancel_uid is not None:
        # a victim runs a few steps and is cancelled mid-flight; the real
        # work then goes through the recycled slot
        eng.submit(request(uid=cancel_uid, prompt=list(prs[0]), max_new_tokens=8))
        eng.step()
        eng.step()
        assert eng.cancel(cancel_uid)
    for i, p in enumerate(prs):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=4))
    eng.run()
    return eng


def assert_same_engine(je, te):
    assert {u: r.output for u, r in je.finished.items()} == {
        u: r.output for u, r in te.finished.items()}
    assert je.steps == te.steps
    for a, b in zip(je.step_stats, te.step_stats):
        assert [getattr(a, f) for f in SCHED_FIELDS] == [getattr(b, f) for f in SCHED_FIELDS]
    assert sorted(je.cancelled) == sorted(te.cancelled)


@pytest.mark.parametrize("budget", [None, 4])
@pytest.mark.parametrize("packed", [False, True], ids=["dense_step", "packed_step"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_matches_jax(engine_pair, cache, packed, budget):
    jc, tc, jp, tp = engine_pair
    kw = dict(cache=cache, packed=packed, token_budget=budget, page_size=4)
    prs = prompts(jc.vocab_size)
    je = run(JBatcher, JRequest, jp, jc, prs, **kw)
    te = run(ContinuousBatcher, Request, tp, tc, prs, **kw)
    assert_same_engine(je, te)
    assert sorted(te.finished) == list(range(len(prs)))
    assert all(len(r.output) == 4 for r in te.finished.values())
    if cache == "paged":
        te.kv.check_invariants()
        assert te.kv.used_pages == 0
    assert te.stats_summary().get("shared_tokens", 0.0) == 0.0


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense_step", "packed_step"])
def test_cancel_then_readmit_matches_jax(engine_pair, cache, packed):
    """A cancelled request's carried state must not leak into the next tenant
    of its slot: the streams after it equal the JAX engine's and a fresh
    engine's."""
    jc, tc, jp, tp = engine_pair
    kw = dict(cache=cache, packed=packed, page_size=4)
    prs = prompts(jc.vocab_size, seed=1)
    je = run(JBatcher, JRequest, jp, jc, prs, cancel_uid=99, **kw)
    te = run(ContinuousBatcher, Request, tp, tc, prs, cancel_uid=99, **kw)
    assert_same_engine(je, te)
    fresh = run(ContinuousBatcher, Request, tp, tc, prs, **kw)
    assert {u: r.output for u, r in fresh.finished.items()} == {
        u: r.output for u, r in te.finished.items() if u != 99}


# ---------------------------------------------------------------------------
# lifecycle and refusals
# ---------------------------------------------------------------------------


def recurrent_rows(kv, slot):
    """Slot ``slot``'s rows of every 'R' leaf of the cache tree."""
    groups = kv.state.data["stack"]["groups"]
    return [x[:, slot] for layer in groups if "rglru" in layer
            for x in tree_leaves(layer["rglru"])]


class TestRecurrentLifecycle:
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_admit_zeroes_fork_copies_trim_refuses(self, engine_pair, layout):
        _, tc, _, tp = engine_pair
        kv = KVCacheSpec(num_slots=2, max_len=ENGINE_MAX_LEN, layout=layout,
                         page_size=4).build(tp, tc)
        assert kv.has_recurrent
        rows = recurrent_rows(kv, 0)
        assert rows and len(rows) == 2 * tc.layer_pattern.count("R")  # conv and h a layer
        for x in tree_leaves(kv.state.data):
            x.fill_(7.0)
        assert kv.admit_slot(0, [1, 2, 3], 4) == 0
        assert all(not r.any() for r in recurrent_rows(kv, 0))  # admission zeroed slot 0
        assert all((r == 7.0).all() for r in recurrent_rows(kv, 1))  # slot 1 untouched
        if layout == "paged":
            for r in recurrent_rows(kv, 0):
                r.fill_(3.0)
            kv.fork_slot(0, 1)
            for a, b in zip(recurrent_rows(kv, 0), recurrent_rows(kv, 1)):
                assert torch.equal(a, b)  # eager copy
        with pytest.raises(UnsupportedPatternError, match="roll back"):
            kv.trim_slot(0, 2)

    def test_prefix_sharing_disabled(self, engine_pair):
        _, tc, _, tp = engine_pair
        kv = KVCacheSpec(num_slots=2, max_len=ENGINE_MAX_LEN, layout="paged",
                         page_size=2).build(tp, tc)
        prompt = list(range(10))
        assert kv.admit_slot(0, prompt, 4) == 0
        kv.register_prompt_pages(0, prompt, len(prompt))
        assert kv.probe_shared(prompt) == 0
        assert kv.share(1, prompt, 0) == 0
        assert kv.admit_slot(1, prompt, 4) == 0

    def test_page_copies_pass_the_r_rows_by(self, engine_pair):
        from repro_torch.serve.kv import copy_pages_state

        _, tc, _, tp = engine_pair
        paged = KVCacheSpec(num_slots=2, max_len=8, layout="paged", page_size=4).build(tp, tc)
        for x in tree_leaves(paged.state.data):
            x.copy_(torch.randn(x.shape).to(x.dtype))
        before = [r.clone() for r in recurrent_rows(paged, 0) + recurrent_rows(paged, 1)]
        copy_pages_state(paged.state, [(0, 1)])
        after = recurrent_rows(paged, 0) + recurrent_rows(paged, 1)
        assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_training_r_on_the_card_takes_built_shapes(engine_pair):
    """'R' stacks train on the card where their attention is built:
    recurrentgemma-2b (head dim 256, group 10, window 2,048) at 8,192 and
    2,048 tokens passes ``require_trainable``; the smoke configs (f32, head
    dim 64, group 2; hybrid_tiny head dim 32) and a planted (256, 4) are
    refused before any work with the typed error naming the head dim and
    group; the CPU takes everything."""
    _, tc, _, _ = engine_pair
    cuda = torch.device("cuda")
    full = get_config("recurrentgemma_2b")
    for seq in (8192, 2048):
        model.require_trainable(full, seq, cuda)
    with pytest.raises(UnbuiltShapeError, match=f"head dim {tc.hd} and group H/KV = 2"):
        model.require_trainable(tc, 16, cuda)
    four = dataclasses.replace(full, n_heads=4)
    with pytest.raises(UnbuiltShapeError, match="head dim 256 and group H/KV = 4"):
        model.require_trainable(four, 8192, cuda)
    with pytest.raises(UnbuiltShapeError, match="sequence lengths"):
        model.require_trainable(full, 8000, cuda)
    for cfg in (tc, four, full):
        model.require_trainable(cfg, 16, torch.device("cpu"))
