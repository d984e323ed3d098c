"""The dense architectures the port serves since the front-end slice —
internlm2-1.8b ('G', untied unembedding, head dim 128, group 2),
starcoder2-7b (LayerNorm, QKV bias, non-gated GELU, group 9) and
gemma3-27b ('LLLLLG' with a 2-layer tail at full depth, a 1-token tail in
the smoke config, window 1,024, QK-norm, GeGLU, the sqrt(d) embedding
scale) — against the JAX package on the CPU, in f32, at their smoke
configs:

* the configs field for field, the exact ``param_count`` of the published
  and the smoke configs, and the parameter tree's paths and shapes;
* ``params_from_jax`` round trip, bit for bit;
* prefill logits (dense and paged caches, chunked and packed steps) and
  ``decode_step`` logits and caches within ``TOL["model_f32"]``;
* ``loss_fn``'s sums and every leaf's gradient against ``jax.grad``;
* the engine's greedy streams, step counts and per-step schedule on the
  dense and paged layouts, chunked and packed, equal to the JAX engine's,
  with requests long enough to cross gemma3's sliding window;
* the K4 instance each published config's serving takes.
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
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import KVCacheSpec as JSpec  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import pack_step as jpack_step  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request  # noqa: E402
from test_torch_parity_util import assert_close, assert_tree_close, tree_np  # noqa: E402

torch.set_num_threads(1)

NAMES = ["internlm2_1_8b", "starcoder2_7b", "gemma3_27b"]


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    jc, tc = jget_smoke(request.param), get_smoke_config(request.param)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def paths(tree, prefix=""):
    """(path, shape) of every leaf of a nested dict / list / tuple tree."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape))]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference(name):
    for jget, tget in ((jget_config, get_config), (jget_smoke, get_smoke_config)):
        jc, tc = jget(name), tget(name)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_count() == tc.param_count()


def test_registry_order_is_the_reference_order():
    from repro.configs import ARCHITECTURES as JARCH

    assert ARCHITECTURES == [a for a in JARCH if a in ARCHITECTURES]
    assert set(NAMES) <= set(ARCHITECTURES)


@pytest.mark.parametrize("name,want", [
    ("internlm2_1_8b", (24, 2048, 16, 8, 128, 8192, 92_544, "G", 1_889_110_016)),
    ("starcoder2_7b", (32, 4608, 36, 4, 128, 18_432, 49_152, "G", 7_173_039_104)),
    ("gemma3_27b", (62, 5376, 32, 16, 128, 21_504, 262_144, "LLLLLG", 27_008_335_616)),
])
def test_published_widths_and_param_counts(name, want):
    """Published widths, and the parameter count of the port's own tree on
    the ``meta`` device equal to ``param_count`` (and the reference's)."""
    cfg = get_config(name)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size, cfg.layer_pattern, cfg.param_count()) == want
    meta = model.init_params(cfg, device="meta")
    assert sum(x.numel() for x in tree_leaves(meta)) == cfg.param_count()
    assert cfg.param_count() == jget_config(name).param_count()


@pytest.mark.parametrize("name", NAMES)
def test_parameter_paths_and_shapes_match_reference(name):
    jc, tc = jget_smoke(name), get_smoke_config(name)
    jp = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jc))
    assert paths(model.init_params(tc, device="meta")) == paths(jp)


def test_params_from_jax_round_trip(pair):
    jc, tc, jp, tp = pair
    assert len(jax.tree.leaves(jp)) == len(tree_leaves(tp))
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(g, np.asarray(w, np.float32)),
                 jp, tree_np(tp))


def test_each_config_reads_its_features(pair):
    """What each smoke config's tree carries: gemma3's QK-norm scales and
    7 = 6 + 1 layers (a one-layer 'L' tail), starcoder2's LayerNorm biases
    and QKV biases, internlm2's untied unembedding."""
    jc, tc, jp, tp = pair
    groups, tail = tp["stack"]["groups"], tp["stack"]["tail"]
    if tc.name.startswith("gemma3"):
        assert len(groups) == 6 and len(tail) == 1 and tc.pattern[-1] == "L"
        assert {"q_norm", "k_norm"} <= set(groups[0]["attn"])
    if tc.name.startswith("starcoder2"):
        assert set(groups[0]["norm1"]) == {"scale", "bias"}
        assert {"bq", "bk", "bv"} <= set(groups[0]["attn"])
    if tc.name.startswith("internlm2"):
        assert not tc.tie_embeddings and "unembed" in tp["embed"]


def test_gemma3_full_depth_groups_and_tail():
    """62 layers of 'LLLLLG': 10 stacked 6-layer groups and a 2-layer 'LL'
    tail, as the reference stacks them."""
    cfg = get_config("gemma3_27b")
    meta = model.init_params(cfg, device="meta")
    assert len(meta["stack"]["groups"]) == 6 and len(meta["stack"]["tail"]) == 2
    assert meta["stack"]["groups"][0]["attn"]["wq"].shape[0] == 10
    assert cfg.pattern.count("L") == 52 and cfg.pattern.count("G") == 10
    assert cfg.pattern[-2:] == "LL"


@pytest.mark.parametrize("name,inst", [("internlm2_1_8b", (128, 2)), ("starcoder2_7b", (128, 9)),
                                       ("gemma3_27b", (128, 2))])
def test_published_configs_take_a_built_k4_instance(name, inst):
    cfg = get_config(name)
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == inst
    # the engine's plans take the instance's tile tokens
    assert flash_attention.tile_tokens(*inst) == flash_attention.instance(*inst).tile_tokens


# ---------------------------------------------------------------------------
# the model's serving steps
# ---------------------------------------------------------------------------

B, MAX_LEN, PAGE, CAPACITY = 3, 40, 4, 24
#: (slot, start position, tokens) grants of successive steps: chunks of a
#: prompt, decode tokens, a verify-sized span; slot 2 passes position 16
#: (gemma3's smoke window) by its last steps
STEPS = [
    [(0, 0, 7), (1, 0, 5), (2, 0, 12)],
    [(0, 7, 1), (1, 5, 3), (2, 12, 6)],
    [(0, 8, 1), (2, 18, 5)],
    [(1, 8, 1), (2, 23, 1), (0, 9, 4)],
]


def build(jc, tc, jp, tp, layout):
    if layout == "dense":
        return (jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=True),
                model.init_decode_cache(tp, tc, B, MAX_LEN, linear=True), None, None)
    jkv = JSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(jp, jc)
    tkv = KVCacheSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(tp, tc)
    for s in range(B):
        prompt = list(range(100 + s, 130 + s))
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
    for a, b in zip(jleaves, tleaves):
        assert a.shape == tuple(b.shape)
        assert_close(b, a, "model_f32")


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_decode_step_matches_jax(pair, layout):
    """``decode_step`` over 24 steps (past gemma3's smoke window of 16, so
    its ring wraps) at per-slot positions: logits each step and every cache
    leaf at the end."""
    jc, tc, jp, tp = pair
    offsets = np.asarray([0, 3, 1])
    if layout == "paged":
        jkv = JSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(jp, jc)
        tkv = KVCacheSpec(num_slots=B, max_len=MAX_LEN, layout="paged",
                          page_size=PAGE).build(tp, tc)
        for s in range(B):
            for kv in (jkv, tkv):
                assert kv.admit_slot(s, list(range(100 + s, 100 + s + MAX_LEN - 1)), 1) == 0
                kv.prepare_write(s, 0, MAX_LEN)
        jcache, tcache = jkv.state, tkv.state
    else:
        jcache = jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=False)
        tcache = model.init_decode_cache(tp, tc, B, MAX_LEN, linear=False)
    rng = np.random.default_rng(3)
    jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,))
    for t in range(24):
        tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        pos = (offsets + t).astype(np.int32)
        jl, jcache = jdecode(jp, jc, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = model.decode_step(tp, tc, tcache, tok, pos)
        assert_close(tl, jl, "model_f32")
    assert_tree_close(getattr(tcache, "data", tcache), getattr(jcache, "data", jcache),
                      "model_f32")


def test_forward_matches_jax(pair):
    """The cache-free forward on a ragged length past gemma3's smoke window."""
    jc, tc, jp, tp = pair
    tokens = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 21)).astype(np.int32)
    want, _ = jmodel.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, _ = model.forward(tp, tc, {"tokens": torch.from_numpy(tokens)})
    assert_close(got, want, "model_f32")


def test_loss_and_every_grad_leaf_match_jax_grad(pair):
    """``loss_fn``'s (loss_sum, w_sum) and the gradient of every leaf against
    ``jax.grad`` of the reference's, on 2 x 33 tokens with token weights
    (past gemma3's smoke window 16)."""
    from repro_torch import core

    jc, tc, jp, tp = pair
    rng = np.random.default_rng(33)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (2, 33)).astype(np.int32),
             "weights": (rng.random((2, 33)) > 0.2).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ls, w), jg = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jc, jb), has_aux=True)(jp)
    grad_fn = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
    g, tls, tw = grad_fn(model.train_params(tp, tc),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_close(tls, ls, "model_f32")
    assert float(tw) == float(w)
    assert_tree_close(g, jg, "model_f32")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_MAX_LEN = 48
SCHED_FIELDS = ("step", "decode_tokens", "prefill_tokens", "deferred_tokens",
                "shared_tokens", "used_pages", "queued_requests", "budget_overshoot")


def engine_prompts(vocab, n=5, seed=0):
    """5 requests of 3-29 tokens through 2 slots (slot reuse); the longest
    run past position 16, gemma3's smoke window; two share a prefix."""
    rng = np.random.default_rng(seed)
    prs = [rng.integers(0, vocab, size=k).tolist() for k in (29, 3, 18, 11, 7)]
    prs[3] = prs[0][:9] + prs[3][9:]  # a shared prefix (paged: prefix sharing)
    return prs[:n]


def run(batcher, request, params, cfg, prs, **kw):
    eng = batcher(params, cfg, batch_slots=2, max_len=ENGINE_MAX_LEN, chunk_size=4, **kw)
    for i, p in enumerate(prs):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=6))
    eng.run()
    return eng


@pytest.mark.parametrize("budget", [None, 5])
@pytest.mark.parametrize("packed", [False, True], ids=["dense_step", "packed_step"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_matches_jax(pair, cache, packed, budget):
    """Greedy streams, step counts and every step's schedule equal to the
    JAX engine's; the paged engine leaks no page.  A request reaches
    position 34, past gemma3's smoke window of 16."""
    jc, tc, jp, tp = pair
    kw = dict(cache=cache, packed=packed, token_budget=budget, page_size=4)
    prs = engine_prompts(jc.vocab_size)
    je = run(JBatcher, JRequest, jp, jc, prs, **kw)
    te = run(ContinuousBatcher, Request, tp, tc, prs, **kw)
    assert {u: r.output for u, r in je.finished.items()} == {
        u: r.output for u, r in te.finished.items()}
    assert je.steps == te.steps
    for a, b in zip(je.step_stats, te.step_stats):
        assert [getattr(a, f) for f in SCHED_FIELDS] == [getattr(b, f) for f in SCHED_FIELDS]
    assert sorted(te.finished) == list(range(len(prs)))
    assert all(len(r.output) == 6 for r in te.finished.values())
    if "L" in tc.pattern:
        assert max(len(p) for p in prs) + 6 > tc.sliding_window
    if cache == "paged":
        te.kv.check_invariants()
        assert te.kv.used_pages == 0


def test_gemma3_window_is_live_past_its_edge():
    """The window binds where the serving tests cross it: the paged step's
    logits of a 29-token prompt with gemma3's smoke window (16) equal the
    reference's, equal the window-free model's (every layer 'G' in effect)
    at positions within the window, and differ from them past it."""
    jc, tc = jget_smoke("gemma3_27b"), get_smoke_config("gemma3_27b")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    prompt = engine_prompts(jc.vocab_size, n=1)[0]

    def logits(cfg, params, batcher_spec, pm):
        kv = batcher_spec(num_slots=1, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(
            params, cfg)
        assert kv.admit_slot(0, prompt, 1) == 0
        kv.prepare_step([(0, 0, prompt)])
        toks, pos, lens = (np.asarray([prompt], np.int32), np.zeros(1, np.int32),
                           np.asarray([len(prompt)], np.int32))
        if pm is jmodel:
            out, _ = pm.prefill_chunk(params, cfg, kv.state, jnp.asarray(toks),
                                      jnp.asarray(pos), jnp.asarray(lens))
            return np.asarray(out)[0]
        out, _ = pm.prefill_chunk(params, cfg, kv.state, toks, pos, lens)
        return out[0].numpy()

    windowed = logits(tc, tp, KVCacheSpec, model)
    assert_close(windowed, logits(jc, jp, JSpec, jmodel), "model_f32")
    full = logits(dataclasses.replace(tc, sliding_window=0), tp, KVCacheSpec, model)
    w = tc.sliding_window
    np.testing.assert_array_equal(windowed[:w], full[:w])
    gap = np.abs(windowed[w:] - full[w:]).max(axis=-1)
    assert (gap > 1e-3).all(), gap
