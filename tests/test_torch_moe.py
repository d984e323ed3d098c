"""The MoE family of the port (``repro_torch.models.moe``, the MoE block and
the serving paths that dispatch it) against the JAX package on the CPU, in
f32, at ``moe_tiny`` and the smoke configs of mixtral-8x22b ('L', window
16, 4 experts top-2, untied) and qwen3-moe-235b-a22b ('G', QK-norm):

* ``_router`` (probabilities, ids and aux), ``apply_moe_dense``,
  ``apply_moe_sort`` (one segment and several) and ``apply_moe_capacity``
  at cf in {inf, 1.25, 0.5, 0.25}, with and without a padding mask: ids
  and overflow counts exactly equal, outputs within ``TOL["model_f32"]``;
* the reference's properties (``tests/test_serve_model_zoo.py:193-270``):
  cf = inf gives the dense form's bits, the overflow is the per-expert
  excess, padding takes no capacity, ``capacity_factor`` needs experts;
* ``forward`` and its aux loss against ``repro.models.model.forward``
  (``moe_impl="sort"``), the serving steps in each dispatch;
* the engine: greedy streams and per-step ``expert_overflow`` equal to the
  JAX engine's on the dense and paged caches, unpacked and packed, in the
  dense dispatch and at three capacity factors; a seeded sampled run and
  an n-gram speculative run on ``moe_tiny``;
* ``params_from_jax`` and a reference npz checkpoint of an MoE tree;
* the refusals: MoE training (``loss_fn``, ``train``) and the mesh form.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import NGramProposer as JNGram  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JParams  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.dist import UnsupportedDistError  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import UnsupportedPatternError  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, KVCacheSpec, NGramProposer,  # noqa: E402
                               Request, SamplingParams, SpecConfig)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_parity_util import assert_close, tree_np  # noqa: E402

torch.set_num_threads(1)

#: moe_tiny has no smoke variant of its own: its config is CPU-sized
NAMES = ["moe_tiny", "mixtral_8x22b", "qwen3_moe_235b_a22b"]
CFS = [math.inf, 1.25, 0.5, 0.25]


def configs(name):
    return jget_smoke(name), get_smoke_config(name)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    jc, tc = configs(request.param)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


@pytest.fixture(scope="module", params=NAMES)
def layer(request):
    """One MoE layer's parameters (the reference's init), as JAX arrays and
    as torch tensors, and x (2, 12, d) from a seed."""
    jc, tc = configs(request.param)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 12, jc.d_model)).astype(np.float32)
    return jc, tc, jp, tp, x


def with_cf(jc, tc, cf):
    return (dataclasses.replace(jc, capacity_factor=cf),
            dataclasses.replace(tc, capacity_factor=cf))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference(name):
    for jget, tget in ((jget_config, get_config), (jget_smoke, get_smoke_config)):
        jc, tc = jget(name), tget(name)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_count() == tc.param_count()


def test_registry_takes_the_moe_models_in_the_reference_order():
    from repro.configs import ARCHITECTURES as JARCH

    assert ARCHITECTURES == [a for a in JARCH if a in ARCHITECTURES]
    assert {"mixtral_8x22b", "qwen3_moe_235b_a22b"} <= set(ARCHITECTURES)
    assert "moe_tiny" not in ARCHITECTURES


@pytest.mark.parametrize("name,want,inst", [
    ("mixtral_8x22b", (56, 6144, 48, 8, 128, 8, 2, 16_384, 32_768, "L", 4096), (128, 6)),
    ("qwen3_moe_235b_a22b", (94, 4096, 64, 4, 128, 128, 8, 1536, 151_936, "G", 1024),
     (128, 16)),
])
def test_published_widths_param_counts_and_k4_instance(name, want, inst):
    """Published widths; the port's own tree on the ``meta`` device has
    ``param_count`` leaves (the reference's count); one layer's reckoning
    (the depth cut's unit); the K4 instance the serving takes."""
    cfg = get_config(name)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_experts,
            cfg.top_k, cfg.expert_d_ff, cfg.vocab_size, cfg.layer_pattern,
            cfg.sliding_window) == want
    cut = dataclasses.replace(cfg, n_layers=12)
    meta = model.init_params(cut, device="meta")
    assert sum(x.numel() for x in tree_leaves(meta)) == cut.param_count()
    assert cut.param_count() == dataclasses.replace(jget_config(name), n_layers=12).param_count()
    moe_leaf = meta["stack"]["groups"][0]["moe"]
    assert tuple(moe_leaf["w_gate"].shape) == (12, cfg.n_experts, cfg.d_model, cfg.expert_d_ff)
    assert moe_leaf["router"].dtype == torch.bfloat16  # the published bf16 storage
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == inst
    assert flash_attention.tile_tokens(*inst) == flash_attention.instance(*inst).tile_tokens


def test_params_from_jax_round_trip(pair):
    jc, tc, jp, tp = pair
    assert len(jax.tree.leaves(jp)) == len(tree_leaves(tp))
    assert set(tp["stack"]["groups"][0]["moe"]) == {"router", "w_gate", "w_in", "w_out"}
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(g, np.asarray(w, np.float32)),
                 jp, tree_np(tp))


def test_port_reads_a_reference_moe_checkpoint(tmp_path):
    jc, tc = configs("mixtral_8x22b")
    jp = jmodel.init_params(jax.random.PRNGKey(5), jc)
    jckpt.save(str(tmp_path), {"params": jp}, step=3)
    template = {"params": model.init_params(tc, seed=1, device="cpu")}
    restored, step = ckpt.restore(str(tmp_path), template)
    assert step == 3
    want = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    for a, b in zip(tree_leaves(restored["params"]), tree_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the layer's functions
# ---------------------------------------------------------------------------


def test_router_matches_reference(layer):
    jc, tc, jp, tp, x = layer
    x2d = x.reshape(-1, jc.d_model)
    jprobs, jids, jaux = jmoe._router(jp, jnp.asarray(x2d), jc)
    probs, ids, aux = moe._router(tp, torch.from_numpy(x2d), tc)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert_close(probs, jprobs, "model_f32")
    assert_close(aux, jaux, "model_f32")


def test_top_k_breaks_ties_to_the_lower_index():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    _, ids = moe.top_k(p, 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(p.numpy()),
                                                                        2)[1]))
    assert ids.tolist() == [[1, 2], [0, 1]]


def test_dense_matches_reference(layer):
    jc, tc, jp, tp, x = layer
    jy, jaux = jmoe.apply_moe_dense(jp, jnp.asarray(x), jc)
    y, aux = moe.apply_moe_dense(tp, torch.from_numpy(x), tc)
    assert_close(y, jy, "model_f32")
    assert_close(aux, jaux, "model_f32")


@pytest.mark.parametrize("segment", [moe._SEGMENT_TOKENS, 8], ids=["one", "segments"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_sort_matches_reference(layer, cf, segment):
    """24 tokens in one segment, or in 3 of 8 (their aux the mean); at cf
    0.5 some choices are dropped."""
    jc, tc, jp, tp, x = layer
    jc, tc = with_cf(jc, tc, cf)
    jy, jaux = jmoe.apply_moe_sort(jp, jnp.asarray(x), jc, segment_tokens=segment)
    y, aux = moe.apply_moe_sort(tp, torch.from_numpy(x), tc, segment_tokens=segment)
    assert_close(y, jy, "model_f32")
    assert_close(aux, jaux, "model_f32")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "padded"])
@pytest.mark.parametrize("cf", CFS)
def test_capacity_matches_reference(layer, cf, masked):
    jc, tc, jp, tp, x = layer
    jc, tc = with_cf(jc, tc, cf)
    lens = np.asarray([7, 12])
    valid = np.arange(x.shape[1])[None, :] < lens[:, None] if masked else None
    jy, jaux, jovf = jmoe.apply_moe_capacity(
        jp, jnp.asarray(x), jc, valid=None if valid is None else jnp.asarray(valid))
    y, aux, ovf = moe.apply_moe_capacity(
        tp, torch.from_numpy(x), tc, valid=None if valid is None else torch.from_numpy(valid))
    assert int(ovf) == int(jovf)
    assert_close(y, jy, "model_f32")
    assert_close(aux, jaux, "model_f32")
    if cf == 0.25:
        assert int(ovf) > 0  # the factor binds


def test_capacity_at_inf_is_bit_identical_to_dense(layer):
    jc, tc, jp, tp, x = layer
    _, tc_inf = with_cf(jc, tc, math.inf)
    yd, aux_d = moe.apply_moe_dense(tp, torch.from_numpy(x), tc)
    yc, aux_c, ovf = moe.apply_moe_capacity(tp, torch.from_numpy(x), tc_inf)
    assert int(ovf) == 0
    assert torch.equal(yd, yc) and torch.equal(aux_d, aux_c)


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0])
def test_overflow_is_the_per_expert_excess(layer, cf):
    jc, tc, jp, tp, x = layer
    _, tc = with_cf(jc, tc, cf)
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(tc, t)
    assert cap == min(max(math.ceil(t * tc.top_k / tc.n_experts * cf), 1), t)
    _, ids, _ = moe._router(tp, torch.from_numpy(x).reshape(t, -1), tc)
    counts = np.bincount(ids.numpy().ravel(), minlength=tc.n_experts)
    _, _, ovf = moe.apply_moe_capacity(tp, torch.from_numpy(x), tc)
    assert int(ovf) == int(np.maximum(counts - cap, 0).sum())


def test_padding_consumes_no_capacity(layer):
    """Padding rows come out zero, and the valid rows' outputs and the
    overflow do not depend on what the padding holds."""
    jc, tc, jp, tp, x = layer
    _, tc = with_cf(jc, tc, 0.5)
    s = x.shape[1]
    valid = torch.arange(s)[None, :] < torch.tensor([s // 2, s // 2])[:, None]
    y, _, ovf = moe.apply_moe_capacity(tp, torch.from_numpy(x), tc, valid=valid)
    assert not y[:, s // 2:].any()
    trimmed = torch.from_numpy(x).clone()
    trimmed[:, s // 2:] = 0
    y2, _, ovf2 = moe.apply_moe_capacity(tp, trimmed, tc, valid=valid)
    assert torch.equal(y[:, : s // 2], y2[:, : s // 2]) and int(ovf) == int(ovf2)


def test_dispatch_by_name_and_the_mesh_form(layer):
    jc, tc, jp, tp, x = layer
    xt = torch.from_numpy(x)
    y, aux, ovf = moe.apply_moe(tp, xt, tc, impl="dense")
    assert torch.equal(y, moe.apply_moe_dense(tp, xt, tc)[0]) and int(ovf) == 0
    assert torch.equal(moe.apply_moe(tp, xt, tc, impl="sort")[0],
                       moe.apply_moe_sort(tp, xt, tc)[0])
    with pytest.raises(UnsupportedDistError, match="model axis"):
        moe.apply_moe(tp, xt, tc, impl="spmd")
    with pytest.raises(ValueError, match="moe_impl"):
        moe.apply_moe(tp, xt, tc, impl="scatter")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moe_impl", ["sort", "dense"])
def test_forward_and_aux_match_reference(pair, moe_impl):
    jc, tc, jp, tp = pair
    tokens = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 21)).astype(np.int32)
    want, jaux = jmodel.forward(jp, jc, {"tokens": jnp.asarray(tokens)}, moe_impl=moe_impl)
    with torch.no_grad():
        got, aux = model.forward(tp, tc, {"tokens": torch.from_numpy(tokens)},
                                 moe_impl=moe_impl)
    assert_close(got, want, "model_f32")
    assert_close(aux, jaux, "model_f32")
    assert float(aux) > 0  # the real load-balancing term, not 0


B, MAX_LEN, PAGE, CAPACITY = 3, 40, 4, 24
#: (slot, start position, tokens) grants of successive steps; slot 2 passes
#: position 16 (mixtral's smoke window) by its last steps
STEPS = [
    [(0, 0, 7), (1, 0, 5), (2, 0, 12)],
    [(0, 7, 1), (1, 5, 3), (2, 12, 6)],
    [(0, 8, 1), (2, 18, 5)],
]


@pytest.mark.parametrize("packed,cf", [(False, 0.5), (True, 0.5), (True, None)],
                         ids=["chunked-capacity", "packed-capacity", "packed-dense"])
def test_serving_steps_match_reference(pair, packed, cf):
    """The paged cache's chunked and packed steps in the capacity dispatch
    at 0.5 (padding columns, from ``seq_lens`` or ``slot_ids``, take no
    capacity in either package) or the dense one (``cf`` None), with the
    reference's ``return_aux`` overflow."""
    jc, tc, jp, tp = pair
    impl = "dense" if cf is None else "capacity"
    if cf is not None:
        jc, tc = with_cf(jc, tc, cf)
    from repro.serve import KVCacheSpec as JSpec
    from repro.serve import pack_step as jpack_step

    jkv = JSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(jp, jc)
    tkv = KVCacheSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(tp, tc)
    for s in range(B):
        prompt = list(range(100 + s, 130 + s))
        assert jkv.admit_slot(s, prompt, 0) == tkv.admit_slot(s, prompt, 0) == 0
    rng = np.random.default_rng(1)
    overflows = []
    for step in STEPS:
        grants = [(s, p, rng.integers(0, jc.vocab_size, n).tolist()) for s, p, n in step]
        jkv.prepare_step(grants)
        tkv.prepare_step(grants)
        if packed:
            lay = jpack_step(grants, CAPACITY)
            jl, jkv.state, jaux = jmodel.packed_prefill(
                jp, jc, jkv.state, jnp.asarray(lay.tokens), jnp.asarray(lay.slot_ids),
                jnp.asarray(lay.positions), moe_impl=impl, return_aux=True)
            tl, tkv.state, aux = model.packed_prefill(tp, tc, tkv.state, lay.tokens,
                                                      lay.slot_ids, lay.positions,
                                                      moe_impl=impl, return_aux=True)
            valid = lay.slot_ids >= 0
            jl, tl = np.asarray(jl)[valid], tl[torch.from_numpy(valid)]
        else:
            c = max(len(tk) for _, _, tk in grants)
            tokens = np.zeros((B, c), np.int32)
            pos = np.zeros(B, np.int32)
            lens = np.zeros(B, np.int32)
            for s, p, tk in grants:
                tokens[s, : len(tk)], pos[s], lens[s] = tk, p, len(tk)
            jl, jkv.state, jaux = jmodel.prefill_chunk(
                jp, jc, jkv.state, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lens),
                moe_impl=impl, return_aux=True)
            tl, tkv.state, aux = model.prefill_chunk(tp, tc, tkv.state, tokens, pos, lens,
                                                     moe_impl=impl, return_aux=True)
            mask = np.arange(c)[None, :] < lens[:, None]
            jl, tl = np.asarray(jl)[mask], tl[torch.from_numpy(mask)]
        assert int(aux["expert_overflow"]) == int(jaux["expert_overflow"])
        overflows.append(int(aux["expert_overflow"]))
        assert_close(tl, jl, "model_f32")
    if cf is None:
        assert overflows == [0] * len(STEPS)


def test_decode_verify_and_serve_steps_match_reference(pair):
    """``decode_step`` (ring cache) and ``verify_step`` in the dense dispatch,
    and ``make_serve_step`` / ``make_prefill_step`` (``"sort"``) against the
    reference's."""
    jc, tc, jp, tp = pair
    jcache = jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=False)
    tcache = model.init_decode_cache(tp, tc, B, MAX_LEN, linear=False)
    rng = np.random.default_rng(3)
    jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,))
    for t in range(6):
        tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        pos = (np.asarray([0, 3, 1]) + t).astype(np.int32)
        jl, jcache = jdecode(jp, jc, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = model.decode_step(tp, tc, tcache, tok, pos, moe_impl="dense")
        assert_close(tl, jl, "model_f32")
    lin_j = jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=True)
    lin_t = model.init_decode_cache(tp, tc, B, MAX_LEN, linear=True)
    toks = rng.integers(0, jc.vocab_size, (B, 5)).astype(np.int32)
    pos, lens = np.zeros(B, np.int32), np.asarray([5, 3, 1], np.int32)
    jl, _ = jmodel.verify_step(jp, jc, lin_j, jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(lens))
    tl, _ = model.verify_step(tp, tc, lin_t, toks, pos, lens, moe_impl="dense")
    mask = np.arange(5)[None, :] < lens[:, None]
    assert_close(tl[torch.from_numpy(mask)], np.asarray(jl)[mask], "model_f32")
    ring_j = jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=False)
    ring_t = model.init_decode_cache(tp, tc, B, MAX_LEN, linear=False)
    tok, pos = toks[:, :1], np.asarray([0, 0, 0], np.int32)
    from repro.launch.steps import make_prefill_step as jprefill
    from repro.launch.steps import make_serve_step as jserve

    jnext, _ = jserve(jc)(jp, ring_j, jnp.asarray(tok), jnp.asarray(pos))
    nxt, _ = make_serve_step(tc)(tp, ring_t, tok, pos)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    batch = {"tokens": toks}
    want = jprefill(jc)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = make_prefill_step(tc)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert batch["tokens"] is toks


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_MAX_LEN = 48
FIELDS = ("step", "decode_tokens", "prefill_tokens", "deferred_tokens", "shared_tokens",
          "used_pages", "queued_requests", "budget_overshoot", "expert_overflow")
#: (cache, packed) layouts, each run in every dispatch across the configs:
#: config i takes layout j in dispatch DISPATCH[(i + j) % 4]
LAYOUTS = [("dense", False), ("dense", True), ("paged", False), ("paged", True)]
DISPATCH = [None, math.inf, 1.25, 0.25]
ENGINE_CASES = [(n, cache, packed, DISPATCH[(i + j) % 4])
                for i, n in enumerate(NAMES) for j, (cache, packed) in enumerate(LAYOUTS)]


def engine_prompts(vocab, seed=0):
    """5 requests of 3-29 tokens through 2 slots (slot reuse); the longest
    past position 16, mixtral's smoke window."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=k).tolist() for k in (29, 3, 18, 11, 7)]


def run(batcher, request, params, cfg, prs, sampling=None, **kw):
    eng = batcher(params, cfg, batch_slots=2, max_len=ENGINE_MAX_LEN, chunk_size=4,
                  page_size=4, **kw)
    for i, p in enumerate(prs):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=6,
                           **({} if sampling is None else {"sampling": sampling(i)})))
    eng.run()
    return eng


_PARAMS = {}


def engine_params(name):
    if name not in _PARAMS:
        jc, tc = configs(name)
        jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
        _PARAMS[name] = jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                                    device="cpu")
    return _PARAMS[name]


def outputs(eng):
    return {u: r.output for u, r in sorted(eng.finished.items())}


@pytest.mark.parametrize("name,cache,packed,cf", ENGINE_CASES)
def test_engine_matches_reference(name, cache, packed, cf):
    """Greedy streams, steps and every step's schedule and expert overflow
    equal to the JAX engine's; the summary's overflow keys agree; no page
    leaks."""
    jc, tc, jp, tp = engine_params(name)
    prs = engine_prompts(jc.vocab_size)
    kw = dict(cache=cache, packed=packed, token_budget=5, capacity_factor=cf)
    je = run(JBatcher, JRequest, jp, jc, prs, **kw)
    te = run(ContinuousBatcher, Request, tp, tc, prs, **kw)
    assert te.moe_impl == ("dense" if cf is None else "capacity")
    assert outputs(te) == outputs(je)
    assert te.steps == je.steps
    for a, b in zip(je.step_stats, te.step_stats):
        assert [getattr(a, f) for f in FIELDS] == [getattr(b, f) for f in FIELDS]
    js, ts = je.stats_summary(), te.stats_summary()
    for k in ("expert_overflow_tokens", "max_expert_overflow"):
        assert ts[k] == js[k]
    if cf == 0.25:
        assert ts["expert_overflow_tokens"] > 0
    if cf is None or math.isinf(cf):
        assert ts["expert_overflow_tokens"] == 0
    assert all(len(r.output) == 6 for r in te.finished.values())
    if cache == "paged":
        te.kv.check_invariants()
        assert te.kv.used_pages == 0


def test_engine_cf_inf_streams_equal_dense_dispatch():
    """The engine's parity criterion (``moe.py:165-170``): capacity at cf =
    inf gives the dense dispatch's streams."""
    _, tc, _, tp = engine_params("moe_tiny")
    prs = engine_prompts(tc.vocab_size)
    for packed in (False, True):
        dense = run(ContinuousBatcher, Request, tp, tc, prs, packed=packed)
        inf = run(ContinuousBatcher, Request, tp, tc, prs, packed=packed,
                  capacity_factor=math.inf)
        assert outputs(dense) == outputs(inf)


def test_sampled_and_speculative_engines_match_reference():
    """A seeded sampled run and an n-gram speculative run on moe_tiny
    (capacity dispatch at 1.25 for the first, the dense dispatch for the
    second): streams, steps and the drafts accepted equal the JAX engine's."""
    jc, tc, jp, tp = engine_params("moe_tiny")
    prs = engine_prompts(jc.vocab_size)
    prs[2] = prs[2][:6] * 3  # a repeating prompt: the n-gram proposer drafts
    kw = dict(temperature=0.8, top_p=0.95)
    je = run(JBatcher, JRequest, jp, jc, prs, capacity_factor=1.25, cache="paged",
             sampling=lambda i: JParams(seed=100 + i, **kw))
    te = run(ContinuousBatcher, Request, tp, tc, prs, capacity_factor=1.25, cache="paged",
             sampling=lambda i: SamplingParams(seed=100 + i, **kw))
    assert outputs(te) == outputs(je)
    assert [s.expert_overflow for s in te.step_stats] == [
        s.expert_overflow for s in je.step_stats]
    je = run(JBatcher, JRequest, jp, jc, prs, spec=JSpecConfig(JNGram(), k=3))
    te = run(ContinuousBatcher, Request, tp, tc, prs, spec=SpecConfig(NGramProposer(), k=3))
    assert outputs(te) == outputs(je) and te.steps == je.steps
    assert [(s.draft_tokens, s.accepted_tokens) for s in te.step_stats] == [
        (s.draft_tokens, s.accepted_tokens) for s in je.step_stats]
    assert sum(s.draft_tokens for s in te.step_stats) > 0


def test_capacity_factor_checks():
    _, tc, _, tp = engine_params("moe_tiny")
    dense = dataclasses.replace(tc, n_experts=0)
    dp = model.init_params(dense, seed=0, device="cpu")
    with pytest.raises(ValueError, match="n_experts=0"):
        ContinuousBatcher(dp, dense, batch_slots=1, max_len=8, capacity_factor=1.0)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="must be > 0"):
            ContinuousBatcher(tp, tc, batch_slots=1, max_len=8, capacity_factor=bad)
    eng = ContinuousBatcher(tp, tc, batch_slots=1, max_len=8, capacity_factor=2)
    assert eng.cfg.capacity_factor == 2.0 and eng.moe_impl == "capacity"


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_moe_training_is_refused():
    from repro_torch import train
    from repro_torch.data import DataConfig

    _, tc, _, tp = engine_params("moe_tiny")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(UnsupportedPatternError, match="MoE training"):
        model.loss_fn(tp, tc, batch)
    with pytest.raises(UnsupportedPatternError, match="MoE training"):
        model.per_token_losses(tp, tc, batch)
    with pytest.raises(UnsupportedPatternError, match="MoE training"):
        train.train(tc, DataConfig(vocab_size=tc.vocab_size, seq_len=8, batch_size=2),
                    train.TrainConfig(steps=1, n_workers=1, microbatches=1), device="cpu")


# ---------------------------------------------------------------------------
# the serving example
# ---------------------------------------------------------------------------


def load_example(name):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_example_matches_reference(tmp_path, capsys, monkeypatch):
    """``examples/serve_torch.py --device cpu`` over the reference example's
    weights (its ``PRNGKey(0)`` draw, saved as a reference checkpoint and
    read with ``--ckpt``) prints the reference example's continuation and
    dropped routes for ``--arch moe_tiny --capacity-factor 1.25 --packed``."""
    import sys

    argv = ["--arch", "moe_tiny", "--capacity-factor", "1.25", "--packed", "--requests", "4",
            "--prompt-len", "24", "--new-tokens", "8", "--token-budget", "24"]
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    load_example("serve").main()
    want = capsys.readouterr().out.splitlines()
    jckpt.save(str(tmp_path), {"params": jmodel.init_params(jax.random.PRNGKey(0),
                                                            jget_smoke("moe_tiny"))}, step=0)
    eng = load_example("serve_torch").main([*argv, "--device", "cpu", "--ckpt", str(tmp_path)])
    got = capsys.readouterr().out.splitlines()
    pick = ("sample continuation", "  MoE capacity dispatch", "serving", "finished")
    for line in pick:
        w = [x for x in want if x.startswith(line)]
        g = [x for x in got if x.startswith(line)]
        assert len(w) == len(g) == 1, line
        if line != "finished":
            assert g == w
        else:
            assert g[0].split(" in ")[0] == w[0].split(" in ")[0]
    assert eng.moe_impl == "capacity" and eng.packed


# ---------------------------------------------------------------------------
# chip_smoke.py's route checks (phase 17c), on the CPU
# ---------------------------------------------------------------------------


def load_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_routes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "router_in_bf16", "router_off_by_one"])
def test_smoke_route_checks_reject_planted_router_faults(layer, fault):
    """``chip_smoke.route_flips`` at the same-input layer check's margins
    (``MOE_LAYER_TIE``, ``MOE_LAYER_LOGITS``): the router against itself
    passes with no flips; a router computed in bf16 and one whose k-th
    choice is its (k+1)-th are each rejected."""
    smoke = load_smoke()
    _, tc, _, tp, x = layer
    x2d = torch.from_numpy(x.reshape(-1, x.shape[-1]))

    def routes():
        rec = []
        with smoke.router_calls(rec):
            moe._router(tp, x2d, tc)
        return rec

    want = routes()
    with getattr(smoke, fault)() if fault else smoke.contextlib.nullcontext():
        got = routes()
    flips, read, why = smoke.route_flips(got, want, smoke.MOE_LAYER_TIE, "layer",
                                         logits_tol=smoke.MOE_LAYER_LOGITS)
    if fault is None:
        assert why is None and read["flips"] == 0 and not flips.any()
    else:
        assert why is not None
    assert moe._router.__name__ == "_router" and moe.router_logits.__name__ == "router_logits"
