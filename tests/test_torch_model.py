"""The port's model against the JAX package on the CPU in f32.

JAX ``init_params`` feeds ``params_from_jax``; both packages then run the
same scripted serving steps — ``prefill_chunk`` (dense (B, C) steps) or
``packed_prefill`` (token-packed steps) — over dense and paged caches, for
the ``qwen2_5_3b`` smoke config and the README's ``LG`` demo config (window
64) with ``logit_softcap`` and ``use_qk_norm`` set.  Logits after every
step and the written cache rows must agree to ``TOL["model_f32"]``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import KVCacheSpec as JSpec  # noqa: E402
from repro.serve import pack_step as jpack_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.dist import UnsupportedDistError  # noqa: E402
from repro_torch.models import ModelConfig, UnsupportedPatternError, model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import KVCacheSpec  # noqa: E402
from test_torch_parity_util import assert_close  # noqa: E402

torch.set_num_threads(1)

DEMO = dict(name="demo", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
            vocab_size=1003, sliding_window=64, layer_pattern="LG", dtype="float32",
            remat=False, logit_softcap=30.0, use_qk_norm=True)

CONFIGS = {
    "qwen_smoke": (jget_smoke("qwen2_5_3b"), get_smoke_config("qwen2_5_3b")),
    "lg_demo": (JConfig(**DEMO), ModelConfig(**DEMO)),
}

B, MAX_LEN, CHUNK, PAGE, CAPACITY = 3, 96, 32, 8, 72
# (slot, first position, tokens) per step: prefill chunks of uneven length,
# a slot going to decode while others prefill, positions past the LG
# window (64), then a pure decode step
STEPS = [
    [(0, 0, 20), (1, 0, 7), (2, 0, 32)],
    [(0, 20, 32), (1, 7, 1), (2, 32, 32)],
    [(0, 52, 32), (1, 8, 1), (2, 64, 16)],
    [(0, 84, 1), (1, 9, 1), (2, 80, 1)],
]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jc, tc = CONFIGS[request.param]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def build_caches(jc, tc, jp, tp, layout):
    if layout == "dense":
        return (jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=True),
                model.init_decode_cache(tp, tc, B, MAX_LEN, linear=True), None, None)
    jkv = JSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(jp, jc)
    tkv = KVCacheSpec(num_slots=B, max_len=MAX_LEN, layout="paged",
                      page_size=PAGE).build(tp, tc)
    for s in range(B):
        prompt = list(range(100 + s, 190 + s))  # distinct: no prefix sharing
        assert jkv.admit_slot(s, prompt, 0) == tkv.admit_slot(s, prompt, 0) == 0
    return None, None, jkv, tkv


def cache_leaves(state):
    data = getattr(state, "data", state)
    return [np.asarray(x) for x in jax.tree.leaves(data)]


@pytest.mark.parametrize("packed", [False, True], ids=["chunked", "packed"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serving_steps_match_jax(pair, layout, packed):
    jc, tc, jp, tp = pair
    jcache, tcache, jkv, tkv = build_caches(jc, tc, jp, tp, layout)
    rng = np.random.default_rng(1)
    for step in STEPS:
        grants = [(s, p, rng.integers(0, jc.vocab_size, n).tolist()) for s, p, n in step]
        if layout == "paged":
            jkv.prepare_step(grants)
            tkv.prepare_step(grants)
            np.testing.assert_array_equal(np.asarray(jkv.state.tables),
                                          tkv.state.tables.numpy())
            jcache, tcache = jkv.state, tkv.state
        if packed:
            lay = jpack_step(grants, CAPACITY)
            jl, jcache = jmodel.packed_prefill(
                jp, jc, jcache, jnp.asarray(lay.tokens), jnp.asarray(lay.slot_ids),
                jnp.asarray(lay.positions))
            tl, tcache = model.packed_prefill(tp, tc, tcache, lay.tokens, lay.slot_ids,
                                              lay.positions)
        else:
            c = CHUNK if any(len(t) > 1 for _, _, t in grants) else 1
            tokens = np.zeros((B, c), np.int32)
            pos = np.zeros(B, np.int32)
            lens = np.zeros(B, np.int32)
            for s, p, t in grants:
                tokens[s, : len(t)], pos[s], lens[s] = t, p, len(t)
            jl, jcache = jmodel.prefill_chunk(jp, jc, jcache, jnp.asarray(tokens),
                                              jnp.asarray(pos), jnp.asarray(lens))
            tl, tcache = model.prefill_chunk(tp, tc, tcache, tokens, pos, lens)
        assert tuple(tl.shape) == tuple(jl.shape)
        assert_close(tl, jl, "model_f32")
        if layout == "paged":
            jkv.state, tkv.state = jcache, tcache
    jleaves = cache_leaves(jcache)
    tleaves = [x.numpy() for x in tree_leaves(getattr(tcache, "data", tcache))]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert_close(b, a, "model_f32")


def test_configs_match_reference():
    for name in ("qwen2_5_3b",):
        for jget, tget in ((jget_config, get_config), (jget_smoke, get_smoke_config)):
            jc, tc = jget(name), tget(name)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert jc.param_count() == tc.param_count()
            assert (jc.hd, jc.pattern, jc.is_encdec) == (tc.hd, tc.pattern, tc.is_encdec)
    jc, tc = CONFIGS["lg_demo"]
    assert jc.param_count() == tc.param_count()


def test_compute_dtype_and_cast_once():
    cfg = get_config("qwen2_5_3b")
    assert cfg.compute_dtype == torch.bfloat16 and cfg.params_dtype == torch.float32
    tc = CONFIGS["lg_demo"][1]
    params = model.init_params(dataclasses.replace(tc, dtype="bfloat16"), device="cpu")
    cast = model.compute_params(params, dataclasses.replace(tc, dtype="bfloat16"))
    leaves = dict(zip(map(id, tree_leaves(params)), tree_leaves(params)))
    for path, leaf in (("embedding", cast["embed"]["embedding"]),
                       ("q_norm", cast["stack"]["groups"][0]["attn"]["q_norm"])):
        want = torch.float32 if path == "q_norm" else torch.bfloat16
        assert leaf.dtype == want, path
    again = model.compute_params(cast, dataclasses.replace(tc, dtype="bfloat16"))
    assert all(a is b for a, b in zip(tree_leaves(again), tree_leaves(cast)))
    assert len(leaves) == len(tree_leaves(cast))


def test_unsupported_patterns_raise_typed():
    # 'R' and 'M' decoder layers, experts (served and trained), an
    # encoder-decoder split with a 'G' decoder and a VLM prefix are ported;
    # an encoder block among decoder blocks and an enc-dec decoder of other
    # blocks are not, nor is the experts' mesh dispatch (no model axis)
    for kw in (dict(layer_pattern="BG"), dict(layer_pattern="RB"),
               dict(enc_layers=2, layer_pattern="L")):
        with pytest.raises(UnsupportedPatternError):
            model.init_params(ModelConfig(**kw), device="cpu")
    for kw in (dict(enc_layers=2), dict(prefix_len=4)):
        model.init_params(ModelConfig(**kw), device="cpu")
    moe = ModelConfig(n_experts=4)
    with pytest.raises(UnsupportedDistError):
        model.loss_fn(model.init_params(moe, device="cpu"), moe,
                      {"tokens": torch.zeros((1, 8), dtype=torch.long)}, moe_impl="spmd")


def test_params_from_jax_checks_the_tree(pair):
    jc, tc, jp, _ = pair
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_jax(tree, tc, device="cpu")


def test_init_params_is_seeded():
    tc = CONFIGS["lg_demo"][1]
    a = model.init_params(tc, seed=3, device="cpu")
    b = model.init_params(tc, seed=3, device="cpu")
    c = model.init_params(tc, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["embed"]["embedding"], c["embed"]["embedding"])
    w = a["stack"]["groups"][0]["attn"]["wq"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(tc.d_model) + 1e-6  # truncated at 2 sigma
