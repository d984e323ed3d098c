"""The port's single-token decode (``decode_step``), its verify step and the
serve steps against the JAX package on the CPU, in f32.

* ``decode_step`` over a run of steps for 'G'/'L' attention (a sliding
  window of 8 past which the ring wraps twice), 'R' (``hybrid_tiny`` and
  recurrentgemma's smoke config, whose 'L' layer's ring wraps) and 'M'
  (``mamba2_tiny``): on the ring layout (``init_decode_cache(linear=False)``)
  and the linear one with a scalar position (a lockstep batch) and with
  per-slot positions, and on the paged layout (per-slot positions; a scalar
  refused): the logits of every step and every cache leaf after the run
  within ``TOL["model_f32"]``;
* the greedy streams of a ``decode_step`` loop equal to the reference's
  single-token oracle (``tests/test_serve_model_zoo.py``'s ``decode_oracle``)
  and to the port engine's, exactly;
* ``decode_step`` and the engine's C = 1 step (``prefill_chunk``) run free,
  each on its own cache, for 'M' and 'R': every step's logits and the
  final caches within ``TOL["model_f32"]``, a skipped decay outside it;
* ``verify_step`` equal to ``prefill_chunk`` bit for bit, and to the
  reference's ``verify_step`` within ``TOL["model_f32"]``;
* ``make_serve_step`` / ``make_prefill_step`` against the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import KVCacheSpec as JSpec  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request  # noqa: E402
from test_serve_model_zoo import decode_oracle  # noqa: E402
from test_torch_parity_util import TOL, assert_close, assert_tree_close  # noqa: E402

torch.set_num_threads(1)

#: 'G'/'L' attention: the qwen smoke config with a sliding-window layer
GL = dict(layer_pattern="LG", sliding_window=8)
CONFIGS = {
    "gl_window8": (dataclasses.replace(jget_smoke("qwen2_5_3b"), **GL),
                   dataclasses.replace(get_smoke_config("qwen2_5_3b"), **GL)),
    "recurrentgemma_smoke": (jget_smoke("recurrentgemma_2b"),
                             get_smoke_config("recurrentgemma_2b")),
    "hybrid_tiny": (jget_config("hybrid_tiny"), get_config("hybrid_tiny")),
    "mamba2_tiny": (jget_config("mamba2_tiny"), get_config("mamba2_tiny")),
}
B, MAX_LEN, STEPS, PAGE = 3, 20, 18, 4
OFFSETS = np.asarray([0, 3, 1])  # per-slot positions: slot i starts OFFSETS[i] later

_jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jc, tc = CONFIGS[request.param]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def caches(jc, tc, jp, tp, layout):
    if layout == "paged":
        jkv = JSpec(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE).build(jp, jc)
        tkv = KVCacheSpec(num_slots=B, max_len=MAX_LEN, layout="paged",
                          page_size=PAGE).build(tp, tc)
        for s in range(B):
            for kv in (jkv, tkv):
                assert kv.admit_slot(s, list(range(100 + s, 100 + s + MAX_LEN - 1)), 1) == 0
                kv.prepare_write(s, 0, MAX_LEN)
        return jkv.state, tkv.state
    linear = layout == "linear"
    return (jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=linear),
            model.init_decode_cache(tp, tc, B, MAX_LEN, linear=linear))


def data(cache):
    return getattr(cache, "data", cache)


@pytest.mark.parametrize("layout,pos_kind", [
    ("ring", "scalar"), ("ring", "slots"), ("linear", "scalar"), ("linear", "slots"),
    ("paged", "slots")])
def test_decode_step_matches_reference(pair, layout, pos_kind):
    jc, tc, jp, tp = pair
    jcache, tcache = caches(jc, tc, jp, tp, layout)
    rng = np.random.default_rng(3)
    steps = STEPS if pos_kind == "scalar" else MAX_LEN - int(OFFSETS.max())
    for t in range(steps):
        tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        pos = np.int32(t) if pos_kind == "scalar" else (OFFSETS + t).astype(np.int32)
        jl, jcache = _jdecode(jp, jc, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = model.decode_step(tp, tc, tcache, tok, pos)
        assert tl.shape == (B, 1, tc.vocab_size)
        assert_close(tl, jl, "model_f32")
    assert_tree_close(data(tcache), data(jcache), "model_f32")


def test_ring_buffer_length_and_spare_row(pair):
    """The ring layout's shapes are the reference's (a sliding-window layer
    keeps ``min(window, seq_len)`` rows), and each layer's pool holds one
    spare row past its slots' rows."""
    jc, tc, jp, tp = pair
    jcache = jmodel.init_decode_cache(jp, jc, B, MAX_LEN)
    tcache = model.init_decode_cache(tp, tc, B, MAX_LEN)
    assert [w.shape for w in jax.tree.leaves(jcache)] == \
        [tuple(g.shape) for g in jax.tree.leaves(tcache)]
    for layer in tcache["stack"]["groups"] + tuple(tcache["stack"]["tail"]):
        if "attn" in layer:
            k = layer["attn"]["k"]
            lead = int(np.prod(k.shape[:-4]))
            row = k.shape[-2] * k.shape[-1] * k.element_size()
            assert k.untyped_storage().nbytes() == lead * (k.shape[-4] * k.shape[-3] + 1) * row
            if "L" in tc.pattern and k.shape[-3] < MAX_LEN:
                assert k.shape[-3] == min(tc.sliding_window, MAX_LEN)


def test_paged_decode_refuses_a_scalar_position():
    jc, tc = CONFIGS["gl_window8"]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    _, tcache = caches(jc, tc, jp, tp, "paged")
    with pytest.raises(ValueError, match="per-slot positions"):
        model.decode_step(tp, tc, tcache, np.zeros((B, 1), np.int64), 3)


def port_oracle(params, cfg, prompt, max_new, max_len):
    """``decode_oracle`` on the port: one request alone, token by token."""
    cache = model.init_decode_cache(params, cfg, 1, max_len, linear=True)
    cur, out = list(prompt), []
    for t in range(len(prompt) + max_new - 1):
        lg, cache = model.decode_step(params, cfg, cache, [[cur[t]]], [t])
        if t >= len(prompt) - 1:
            nxt = int(lg[0, 0].argmax())
            cur.append(nxt)
            out.append(nxt)
    return out


@pytest.mark.parametrize("name", ["qwen_smoke", "recurrentgemma_smoke", "hybrid_tiny",
                                  "mamba2_tiny"])
def test_greedy_streams_equal_reference_oracle_and_engine(name):
    jc, tc = ((jget_smoke("qwen2_5_3b"), get_smoke_config("qwen2_5_3b"))
              if name == "qwen_smoke" else CONFIGS[name])
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist() for n in (3, 6)]
    max_new, max_len = 4, 32
    eng = ContinuousBatcher(tp, tc, batch_slots=2, max_len=max_len, chunk_size=4)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    for i, p in enumerate(prompts):
        want = decode_oracle(jp, jc, p, max_new=max_new, max_len=max_len)
        assert port_oracle(tp, tc, p, max_new, max_len) == want
        assert done[i].output == want


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_step_is_prefill_chunk(pair, layout):
    jc, tc, jp, tp = pair
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jc.vocab_size, (B, 5)).astype(np.int32)
    pos = np.asarray([0, 4, 9], np.int32)
    lens = np.asarray([5, 3, 0], np.int32)

    def fresh():
        if layout == "dense":
            return (jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=True),
                    model.init_decode_cache(tp, tc, B, MAX_LEN, linear=True))
        return caches(jc, tc, jp, tp, "paged")

    _, c1 = fresh()
    jcache, c2 = fresh()
    lv, c1 = model.verify_step(tp, tc, c1, tokens, pos, lens)
    lp, c2 = model.prefill_chunk(tp, tc, c2, tokens, pos, lens)
    assert torch.equal(lv, lp)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, {"d": data(c1)}["d"],
                                                 is_leaf=lambda x: isinstance(x, torch.Tensor))),
                    jax.tree.leaves({"d": data(c2)}["d"],
                                    is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert np.array_equal(np.asarray(a), b.numpy())
    jl, _ = jmodel.verify_step(jp, jc, jcache, jnp.asarray(tokens), jnp.asarray(pos),
                               jnp.asarray(lens))
    mask = np.arange(5)[None, :] < lens[:, None]
    assert_close(lv[torch.from_numpy(mask)], np.asarray(jl)[mask], "model_f32")


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_make_serve_step_matches_reference(pair, layout):
    jc, tc, jp, tp = pair
    jcache, tcache = caches(jc, tc, jp, tp, layout)
    jstep = jax.jit(jsteps.make_serve_step(jc))
    tstep = steps.make_serve_step(tc)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
    jtok = jnp.asarray(tok)
    for t in range(MAX_LEN - int(OFFSETS.max())):
        pos = (OFFSETS + t).astype(np.int32)
        jtok, jcache = jstep(jp, jcache, jtok, jnp.asarray(pos))
        ttok, tcache = tstep(tp, tcache, tok, pos)
        assert ttok.shape == (B, 1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        tok = ttok.numpy()


def test_make_prefill_step_matches_reference(pair):
    jc, tc, jp, tp = pair
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    want = jax.jit(jsteps.make_prefill_step(jc))(jp, {"tokens": jnp.asarray(tokens)})
    got = steps.make_prefill_step(tc)(tp, {"tokens": tokens})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["mamba2_tiny", "hybrid_tiny"])
def test_decode_step_runs_free_with_the_chunked_step(name, monkeypatch):
    """Each on its own cache for a whole run, ``decode_step`` (the 'M' and
    'R' layers' single-token forms) and the engine's step, ``prefill_chunk``
    with C = 1 (their chunked forms), give the same logits at every step and
    the same caches at the end within ``TOL["model_f32"]``, so that an error
    which builds up in the state shows.  With the state's decay left out of
    the single-token step ('M': ``exp(-dt a)`` taken as 1; 'R': ``a`` as 1)
    the logits fall outside it."""
    _, tc = CONFIGS[name]
    tp = model.init_params(tc, seed=0, device="cpu")
    tokens = np.random.default_rng(13).integers(0, tc.vocab_size, (B, MAX_LEN - 1))
    lens = np.ones(B, np.int64)
    dec, ref, bad = (model.init_decode_cache(tp, tc, B, MAX_LEN, linear=True) for _ in range(3))
    gaps = []
    for t in range(MAX_LEN - 1):
        tok, pos = tokens[:, t:t + 1], np.full(B, t)
        got, dec = model.decode_step(tp, tc, dec, tok, pos)
        want, ref = model.prefill_chunk(tp, tc, ref, tok, pos, lens)
        assert_close(got, want, "model_f32")
        with monkeypatch.context() as m:
            if name == "mamba2_tiny":
                sound = ssm._apply_decode
                m.setattr(ssm, "_apply_decode",
                          lambda xbc, dt, a, *rest: sound(xbc, dt, torch.zeros_like(a), *rest))
            else:
                m.setattr(rglru, "_softplus", torch.zeros_like)
            faulty, bad = model.decode_step(tp, tc, bad, tok, pos)
        gaps.append(float((faulty - want).abs().max() - TOL["model_f32"]["rtol"]
                          * want.abs().max()))
    for g, w in zip(tree_leaves(data(dec)), tree_leaves(data(ref))):
        assert_close(g, w, "model_f32")
    assert max(gaps) > TOL["model_f32"]["atol"]
