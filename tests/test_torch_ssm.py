"""The port's Mamba-2 ('M') serving path against the JAX package on the CPU.

Same numpy inputs (or JAX-initialised weights carried across by
``params_from_jax``) through both packages, in f32:

* the recurrent helpers (``segment_info``, ``packed_conv``,
  ``chunked_conv_state``, ``final_segment_decay``) on ``pack_step``
  layouts, exactly;
* ``_ssd_chunked`` (y and the final state, with a carried initial state
  and a dt = 0 padded tail) and ``apply_ssd``'s three branches, to
  ``TOL["model_f32"]``; the port's shortened short-step chunk against the
  reference's ``ssm_chunk`` padding;
* ``prefill_chunk`` / ``packed_prefill`` logits after every step and the
  carried conv / SSM states for ``mamba2_tiny``, the 2-layer
  ``mamba2_130m`` smoke config and a stack mixing 'G' and 'M' layers,
  over dense and paged caches;
* the ``ContinuousBatcher`` greedy streams against the JAX engine, exactly,
  over {dense, paged} x {dense step, packed step} x budgets {None, 4, 16}
  with slot reuse, and after a cancel (mirroring
  ``tests/test_serve_model_zoo.py:91-189``);
* the recurrent-state lifecycle (admission zeroes, fork copies, sharing
  off, trim refuses) and the typed refusals (training 'R' patterns on the
  card at attention shapes the kernels are not built for; training 'M' at
  SSD shapes the kernels are not built for, K5 under grad).
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
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import KVCacheSpec as JSpec  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import pack_step as jpack_step  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import UnbuiltShapeError  # noqa: E402
from repro_torch.kernels.ssd_chunk import ROW_TILE  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ModelConfig, UnsupportedPatternError, model  # noqa: E402
from repro_torch.models import recurrent, ssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.train import TrainConfig, train  # noqa: E402
from test_torch_parity_util import assert_close, tree_np  # noqa: E402

torch.set_num_threads(1)

# attention and SSD layers in one stack (G then M, repeated), at small widths
GM = dict(name="gm-mix", family="hybrid", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=97, layer_pattern="GM", ssm_state=8, ssm_expand=2,
          ssm_head_dim=16, ssm_chunk=8, dtype="float32", remat=False)
CONFIGS = {
    "mamba2_tiny": (jget_config("mamba2_tiny"), get_config("mamba2_tiny")),
    "mamba2_130m_smoke": (jget_smoke("mamba2_130m"), get_smoke_config("mamba2_130m")),
    "gm_mix": (JConfig(**GM), ModelConfig(**GM)),
}
# a chunk above the kernel's 64-row tile, so short steps take the port's
# shortened chunk (mamba2-130m's own is 256)
LONG_CHUNK = dict(name="long-chunk", family="ssm", n_layers=2, d_model=64, n_heads=1,
                  n_kv_heads=1, d_ff=0, vocab_size=97, layer_pattern="M", ssm_state=8,
                  ssm_expand=2, ssm_head_dim=16, ssm_chunk=128, pos="none", dtype="float32",
                  remat=False)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jc, tc = CONFIGS[request.param]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


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
# the recurrent helpers, exactly
# ---------------------------------------------------------------------------


class TestRecurrentHelpers:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_segment_info(self, seed):
        for lay in layouts(seed):
            want = jrec.segment_info(jnp.asarray(lay.slot_ids), 4)
            got = recurrent.segment_info(t(lay.slot_ids), 4)
            for name in recurrent.SegmentInfo._fields:
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)), err_msg=name)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_packed_conv(self, seed):
        rng = np.random.default_rng(seed)
        for lay in layouts(seed):
            p, k, ch = lay.slot_ids.shape[0], 4, 6
            x = rng.normal(size=(p, ch)).astype(np.float32)
            w = rng.normal(size=(k, ch)).astype(np.float32)
            b = rng.normal(size=(ch,)).astype(np.float32)
            state = rng.normal(size=(4, k - 1, ch)).astype(np.float32)
            jinfo = jrec.segment_info(jnp.asarray(lay.slot_ids), 4)
            want = jrec.packed_conv(*map(jnp.asarray, (x, w, b, state)), jinfo)
            got = recurrent.packed_conv(t(x), t(w), t(b), t(state),
                                        recurrent.segment_info(t(lay.slot_ids), 4))
            for g, wnt in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))

    def test_chunked_conv_state(self):
        rng = np.random.default_rng(3)
        xp = rng.normal(size=(3, 3 + 5, 7)).astype(np.float32)
        lens = np.asarray([0, 5, 2], np.int32)
        want = jrec.chunked_conv_state(jnp.asarray(xp), jnp.asarray(lens), 4)
        got = recurrent.chunked_conv_state(t(xp), t(lens), 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[0].numpy(), xp[0, :3])  # idle row keeps its window

    @pytest.mark.parametrize("seed", [0, 1])
    def test_final_segment_decay(self, seed):
        rng = np.random.default_rng(seed)
        for lay in layouts(seed):
            p = lay.slot_ids.shape[0]
            da = rng.uniform(0.0, 2.0, size=(p, 3)).astype(np.float32)
            da[lay.slot_ids < 0] = 0.0
            cum = np.cumsum(da, axis=0, dtype=np.float32)
            jinfo = jrec.segment_info(jnp.asarray(lay.slot_ids), 4)
            want = jrec.final_segment_decay(jnp.asarray(cum), jnp.asarray(da), jinfo)
            got = recurrent.final_segment_decay(t(cum), t(da),
                                                recurrent.segment_info(t(lay.slot_ids), 4))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # ent
            # w_end is one exp of the same argument: XLA's and torch's exp may
            # round it one ulp apart
            np.testing.assert_array_max_ulp(got[1].numpy(), np.asarray(want[1]), maxulp=1)

    def test_scatter_rows_drops_the_spare_row(self):
        rows = torch.zeros(3, 2)
        out = recurrent.scatter_rows(rows, torch.tensor([3, 1, 3]), torch.ones(3, 2) * 5)
        assert out.tolist() == [[0, 0], [5, 5], [0, 0]]
        assert rows.abs().sum() == 0  # functional: the input is untouched


# ---------------------------------------------------------------------------
# the SSD scan and the block
# ---------------------------------------------------------------------------


def ssd_inputs(bs, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bs, s, h, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(bs, s, h)).astype(np.float32),
            rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32),
            rng.normal(size=(bs, s, n)).astype(np.float32),
            rng.normal(size=(bs, s, n)).astype(np.float32),
            rng.normal(size=(bs, h, n, p)).astype(np.float32))


class TestSsdChunked:
    @pytest.mark.parametrize("s,chunk", [(16, 16), (32, 8), (24, 8)])
    @pytest.mark.parametrize("carried", [False, True])
    def test_matches_reference(self, s, chunk, carried):
        x, dt, a, b, c, st = ssd_inputs(2, s, 3, 4, 5, seed=s + chunk)
        init = st if carried else None
        wy, wf = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk,
                                   init_state=None if init is None else jnp.asarray(init))
        gy, gf = ssm._ssd_chunked(t(x), t(dt), t(a), t(b), t(c), chunk,
                                  init_state=None if init is None else t(init))
        assert_close(gy, wy, "model_f32")
        assert_close(gf, wf, "model_f32")

    def test_ragged_tail_padding_is_an_identity(self):
        """A 13-token step padded with dt = 0 to two chunks of 8: y of the real
        tokens and the final state equal the reference's on the same padded
        inputs, and the state equals a scan of the 13 tokens alone."""
        x, dt, a, b, c, st = ssd_inputs(2, 16, 3, 4, 5, seed=7)
        dt[:, 13:] = 0.0
        x[:, 13:], b[:, 13:], c[:, 13:] = 5.0, 3.0, -2.0  # padding values never count
        wy, wf = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), 8,
                                   init_state=jnp.asarray(st))
        gy, gf = ssm._ssd_chunked(t(x), t(dt), t(a), t(b), t(c), 8, init_state=t(st))
        assert_close(gy[:, :13], np.asarray(wy)[:, :13], "model_f32")
        assert_close(gf, wf, "model_f32")
        _, alone = ssm._ssd_chunked(*(t(v[:, :13]) for v in (x, dt)), t(a),
                                    *(t(v[:, :13]) for v in (b, c)), 13, init_state=t(st))
        assert_close(gf, alone, "model_f32")

    @pytest.mark.parametrize("s", [1, 15, 16, 17, 20, 64, 65, 127])
    def test_short_step_chunk_matches_reference_padding(self, s):
        """The port runs a step shorter than ssm_chunk (128 here) as one chunk
        of its length rounded up to the kernel's row tile; the reference pads
        it to 128.  Same y and final state on the same inputs."""
        cfg = ModelConfig(**LONG_CHUNK)
        assert ssm.chunk_len(s, 128) == min(128, -(-s // ROW_TILE) * ROW_TILE)
        x, dt, a, b, c, st = ssd_inputs(2, s, 3, 4, 5, seed=s)
        pad = 128 - s
        jx, jdt, jb, jc = (jnp.pad(jnp.asarray(v), [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
                           for v in (x, dt, b, c))
        wy, wf = jssm._ssd_chunked(jx, jdt, jnp.asarray(a), jb, jc, 128,
                                   init_state=jnp.asarray(st))
        gy, gf = ssm._ssd_dense(t(x), t(dt), t(a), t(b), t(c), cfg, init_state=t(st))
        assert gy.shape[1] == s
        assert_close(gy, np.asarray(wy)[:, :s], "model_f32")
        assert_close(gf, wf, "model_f32")

    def test_chunk_len(self):
        r = ROW_TILE
        assert [ssm.chunk_len(s, 256) for s in (1, r, r + 1, 200, 256, 300)] == \
            [r, r, 2 * r, -(-200 // r) * r, 256, 256]
        assert [ssm.chunk_len(s, 8) for s in (1, 8, 9)] == [8, 8, 8]


def block_params(cfg, seed):
    """Reference 'M' block parameters with a non-trivial conv bias, step
    bias, skip and norm scale, and the same tree for the port."""
    jp = jssm.init_ssd(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "dt_bias", "d_skip", "norm_scale"):
        jp[k] = jnp.asarray(rng.normal(scale=0.3, size=jp[k].shape).astype(np.float32))
    return jp, {k: t(np.asarray(v)) for k, v in jp.items()}


def block_cache(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    jc = jssm.init_ssd_cache(cfg, batch)
    return {k: rng.normal(scale=0.5, size=v.shape).astype(np.float32) for k, v in jc.items()}


class TestApplySsd:
    """``apply_ssd``'s cache-free, dense chunked and packed branches."""

    @pytest.fixture(params=["mamba2_tiny", "long_chunk"])
    def cfgs(self, request):
        if request.param == "long_chunk":
            return JConfig(**LONG_CHUNK), ModelConfig(**LONG_CHUNK)
        return CONFIGS[request.param][:2]

    def test_cache_free(self, cfgs):
        jc, tc = cfgs
        jp, tp = block_params(jc, 1)
        x = np.random.default_rng(2).normal(size=(2, 21, jc.d_model)).astype(np.float32)
        wy, _ = jssm.apply_ssd(jp, jnp.asarray(x), jc)
        gy, gc = ssm.apply_ssd(tp, t(x), tc)
        assert gc is None
        assert_close(gy, wy, "model_f32")

    def test_chunked(self, cfgs):
        jc, tc = cfgs
        jp, tp = block_params(jc, 3)
        cache = block_cache(jc, 3, 4)
        x = np.random.default_rng(5).normal(size=(3, 11, jc.d_model)).astype(np.float32)
        lens = np.asarray([11, 0, 6], np.int32)
        wy, wc = jssm.apply_ssd(jp, jnp.asarray(x), jc, {k: jnp.asarray(v) for k, v in cache.items()},
                                seq_lens=jnp.asarray(lens))
        tcache = {k: t(v) for k, v in cache.items()}
        gy, _ = ssm.apply_ssd(tp, t(x), tc, tcache, seq_lens=t(lens))
        for i, n in enumerate(lens):
            assert_close(gy[i, :n], np.asarray(wy)[i, :n], "model_f32")
        for k in ("conv", "state"):
            assert_close(tcache[k], wc[k], "model_f32")  # updated in place
        np.testing.assert_array_equal(tcache["state"][1].numpy(), cache["state"][1])  # idle row

    @pytest.mark.parametrize("seed", [0, 1])
    def test_packed(self, cfgs, seed):
        jc, tc = cfgs
        jp, tp = block_params(jc, 6 + seed)
        for lay in layouts(seed, cap=20):
            cache = block_cache(jc, 4, seed)
            p = lay.slot_ids.shape[0]
            x = np.random.default_rng(seed).normal(size=(1, p, jc.d_model)).astype(np.float32)
            wy, wc = jssm.apply_ssd(jp, jnp.asarray(x), jc,
                                    {k: jnp.asarray(v) for k, v in cache.items()},
                                    slot_ids=jnp.asarray(lay.slot_ids))
            tcache = {k: t(v) for k, v in cache.items()}
            gy, _ = ssm.apply_ssd(tp, t(x), tc, tcache, slot_ids=t(lay.slot_ids))
            valid = lay.slot_ids >= 0
            assert_close(gy[0, valid], np.asarray(wy)[0, valid], "model_f32")
            for k in ("conv", "state"):
                assert_close(tcache[k], wc[k], "model_f32")

    def test_decode_branch_is_not_ported(self):
        """The single-token branch (``decode_step``'s), which earlier slices
        refused, against the reference's over several steps from a carried
        state: outputs and both cache leaves."""
        jc, tc = jget_config("mamba2_tiny"), get_config("mamba2_tiny")
        jp, tp = block_params(jc, 0)
        cache = block_cache(jc, 3, 0)
        tcache = {k: t(v) for k, v in cache.items()}
        jcache = {k: jnp.asarray(v) for k, v in cache.items()}
        rng = np.random.default_rng(4)
        for _ in range(5):
            x = rng.normal(size=(3, 1, jc.d_model)).astype(np.float32)
            wy, jcache = jssm.apply_ssd(jp, jnp.asarray(x), jc, jcache)
            gy, _ = ssm.apply_ssd(tp, t(x), tc, tcache)
            assert_close(gy, wy, "model_f32")
            for k in ("conv", "state"):
                assert_close(tcache[k], jcache[k], "model_f32")


# ---------------------------------------------------------------------------
# the model's serving steps
# ---------------------------------------------------------------------------

B, MAX_LEN, PAGE, CAPACITY = 3, 64, 4, 40
# (slot, first position, tokens) per step: uneven prefill chunks spanning
# several scan chunks, a slot decoding while others prefill, an idle slot,
# then a pure decode step
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
    for a, b in zip(jleaves, tleaves):
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


def test_params_from_jax_carries_the_m_tree(pair):
    jc, tc, jp, tp = pair
    assert len(jax.tree.leaves(jp)) == len(tree_leaves(tp))
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(g, np.asarray(w, np.float32)),
                 jp, tree_np(tp))
    m = tp["stack"]["groups"][tc.layer_pattern.index("M")]
    assert set(m) == {"norm1", "ssd"}
    assert set(m["ssd"]) == {
        "w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_scale", "w_out"}


def test_compute_params_keeps_the_ssd_f32_leaves():
    cfg = get_config("mamba2_130m")
    params = model.init_params(dataclasses.replace(cfg, n_layers=1), device="cpu")
    ssd = model.compute_params(params, cfg)["stack"]["groups"][0]["ssd"]
    for k in ("a_log", "dt_bias", "d_skip", "norm_scale"):
        assert ssd[k].dtype == torch.float32, k
    for k in ("w_in", "conv_w", "conv_b", "w_out"):
        assert ssd[k].dtype == torch.bfloat16, k


def test_configs_match_reference():
    assert "mamba2_130m" in ARCHITECTURES and "mamba2_tiny" not in ARCHITECTURES
    for name in ("mamba2_130m", "mamba2_tiny"):
        for jget, tget in ((jget_config, get_config), (jget_smoke, get_smoke_config)):
            jc, tc = jget(name), tget(name)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert jc.param_count() == tc.param_count()
    full = get_config("mamba2_130m")
    assert (full.n_layers, full.d_model, full.ssm_state, full.ssm_head_dim,
            full.ssm_chunk, full.vocab_size) == (24, 768, 128, 64, 256, 50280)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_MAX_LEN = 32
SCHED_FIELDS = ("step", "decode_tokens", "prefill_tokens", "deferred_tokens",
                "shared_tokens", "used_pages", "queued_requests", "budget_overshoot")


@pytest.fixture(scope="module")
def tiny():
    jc, tc = CONFIGS["mamba2_tiny"]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def prompts(vocab, n=5, seed=0):
    """``test_serve_model_zoo``'s prompts: 5 requests of 3-11 tokens
    through 2 slots (slot reuse), spanning several 8-token scan chunks."""
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


@pytest.mark.parametrize("budget", [None, 4, 16])
@pytest.mark.parametrize("packed", [False, True], ids=["dense_step", "packed_step"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_matches_jax(tiny, cache, packed, budget):
    jc, tc, jp, tp = tiny
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
def test_cancel_then_readmit_matches_jax(tiny, cache, packed):
    """A cancelled request's carried state must not leak into the next tenant
    of its slot: the streams after it equal the JAX engine's and a fresh
    engine's."""
    jc, tc, jp, tp = tiny
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
    return [x[:, slot] for x in tree_leaves(kv.state.data["stack"]["groups"])]


class TestRecurrentLifecycle:
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_admit_zeroes_fork_copies_trim_refuses(self, tiny, layout):
        _, tc, _, tp = tiny
        kv = KVCacheSpec(num_slots=2, max_len=ENGINE_MAX_LEN, layout=layout,
                         page_size=4).build(tp, tc)
        assert kv.has_recurrent
        for x in tree_leaves(kv.state.data):
            x.fill_(7.0)
        assert kv.admit_slot(0, [1, 2, 3], 4) == 0
        assert all(not r.any() for r in recurrent_rows(kv, 0))  # admission zeroed slot 0
        assert all((r == 7.0).all() for r in recurrent_rows(kv, 1))  # slot 1 untouched
        if layout == "paged":
            for x in tree_leaves(kv.state.data):
                x[:, 0] = 3.0
            kv.fork_slot(0, 1)
            for a, b in zip(recurrent_rows(kv, 0), recurrent_rows(kv, 1)):
                assert torch.equal(a, b)  # eager copy
        with pytest.raises(UnsupportedPatternError, match="roll back"):
            kv.trim_slot(0, 2)

    def test_prefix_sharing_disabled(self, tiny):
        _, tc, _, tp = tiny
        kv = KVCacheSpec(num_slots=2, max_len=ENGINE_MAX_LEN, layout="paged",
                         page_size=2).build(tp, tc)
        prompt = list(range(10))
        assert kv.admit_slot(0, prompt, 4) == 0
        kv.register_prompt_pages(0, prompt, len(prompt))
        assert kv.probe_shared(prompt) == 0
        assert kv.share(1, prompt, 0) == 0
        assert kv.admit_slot(1, prompt, 4) == 0

    def test_paged_layout_keeps_slot_rows_beside_no_pool(self, tiny):
        """A pure 'M' pattern has no attention pool: the paged layout's tree
        is the dense layout's slot-indexed rows, and page copies pass them by."""
        _, tc, _, tp = tiny
        dense = KVCacheSpec(num_slots=2, max_len=8).build(tp, tc)
        paged = KVCacheSpec(num_slots=2, max_len=8, layout="paged", page_size=4).build(tp, tc)
        shapes = [tuple(x.shape) for x in tree_leaves(dense.state.data)]
        assert shapes == [tuple(x.shape) for x in tree_leaves(paged.state.data)]
        before = [x.clone() for x in tree_leaves(paged.state.data)]
        from repro_torch.serve.kv import copy_pages_state
        copy_pages_state(paged.state, [(0, 1)])
        assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(paged.state.data)))


def test_r_patterns_still_refuse():
    """'R' stacks build, serve (``tests/test_torch_rglru.py``) and train
    (``tests/test_torch_rglru_train.py``); what they still refuse is
    training on the card at a shape the attention kernels are not built
    for, before any work: hybrid_tiny's head dim 32, group 2.
    recurrentgemma-2b trains at 8,192 tokens, and at 16 (K3 takes any
    length)."""
    cuda = torch.device("cuda")
    for name in ("hybrid_tiny", "recurrentgemma_2b"):
        jc = jget_config(name)
        tc = ModelConfig(**dataclasses.asdict(jc))
        assert "R" in tc.pattern
        model.init_params(tc, device="meta")
        model.require_chunkable(tc)
        if name == "hybrid_tiny":
            with pytest.raises(UnbuiltShapeError, match="head dim 32 and group H/KV = 2"):
                model.require_trainable(tc, 16, cuda)
    model.require_trainable(tc, 16, cuda)
    model.require_trainable(tc, 8192, cuda)


def test_training_m_is_refused_before_any_work(tiny, capsys):
    """Training 'M' layers runs (K6 has a backward); what is still refused
    is refused before any work: on the card an 'M' config whose (state, head
    dim) the SSD kernels are not built for, through ``require_trainable``,
    the trainer and the launcher, and K5 (``ssd_segment``) under grad, which
    no training path runs.  The forward-only calls work under ``no_grad``."""
    _, tc, _, _ = tiny
    cuda = torch.device("cuda")
    with pytest.raises(UnbuiltShapeError, match="state 8 and head dim 16"):
        model.require_trainable(tc, 16, cuda)
    model.require_trainable(tc, 16, torch.device("cpu"))
    data = DataConfig(vocab_size=tc.vocab_size, seq_len=8, batch_size=4)
    # the trainer's default device is CUDA: without a card it raises for the
    # device, with one for the SSD shape, before any work either way
    with pytest.raises((UnbuiltShapeError, RuntimeError), match="CUDA|state 8"):
        train(tc, data, TrainConfig(steps=1, n_workers=2, microbatches=2))
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "mamba2-130m", "--steps", "1"])
    assert "state 16 and head dim 32" in capsys.readouterr().err
    # K5 refuses a gradient; K6 takes one
    x = torch.zeros(1, 1, 8, 2, 4, requires_grad=True)
    z = torch.zeros(1, 1, 8, 2)
    bc = torch.zeros(1, 1, 8, 3)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.ssd_segment(x[0, 0], z[0, 0], z[0, 0], bc[0, 0], bc[0, 0],
                        torch.zeros(8, dtype=torch.long))
    ops.ssd_chunk(x, z, z, bc, bc).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    with torch.no_grad():  # forward only is fine
        assert ops.ssd_chunk(x, z, z, bc, bc).shape == x.shape
        assert ops.ssd_segment(x[0, 0], z[0, 0], z[0, 0], bc[0, 0], bc[0, 0],
                               torch.zeros(8, dtype=torch.long)).shape == x.shape[2:]
