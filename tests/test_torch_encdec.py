"""The enc-dec family in the port (whisper-tiny), against the JAX package
on the CPU in f32, and K3 at the ragged lengths it trains at.

whisper's smoke config (2 + 2 layers, d 128, 4 heads) with a ragged
``enc_seq`` of 40 frames (``ENC``): the configs equal the reference's field
for field; ``params_from_jax`` maps the reference's tree exactly (the
``encoder`` and the decoder blocks' ``cross_norm`` / ``cross_attn``);
``encode``, ``_cross_kv``, ``forward`` and ``loss_fn`` equal the
reference's to ``model_f32``, every gradient leaf ``jax.grad``'s (with and
without remat); 20 ``decode_step`` logits equal the reference's
``decode_step`` and the port's own teacher-forced ``forward`` (the
reference's ``test_decode_matches_prefill`` check), greedy tokens through
``make_serve_step`` too; 3 ``TrainStep`` steps with ``frames`` equal the
reference's ``make_train_step`` (drop masks exactly); a reference
checkpoint of the tree loads and gives the same ``forward``; what enc-dec
still refuses (paged decode, the engine, a decode cache without
``enc_out``), and that the VLM config, refused until the VLM slice, is
admitted.

K3 at ragged lengths: its plain versions equal the reference's ``sdpa``
and its ``jax.vjp`` at lengths off the tiles (every key attended);
``tile_plan``'s forward rows end at Sk there, its plans at multiples of
the tile are the earlier formula's, and a numpy walk of the CUDA kernels'
schedule (``walk_fwd`` / ``walk_bwd``: zero-filled tail tiles, the masks,
lse and delta padded to a 64-row step) equals the plain versions, while
the two faults ``chip_smoke.py`` plants (the tail tile's mask skipped, the
last key tile's dK/dV dropped) do not.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import InputShape as JShape  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, ref  # noqa: E402
from repro_torch.kernels.flash_attention import UnbuiltShapeError  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import InputShape, ModelConfig, UnsupportedPatternError, model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_parity_util import (  # noqa: E402
    TOL,
    assert_close,
    assert_tree_close,
    load_smoke,
    np32,
)

torch.set_num_threads(1)

#: the encoder's frames in these tests: off every tile, as whisper's 1,500
ENC = 40
#: decoder tokens a sequence, decode steps, and the decode cache's length
SEQ, STEPS, MAX_LEN = 12, 20, 24


def configs(**kw):
    jc = dataclasses.replace(jget_smoke("whisper_tiny"), enc_seq=ENC, **kw)
    tc = dataclasses.replace(get_smoke_config("whisper_tiny"), enc_seq=ENC, **kw)
    return jc, tc


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs()
    jp = jax.jit(jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(3), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(30)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (2, SEQ)).astype(np.int32),
             "weights": (rng.random((2, SEQ)) > 0.2).astype(np.float32),
             "frames": rng.normal(size=(2, ENC, jc.d_model)).astype(np.float32)}
    return jc, tc, jp, tp, batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape))]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_configs_equal_the_reference_field_for_field():
    assert "whisper_tiny" in ARCHITECTURES
    for port, jref in ((get_config("whisper_tiny"), jget_config("whisper_tiny")),
                       (get_smoke_config("whisper_tiny"), jget_smoke("whisper_tiny"))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jref)
        assert port.param_count() == jref.param_count()
    full = get_config("whisper_tiny")
    assert (full.enc_layers, full.n_layers, full.enc_seq, full.d_model, full.hd) == (
        4, 4, 1500, 384, 64)


def test_parameter_trees_equal_the_reference(setup):
    """Paths and shapes at the smoke config and, from the meta device, at
    full size against JAX's abstract tree: the tail-only decoder with
    ``cross_norm`` / ``cross_attn``, the ``encoder`` blocks, norm and
    positions."""
    _, tc, jp, _, _ = setup
    got = _paths(model.init_params(tc, seed=0, device="cpu"))
    assert got == _paths(jp)
    assert ("/encoder/pos_embedding", (ENC, tc.d_model)) in got
    assert ("/stack/tail/1/cross_attn/wq", (tc.d_model, tc.n_heads, tc.hd)) in got
    full = _paths(model.init_params(get_config("whisper_tiny"), device="meta"))
    abstract = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                         jget_config("whisper_tiny")))
    assert full == _paths(abstract)


def test_params_from_jax_is_exact(setup):
    jc, tc, jp, tp, _ = setup
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tree_leaves(tp))
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert torch.equal(node, torch.from_numpy(np.asarray(leaf))), path


# ---------------------------------------------------------------------------
# the forward, the loss and its gradient
# ---------------------------------------------------------------------------


def test_encode_and_cross_kv(setup):
    jc, tc, jp, tp, batch = setup
    want = jax.jit(lambda p, f: jmodel.encode(p, jc, f))(jp, jnp.asarray(batch["frames"]))
    with torch.no_grad():
        got = model.encode(tp, tc, torch.from_numpy(batch["frames"]))
        assert_close(got, want, "model_f32")
        for blk, jblk in zip(tp["stack"]["tail"], jp["stack"]["tail"]):
            for g, w in zip(model._cross_kv(blk, got, tc), jmodel._cross_kv(jblk, want, jc)):
                assert g.shape == (2, ENC, tc.n_kv_heads, tc.hd)
                assert_close(g, w, "model_f32")


def test_encoder_attends_both_ways(setup):
    """Changing the last frame moves the first frame's encoding (a causal
    encoder would leave it)."""
    _, tc, _, tp, batch = setup
    other = batch["frames"].copy()
    other[:, -1] = np.random.default_rng(33).normal(size=other[:, -1].shape)
    with torch.no_grad():
        a = model.encode(tp, tc, torch.from_numpy(batch["frames"]))
        b = model.encode(tp, tc, torch.from_numpy(other))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


def test_forward_and_loss(setup):
    jc, tc, jp, tp, batch = setup
    (jl, jaux), (ls, w) = jax.jit(lambda p, b: (jmodel.forward(p, jc, b),
                                                 jmodel.loss_fn(p, jc, b)))(jp, jbatch(batch))
    with torch.no_grad():
        tl, taux = model.forward(tp, tc, tbatch(batch))
        tls, tw = model.loss_fn(tp, tc, tbatch(batch))
    assert tl.shape == (2, SEQ, tc.vocab_size)
    assert_close(tl, jl, "model_f32")
    assert float(taux) == float(jaux) == 0.0
    assert_close(tls, ls, "model_f32")
    assert float(tw) == float(w)


@pytest.mark.parametrize("remat", [False, True])
def test_every_grad_leaf(setup, remat):
    """``loss_fn``'s gradient for every leaf (the encoder's through the
    cross K/V) against ``jax.value_and_grad`` of the reference's; with
    remat each encoder block and each decoder block with its cross K/V is
    checkpointed."""
    jc, tc, jp, tp, batch = setup
    jc, tc = dataclasses.replace(jc, remat=remat), dataclasses.replace(tc, remat=remat)
    (ls, w), jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(p, jc, jbatch(batch)),
                                             has_aux=True))(jp)
    grad_fn = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
    g, tls, tw = grad_fn(model.train_params(tp, tc), tbatch(batch))
    assert_close(tls, ls, "model_f32")
    assert float(tw) == float(w)
    assert float(torch.linalg.vector_norm(g["encoder"]["pos_embedding"])) > 0
    assert_tree_close(g, jg, "model_f32")


# ---------------------------------------------------------------------------
# serving: decode_step over the self and cross caches
# ---------------------------------------------------------------------------


def test_decode_steps_match_the_reference_and_the_forward(setup):
    """20 greedy-free steps teacher-forced on one token stream: each step's
    logits against the reference's ``decode_step`` and the port's own
    ``forward`` of the whole stream at that position; the cross K/V in the
    cache is each layer's ``_cross_kv`` of the encoding."""
    jc, tc, jp, tp, batch = setup
    toks = np.random.default_rng(31).integers(0, jc.vocab_size, (2, STEPS)).astype(np.int32)
    jenc = jmodel.encode(jp, jc, jnp.asarray(batch["frames"]))
    jcache = jmodel.init_decode_cache(jp, jc, 2, MAX_LEN, enc_out=jenc)
    jstep = jax.jit(lambda c, t, p: jmodel.decode_step(jp, jc, c, t, p))
    fb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(batch["frames"])}
    with torch.no_grad():
        tenc = model.encode(tp, tc, torch.from_numpy(batch["frames"]))
        cache = model.init_decode_cache(tp, tc, 2, MAX_LEN, enc_out=tenc)
        assert len(cache["cross_kv"]) == tc.n_layers
        assert_close(cache["cross_kv"][0][0], jcache["cross_kv"][0][0], "model_f32")
        teacher, _ = model.forward(tp, tc, fb)
        for t in range(STEPS):
            jl, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            tl, cache = model.decode_step(tp, tc, cache, torch.from_numpy(toks[:, t:t + 1]), t)
            assert tl.shape == (2, 1, tc.vocab_size)
            assert_close(tl, jl, "model_f32")
            assert_close(tl[:, 0], teacher[:, t], "model_f32")


def test_serve_step_generates_the_decode_steps_tokens(setup):
    """``make_serve_step`` (on the CPU the step runs eagerly) over an
    enc-dec cache: 8 greedy tokens a request, per-slot positions, equal to
    ``decode_step``'s argmax run by hand."""
    _, tc, _, tp, batch = setup
    with torch.no_grad():
        enc = model.encode(tp, tc, torch.from_numpy(batch["frames"]))
        caches = [model.init_decode_cache(tp, tc, 2, MAX_LEN, enc_out=enc) for _ in range(2)]
        step = steps.make_serve_step(tc)
        tok = want = torch.tensor([[1], [2]])
        got, ref_toks = [], []
        for t in range(8):
            pos = torch.full((2,), t)
            tok, _ = step(tp, caches[0], tok, pos)
            got.append(tok.clone())
            logits, _ = model.decode_step(tp, tc, caches[1], want, pos)
            want = logits[:, -1].argmax(-1, keepdim=True)
            ref_toks.append(want)
    assert torch.equal(torch.cat(got, 1), torch.cat(ref_toks, 1))


# ---------------------------------------------------------------------------
# training: the DropCompute step with frames; a checkpoint
# ---------------------------------------------------------------------------


def test_train_step_with_frames_matches_the_reference():
    """``make_train_step`` on 2 workers x 2 micro-batches with ``frames`` in
    the batch (sliced with the tokens, as the reference's ``to_micro``
    maps every leaf): 3 steps whose latencies drop one micro-batch, then
    none, then two; the completed fractions exactly, losses and final
    parameters to ``model_f32``."""
    jc, tc = configs()
    jp = jax.jit(jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(6), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jshape = JShape("t", SEQ, 8, "train", microbatches=2)
    shape = InputShape("t", SEQ, 8, "train", microbatches=2)
    jdrop, drop = jcore.DropConfig(enabled=True, tau=1.0), core.DropConfig(enabled=True, tau=1.0)
    jopt, jstep = jsteps.make_train_step(jc, jshape, jdrop, 2, lr=1e-3)
    opt, step = steps.make_train_step(tc, shape, drop, 2, lr=1e-3)
    jstate, state = jopt.init(jp), opt.init(tp)
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(32)
    lats = ([[0.3, 0.3], [0.3, 0.8]], [[0.3, 0.3], [0.3, 0.3]], [[0.3, 0.8], [0.3, 0.8]])
    for lat in lats:
        lat = np.asarray(lat, np.float32)
        batch = {"tokens": rng.integers(0, jc.vocab_size, (8, SEQ)).astype(np.int32),
                 "weights": np.ones((8, SEQ), np.float32),
                 "frames": rng.normal(size=(8, ENC, jc.d_model)).astype(np.float32)}
        jp, jstate, jm = jstep(jp, jstate, jbatch(batch), jnp.asarray(lat))
        _, state, m = step(tp, state, batch, lat)
        assert float(m["completed_fraction"]) == float(jm["completed_fraction"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL["model_f32"])
    assert_tree_close(tp, jax.tree.map(lambda x: np.asarray(x, np.float32), jp), "model_f32")


def test_reference_checkpoint_round_trip(setup, tmp_path):
    """The reference's npz + ``meta.json`` of whisper's smoke tree restores
    into the port's tree bit for bit and gives the reference's
    ``forward``; the port's own save of it restores in the reference."""
    jc, tc, jp, _, batch = setup
    jckpt.save(str(tmp_path / "jax"), {"params": jp}, step=7)
    restored, at = ckpt.restore(str(tmp_path / "jax"),
                                {"params": model.init_params(tc, seed=1, device="cpu")})
    assert at == 7
    want = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    for a, b in zip(tree_leaves(restored["params"]), tree_leaves(want)):
        assert torch.equal(a, b)
    with torch.no_grad():
        got, _ = model.forward(restored["params"], tc, tbatch(batch))
    assert_close(got, jmodel.forward(jp, jc, jbatch(batch))[0], "model_f32")
    ckpt.save(str(tmp_path / "torch"), {"params": restored["params"]}, step=8)
    back, at = jckpt.restore(str(tmp_path / "torch"), {"params": jp})
    assert at == 8
    for a, b in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# what enc-dec refuses, and the card's shapes
# ---------------------------------------------------------------------------


def test_refusals(setup):
    """Paged decode, the engine, the paged layout and the prefill steps
    refuse an enc-dec model with the typed error, as the reference's do;
    a decode cache without ``enc_out`` raises ``ValueError``; the VLM
    config is admitted (``tests/test_torch_vlm.py`` holds it)."""
    _, tc, _, tp, batch = setup
    with pytest.raises(ValueError, match="enc_out"):
        model.init_decode_cache(tp, tc, 2, MAX_LEN)
    with pytest.raises(UnsupportedPatternError, match="ContinuousBatcher does not support enc-dec"):
        ContinuousBatcher(tp, tc, batch_slots=2, max_len=MAX_LEN)
    with pytest.raises(UnsupportedPatternError):
        KVCacheSpec(num_slots=2, max_len=MAX_LEN, layout="paged", page_size=8).build(tp, tc)
    with pytest.raises(UnsupportedPatternError):
        model.prefill_chunk(tp, tc, {}, torch.zeros((1, 4), dtype=torch.long),
                            torch.zeros(1), torch.ones(1))
    with pytest.raises(UnsupportedPatternError, match="enc-dec"):
        model.require_chunkable(tc)
    with torch.no_grad():
        cache = model.init_decode_cache(tp, tc, 2, MAX_LEN,
                                        enc_out=model.encode(tp, tc, torch.from_numpy(
                                            batch["frames"])))
    paged = type("PagedState", (), {"data": cache, "tables": torch.zeros((2, 3), dtype=torch.int32),
                                    "page_size": 8})()
    with pytest.raises(UnsupportedPatternError, match="paged KV does not support enc-dec"):
        model.decode_step(tp, tc, paged, torch.zeros((2, 1), dtype=torch.long), 0)
    vlm = ModelConfig(**dataclasses.asdict(jget_config("internvl2_1b")))
    model.init_params(vlm, device="meta")
    model.require_trainable(vlm, 448, torch.device("cuda"))  # 256 prefix rows + 192 tokens


def test_card_shapes_are_admitted():
    """whisper-tiny on the card: head dim 64, group 1, bf16 at its three
    attention shapes (1,500 frames, 448 tokens, 448 x 1,500); its f32 smoke
    config is refused for its head dim 32."""
    cuda = torch.device("cuda")
    model.require_trainable(get_config("whisper_tiny"), 448, cuda)
    with pytest.raises(UnbuiltShapeError, match="head dim 32 and group H/KV = 1"):
        model.require_trainable(get_smoke_config("whisper_tiny"), 448, cuda)
    model.require_trainable(get_smoke_config("whisper_tiny"), 448, torch.device("cpu"))


# ---------------------------------------------------------------------------
# K3 at ragged lengths
# ---------------------------------------------------------------------------

#: (Sq, Sk, causal): the encoder's and the decoder's self-attention, cross-
#: attention, lengths below 128 off 64, a multiple of 64 above 128 that is
#: not one of 128, a tail tile of one key
RAGGED = [(200, 200, False), (200, 200, True), (200, 300, False), (100, 100, True),
          (90, 130, False), (192, 192, True), (129, 257, False)]
STEP = flash_attention.STEP


def k3_inputs(sq, sk, b=2, h=3, d=16, seed=0):
    rng = np.random.default_rng(seed + sq + sk)

    def t(s):
        return torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32))

    return t(sq), t(sk), t(sk), t(sq)


@pytest.mark.parametrize("sq,sk,causal", RAGGED)
def test_k3_plain_versions_equal_the_references_sdpa(sq, sk, causal):
    """Off the tiles every key is attended: the plain forward equals the
    reference's ``sdpa`` (right-aligned causal mask where causal), the
    plain backward its ``jax.vjp``."""
    q, k, v, do = k3_inputs(sq, sk)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    mask = jlayers.causal_mask(sq, sk, q_offset=sk - sq) if causal else None

    def jsdpa(q_, k_, v_):  # (B, H, S, D) in the kernel's layout
        o = jlayers.sdpa(*(jnp.swapaxes(x, 1, 2) for x in (q_, k_, v_)), mask)
        return jnp.swapaxes(o, 1, 2)

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_):
        o, vjp = jax.vjp(jsdpa, q_, k_, v_)
        return o, vjp(do_)

    want, wgrads = fwd_bwd(*(jnp.asarray(np32(x)) for x in (q, k, v, do)))
    assert_close(out, want, "kernel_f32")
    for g, w in zip(grads, wgrads):
        assert_close(g, w, "kernel_f32")


def _old_fwd_plan(sq, sk, causal, window):
    """``tile_plan("fwd")`` before ragged lengths (the block count floored),
    for the lengths it took."""
    rows = []
    kp = flash_attention._key_ranges(sq, sk, causal, window)
    for start in range(0, sq, 128):
        a, b = kp[0][start:start + 128], kp[1][start:start + 128]
        bq, bk = min(128, sq), min(128, sk)
        t_hi = sk // bk
        if causal:
            t_hi = min((start + bq - 1 + sk - sq) // bk + 1, t_hi)
        t_lo = max((start + sk - sq - window + 1) // bk, 0) if window > 0 else 0
        end = max(t_hi, 0) * bk
        s_lo, s_hi = t_lo * bk // STEP, -(-end // STEP)
        f_lo, f_hi = max(-(-int(a.max()) // STEP), s_lo), min(min(int(b.min()), end) // STEP, s_hi)
        if f_hi <= f_lo:
            f_lo = f_hi = s_lo
        rows.append((start, s_lo, max(s_hi, s_lo), f_lo, f_hi, end))
    plan = np.array(rows, dtype=np.int32)
    return plan[np.argsort(-(plan[:, 2] - plan[:, 1]), kind="stable")]


@pytest.mark.parametrize("sq,sk", [(64, 64), (128, 128), (2048, 2048), (128, 256), (64, 2048),
                                   (100, 100), (256, 100)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0)])
def test_plans_at_the_tpu_kernels_lengths_are_unchanged(sq, sk, causal, window):
    assert not flash_attention._ragged(sq, sk)
    np.testing.assert_array_equal(flash_attention.tile_plan("fwd", sq, sk, causal, window),
                                  _old_fwd_plan(sq, sk, causal, window))


@pytest.mark.parametrize("sq,sk,causal", RAGGED + [(448, 1500, False), (1500, 1500, False),
                                                    (448, 448, True)])
def test_ragged_plans(sq, sk, causal):
    """Every forward row ends at Sk and visits ``ref.visited_keys``'s range
    (every admissible key: non-causal rows all Sk keys); in every plan each
    admissible pair is visited, each mask-free tile holds only admissible
    pairs of real elements, and each outer tile has its CTA."""
    fwd = flash_attention.tile_plan("fwd", sq, sk, causal, 0)
    assert flash_attention._ragged(sq, sk) == any(s > 128 and s % 128 > 0 for s in (sq, sk))
    assert (fwd[:, 5] == sk).all()
    lo, hi = ref.visited_keys(sq, sk, causal, 0)
    for start, s_lo, s_hi, *_ in fwd.tolist():
        rows = slice(start, start + 128)
        assert (lo[rows] == s_lo * STEP).all()
        assert (hi[rows] == min(s_hi * STEP, sk)).all()
    if not causal:
        assert (hi == sk).all()
    mask = ref.attention_mask(sq, sk, causal, 0)[0].numpy()
    for kind in ("fwd", "dkdv", "dq"):
        plan = flash_attention.tile_plan(kind, sq, sk, causal, 0)
        outer_n, inner = flash_attention.PLAN_KINDS[kind]
        m = mask.T if kind == "dkdv" else mask
        n_outer, n_inner = m.shape
        visited, free = np.zeros_like(m), np.zeros((n_outer, -(-n_inner // inner) * inner), bool)
        for start, s_lo, s_hi, f_lo, f_hi, end in plan.tolist():
            rows = slice(start, min(start + outer_n, n_outer))
            visited[rows, s_lo * inner:min(s_hi * inner, end)] = True
            assert s_lo <= f_lo <= f_hi <= s_hi
            free[rows, f_lo * inner:f_hi * inner] = True
        assert not (m & ~visited).any()
        assert not free[:, n_inner:].any()  # a tile past the length is never free
        assert not (free[:, :n_inner] & ~m).any()
        assert sorted(plan[:, 0].tolist()) == list(range(0, n_outer, outer_n))


def _pad(x, n):
    return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:], x.dtype)])


def _admissible(qpos, kpos, causal, window):
    ok = np.ones((len(qpos), len(kpos)), bool)
    if causal:
        ok &= kpos[None] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None] > qpos[:, None] - window
    return ok


def walk_fwd(q, k, v, plan, causal, window=0):
    """What ``attn_fwd`` computes for one (batch, head) of f32 q (Sq, D),
    k / v (Sk, D), walking ``plan``: 128-row tiles, 64-key steps read with
    TMA's zeros past Sk, unfree steps masked (-inf at or past the row's
    end, -1e30 on inadmissible pairs), an online softmax from -1e30.
    Returns (out, lse) for the real rows."""
    sq, sk, d = len(q), len(k), q.shape[1]
    scale = 1.0 / np.sqrt(d)
    qp = _pad(q, -(-sq // 128) * 128)
    kp, vp = _pad(k, -(-sk // STEP) * STEP), _pad(v, -(-sk // STEP) * STEP)
    out, lse = np.zeros((sq, d)), np.zeros(sq)
    for start, s_lo, s_hi, f_lo, f_hi, end in plan.tolist():
        rows = np.arange(start, start + 128)
        m, l, acc = np.full(128, -1e30), np.zeros(128), np.zeros((128, d))
        for t in range(s_lo, s_hi):
            keys = np.arange(t * STEP, (t + 1) * STEP)
            s = qp[rows] @ kp[keys].T * scale
            if not f_lo <= t < f_hi:
                ok = _admissible(rows + sk - sq, keys, causal, window)
                s = np.where(keys[None] >= end, -np.inf, np.where(ok, s, -1e30))
            mn = np.maximum(m, s.max(1))
            alpha = np.exp(m - mn)
            p = np.exp(s - mn[:, None])
            l, acc, m = l * alpha + p.sum(1), acc * alpha[:, None] + p @ vp[keys], mn
        real = rows < sq
        out[rows[real]] = (acc / np.maximum(l, 1e-30)[:, None])[real]
        lse[rows[real]] = np.where(m == -1e30, -1e30, m + np.log(np.maximum(l, 1e-30)))[real]
    return out, lse


def walk_bwd(q, k, v, o, lse, do, plans, causal, window=0):
    """What ``attn_bwd_dkdv`` and ``attn_bwd_dq`` compute for one (batch,
    head), walking ``plans`` = (dkdv plan, dq plan): lse and delta read in
    64-row steps from rows padded to one (lse +inf, delta 0 in the pad),
    q / dO / k / v tiles with zeros past their lengths, unfree steps masked
    (P = 0 at keys at or past Sk, query rows at or past Sq, inadmissible
    pairs), dK / dV stored for real keys, dQ for real rows."""
    sq, sk, d = len(q), len(k), q.shape[1]
    scale = 1.0 / np.sqrt(d)
    ls = -(-sq // STEP) * STEP
    lse_p = np.full(ls, np.inf)
    lse_p[:sq] = lse
    delta_p = np.zeros(ls)
    delta_p[:sq] = (do * o).sum(1)
    qp, dop = _pad(q, -(-sq // 128) * 128), _pad(do, -(-sq // 128) * 128)
    kp, vp = _pad(k, -(-sk // STEP) * STEP), _pad(v, -(-sk // STEP) * STEP)
    dq, dk, dv = np.zeros((sq, d)), np.zeros((sk, d)), np.zeros((sk, d))
    for start, s_lo, s_hi, f_lo, f_hi, _ in plans[0].tolist():
        keys = np.arange(start, start + STEP)
        tk, tv = np.zeros((STEP, d)), np.zeros((STEP, d))
        for j in range(s_lo, s_hi):
            qr = np.arange(j * STEP, (j + 1) * STEP)
            pt = np.exp(kp[keys] @ qp[qr].T * scale - lse_p[qr][None])
            if not f_lo <= j < f_hi:
                ok = _admissible(qr + sk - sq, keys, causal, window).T
                pt = np.where((keys[:, None] >= sk) | (qr[None] >= sq) | ~ok, 0.0, pt)
            dst = pt * (vp[keys] @ dop[qr].T - delta_p[qr][None])
            tv, tk = tv + pt @ dop[qr], tk + dst @ qp[qr] * scale
        real = keys < sk
        dk[keys[real]], dv[keys[real]] = tk[real], tv[real]
    for start, s_lo, s_hi, f_lo, f_hi, _ in plans[1].tolist():
        rows = np.arange(start, start + 128)
        real = rows < sq
        rl, rd = np.zeros(128), np.zeros(128)  # rows past Sq: never read (r < Sq guards)
        rl[real], rd[real] = lse[rows[real]], delta_p[rows[real]]
        acc = np.zeros((128, d))
        for j in range(s_lo, s_hi):
            keys = np.arange(j * STEP, (j + 1) * STEP)
            p = np.exp(qp[rows] @ kp[keys].T * scale - rl[:, None])
            if not f_lo <= j < f_hi:
                ok = _admissible(rows + sk - sq, keys, causal, window)
                p = np.where((keys[None] >= sk) | ~ok, 0.0, p)
            acc += p * (dop[rows] @ vp[keys].T - rd[:, None]) @ kp[keys]
        dq[rows[real]] = acc[real] * scale
    return dq, dk, dv


def _plans(sq, sk, causal, edit=None):
    """The three plans, each edited by ``edit(kind, plan, sq)`` (one of
    ``chip_smoke.py``'s planted faults) when given."""
    out = {kind: flash_attention.tile_plan(kind, sq, sk, causal, 0).copy()
           for kind in ("fwd", "dkdv", "dq")}
    for kind, plan in out.items():
        if edit is not None:
            edit(kind, plan, sq)
    return out


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


@pytest.mark.parametrize("sq,sk,causal", RAGGED)
def test_a_walk_of_the_kernels_schedule_equals_the_plain_versions(smoke, sq, sk, causal):
    """The numpy walk of the kernels' schedule at ragged lengths equals the
    plain versions (f32, ``kernel_f32``); under ``chip_smoke.py``'s planted
    faults the tail mask skipped moves the log-sum-exp where the tail tile
    is partial, the TPU kernel's floored range (the plan before ragged
    lengths) moves the output where a length is ragged, and the last key
    tile's dK/dV dropped zeroes that tile's dK and dV."""
    q, k, v, do = (x[0, 0].double().numpy() for x in k3_inputs(sq, sk, d=32))
    tq, tk, tv, tdo = (torch.from_numpy(x)[None, None] for x in (q, k, v, do))
    want, want_lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=causal)
    wants = ref.flash_attention_bwd_ref(tq, tk, tv, want, want_lse, tdo, causal=causal)
    plans = _plans(sq, sk, causal)
    out, lse = walk_fwd(q, k, v, plans["fwd"], causal)
    np.testing.assert_allclose(out, want[0, 0].numpy(), **TOL["kernel_f32"])
    np.testing.assert_allclose(lse, want_lse[0, 0].numpy(), **TOL["kernel_f32"])
    grads = walk_bwd(q, k, v, out, lse, do, (plans["dkdv"], plans["dq"]), causal)
    for g, w in zip(grads, wants):
        np.testing.assert_allclose(g, w[0, 0].numpy(), **TOL["kernel_f32"])
    _, bad_lse = walk_fwd(q, k, v, _plans(sq, sk, causal, smoke.tail_mask_skipped)["fwd"],
                          causal)
    if sk % STEP:  # the tail tile's zero keys move every row's log-sum-exp
        assert np.abs(bad_lse - want_lse[0, 0].numpy()).max() > 1e-3
    if flash_attention._ragged(sq, sk):
        bad, _ = walk_fwd(q, k, v, _plans(sq, sk, causal, smoke.tpu_range_floored)["fwd"],
                          causal)
        assert np.abs(bad - want[0, 0].numpy()).max() > 1e-2
    dropped = _plans(sq, sk, causal, smoke.last_key_tile_dropped)
    bad = walk_bwd(q, k, v, out, lse, do, (dropped["dkdv"], dropped["dq"]), causal)
    for g, w in zip(bad[1:], wants[1:]):
        last = slice((sk - 1) // STEP * STEP, sk)
        assert np.abs(g[last]).max() == 0 < np.abs(w[0, 0].numpy()[last]).max()


def test_smoke_reads_k3_launches_by_shape(smoke):
    """``chip_smoke.py``'s launch window: K3's launches by (B, Sq, Sk) as
    its wrappers tally them, apart from the per-kernel counts, so a
    cross-attention launched at the encoder's shape shows in the tally
    and not only in the kernel's total."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    before = ops.launch_counts(by_shape=True)
    ops.add_launches({"flash_attention": 3, ("flash_attention", (16, 448, 1500)): 2,
                      ("flash_attention", (16, 1500, 1500)): 1, "masked_accum": 5})
    counts, shapes = smoke.launch_window(before)
    assert counts["flash_attention"] == 3 and counts["masked_accum"] == 5
    assert shapes == {**smoke.k3_shape_launches(16, 448, 1500, 2, 0),
                      **smoke.k3_shape_launches(16, 1500, 1500, 1, 0)}
    assert shapes != {**smoke.k3_shape_launches(16, 448, 1500, 3, 0)}
    ops.reset_launch_counts()
    assert smoke.launch_window(ops.launch_counts(by_shape=True)) == (
        {k: 0 for k in ops.KERNELS}, {})
