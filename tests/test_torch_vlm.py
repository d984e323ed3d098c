"""The VLM family in the port (internvl2-1b), against the JAX package on the
CPU in f32, at its smoke config (2 layers, d 128, 4 heads over 2, a patch
prefix of 8 rows):

* the configs field for field, ``param_count``, and ``ARCHITECTURES`` the
  reference's list in its order;
* the parameter tree's paths and shapes (the smoke config, and the
  published one from the meta device against JAX's abstract tree), and
  ``params_from_jax`` bit for bit;
* ``forward`` and ``loss_fn`` with the prefix placed before the text
  (RoPE positions over both, the prefix rows stripped after the final
  norm), and every leaf of ``jax.grad``, with and without remat; a batch
  without ``prefix`` raises as the reference's does;
* ``make_prefill_step``'s next tokens with the prefix;
* the serving engine text-only (dense and paged, chunked and packed): its
  greedy streams, step counts and schedule equal to the reference's;
* 3 ``make_train_step`` steps with ``prefix`` in the batch (kept in its own
  dtype and cut into (W·M, mbw, P, d) blocks): drop masks exactly, losses
  and final parameters within ``model_f32``;
* ``require_trainable``'s convention (``seq_len`` counts the prefix rows)
  and the (64, 7) builds it admits on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import InputShape as JShape  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import UnbuiltShapeError  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import InputShape, model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request  # noqa: E402
from test_torch_parity_util import TOL, assert_close, assert_tree_close  # noqa: E402

torch.set_num_threads(1)

NAME = "internvl2_1b"
#: text tokens a sequence in these tests (after the smoke config's 8 prefix rows)
TEXT = 12


def configs(**kw):
    return (dataclasses.replace(jget_smoke(NAME), **kw),
            dataclasses.replace(get_smoke_config(NAME), **kw))


def make_batch(cfg, rng, b: int = 2, text: int = TEXT) -> dict:
    """Seeded numpy inputs: text tokens, loss weights, the patch prefix."""
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(np.int32),
            "weights": (rng.random((b, text)) > 0.2).astype(np.float32),
            "prefix": rng.normal(size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs()
    jp = jax.jit(jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(4), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp, make_batch(jc, np.random.default_rng(40))


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
    for port, jref in ((get_config(NAME), jget_config(NAME)),
                       (get_smoke_config(NAME), jget_smoke(NAME))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jref)
        assert port.param_count() == jref.param_count()
    full = get_config(NAME)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.hd,
            full.prefix_len, full.vocab_size) == (24, 896, 14, 2, 64, 256, 151_655)
    assert round(full.param_count() / 1e9, 3) == 0.494


def test_architectures_are_the_reference_list():
    """Every architecture of the reference's registry is ported, in its
    order (internvl2-1b after mixtral-8x22b)."""
    assert ARCHITECTURES == JARCH
    assert ARCHITECTURES.index(NAME) == ARCHITECTURES.index("mixtral_8x22b") + 1


def test_parameter_trees_equal_the_reference(setup):
    _, tc, jp, _, _ = setup
    assert _paths(model.init_params(tc, seed=0, device="cpu")) == _paths(jp)
    full = _paths(model.init_params(get_config(NAME), device="meta"))
    abstract = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                         jget_config(NAME)))
    assert full == _paths(abstract)


def test_params_from_jax_is_exact(setup):
    _, _, jp, tp, _ = setup
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tree_leaves(tp))
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert torch.equal(node, torch.from_numpy(np.asarray(leaf))), path


# ---------------------------------------------------------------------------
# the forward with the prefix, the loss and its gradient
# ---------------------------------------------------------------------------


def test_forward_and_loss(setup):
    """Logits of the text rows alone (the prefix stripped) and the loss
    sums equal the reference's."""
    jc, tc, jp, tp, batch = setup
    (jl, jaux), (ls, w) = jax.jit(lambda p, b: (jmodel.forward(p, jc, b),
                                                 jmodel.loss_fn(p, jc, b)))(jp, jbatch(batch))
    with torch.no_grad():
        tl, taux = model.forward(tp, tc, tbatch(batch))
        tls, tw = model.loss_fn(tp, tc, tbatch(batch))
    assert tl.shape == (2, TEXT, tc.vocab_size)
    assert_close(tl, jl, "model_f32")
    assert float(taux) == float(jaux) == 0.0
    assert_close(tls, ls, "model_f32")
    assert float(tw) == float(w)


def test_the_prefix_reaches_every_text_row(setup):
    """Another prefix moves the first text row's logits (the text attends
    the prefix rows before it); the same prefix cast from bf16 or f32 gives
    the compute dtype's values."""
    _, tc, _, tp, batch = setup
    other = dict(batch, prefix=batch["prefix"][:, ::-1].copy())
    with torch.no_grad():
        a, _ = model.forward(tp, tc, tbatch(batch))
        b, _ = model.forward(tp, tc, tbatch(other))
        half = dict(tbatch(batch), prefix=torch.from_numpy(batch["prefix"]).to(torch.bfloat16))
        c, _ = model.forward(tp, tc, half)
        d, _ = model.forward(tp, tc, dict(half, prefix=half["prefix"].float()))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
    assert torch.equal(c, d)


def test_a_batch_without_prefix_raises(setup):
    """A VLM batch must carry its prefix: the reference's forward raises
    ``KeyError`` without one, and so does the port's."""
    jc, tc, jp, tp, batch = setup
    text = {k: v for k, v in batch.items() if k != "prefix"}
    with pytest.raises(KeyError, match="prefix"):
        jmodel.forward(jp, jc, jbatch(text))
    with pytest.raises(KeyError, match="prefix"):
        model.forward(tp, tc, tbatch(text))


@pytest.mark.parametrize("remat", [False, True])
def test_every_grad_leaf(setup, remat):
    """``loss_fn``'s gradient of every leaf with the prefix against
    ``jax.value_and_grad`` of the reference's, with and without remat."""
    jc, tc, jp, tp, batch = setup
    jc, tc = dataclasses.replace(jc, remat=remat), dataclasses.replace(tc, remat=remat)
    (ls, w), jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(p, jc, jbatch(batch)),
                                             has_aux=True))(jp)
    grad_fn = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
    g, tls, tw = grad_fn(model.train_params(tp, tc), tbatch(batch))
    assert_close(tls, ls, "model_f32")
    assert float(tw) == float(w)
    assert_tree_close(g, jg, "model_f32")


def test_prefill_step_tokens(setup):
    """``make_prefill_step`` with the prefix: the reference's next tokens
    (the text's last position), on 4 sequences."""
    jc, tc, jp, tp, _ = setup
    batch = make_batch(jc, np.random.default_rng(41), b=4)
    batch.pop("weights")
    want = jax.jit(jsteps.make_prefill_step(jc))(jp, jbatch(batch))
    with torch.no_grad():
        got = steps.make_prefill_step(tc)(tp, tbatch(batch))
    assert got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# serving: text-only, as the reference's engine serves a VLM
# ---------------------------------------------------------------------------

SCHED_FIELDS = ("step", "decode_tokens", "prefill_tokens", "deferred_tokens",
                "shared_tokens", "used_pages", "queued_requests", "budget_overshoot")


def run(batcher, request, params, cfg, prs, **kw):
    eng = batcher(params, cfg, batch_slots=2, max_len=40, chunk_size=4, **kw)
    for i, p in enumerate(prs):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=6))
    eng.run()
    return eng


@pytest.mark.parametrize("packed", [False, True], ids=["dense_step", "packed_step"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_streams_equal_the_reference(setup, cache, packed):
    """5 requests of 3-21 tokens through 2 slots, text-only: greedy streams,
    step counts and every step's schedule equal to the reference engine's;
    the paged engine leaks no page."""
    jc, tc, jp, tp, _ = setup
    rng = np.random.default_rng(42)
    prs = [rng.integers(0, jc.vocab_size, size=k).tolist() for k in (21, 3, 14, 9, 5)]
    kw = dict(cache=cache, packed=packed, token_budget=5, page_size=4)
    je = run(JBatcher, JRequest, jp, jc, prs, **kw)
    te = run(ContinuousBatcher, Request, tp, tc, prs, **kw)
    assert {u: r.output for u, r in je.finished.items()} == {
        u: r.output for u, r in te.finished.items()}
    assert je.steps == te.steps
    for a, b in zip(je.step_stats, te.step_stats):
        assert [getattr(a, f) for f in SCHED_FIELDS] == [getattr(b, f) for f in SCHED_FIELDS]
    assert all(len(r.output) == 6 for r in te.finished.values())
    if cache == "paged":
        te.kv.check_invariants()
        assert te.kv.used_pages == 0


# ---------------------------------------------------------------------------
# training: the DropCompute step with the prefix in the batch
# ---------------------------------------------------------------------------


def test_train_step_keeps_the_prefix_blocks():
    """``TrainStep._blocks`` cuts ``prefix`` with the tokens, (W·M, mbw, P,
    d), in its own dtype (bf16 stays bf16), rows ``(w·M + j)·mbw`` on."""
    _, tc = configs()
    _, step = steps.make_train_step(tc, InputShape("t", TEXT, 16, "train", microbatches=2),
                                    core.DropConfig(enabled=False), 2)
    batch = tbatch(make_batch(tc, np.random.default_rng(43), b=16))
    batch["prefix"] = batch["prefix"].to(torch.bfloat16)
    got = step._blocks(batch, torch.device("cpu"))
    assert got["prefix"].dtype == torch.bfloat16
    assert got["prefix"].shape == (4, 4, tc.prefix_len, tc.d_model)
    assert torch.equal(got["prefix"][3], batch["prefix"][12:16])
    assert got["tokens"].dtype == torch.long and got["weights"].dtype == torch.float32


def test_train_step_with_prefix_matches_the_reference():
    """``make_train_step`` on 2 workers x 2 micro-batches with ``prefix`` in
    the batch: 3 steps whose latencies drop one micro-batch, then none,
    then two; the completed fractions exactly, losses and final parameters
    to ``model_f32``."""
    jc, tc = configs()
    jp = jax.jit(jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(7), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    seq = jc.prefix_len + TEXT  # the attention length, as InputShape counts it
    jshape = JShape("t", seq, 8, "train", microbatches=2)
    shape = InputShape("t", seq, 8, "train", microbatches=2)
    jdrop, drop = jcore.DropConfig(enabled=True, tau=1.0), core.DropConfig(enabled=True, tau=1.0)
    jopt, jstep = jsteps.make_train_step(jc, jshape, jdrop, 2, lr=1e-3)
    opt, step = steps.make_train_step(tc, shape, drop, 2, lr=1e-3)
    jstate, state = jopt.init(jp), opt.init(tp)
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(44)
    lats = ([[0.3, 0.3], [0.3, 0.8]], [[0.3, 0.3], [0.3, 0.3]], [[0.3, 0.8], [0.3, 0.8]])
    fractions = []
    for lat in lats:
        lat = np.asarray(lat, np.float32)
        batch = make_batch(jc, rng, b=8)
        jp, jstate, jm = jstep(jp, jstate, jbatch(batch), jnp.asarray(lat))
        _, state, m = step(tp, state, batch, lat)
        assert float(m["completed_fraction"]) == float(jm["completed_fraction"])
        fractions.append(float(m["completed_fraction"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL["model_f32"])
    assert fractions == [0.75, 1.0, 0.5]
    assert_tree_close(tp, jax.tree.map(lambda x: np.asarray(x, np.float32), jp), "model_f32")


# ---------------------------------------------------------------------------
# the card's shapes
# ---------------------------------------------------------------------------


def test_require_trainable_counts_the_prefix():
    """``seq_len`` is the attention length, prefix rows and text, as the
    reference's ``InputShape.seq_len``: internvl2-1b at 2,048 (256 + 1,792)
    and at ragged prefill lengths passes on the card (K3 (64, 7)); a
    ``seq_len`` that leaves fewer than two text tokens raises
    ``ValueError``; the f32 smoke config is refused on the card (head dim
    32) and admitted on the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    full = get_config(NAME)
    assert (64, 7) in flash_attention.TRAINED and (64, 7) in flash_attention.SERVED
    for seq in (2048, 256 + 333, 256 + 2):
        model.require_trainable(full, seq, cuda)
    for seq in (256, 257):
        with pytest.raises(ValueError, match="counts the 256 prefix rows"):
            model.require_trainable(full, seq, cuda)
    with pytest.raises(UnbuiltShapeError, match="head dim 32 and group H/KV = 2"):
        model.require_trainable(get_smoke_config(NAME), 20, cuda)
    model.require_trainable(get_smoke_config(NAME), 20, cpu)


def test_the_paged_instance_of_the_published_config():
    """internvl2-1b's serving takes K4's (64, 7) instance: (128, 8)'s cut
    (tiles of 8 tokens, two a warp, 64-key stages) at four CTAs an SM."""
    full = get_config(NAME)
    inst = flash_attention.instance(full.hd, full.n_heads // full.n_kv_heads)
    assert inst == (8, 2, 64, 4)
    assert flash_attention.tile_tokens(64, 7) == 8


def test_smoke_cpu_passes_and_planted_prefix_faults():
    """``chip_smoke.py``'s phase 20 helpers on the CPU at the smoke config:
    its CPU passes (``run_cpu_passes``; on the card a spawned process)
    give the prefill logits and the loss of the weights drawn from the
    seed, with a bf16 control gap for every leaf (``train_parity_job``, as
    13b's text-only job too); its two planted prefix faults
    (``PREFIX_FAULTS``, as ``train_parity`` runs them) move the logits past
    the row limit: the strip off by one row gives the sound rows one
    position late, the prefix dropped other rows, and both move gradient
    leaves past the leaf limit."""
    import queue
    import threading

    from test_torch_parity_util import load_smoke

    smoke = load_smoke()
    _, tc = configs()
    ctl = dataclasses.replace(tc, dtype="bfloat16")  # the card's compute dtype
    text = dataclasses.replace(ctl, prefix_len=0)  # 13b's job: a text-only model
    tokens = torch.from_numpy(np.random.default_rng(45).integers(0, tc.vocab_size, (2, 20)))
    batch = smoke.vlm_parity_batch(tc, 0)
    out, done, threads = queue.Queue(), threading.Event(), torch.get_num_threads()
    done.set()
    try:
        smoke.run_cpu_passes([("p", tc, 0, smoke.vlm_prefill_cpu),
                              smoke.train_parity_job("t", ctl, 0, batch, tc.n_layers),
                              smoke.train_parity_job("r", text, 0, {"tokens": tokens},
                                                     text.n_layers)],
                             out, done, device="cpu")
    finally:
        torch.set_num_threads(threads)
    got = dict(out.get(timeout=5) for _ in range(3))
    params = model.init_params(tc, seed=0, device="cpu")
    with torch.no_grad():
        sound = model.forward(params, tc, batch)[0]
    assert got["p"]["want"].shape == (smoke.V_PARITY_SEQS, smoke.V_PARITY_TEXT, tc.vocab_size)
    torch.testing.assert_close(got["p"]["want"], sound)  # another thread count there
    for name in ("t", "r"):
        assert set(got[name]["control"]) == set(got[name]["grads"])
        assert all(0 < e < smoke.PARITY_LEAF_REL_TOL for e in got[name]["control"].values())
    assert set(smoke.PREFIX_FAULTS) == {"prefix dropped", "strip off by one row"}
    with torch.no_grad():
        with smoke.prefix_strip_off_by_one(tc, batch) as (c, b):
            late = model.forward(params, c, b)[0]
        with smoke.prefix_dropped(tc, batch) as (c, b):
            dropped = model.forward(params, c, b)[0]
    torch.testing.assert_close(late[:, 1:], sound[:, :-1])
    for bad in (late, dropped):
        assert smoke.row_rel_err(bad, sound) > smoke.LOGITS_ROW_TOL
    loss, grads = smoke.train_parity_run(params, tc, "cpu", batch)
    assert loss == pytest.approx(got["t"]["loss"], rel=1e-5)
    for fault in smoke.PREFIX_FAULTS.values():
        with fault(tc, batch) as (c, b):
            bad_g = smoke.train_parity_run(params, c, "cpu", b)[1]
        errs = smoke.leaf_rel_errs(bad_g, grads, "cpu")
        assert max(errs.values()) > smoke.PARITY_LEAF_REL_TOL
