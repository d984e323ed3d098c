"""MoE training in the port against the JAX package on the CPU, in f32 (and
bf16 parameters where named), with numpy inputs from a seed:

* each dispatch form (``apply_moe_sort`` in one segment and several,
  ``apply_moe_capacity`` with and without a padding mask,
  ``apply_moe_dense``): its output, aux loss and the gradients of every
  parameter leaf and of x against ``jax.grad`` of the reference's form, at
  ``moe_tiny`` and the mixtral / qwen3-moe smoke widths, with capacity
  drops (cf 0.5) and with router ties (two experts' router columns equal:
  a tie at the k-th place goes to the lower index in both packages);
* ``loss_fn`` (``loss_sum`` and every leaf's gradient, the router's aux
  term included) against ``jax.grad`` of the reference's for ``moe_tiny``
  and the two smoke configs, ``router_aux_weight`` at its default and at
  1.0;
* 10-step DropCompute ``train`` runs against the reference's ``train``:
  drop fractions and the tau trajectory exactly, losses within
  ``TOL["model_f32"]``, final parameters within it (f32 parameters) or each
  leaf's update within ``BF16_UPDATE_REL`` (bf16 parameters: the gradient
  sums in bf16 in both packages, one rounding a kept micro-batch);
* ``make_train_step`` with ``moe_impl``, ``state_dtype`` and
  ``accum_dtype`` against the reference's on ``moe_tiny``, bf16 moments and
  sums;
* the bf16 form of the masked accumulate (K1's plain version) against
  ``jnp.add`` of two bf16 arrays, bit for bit;
* the launcher on the smoke MoE configs;
* ``chip_smoke.py``'s phase 18b helpers: its planted faults move their
  readings, its CPU passes record their routes and control gaps, and
  18c's route record counts the capacity drops.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import InputShape as JShape  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import core, train  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import InputShape, model, moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from test_torch_parity_util import TOL, assert_close, assert_tree_close, tree_np  # noqa: E402

torch.set_num_threads(1)

NAMES = ["moe_tiny", "mixtral_8x22b", "qwen3_moe_235b_a22b"]

#: a 10-step run with bf16 parameters: both packages' parameters are bf16
#: after every step, so an update that lands near a rounding midpoint can
#: round the other way and later steps follow.  Each leaf is held on its
#: update (final - initial parameters): ||du_port - du_ref|| / ||du_ref||
#: within BF16_UPDATE_REL (readings 2.6e-4 to 3.9e-3 on moe_tiny's leaves;
#: an update left out reads 1), a leaf the reference leaves unchanged (the
#: norm scales: 1 - 1e-3 rounds back to 1 in bf16) unchanged, and every
#: element within one bf16 ulp of the leaf's largest magnitude (readings:
#: half of it at most).  The losses read 2.8e-6 apart: ``model_f32``.
BF16_UPDATE_REL = 2e-2


def assert_bf16_updates_close(init, got, want):
    """``got`` and ``want`` (final parameter leaves, f32 arrays of bf16
    values) moved from ``init`` alike, by ``BF16_UPDATE_REL``."""
    for p0, g, w in zip(init, got, want):
        dg, dw = g - p0, w - p0
        ref_norm = np.linalg.norm(dw)
        if ref_norm == 0:
            assert not dg.any()
        else:
            assert np.linalg.norm(dg - dw) / ref_norm <= BF16_UPDATE_REL
        ulp = 2.0 ** (np.floor(np.log2(max(float(np.max(np.abs(w))), 2.0 ** -126))) - 7)
        np.testing.assert_allclose(g, w, rtol=0, atol=ulp)


def configs(name, **kw):
    jc, tc = jget_smoke(name), get_smoke_config(name)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


@pytest.fixture(scope="module", params=NAMES)
def layer(request):
    """One MoE layer's parameters (the reference's init) and x (2, 12, d),
    a cotangent for y, from a seed."""
    jc, tc = configs(request.param)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jc)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, jc.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 12, jc.d_model)).astype(np.float32)
    return jc, tc, {k: np.array(v) for k, v in jp.items()}, x, cot


#: the aux loss's weight in the objectives below (large, so its gradient
#: shows beside the output's)
AUX_W = 3.0


def _jax_form(form, jc, segment, valid):
    def f(p, x):
        if form == "sort":
            y, aux = jmoe.apply_moe_sort(p, x, jc, segment_tokens=segment)
        elif form == "capacity":
            y, aux, _ = jmoe.apply_moe_capacity(p, x, jc, valid=valid)
        else:
            y, aux = jmoe.apply_moe_dense(p, x, jc)
        return y, aux
    return f


def _port_form(form, tc, segment, valid):
    def f(p, x):
        if form == "sort":
            return moe.apply_moe_sort(p, x, tc, segment_tokens=segment)
        if form == "capacity":
            y, aux, _ = moe.apply_moe_capacity(p, x, tc, valid=valid)
            return y, aux
        return moe.apply_moe_dense(p, x, tc)
    return f


def _tied(jp):
    """The router with expert 1's column equal to expert 0's: their
    probabilities tie exactly on every token."""
    jp = dict(jp)
    r = jp["router"].copy()
    r[:, 1] = r[:, 0]
    jp["router"] = r
    return jp


FORMS = [("sort", 1.25, None), ("sort", 0.5, None), ("sort", 0.5, 8),
         ("capacity", 1.25, None), ("capacity", 0.5, None), ("capacity", 0.5, "padded"),
         ("dense", None, None)]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("form,cf,extra", FORMS,
                         ids=["sort-1.25", "sort-0.5", "sort-0.5-segments", "capacity-1.25",
                              "capacity-0.5", "capacity-0.5-padded", "dense"])
def test_dispatch_and_gradients_match_jax_grad(layer, form, cf, extra, ties):
    """y, aux and the gradient of sum(y * cot) + AUX_W * aux for every
    parameter leaf and x, against ``jax.grad`` of the reference's form; at
    cf 0.5 choices are dropped; ``ties``: experts 0 and 1 tie on every
    token, and the k-th place goes to expert 0 in both."""
    jc, tc, jp, x, cot = layer
    if cf is not None:
        jc, tc = (dataclasses.replace(c, capacity_factor=cf) for c in (jc, tc))
    if ties:
        jp = _tied(jp)
    segment = extra if isinstance(extra, int) else moe._SEGMENT_TOKENS
    valid = None
    if extra == "padded":
        valid = np.arange(x.shape[1])[None, :] < np.asarray([7, 12])[:, None]
    jf = _jax_form(form, jc, segment, None if valid is None else jnp.asarray(valid))

    def jloss(p, xx):
        y, aux = jf(p, xx)
        return jnp.sum(y * cot) + AUX_W * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in jp.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    y, aux = _port_form(form, tc, segment, None if valid is None else torch.from_numpy(valid))(
        tp, tx)
    (torch.sum(y * torch.from_numpy(cot)) + AUX_W * aux).backward()
    assert_close(y.detach(), jy, "model_f32")
    assert_close(aux.detach(), jaux, "model_f32")
    assert_close(tx.grad, jgx, "model_f32")
    for k in jp:
        assert_close(tp[k].grad, jgp[k], "model_f32")
    # the ids, and the ties resolved alike
    x2d = x.reshape(-1, jc.d_model)
    _, jids, _ = jmoe._router({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x2d), jc)
    with torch.no_grad():
        probs = torch.softmax(moe.router_logits(tp, torch.from_numpy(x2d)), dim=-1)
        ids = moe.route_ids(probs, tc.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    if ties:
        top = probs.sort(dim=-1, descending=True).values
        assert (top[:, tc.top_k - 1] == top[:, tc.top_k]).any()  # a tie at the k-th place
    if cf == 0.5 and form != "dense":
        t = x2d.shape[0]
        cap = max(int(t * tc.top_k / tc.n_experts * cf), 1)
        assert np.bincount(ids.numpy().ravel(), minlength=tc.n_experts).max() > cap  # drops


def test_route_ids_pin_forward_drops_and_aux(layer):
    """Ids forced through ``route_ids`` reach the capacity drops and the aux
    term alike: pinned to another router's ids, the capacity form's
    overflow is those ids' per-expert excess and its aux is ``routed``'s
    of its own probabilities at them."""
    jc, tc, jp, x, _ = layer
    tc = dataclasses.replace(tc, capacity_factor=0.5)
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    x2d = torch.from_numpy(x).reshape(-1, jc.d_model)
    probs = torch.softmax(moe.router_logits(tp, x2d), dim=-1)
    other = torch.softmax(moe.router_logits({"router": torch.flip(tp["router"], (1,))}, x2d),
                          dim=-1)
    pinned = moe.route_ids(other, tc.top_k)
    assert not torch.equal(pinned, moe.route_ids(probs, tc.top_k))
    sound = moe.route_ids
    moe.route_ids = lambda p, k: pinned
    try:
        _, aux, ovf = moe.apply_moe_capacity(tp, torch.from_numpy(x), tc)
    finally:
        moe.route_ids = sound
    assert torch.equal(aux, moe.routed(probs, pinned, tc)[1])
    counts = np.bincount(pinned.numpy().ravel(), minlength=tc.n_experts)
    cap = moe.capacity(tc, x2d.shape[0])
    assert int(ovf) == int(np.maximum(counts - cap, 0).sum()) > 0


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aux_weight", [0.01, 1.0], ids=["aux-default", "aux-1"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_grad_leaf_match_jax_grad(name, aux_weight):
    """``loss_fn``'s (loss_sum, w_sum) and the gradient of every leaf, the
    router's aux term included (``router_aux_weight``), on 2 x 33 tokens
    (past mixtral's smoke window 16) with token weights."""
    jc, tc = configs(name, router_aux_weight=aux_weight)
    jp = jmodel.init_params(jax.random.PRNGKey(1), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(33)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (2, 33)).astype(np.int32),
             "weights": (rng.random((2, 33)) > 0.2).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ls, w), jg = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jc, jb), has_aux=True)(jp)
    grad_fn = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
    g, tls, tw = grad_fn(model.train_params(tp, tc), {k: torch.from_numpy(v)
                                                       for k, v in batch.items()})
    assert_close(tls, ls, "model_f32")
    assert float(tw) == float(w)
    assert_tree_close(g, jg, "model_f32")
    # the aux term is in: without it the loss moves by its weight times aux
    (ls0, _), _ = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, dataclasses.replace(jc, router_aux_weight=0.0), jb),
        has_aux=True)(jp)
    assert abs(float(tls) - float(ls0)) > 1e-3 * aux_weight * float(w)


def test_per_token_losses_return_the_aux_loss():
    jc, tc = configs("moe_tiny")
    jp = jmodel.init_params(jax.random.PRNGKey(2), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    tokens = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 17)).astype(np.int32)
    jce, jw, jaux = jmodel.per_token_losses(jp, jc, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        ce, w, aux = model.per_token_losses(tp, tc, {"tokens": torch.from_numpy(tokens)},
                                            moe_impl="sort")
    assert_close(ce, jce, "model_f32")
    assert_close(w, jw, "model_f32")
    assert_close(aux, jaux, "model_f32")


def test_remat_gradients_equal_without_remat():
    """Remat reruns the router and the dispatch in the backward: the same
    routes, so the same gradients bit for bit."""
    _, tc = configs("mixtral_8x22b")
    params = model.init_params(tc, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, tc.vocab_size, (2, 24)))
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(tc, remat=remat)
        g, _, _ = core.make_grad_fn(lambda p, mb: model.loss_fn(p, c, mb))(
            model.train_params(params, c), {"tokens": tokens})
        grads.append(tree_leaves(g))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------------------
# the masked accumulate's bf16 form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
def test_bf16_masked_accum_is_jnp_add_bit_for_bit(grad_dtype):
    """``masked_accum_ref`` on a bf16 accumulator: the gradient rounded to
    bf16 and added in f32 with one rounding, which is XLA's bf16 add
    (``a + g.astype(a.dtype)``), bit for bit; keep 0 leaves it alone; an f32
    accumulator keeps its f32 sum."""
    rng = np.random.default_rng(7)
    a = (rng.standard_normal(4099) * 3).astype(np.float32)
    g = (rng.standard_normal(4099) * np.exp(rng.uniform(-12, 4, 4099))).astype(np.float32)
    ja, jg = jnp.asarray(a, jnp.bfloat16), jnp.asarray(g).astype(
        jnp.bfloat16 if grad_dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray((ja + jg.astype(jnp.bfloat16)).astype(jnp.float32))
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(grad_dtype)
    got = ref.masked_accum_ref(ta, tg, 1.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(ref.masked_accum_ref(ta, tg, 0.0), ta)
    acc = torch.from_numpy(a)
    np.testing.assert_array_equal(ref.masked_accum_ref(acc, tg, 1.0).numpy(),
                                  a + tg.float().numpy())


def test_accumulator_takes_the_masters_dtype():
    """The trainer's accumulator sums in the master parameters' dtype (the
    reference's ``zeros_like(params)``): bf16 masters, bf16 sums; f32
    masters, f32 sums; ``make_train_step`` sums in f32 unless asked."""
    _, tc = configs("moe_tiny")
    shape = InputShape("t", 8, 4, "train", microbatches=2)
    batch = {"tokens": np.random.default_rng(8).integers(0, tc.vocab_size, (4, 8)),
             "weights": np.ones((4, 8), np.float32)}
    lat = np.ones((2, 2), np.float32)
    for pd, accum, want in (("bfloat16", None, torch.bfloat16), ("float32", None, torch.float32),
                            ("bfloat16", torch.float32, torch.float32)):
        c = dataclasses.replace(tc, param_dtype=pd)
        params = model.init_params(c, seed=0, device="cpu")
        _, step = steps.make_train_step(c, shape, core.DropConfig(enabled=False), 2,
                                        accum_dtype=accum)
        step(params, step.opt.init(params), batch, lat)
        assert {a.dtype for a in step.accumulator.leaves} == {want}
        assert all(p.dtype == c.params_dtype for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# the trainer and the train step
# ---------------------------------------------------------------------------


def _run_configs(pkg, cpkg, data_cls, steps_=10):
    data = data_cls(vocab_size=211, seq_len=16, batch_size=8, seed=2)
    tcfg = pkg.TrainConfig(
        steps=steps_, n_workers=4, microbatches=2, lr=1e-3, seed=3,
        drop=cpkg.DropConfig(enabled=True), auto_threshold=True, calibration_steps=5,
        latency=cpkg.LatencyModel(base=0.45, noise=cpkg.NoiseModel(kind="paper_lognormal")))
    return data, tcfg


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_ten_step_run_matches_reference(param_dtype):
    """``moe_tiny`` (cf 1.25: routes dropped) through both trainers for 10
    steps, tau from Algorithm 2 after 5: the same drop fractions, tau
    trajectory and simulated times; losses within ``model_f32``, final
    parameters within it (f32 parameters) or their updates within
    ``BF16_UPDATE_REL`` (bf16 parameters, bf16 gradient sums in both)."""
    jc, tc = configs("moe_tiny", param_dtype=param_dtype)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    init = [np.asarray(x, np.float32) for x in jax.tree.leaves(jp)]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jdata, jcfg = _run_configs(jtrain, jcore, JData)
    data, cfg = _run_configs(train, core, DataConfig)
    want = jtrain.train(jc, jdata, jcfg, params=jp)
    got = train.train(tc, data, cfg, params=tp, device="cpu")
    assert got.drop_fractions == want.drop_fractions
    assert got.tau_trajectory == want.tau_trajectory
    assert got.sim_times == want.sim_times
    assert len(got.tau_trajectory) == 2 and any(d > 0 for d in got.drop_fractions)
    assert got.tau == want.tau
    assert all(p.dtype == tc.params_dtype for p in tree_leaves(got.params))
    np.testing.assert_allclose(got.losses, want.losses, **TOL["model_f32"])
    got_leaves = [np.asarray(x, np.float32) for x in jax.tree.leaves(tree_np(got.params))]
    want_leaves = [np.asarray(x, np.float32) for x in jax.tree.leaves(want.params)]
    if param_dtype == "float32":
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(g, w, **TOL["model_f32"])
    else:
        assert_bf16_updates_close(init, got_leaves, want_leaves)
        with pytest.raises(AssertionError):  # an update left out fails the check
            assert_bf16_updates_close(init, init, want_leaves)


def test_train_step_options_match_reference():
    """``make_train_step`` with ``moe_impl="sort"``, bf16 AdamW moments and
    bf16 gradient sums (the reference's options for its >100B configs) on
    ``moe_tiny``, one worker (the reference's micro-batch is then the
    port's block, so the same tokens share a dispatch) and 4 micro-batches
    of which the latencies drop the last: 3 steps, losses and parameters
    within ``model_f32``, the moments bf16."""
    jc, tc = configs("moe_tiny")
    jp = jmodel.init_params(jax.random.PRNGKey(4), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jshape = JShape("t", 16, 8, "train", microbatches=4)
    shape = InputShape("t", 16, 8, "train", microbatches=4)
    jdrop, drop = jcore.DropConfig(enabled=True, tau=1.0), core.DropConfig(enabled=True, tau=1.0)
    jopt, jstep = jsteps.make_train_step(jc, jshape, jdrop, 1, lr=1e-3, moe_impl="sort",
                                         state_dtype=jnp.bfloat16, accum_dtype=jnp.bfloat16)
    opt, step = steps.make_train_step(tc, shape, drop, 1, lr=1e-3, moe_impl="sort",
                                      state_dtype=torch.bfloat16, accum_dtype=torch.bfloat16)
    jstate, state = jopt.init(jp), opt.init(tp)
    lat = np.asarray([[0.3, 0.3, 0.3, 0.3]], np.float32)  # the 4th crosses tau: dropped
    rng = np.random.default_rng(9)
    jstep = jax.jit(jstep)
    for _ in range(3):
        batch = {"tokens": rng.integers(0, jc.vocab_size, (8, 16)).astype(np.int32),
                 "weights": np.ones((8, 16), np.float32)}
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(lat))
        _, state, m = step(tp, state, batch, lat)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL["model_f32"])
        assert float(m["completed_fraction"]) == float(jm["completed_fraction"]) == 0.75
    assert {a.dtype for a in step.accumulator.leaves} == {torch.bfloat16}
    assert {x.dtype for x in tree_leaves(state["m"]) + tree_leaves(state["v"])} == {
        torch.bfloat16}
    assert_tree_close(tp, jax.tree.map(lambda x: np.asarray(x, np.float32), jp), "model_f32")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_launcher_trains_the_moe_models(capsys, arch):
    """The smoke MoE configs train on the CPU; without ``--device cpu`` the
    smoke config (head dim 32, f32) is refused at parsing, before any
    work."""
    assert launch_train.main(["--arch", arch, "--steps", "3", "--seq", "32", "--batch", "8",
                              "--workers", "2", "--microbatches", "2", "--drop-compute",
                              "--tau", "0.6", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "family=moe" in out and "[train] loss" in out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", arch, "--steps", "1"])
    assert "head dim 32" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 18b helpers, on the CPU
# ---------------------------------------------------------------------------


def load_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_moe_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_layer():
    _, tc = configs("mixtral_8x22b", n_layers=1, remat=True)
    return tc, model.init_params(tc, seed=0, device="cpu")


@pytest.mark.parametrize("fault", ["routing_weights_detached", "aux_dropped"])
def test_smoke_parity_faults_move_their_reading(fault):
    """18b's planted faults at the smoke widths: with the aux term dropped
    the loss's aux part reads 0 and its CE part is unchanged; with the
    routing weights detached the router's gradient is the aux term's alone
    (over the limit), the loss unchanged."""
    smoke = load_smoke()
    tc, params = smoke_layer()
    tokens = smoke.moe_parity_tokens(tc, 0)
    routes = []
    (ls, ce, aux), g = smoke.moe_parity_run(params, tc, "cpu", tokens, routes)
    (bls, bce, baux), bg = smoke.moe_parity_run(params, tc, "cpu", tokens, [], routes,
                                                getattr(smoke, fault))
    assert len(routes) == 2  # the forward's call and the remat backward's
    router = "/stack/groups/0/moe/router"
    gap = smoke.leaf_rel_errs({router: bg[router]}, {router: g[router]}, "cpu")[router]
    if fault == "aux_dropped":
        assert baux == 0.0 and aux > 0 and abs(bce - ce) <= 1e-6 * abs(ce)
        assert gap < smoke.PARITY_LEAF_REL_TOL  # the router alone would not show it
    else:
        assert bls == ls and gap > smoke.PARITY_LEAF_REL_TOL


def test_smoke_cpu_passes_and_route_records():
    """18b's CPU passes (``run_cpu_passes``, run here in this process on
    the CPU; on the card a spawned one) draw the weights from the seed and
    put one result a model: one router call a run (no remat on the CPU), a
    control gap for every leaf; a failure comes back as its traceback,
    which ``cpu_pass_result`` raises.  18c's route record
    (``routes_recorded``) keeps every call's ids, and ``sort_drops`` counts
    the choices past capacity."""
    import queue
    import threading

    smoke = load_smoke()
    tc, params = smoke_layer()
    tc = dataclasses.replace(tc, capacity_factor=0.5)
    out, done, threads = queue.Queue(), threading.Event(), torch.get_num_threads()
    done.set()

    class Alive:
        exitcode = None

        def is_alive(self):
            return True

    try:
        smoke.run_cpu_passes([("a", tc, 0)], out, done, device="cpu")
        smoke.run_cpu_passes([("b", None, 0)], out, done, device="cpu")  # fails: no config
    finally:
        torch.set_num_threads(threads)
    name, res = smoke.cpu_pass_result(Alive(), out)
    assert name == "a" and len(res["routes"]) == 1 and set(res["control"]) == set(res["grads"])
    want = model.init_params(tc, seed=0, device="cpu")
    assert res["loss"][0] == pytest.approx(smoke.moe_parity_run(want, dataclasses.replace(
        tc, remat=False), "cpu", smoke.moe_parity_tokens(tc, 0), [])[0][0], rel=1e-5)
    with pytest.raises(smoke.SmokeFailure, match="the CPU passes failed"):
        smoke.cpu_pass_result(Alive(), out)
    rec = []
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, tc.vocab_size, (1, 40)))
    with smoke.routes_recorded(rec):
        for _ in range(5):
            model.loss_fn(params, tc, {"tokens": tokens})
    assert len(rec) == 5
    ids = rec[0]
    cap = max(int(40 * tc.top_k / tc.n_experts * tc.capacity_factor), 1)
    want = int(np.maximum(np.bincount(ids.numpy().ravel(), minlength=tc.n_experts) - cap, 0).sum())
    assert smoke.sort_drops(tc, rec[:1]) == [want] and want > 0


@pytest.mark.parametrize("name,seq", [("mixtral_8x22b", 8192), ("qwen3_moe_235b_a22b", 4096),
                                      ("internlm2_1_8b", 2048), ("starcoder2_7b", 2048),
                                      ("gemma3_27b", 2048)])
def test_training_kernels_take_the_published_models(name, seq):
    """On the card ``require_trainable`` admits the MoE models and the dense
    zoo at their published widths: K3 is held at (128, 6), (128, 16),
    (128, 2) and (128, 9) beside its earlier three pairs and internvl2-1b's
    (64, 7)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention

    cfg = get_config(name)
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) in flash_attention.TRAINED
    assert len(flash_attention.TRAINED) == 8
    model.require_trainable(cfg, seq, torch.device("cuda"))
