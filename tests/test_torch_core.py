"""The port's DropCompute core, data, optimizers and resilience carry-overs
against the JAX package on the CPU.

Exact where the reference is exact: drop masks (over many seeds, with tau
placed on a worker's running sum), completed fractions, latency draws,
theory values, Algorithm 2's tau*, synthetic batches and the online
controller's decisions.  Allclose (``TOL["model_f32"]``) where floats are
summed in another order: Algorithm 1's accumulated gradients under both
normalisations and five steps of each optimizer.  Inputs are made with
numpy from a seed and fed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import resilience as jres  # noqa: E402
from repro_torch import core, optim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.train import resilience  # noqa: E402
from test_torch_parity_util import assert_close, assert_tree_close  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# drop masks
# ---------------------------------------------------------------------------


class TestDropMask:
    @pytest.mark.parametrize("m", [2, 4, 7, 33, 64])
    def test_equal_to_reference_over_seeds(self, m):
        """Taus on the f32 running sum of a random worker (exactly at it,
        and one f32 ulp either side): a sum taken in another order would
        flip the micro-batch sitting there."""
        flips = 0
        for seed in range(40):
            rng = np.random.default_rng(seed * 100 + m)
            t = rng.lognormal(-1.0, 0.6, size=(8, m))
            run = np.cumsum(t.astype(np.float32), axis=-1, dtype=np.float32)
            at = float(run[rng.integers(8), rng.integers(m)])
            for tau in (at, float(np.nextafter(np.float32(at), np.float32(np.inf))),
                        float(np.nextafter(np.float32(at), np.float32(0))),
                        float(rng.uniform(0, t.sum(-1).max()))):
                for mmb in (0, 1, 3):
                    want = np.asarray(jcore.drop_mask(jnp.asarray(t), tau, mmb))
                    got = core.drop_mask(t, tau, mmb).numpy()
                    np.testing.assert_array_equal(got, want)
                    flips += int((got != 1.0).any())
        assert flips > 0  # the taus do drop micro-batches

    def test_tensor_input_and_completed_fraction(self):
        t = np.random.default_rng(3).lognormal(size=(4, 5))
        got = core.drop_mask(torch.from_numpy(t), 1.5)
        want = jcore.drop_mask(jnp.asarray(t), 1.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(core.completed_fraction(got)) == float(jcore.completed_fraction(want))

    def test_example_weights_and_weighted_loss(self):
        rng = np.random.default_rng(5)
        mask = (rng.random((3, 4)) > 0.3).astype(np.float32)
        ex = core.example_weights(torch.from_numpy(mask), 8, 2)
        jex = jcore.example_weights(jnp.asarray(mask), 8, 2)
        np.testing.assert_array_equal(ex.numpy(), np.asarray(jex))
        losses = rng.random((24, 6)).astype(np.float32)
        tw = (rng.random((24, 6)) > 0.2).astype(np.float32)
        for norm in ("computed", "nominal"):
            cfg = core.DropConfig(normalize=norm)
            got = core.weighted_loss(torch.from_numpy(losses), torch.from_numpy(tw), ex, cfg)
            want = jcore.weighted_loss(jnp.asarray(losses), jnp.asarray(tw), jex,
                                       jcore.DropConfig(normalize=norm))
            for g, w in zip(got, want):
                assert_close(g, w, "kernel_f32")


# ---------------------------------------------------------------------------
# Algorithm 1 and the engines, on the qwen smoke model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    jc, tc = jget_smoke("qwen2_5_3b"), get_smoke_config("qwen2_5_3b")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    data = jsyn.DataConfig(vocab_size=jc.vocab_size, seq_len=16, batch_size=4, seed=1)
    mbs = jsyn.microbatches_at(0, data, 4)  # 4 micro-batches of one sequence
    return jc, tc, jp, tp, mbs


def _both_accumulate(smoke, mask, normalize):
    jc, tc, jp, tp, mbs = smoke
    jgrad = jcore.make_grad_fn(lambda p, mb: jmodel.loss_fn(p, jc, mb))
    want = jcore.accumulate_grads(jgrad, jp, {k: jnp.asarray(v) for k, v in mbs.items()},
                                  jnp.asarray(mask), jcore.DropConfig(normalize=normalize))
    grad = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
    got = core.accumulate_grads(grad, tp, {k: torch.from_numpy(v) for k, v in mbs.items()},
                                mask, core.DropConfig(normalize=normalize))
    return want, got


class TestAccumulateGrads:
    @pytest.mark.parametrize("normalize", ["computed", "nominal"])
    @pytest.mark.parametrize("mask", [(1, 0, 1, 0), (1, 1, 1, 1), (0, 0, 0, 0)])
    def test_matches_reference(self, smoke, normalize, mask):
        mask = np.asarray(mask, np.float32)
        (jg, jl, js), (g, l, s) = _both_accumulate(smoke, mask, normalize)
        assert_tree_close(g, jg, "model_f32")
        assert_close(l, jl, "model_f32")
        for key in ("completed_microbatches", "completed_fraction", "computed_weight",
                    "grad_denom"):
            assert_close(s[key], js[key], "model_f32")

    def test_dropped_microbatches_are_never_computed(self, smoke):
        calls = []
        tc, tp, mbs = smoke[1], smoke[3], smoke[4]
        base = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))

        def counting(p, mb):
            calls.append(1)
            return base(p, mb)

        core.accumulate_grads(counting, tp, {k: torch.from_numpy(v) for k, v in mbs.items()},
                              [1, 0, 0, 1], core.DropConfig())
        assert len(calls) == 2

    def test_in_graph_engine_matches_reference(self, smoke):
        jc, tc, jp, tp, mbs = smoke
        lat = np.asarray([0.4, 0.3, 0.5, 0.2])
        cfg = dict(tau=0.8, normalize="computed")
        jeng = jcore.InGraphEngine(jcore.make_grad_fn(lambda p, mb: jmodel.loss_fn(p, jc, mb)),
                                   jcore.DropConfig(**cfg))
        eng = core.InGraphEngine(core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb)),
                                 core.DropConfig(**cfg))
        jg, jl, js = jeng.step(jp, {k: jnp.asarray(v) for k, v in mbs.items()}, lat)
        g, l, s = eng.step(tp, {k: torch.from_numpy(v) for k, v in mbs.items()}, lat)
        assert float(s["completed_fraction"]) == float(js["completed_fraction"]) == 0.5
        assert_tree_close(g, jg, "model_f32")
        assert_close(l, jl, "model_f32")

    def test_host_timed_engine_without_a_threshold_keeps_all(self, smoke):
        tc, tp, mbs = smoke[1], smoke[3], smoke[4]
        grad = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
        eng = core.HostTimedEngine(grad, core.DropConfig(tau=float("inf")))
        tmbs = {k: torch.from_numpy(v) for k, v in mbs.items()}
        g, l, s = eng.step(tp, tmbs)
        want, wl, _ = core.accumulate_grads(grad, tp, tmbs, [1, 1, 1, 1], core.DropConfig())
        assert s["completed_fraction"] == 1.0
        for a, b in zip(tree_leaves(g), tree_leaves(want)):
            assert torch.equal(a, b)
        assert eng.profile().shape == (1, 1, 4)

    def test_host_timed_engine_drops_past_tau(self, smoke):
        tc, tp, mbs = smoke[1], smoke[3], smoke[4]
        grad = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
        eng = core.HostTimedEngine(grad, core.DropConfig(tau=0.0, min_microbatches=1))
        _, _, s = eng.step(tp, {k: torch.from_numpy(v) for k, v in mbs.items()})
        assert s["completed_microbatches"] == 1.0  # min_microbatches, then tau ends it


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adamw", {"weight_decay": 0.1}),
                                     ("sgd", {}), ("lamb", {}), ("lans", {})])
def test_optimizer_five_steps(name, kw):
    """Parameters after 5 steps, from the same numpy gradients, through
    the reference's ``update`` + ``apply_updates`` and the port's
    ``update`` + ``apply_updates`` and in-place ``step``."""
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "b": (5,), "s": (3, 4, 2)}
    p0 = _tree(rng, shapes)
    grads = [_tree(rng, shapes) for _ in range(5)]
    jopt = joptim.make(name, 1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    opt_a, opt_b = optim.make(name, 1e-2, **kw), optim.make(name, 1e-2, **kw)
    pa = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pb = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sa, sb = opt_a.init(pa), opt_b.init(pb)
    for g in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = joptim.apply_updates(jp, upd)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        upd_t, sa = opt_a.update(tg, sa, pa)
        pa = optim.apply_updates(pa, upd_t)
        sb = opt_b.step({k: v.clone() for k, v in tg.items()}, sb, pb)
    for k in shapes:
        assert_close(pa[k], jp[k], "model_f32")
        assert_close(pb[k], jp[k], "model_f32")


def test_adamw_step_slices_large_leaves(monkeypatch):
    """``step`` updates an elementwise optimizer's big leaves slice by slice:
    the same numbers as the whole-leaf update."""
    monkeypatch.setattr(optim.optimizers, "_SLICE", 7)
    rng = np.random.default_rng(2)
    p0 = {"w": rng.normal(size=(9, 5)).astype(np.float32)}
    g = {"w": torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))}
    opt = optim.adamw(1e-2)
    pa, pb = ({"w": torch.from_numpy(p0["w"].copy())} for _ in range(2))
    sa, sb = opt.init(pa), opt.init(pb)
    upd, sa = opt.update(g, sa, pa)
    opt.step(g, sb, pb)
    assert torch.equal(optim.apply_updates(pa, upd)["w"], pb["w"])
    assert torch.equal(sa["m"]["w"], sb["m"]["w"])


def test_clip_and_global_norm():
    rng = np.random.default_rng(3)
    g = _tree(rng, {"a": (4, 3), "b": (7,)})
    want = joptim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 0.5)
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    assert_close(optim.global_norm(tg), joptim.global_norm({k: jnp.asarray(v) for k, v in
                                                            g.items()}), "kernel_f32")
    got = optim.clip_by_global_norm(tg, 0.5)
    for k in g:
        assert_close(got[k], want[k], "kernel_f32")


@pytest.mark.parametrize("sched", ["warmup_linear", "warmup_cosine"])
def test_schedules(sched):
    jf, tf = getattr(joptim, sched)(1e-3, 10, 100, 1e-5), getattr(optim, sched)(1e-3, 10, 100, 1e-5)
    for step in (0, 3, 10, 55, 100, 130):
        assert tf(step) == float(jf(step))
    assert optim.constant(3e-4)(5) == float(joptim.constant(3e-4)(5))


# ---------------------------------------------------------------------------
# numpy carry-overs: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["paper_lognormal", "exponential", "normal", "none"])
def test_latency_draws_identical(kind):
    jm = jcore.LatencyModel(base=0.45, noise=jcore.NoiseModel(kind=kind))
    tm = core.LatencyModel(base=0.45, noise=core.NoiseModel(kind=kind))
    for step in (0, 3, 17):
        np.testing.assert_array_equal(tm.sample_at(step, 8, 4, seed=1),
                                      jm.sample_at(step, 8, 4, seed=1))
    js, ts = jcore.simulate(jm, 30, 16, 8, seed=2), core.simulate(tm, 30, 16, 8, seed=2)
    np.testing.assert_array_equal(ts.t, js.t)
    assert ts.effective_speedup(2.0) == js.effective_speedup(2.0)


def test_threshold_and_theory_identical():
    prof = jcore.simulate(jcore.LatencyModel(base=0.45), 40, 16, 8, seed=4).t
    want, got = jcore.select_threshold(prof, 0.5), core.select_threshold(prof, 0.5)
    assert got.tau == want.tau and got.speedup == want.speedup
    assert core.optimal_tau(0.45, 0.1, 8, 64, 0.5) == jcore.optimal_tau(0.45, 0.1, 8, 64, 0.5)
    assert core.effective_speedup(3.0, 0.45, 0.1, 8, 64, 0.5) == \
        jcore.effective_speedup(3.0, 0.45, 0.1, 8, 64, 0.5)
    assert core.expected_max_normal(1.0, 0.2, 100) == jcore.expected_max_normal(1.0, 0.2, 100)


@pytest.mark.parametrize("strategy", ["pack", "pad"])
def test_synthetic_batches_byte_identical(strategy):
    kw = dict(vocab_size=1000, seq_len=64, batch_size=8, strategy=strategy, seed=3)
    jd, td = jsyn.DataConfig(**kw), synthetic.DataConfig(**kw)
    for step in (0, 5):
        want, got = jsyn.batch_at(step, jd), synthetic.batch_at(step, td)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
        want, got = jsyn.microbatches_at(step, jd, 4), synthetic.microbatches_at(step, td, 4)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()


def test_controller_decisions_identical_on_pareto():
    """The online controller on the pareto scenario: every decision (tau,
    applied, reason) the same in both packages."""
    steps, n, m = 80, 16, 4

    def run(pkg, cpkg):
        lat = pkg.make_scenario("pareto", base=cpkg.LatencyModel(base=0.45), seed=0)
        tel = pkg.ComputeTelemetry(n, m, window=32)
        ctl = pkg.TauController(pkg.ControllerConfig(), 0.5, total_steps=steps)
        for step in range(steps):
            t = lat.sample_at(step, n, m, seed=1)
            ctl.maybe_update(step, tel, steps_remaining=steps - step)
            mask = np.ones((n, m)) if not np.isfinite(ctl.tau) else \
                (np.cumsum(t, -1) < ctl.tau)
            tel.record(step, t, host_step_s=0.0, tau=ctl.tau,
                       drop_fraction=float(1 - np.mean(mask)))
        return [(d.step, d.tau, d.applied, d.reason) for d in ctl.decisions], ctl.trajectory

    want, got = run(jres, jcore), run(resilience, core)
    assert got == want
    assert len(got[1]) > 1  # the controller did move tau
