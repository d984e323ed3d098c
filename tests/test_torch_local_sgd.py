"""The port's Local-SGD + DropCompute (appendix B.3) against
``repro.core.local_sgd`` on the CPU: the runtime model's draws and
speedups exactly; ``localsgd_train`` on the reference test's quadratic and
on the qwen2.5-3b and mamba2-130m smoke configs through the model's loss (weights carried
across by ``params_from_jax``, the same numpy batches) within ``TOL``; and
the port's own choices: a dropped step runs no backward while its loss
still enters the round's mean, and a worker whose steps are all dropped
contributes the round's starting parameters unchanged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import local_sgd as jlocal  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from test_torch_parity_util import assert_close, assert_tree_close, np32  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the runtime model (fig. 12): numpy, exactly the reference's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tau_scale", [None, 0.16], ids=["no_tau", "tau"])
@pytest.mark.parametrize("h", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("mode", ["uniform", "single_server"])
def test_runtime_model_equals_reference(mode, h, tau_scale):
    kw = dict(mode=mode, p=0.3 if mode == "single_server" else 0.04, delay=1.0, base=0.1,
              server_size=4)
    sc, jsc = local_sgd.StragglerScenario(**kw), jlocal.StragglerScenario(**kw)
    got = sc.sample(np.random.default_rng(h), 7, 32, h)
    want = jsc.sample(np.random.default_rng(h), 7, 32, h)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    tau = None if tau_scale is None else h * tau_scale
    assert (local_sgd.localsgd_speedup(sc, 32, h, tau=tau, iters=200, seed=h)
            == jlocal.localsgd_speedup(jsc, 32, h, tau=tau, iters=200, seed=h))


# ---------------------------------------------------------------------------
# the quadratic of tests/test_local_sgd.py
# ---------------------------------------------------------------------------

H, N, ROUNDS, LR = 6, 4, 20, 0.05
W_TRUE = np.random.default_rng(0).normal(size=(4,)).astype(np.float32)


def quad_data(r, n):
    rr = np.random.default_rng(100 * r + n)
    x = rr.normal(size=(H, 8, 4)).astype(np.float32)
    return {"x": x, "y": x @ W_TRUE}


def quad_loss(p, mb):
    return torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


def jquad_loss(p, mb):
    return jnp.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


def port_quadratic(keep, **kw):
    p0 = {"w": torch.zeros(4, dtype=torch.float32)}
    return local_sgd.localsgd_train(quad_loss, p0, quad_data, N, kw.pop("rounds", ROUNDS), H,
                                    LR, keep_mask=keep, device="cpu", **kw)


KEEP = (np.random.default_rng(1).random((ROUNDS, N, H)) > 0.2).astype(np.float32)


@pytest.mark.parametrize("keep", [None, KEEP], ids=["all_kept", "dropped"])
def test_quadratic_matches_reference(keep):
    def jdata(r, n):
        return {k: jnp.asarray(v) for k, v in quad_data(r, n).items()}

    want_p, want_l = jlocal.localsgd_train(jquad_loss, {"w": jnp.zeros((4,), jnp.float32)},
                                           jdata, N, ROUNDS, H, LR, keep_mask=keep)
    got_p, got_l = port_quadratic(keep)
    assert_close(got_l, want_l, "model_f32")
    assert_tree_close(got_p, want_p, "model_f32")
    assert got_l[-1] < 0.1 * got_l[0]  # the B.3 claim survives the drops


def test_worker_with_every_step_dropped_contributes_the_start():
    """Worker 0 drops all of its local steps in the one round: the average
    is (P + W_1 + ... ) / N with P the round's start, bit for bit, where W_n
    is what worker n alone makes of P."""
    keep = np.ones((1, N, H), np.float32)
    keep[0, 0] = 0.0
    got, _ = port_quadratic(keep, rounds=1)
    alone = []
    for n in range(1, N):
        w, _ = local_sgd.localsgd_train(quad_loss, {"w": torch.zeros(4)},
                                        lambda r, _w, n=n: quad_data(r, n), 1, 1, H, LR,
                                        device="cpu")
        alone.append(w["w"])
    want = torch.zeros(4)
    for w in [torch.zeros(4)] + alone:  # the sum in the port's order (S += W)
        want = want + w
    assert torch.equal(got["w"], want / N)
    none, losses = port_quadratic(np.zeros((1, N, H), np.float32), rounds=1)
    assert torch.equal(none["w"], torch.zeros(4))  # nothing kept: P unchanged
    every = np.stack([np.asarray([quad_loss({"w": torch.zeros(4)},
                                            {k: torch.from_numpy(v[h])
                                             for k, v in quad_data(0, n).items()})
                                  for h in range(H)]) for n in range(N)])
    assert_close(losses[0], every.mean(axis=1).mean(), "kernel_f32")


def test_dropped_step_runs_no_backward_and_its_loss_counts():
    """One worker, two local steps, the second dropped: the loss is
    differentiated once (the kept step), evaluated three times (the kept
    step's gradient and post-step loss, the dropped step's loss), and the
    round's loss is the mean of both post-step losses at the weights the
    kept step left."""
    calls = []

    def loss(p, mb):
        calls.append(torch.is_grad_enabled())
        return quad_loss(p, mb)

    data = quad_data(0, 0)
    p, losses = local_sgd.localsgd_train(loss, {"w": torch.zeros(4)},
                                         lambda r, n: {k: v[:2] for k, v in data.items()}, 1, 1,
                                         2, LR, keep_mask=np.array([[[1.0, 0.0]]]), device="cpu")
    assert calls == [True, False, False]
    mbs = [{k: torch.from_numpy(v[h]) for k, v in data.items()} for h in range(2)]
    w0 = torch.zeros(4, requires_grad=True)
    (g,) = torch.autograd.grad(quad_loss({"w": w0}, mbs[0]), [w0])
    w1 = torch.zeros(4) + np.float32(-LR) * g
    assert torch.equal(p["w"], w1)
    want = (quad_loss({"w": w1}, mbs[0]) + quad_loss({"w": w1}, mbs[1])) / 2
    assert_close(losses[0], want, "kernel_f32")


# ---------------------------------------------------------------------------
# the qwen2.5-3b and mamba2-130m smoke configs through the model's loss
# ---------------------------------------------------------------------------


def _smoke_matches_reference(name):
    """2 workers x 2 local steps x 2 rounds of ``name``'s smoke config, one
    step dropped and one worker round all dropped: (port, reference) round
    losses and final parameters on the same batches."""
    jc, tc = jget_smoke(name), get_smoke_config(name)
    jp = jmodel.init_params(jax.random.PRNGKey(4), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    n, h, rounds, seq = 2, 2, 2, 32

    def data(r, w):
        rng = np.random.default_rng(10 * r + w)
        return {"tokens": rng.integers(0, jc.vocab_size, (h, 2, seq)).astype(np.int32),
                "weights": (rng.random((h, 2, seq)) > 0.1).astype(np.float32)}

    def jloss(p, mb):
        ls, w = jmodel.loss_fn(p, jc, mb)
        return ls / w

    def loss(p, mb):
        ls, w = model.loss_fn(p, tc, mb)
        return ls / w

    keep = np.array([[[1, 0], [1, 1]], [[0, 0], [1, 1]]], np.float32)
    want_p, want_l = jlocal.localsgd_train(
        jloss, jp, lambda r, w: {k: jnp.asarray(v) for k, v in data(r, w).items()},
        n, rounds, h, 0.5, keep_mask=keep)
    got_p, got_l = local_sgd.localsgd_train(
        loss, tp, data, n, rounds, h, 0.5, keep_mask=keep, device="cpu",
        cast=lambda w, out=None: model.train_params(w, tc, out=out))
    return got_p, got_l, want_p, want_l


def test_qwen_smoke_matches_reference():
    """2 workers x 2 local steps x 2 rounds, one step dropped and one worker
    round all dropped: round losses and every final leaf within
    ``TOL["model_f32"]`` of JAX's ``localsgd_train`` on the same batches."""
    got_p, got_l, want_p, want_l = _smoke_matches_reference("qwen2_5_3b")
    assert_close(got_l, want_l, "model_f32")
    assert_tree_close(got_p, want_p, "model_f32")
    # the run moved the weights (a vacuous match would not)
    assert np.abs(np32(got_p["final_norm"]["scale"]) - 1.0).max() > 1e-3


def test_mamba_smoke_matches_reference():
    """The same run through the mamba2-130m smoke config ('M' layers: the
    chunked scan and K6's plain backward under the local steps)."""
    got_p, got_l, want_p, want_l = _smoke_matches_reference("mamba2_130m")
    assert_close(got_l, want_l, "model_f32")
    assert_tree_close(got_p, want_p, "model_f32")
    assert np.abs(np32(got_p["final_norm"]["scale"]) - 1.0).max() > 1e-3
