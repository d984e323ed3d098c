"""The port's RG-LRU ('R') training path against the JAX package on the CPU
in f32.

Same numpy inputs (or JAX-initialised weights carried across by
``params_from_jax``) through both packages:

* the scan's gradient (``rglru.linear_scan`` after ``_decay_and_update``,
  its backward the reverse scan of ``LinearScanFn``) against ``jax.grad``
  of the reference's ``_rglru_scan`` for x, r, i and the decay parameter,
  at lengths 1 to 100 (powers of two and not); ``LinearScanFn``'s backward
  against autograd through the log-depth ``_scan`` itself;
* the cache-free ``apply_rglru``'s gradient for every parameter and for x
  against ``jax.grad`` of the reference's;
* ``loss_fn`` and every gradient leaf for recurrentgemma-2b's smoke config
  (RRL, window 16) at 32 tokens, where the reference's 'L' layer takes its
  masked ``sdpa``, and at 64, where it takes ``sdpa_local_banded``
  (``layers.py:589-590``), and for ``hybrid_tiny`` (RRG); with remat and the
  chunked CE too;
* a 10-step DropCompute ``train`` run of the smoke config against the
  reference's: drop fractions, tau and simulated times exact, losses and
  final parameters within ``TOL["model_f32"]``;
* the launcher's 'R' line on the CPU and its refusal of the smoke config on
  the card.

Every comparison is ``TOL["model_f32"]``: the scan's sums run over up to 100
steps in another order than XLA's tree (values of O(1-10)), and the model's
over a few layers of matmuls.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch import core, train  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model, rglru  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from test_torch_parity_util import assert_close, assert_tree_close  # noqa: E402

torch.set_num_threads(1)

LENGTHS = [1, 7, 16, 33, 100]


def _scan_inputs(s: int, seed: int, dr: int = 24, b: int = 2):
    """x, the gates r and i, the decay parameter (a = sigmoid spans 0.27 to
    0.999, so some channels remember ~1000 steps) and a loss weight."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, dr)).astype(np.float32)
    r = rng.uniform(0.05, 0.95, size=(b, s, dr)).astype(np.float32)
    i = rng.uniform(0.05, 0.95, size=(b, s, dr)).astype(np.float32)
    lam = np.linspace(-1.0, 6.9, dr).astype(np.float32)
    w = rng.normal(size=(b, s, dr)).astype(np.float32)
    return (x, r, i, lam), w


@pytest.mark.parametrize("s", LENGTHS)
def test_scan_gradient_matches_jax(s):
    """h and the gradients of sum(h * w) for x, r, i and the decay
    parameter: the port's decay, gated input and ``linear_scan`` against
    ``jax.grad`` of ``_rglru_scan`` (``associative_scan``)."""
    args, w = _scan_inputs(s, seed=s)

    def jloss(*v):
        return jnp.sum(jrg._rglru_scan(*v)[1] * w)

    jargs = tuple(map(jnp.asarray, args))
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    leaves = [torch.from_numpy(v).requires_grad_() for v in args]
    h = rglru.linear_scan(*rglru._decay_and_update(*leaves))
    (h * torch.from_numpy(w)).sum().backward()
    assert_close(h, jrg._rglru_scan(*jargs)[1], "model_f32")
    for name, leaf, g in zip(("x", "r", "i", "lam"), leaves, want):
        assert leaf.grad.shape == g.shape, name
        assert_close(leaf.grad, g, "model_f32")


@pytest.mark.parametrize("s", LENGTHS)
def test_linear_scan_backward_is_autograd_of_the_scan(s):
    """``LinearScanFn``'s reverse scan against autograd through the
    log-depth ``_scan`` (which keeps every round): the same gradients of a
    and b, and the same h."""
    rng = np.random.default_rng(100 + s)
    a = rng.uniform(0.3, 1.0, size=(2, s, 8)).astype(np.float32)
    b = rng.normal(size=(2, s, 8)).astype(np.float32)
    dh = torch.from_numpy(rng.normal(size=(2, s, 8)).astype(np.float32))
    fa, fb = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    ra, rb = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    h = rglru.linear_scan(fa, fb)
    h.backward(dh)
    want = rglru._scan(ra, rb, dim=1)[1]
    want.backward(dh)
    assert torch.equal(h, want)
    # at length 1 h = b and autograd leaves a without a gradient: zero
    want_da = torch.zeros_like(fa) if ra.grad is None else ra.grad
    assert_close(fa.grad, want_da, "model_f32")
    assert_close(fb.grad, rb.grad, "model_f32")


@pytest.mark.parametrize("seq", [5, 16, 37])
def test_cache_free_block_gradients_match_jax(seq):
    """One RG-LRU block of the smoke config without a cache, as training
    runs it: the gradient of every parameter and of the input.  The gates
    and the conv bias start at zero in both packages' init; they are given
    values here so that every path carries a gradient."""
    jc, tc = jget_smoke("recurrentgemma_2b"), get_smoke_config("recurrentgemma_2b")
    rng = np.random.default_rng(seq)
    params = dict(jrg.init_rglru(jax.random.PRNGKey(3), jc))
    for k in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b", "conv_b"):
        params[k] = jnp.asarray(rng.normal(scale=0.5, size=params[k].shape), jnp.float32)
    x = rng.normal(size=(2, seq, jc.d_model)).astype(np.float32)
    w = rng.normal(size=(2, seq, jc.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jrg.apply_rglru(p, xx, jc)[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (rglru.apply_rglru(tp, tx, tc)[0] * torch.from_numpy(w)).sum().backward()
    for k, v in tp.items():
        assert_close(v.grad, jg[k], "model_f32")
    assert_close(tx.grad, jgx, "model_f32")


# ---------------------------------------------------------------------------
# the model: loss_fn and every gradient leaf
# ---------------------------------------------------------------------------

CONFIGS = {
    # RRL, window 16: at 32 tokens the reference's 'L' layer runs masked sdpa,
    # at 64 (> 2 x window) sdpa_local_banded
    "rg_smoke_s32": (jget_smoke("recurrentgemma_2b"), get_smoke_config("recurrentgemma_2b"), 32),
    "rg_smoke_s64": (jget_smoke("recurrentgemma_2b"), get_smoke_config("recurrentgemma_2b"), 64),
    "hybrid_tiny": (jget_config("hybrid_tiny"), get_config("hybrid_tiny"), 32),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    jc, tc, seq = CONFIGS[request.param]
    jp = jmodel.init_params(jax.random.PRNGKey(1), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(seq)
    batch = {"tokens": rng.integers(0, jc.vocab_size, size=(2, seq)).astype(np.int32),
             "weights": (rng.random((2, seq)) > 0.2).astype(np.float32)}
    return jc, tc, jp, tp, batch


def _jax_loss_and_grads(jc, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ls, w), g = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jc, jb), has_aux=True)(jp)
    return ls, w, g


def _port_loss_and_grads(tc, tp, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grad_fn = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
    return grad_fn(model.train_params(tp, tc), tb)


class TestLoss:
    def test_loss_and_every_grad_leaf(self, setup):
        jc, tc, jp, tp, batch = setup
        ls, w, jg = _jax_loss_and_grads(jc, jp, batch)
        g, tls, tw = _port_loss_and_grads(tc, tp, batch)
        assert_close(tls, ls, "model_f32")
        assert float(tw) == float(w)
        assert_tree_close(g, jg, "model_f32")

    def test_remat_and_chunked_ce(self, setup, monkeypatch):
        """Remat per group (``torch.utils.checkpoint``: an 'R' block's
        ``LinearScanFn`` runs again in the backward) and the CE chunked at 8
        positions in both packages."""
        jc, tc, jp, tp, batch = setup
        monkeypatch.setattr(jmodel, "_CE_CHUNK", 8)
        monkeypatch.setattr(model, "_CE_CHUNK", 8)
        jc, tc = dataclasses.replace(jc, remat=True), dataclasses.replace(tc, remat=True)
        ls, w, jg = _jax_loss_and_grads(jc, jp, batch)
        g, tls, tw = _port_loss_and_grads(tc, tp, batch)
        assert_close(tls, ls, "model_f32")
        assert_tree_close(g, jg, "model_f32")


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------


def _run_configs(pkg, cpkg, data_cls):
    """The smoke config's 10-step run: 4 workers x 2 micro-batches of one
    64-token sequence (the banded branch), tau calibrated by Algorithm 2
    after 5 steps."""
    data = data_cls(vocab_size=503, seq_len=64, batch_size=8, seed=2)
    return data, pkg.TrainConfig(
        steps=10, n_workers=4, microbatches=2, lr=1e-3, seed=3,
        drop=cpkg.DropConfig(enabled=True), auto_threshold=True, calibration_steps=5,
        latency=cpkg.LatencyModel(base=0.45, noise=cpkg.NoiseModel(kind="paper_lognormal")))


def test_ten_step_run_matches_reference():
    jc, tc = jget_smoke("recurrentgemma_2b"), get_smoke_config("recurrentgemma_2b")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jdata, jcfg = _run_configs(jtrain, jcore, JData)
    data, cfg = _run_configs(train, core, DataConfig)
    want = jtrain.train(jc, jdata, jcfg, params=jp)
    got = train.train(tc, data, cfg, params=tp, device="cpu")
    assert got.drop_fractions == want.drop_fractions
    assert got.tau_trajectory == want.tau_trajectory
    assert got.sim_times == want.sim_times
    assert len(got.tau_trajectory) == 2 and any(d > 0 for d in got.drop_fractions)
    assert got.tau == want.tau and got.metrics["tau_changes"] == want.metrics["tau_changes"]
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert_tree_close(got.params, want.params, "model_f32")


def test_launcher_trains_recurrentgemma(capsys):
    """``--arch recurrentgemma-2b`` on the CPU (the smoke config, 3 steps);
    without ``--device cpu`` the smoke config (f32, head dim 64, group 2)
    is refused at parsing, before any work."""
    assert launch_train.main(["--arch", "recurrentgemma-2b", "--steps", "3", "--seq", "64",
                              "--drop-compute", "--auto-threshold", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pattern=RRL" in out and "[train] loss" in out and "drop" in out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "recurrentgemma-2b", "--steps", "1"])
    assert "head dim 64 and group H/KV = 2" in capsys.readouterr().err
