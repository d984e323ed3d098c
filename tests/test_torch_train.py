"""The port's training path against the JAX package on the CPU in f32.

JAX ``init_params`` feeds ``params_from_jax``; both packages then compute
``loss_fn``'s ``(loss_sum, w_sum)`` and its gradient for every leaf, the
forward logits and ``per_token_losses`` on the qwen2.5-3b smoke config and
on an 'LG' config with a sliding window (the reference takes its banded
path there) and QK-norm; with remat and the chunked CE on; and a 10-step
DropCompute ``train`` run whose drop fractions, tau trajectory (Algorithm 2
calibrated mid-run) and simulated times must be identical and whose losses
and final parameters must agree to ``TOL["model_f32"]``.
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
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import core, train  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels.flash_attention import UnbuiltShapeError  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ModelConfig, UnsupportedPatternError, model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from test_torch_parity_util import assert_close, assert_tree_close  # noqa: E402

torch.set_num_threads(1)

# 'LG' with window 16 at 48 tokens: the reference's 'L' layers take the
# banded path (sq > 2 * window), its 'G' layers plain sdpa
LG = dict(name="lg", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
          vocab_size=211, sliding_window=16, layer_pattern="LG", dtype="float32",
          remat=False, use_qk_norm=True)

CONFIGS = {
    "qwen_smoke": (jget_smoke("qwen2_5_3b"), get_smoke_config("qwen2_5_3b"), 32),
    "lg_window": (JConfig(**LG), ModelConfig(**LG), 48),
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
        """Remat per group (``torch.utils.checkpoint``) and the CE chunked
        at 8 positions in both packages: the same sums and gradients."""
        jc, tc, jp, tp, batch = setup
        monkeypatch.setattr(jmodel, "_CE_CHUNK", 8)
        monkeypatch.setattr(model, "_CE_CHUNK", 8)
        jc, tc = dataclasses.replace(jc, remat=True), dataclasses.replace(tc, remat=True)
        ls, w, jg = _jax_loss_and_grads(jc, jp, batch)
        g, tls, tw = _port_loss_and_grads(tc, tp, batch)
        assert_close(tls, ls, "model_f32")
        assert_tree_close(g, jg, "model_f32")

    def test_forward_and_per_token_losses(self, setup):
        jc, tc, jp, tp, batch = setup
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            logits, _ = model.forward(tp, tc, tb)
            ce, w, _ = model.per_token_losses(tp, tc, tb)
        assert_close(logits, jmodel.forward(jp, jc, jb)[0], "model_f32")
        jce, jw, _ = jmodel.per_token_losses(jp, jc, jb)
        assert_close(ce, jce, "model_f32")
        assert_close(w, jw, "model_f32")


def test_tied_embedding_gradient_stays_f32():
    """The tied table is read by the gather and by every CE chunk: its
    gradient is taken on the f32 master, the other leaves on the compute
    copy (bf16 in the full config)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="bfloat16")
    params = model.init_params(cfg, seed=0, device="cpu")
    comp = model.train_params(params, cfg)
    assert comp["embed"]["embedding"] is params["embed"]["embedding"]
    assert comp["final_norm"]["scale"].dtype == torch.bfloat16
    tokens = torch.randint(0, cfg.vocab_size, (1, 16))
    g, _, _ = core.make_grad_fn(lambda p, mb: model.loss_fn(p, cfg, mb))(comp, {"tokens": tokens})
    assert g["embed"]["embedding"].dtype == torch.float32
    assert g["stack"]["groups"][0]["mlp"]["w_in"].dtype == torch.bfloat16


def test_training_refuses_what_is_not_ported():
    cap = ModelConfig(**dict(LG, logit_softcap=30.0))
    params = model.init_params(cap, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="softcap"):
        model.loss_fn(params, cap, {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    rec = ModelConfig(**dict(LG, layer_pattern="RG"))
    with pytest.raises(UnsupportedPatternError):
        model.forward_features({}, rec, {"tokens": torch.zeros((1, 8), dtype=torch.long)})


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _configs(pkg, cpkg, data_cls, **kw):
    data = data_cls(vocab_size=503, seq_len=16, batch_size=8, seed=2)
    tcfg = pkg.TrainConfig(
        steps=10, n_workers=4, microbatches=2, lr=1e-3, seed=3,
        drop=cpkg.DropConfig(enabled=True), auto_threshold=True, calibration_steps=5,
        latency=cpkg.LatencyModel(base=0.45, noise=cpkg.NoiseModel(kind="paper_lognormal")),
        **kw)
    return data, tcfg


def test_ten_step_run_matches_reference():
    jc, tc = jget_smoke("qwen2_5_3b"), get_smoke_config("qwen2_5_3b")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jdata, jcfg = _configs(jtrain, jcore, JData)
    data, cfg = _configs(train, core, DataConfig)
    want = jtrain.train(jc, jdata, jcfg, params=jp)
    got = train.train(tc, data, cfg, params=tp, device="cpu")
    assert got.drop_fractions == want.drop_fractions
    assert got.tau_trajectory == want.tau_trajectory
    assert got.sim_times == want.sim_times
    assert len(got.tau_trajectory) == 2 and any(d > 0 for d in got.drop_fractions)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert_tree_close(got.params, want.params, "model_f32")
    assert got.tau == want.tau and got.metrics["tau_changes"] == want.metrics["tau_changes"]


def test_trainer_refuses_unported_paths():
    cfg = get_smoke_config("qwen2_5_3b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, batch_size=8)
    for kw, err in (({"mesh": "2,2"}, train.UnsupportedDistError),
                    ({"ckpt_dir": "x"}, train.UnsupportedCheckpointError),
                    ({"resume_from": "x"}, train.UnsupportedCheckpointError)):
        with pytest.raises(err):
            train.train(cfg, data, train.TrainConfig(steps=1, **kw), device="cpu")


def test_trainer_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = get_smoke_config("qwen2_5_3b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, batch_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(cfg, data, train.TrainConfig(steps=1, n_workers=2, microbatches=2))


def test_training_refuses_unbuilt_kernel_shapes_before_any_work():
    """On the card, a config whose attention the training kernels are not
    built for (the smoke config: f32, head dim 32, group 2) or a sequence
    length they do not take is refused up front with a typed error; the
    published qwen2.5-3b at 2048 tokens passes; the CPU takes anything."""
    cuda = torch.device("cuda")
    smoke = get_smoke_config("qwen2_5_3b")
    full = model.ModelConfig(**{**smoke.__dict__, "name": "qwen-widths", "d_model": 2048,
                                "n_heads": 16, "n_kv_heads": 2, "dtype": "bfloat16"})
    for cfg, seq, match in ((smoke, 2048, "head dim 32"),
                            (dataclasses.replace(full, dtype="float32"), 2048, "bfloat16"),
                            (full, 96, "sequence lengths")):
        with pytest.raises(UnbuiltShapeError, match=match):
            model.require_trainable(cfg, seq, cuda)
    model.require_trainable(full, 2048, cuda)
    model.require_trainable(smoke, 33, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="softcap"):
        model.require_trainable(dataclasses.replace(full, logit_softcap=30.0), 2048, cuda)


def test_per_microbatch_times_in_metrics():
    cfg = get_smoke_config("qwen2_5_3b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, batch_size=4)
    tcfg = train.TrainConfig(steps=2, n_workers=2, microbatches=2, seed=1,
                             drop=core.DropConfig(enabled=True, tau=0.6))
    res = train.train(cfg, data, tcfg, device="cpu")
    kept = [round(4 * (1 - d)) for d in res.drop_fractions]
    assert [len(t) for t in res.metrics["microbatch_s"]] == kept
    assert all(0 < t < s for ts, s in zip(res.metrics["microbatch_s"], res.metrics["step_s"])
               for t in ts)


def test_launcher(capsys):
    assert launch_train.main(["--arch", "qwen2.5-3b", "--steps", "2", "--batch", "4",
                              "--seq", "8", "--workers", "2", "--microbatches", "2",
                              "--drop-compute", "--tau", "0.6", "--device", "cpu"]) == 0
    assert "[train] loss" in capsys.readouterr().out
    for flag in (["--mesh", "2,2"], ["--ckpt", "/x"], ["--resume", "/x"]):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", "qwen2.5-3b", "--device", "cpu"] + flag)
    capsys.readouterr()
    with pytest.raises(SystemExit):  # the smoke config on the card: refused at parsing
        launch_train.main(["--arch", "qwen2.5-3b", "--steps", "1"])
    assert "head dim 32" in capsys.readouterr().err
