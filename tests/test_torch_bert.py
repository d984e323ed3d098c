"""The paper's own models in the port: 'B' encoder blocks, ``bert_large``
and ``bert_1_5b`` (``PAPER_MODELS``), against the JAX package on the CPU in
f32.

The configs equal the reference's field for field (and ``param_count`` at
full size); ``init_params`` gives the reference's paths and shapes; a 'B'
layer attends both ways (a later token moves an earlier position) and its
forward equals the reference's ``sdpa(..., mask=None)`` path; ``loss_fn``
and every gradient leaf match ``jax.value_and_grad`` of the reference's
``loss_fn`` (also under remat and the chunked CE); a 10-step DropCompute
``train`` (bert-1.5b smoke with LANS, bert-large smoke with LAMB) has the
reference's drop fractions, tau trajectory and simulated times exactly and
its losses and parameters to ``TOL``; a reference checkpoint of the bert
smoke tree loads in the port; serving refuses 'B' stacks; the card's
kernels are built for bert's (head dim 64, group 1) attention; and the
port's launcher trains the bert-1.5b smoke config.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.configs import PAPER_MODELS as JPAPER_MODELS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import core, train  # noqa: E402
from repro_torch.configs import PAPER_MODELS, get_config, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import UnbuiltShapeError  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import UnsupportedPatternError, layers, model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_parity_util import assert_close, assert_tree_close  # noqa: E402

torch.set_num_threads(1)

#: the published parameter counts (the reference's ``param_count()``)
PARAMS = {"bert_large": 341_733_376, "bert_1_5b": 1_536_812_800}
#: the optimizer each paper model trains with in the paper (§5.1, B.1)
OPTIMIZER = {"bert_large": "lamb", "bert_1_5b": "lans"}


def _paths(tree, prefix=""):
    """(path, shape) of every leaf of a port (dict / tuple / list) or a JAX
    tree, in one order for both."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape))]


@pytest.fixture(scope="module", params=PAPER_MODELS)
def setup(request):
    name = request.param
    jc, tc = jget_smoke(name), get_smoke_config(name)
    jp = jmodel.init_params(jax.random.PRNGKey(4), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(len(name))
    batch = {"tokens": rng.integers(0, jc.vocab_size, size=(2, 24)).astype(np.int32),
             "weights": (rng.random((2, 24)) > 0.2).astype(np.float32)}
    return name, jc, tc, jp, tp, batch


class TestConfigs:
    def test_registry(self):
        assert PAPER_MODELS == JPAPER_MODELS
        for name in ("bert-large", "bert-1.5b"):
            assert get_config(name).name == name
            assert get_smoke_config(name).layer_pattern == "B"

    @pytest.mark.parametrize("name", PAPER_MODELS)
    def test_configs_equal_the_reference_field_for_field(self, name):
        for port, ref in ((get_config(name), jget_config(name)),
                          (get_smoke_config(name), jget_smoke(name))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.param_count() == ref.param_count()
        assert get_config(name).param_count() == PARAMS[name]

    @pytest.mark.parametrize("name", PAPER_MODELS)
    def test_parameter_trees_equal_the_reference(self, name):
        """Paths and shapes of ``init_params`` (the LayerNorm ``bias`` leaves
        and the 8192-row ``pos_embedding`` included) at the smoke config,
        and at full size from the meta device against JAX's abstract tree."""
        tc, jc = get_smoke_config(name), jget_smoke(name)
        got = _paths(model.init_params(tc, seed=0, device="cpu"))
        want = _paths(jmodel.init_params(jax.random.PRNGKey(0), jc))
        assert got == want
        assert ("/embed/pos_embedding", (8192, tc.d_model)) in got
        assert ("/final_norm/bias", (tc.d_model,)) in got
        full = _paths(model.init_params(get_config(name), device="meta"))
        abstract = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                             jget_config(name)))
        assert full == _paths(abstract)


class TestEncoder:
    def test_attention_is_bidirectional(self, setup):
        """Changing token j moves the features at i < j (a causal stack would
        leave them); the port's features equal the reference's."""
        _, jc, tc, jp, tp, batch = setup
        tokens = batch["tokens"][:1].copy()
        other = tokens.copy()
        other[0, 17] = (other[0, 17] + 1) % jc.vocab_size
        with torch.no_grad():
            a, _ = model.forward_features(tp, tc, {"tokens": torch.from_numpy(tokens)})
            b, _ = model.forward_features(tp, tc, {"tokens": torch.from_numpy(other)})
        moved = (a - b).abs().amax(-1)[0]
        assert bool((moved[:17] > 1e-4).all())
        want, _ = jmodel.forward_features(jp, jc, {"tokens": jnp.asarray(tokens)})
        assert_close(a, want, "model_f32")

    def test_b_layer_is_the_references_mask_free_sdpa(self, setup):
        """One 'B' layer's attention (the kernel dispatch on the CPU, no
        mask) against the reference's ``sdpa(q, k, v, None)``."""
        _, jc, tc, jp, tp, batch = setup
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 24, tc.d_model)).astype(np.float32)
        blk = {k: v[0] for k, v in tp["stack"]["groups"][0]["attn"].items()}
        jblk = jax.tree.map(lambda v: v[0], jp["stack"]["groups"][0]["attn"])
        pos = np.arange(24)
        with torch.no_grad():
            got = layers.apply_attention_nocache(blk, torch.from_numpy(x), tc, "B",
                                                 torch.from_numpy(pos))
        want, _ = jlayers.apply_attention(jblk, jnp.asarray(x), jc, "B", jnp.asarray(pos))
        assert_close(got, want, "model_f32")
        q, k, v = (jnp.einsum("bsd,dhk->bshk", jnp.asarray(x), jblk[w]) for w in ("wq", "wk", "wv"))
        out = jlayers.sdpa(q, k, v, None)
        assert_close(got, jnp.einsum("bshk,hkd->bsd", out, jblk["wo"]), "model_f32")

    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_every_grad_leaf(self, setup, remat, monkeypatch):
        """``loss_fn`` and its gradient for every leaf against
        ``jax.value_and_grad`` of the reference's; with remat also the CE
        chunked at 8 positions in both packages."""
        _, jc, tc, jp, tp, batch = setup
        if remat:
            monkeypatch.setattr(jmodel, "_CE_CHUNK", 8)
            monkeypatch.setattr(model, "_CE_CHUNK", 8)
            jc, tc = dataclasses.replace(jc, remat=True), dataclasses.replace(tc, remat=True)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (ls, w), jg = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jc, jb), has_aux=True)(jp)
        grad_fn = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
        g, tls, tw = grad_fn(model.train_params(tp, tc),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
        assert_close(tls, ls, "model_f32")
        assert float(tw) == float(w)
        assert_tree_close(g, jg, "model_f32")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _configs(pkg, cpkg, data_cls, optimizer):
    data = data_cls(vocab_size=503, seq_len=16, batch_size=8, seed=2)
    tcfg = pkg.TrainConfig(
        steps=10, n_workers=4, microbatches=2, optimizer=optimizer, lr=1e-3, seed=3,
        drop=cpkg.DropConfig(enabled=True), auto_threshold=True, calibration_steps=5,
        latency=cpkg.LatencyModel(base=0.45, noise=cpkg.NoiseModel(kind="paper_lognormal")))
    return data, tcfg


@pytest.mark.parametrize("name", PAPER_MODELS)
def test_ten_step_run_matches_reference(name):
    """bert-1.5b's smoke config with LANS, bert-large's with LAMB, through
    both trainers: the same drops, tau and simulated times; losses and
    final parameters to ``TOL``."""
    jc, tc = jget_smoke(name), get_smoke_config(name)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jdata, jcfg = _configs(jtrain, jcore, JData, OPTIMIZER[name])
    data, cfg = _configs(train, core, DataConfig, OPTIMIZER[name])
    want = jtrain.train(jc, jdata, jcfg, params=jp)
    got = train.train(tc, data, cfg, params=tp, device="cpu")
    assert got.drop_fractions == want.drop_fractions
    assert got.tau_trajectory == want.tau_trajectory
    assert got.sim_times == want.sim_times
    assert len(got.tau_trajectory) == 2 and any(d > 0 for d in got.drop_fractions)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert_tree_close(got.params, want.params, "model_f32")
    assert got.tau == want.tau


def test_reference_checkpoint_of_a_bert_tree_loads(tmp_path):
    """The reference's npz checkpoint of the bert-1.5b smoke parameters
    (learned positions, LayerNorm biases) restores into the port's tree bit
    for bit."""
    jc, tc = jget_smoke("bert_1_5b"), get_smoke_config("bert_1_5b")
    jp = jmodel.init_params(jax.random.PRNGKey(5), jc)
    jckpt.save(str(tmp_path), {"params": jp}, step=3)
    restored, step = ckpt.restore(str(tmp_path),
                                  {"params": model.init_params(tc, seed=1, device="cpu")})
    want = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    assert step == 3
    for a, b in zip(tree_leaves(restored["params"]), tree_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# what the port refuses, and what the card's kernels are built for
# ---------------------------------------------------------------------------


def test_serving_refuses_b_stacks():
    """Encoder-only: no decode shapes, so the engine, the paged layout and
    the decode cache refuse a 'B' stack with the typed error."""
    cfg = get_smoke_config("bert_large")
    params = model.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(UnsupportedPatternError, match="ContinuousBatcher supports"):
        ContinuousBatcher(params, cfg, batch_slots=2, max_len=32)
    with pytest.raises(UnsupportedPatternError, match="paged KV layout"):
        KVCacheSpec(num_slots=2, max_len=32, layout="paged", page_size=8).build(params, cfg)
    with pytest.raises(UnsupportedPatternError):
        model.init_decode_cache(params, cfg, 2, 32, linear=True)
    with pytest.raises(UnsupportedPatternError):
        model.prefill_chunk(params, cfg, {}, torch.zeros((1, 4), dtype=torch.long),
                            torch.zeros(1), torch.ones(1))


def test_mixed_b_stacks_are_refused():
    cfg = dataclasses.replace(get_smoke_config("bert_large"), layer_pattern="BG")
    with pytest.raises(UnsupportedPatternError):
        model.init_params(cfg, seed=0, device="cpu")


def test_kernels_are_built_for_berts_attention():
    """K3 takes head dim 64, group 1, bf16 at bert's lengths (128, 512) and
    at ragged ones (96); not group 2, nor 96 tokens with segment ids; the
    published BERT configs pass the trainer's up-front check on the card,
    their f32 smoke configs do not."""
    flash_attention.require_trained(64, 1, torch.bfloat16, 128)
    flash_attention.require_trained(64, 1, torch.bfloat16, 512, 512)
    flash_attention.require_trained(64, 1, torch.bfloat16, 96)
    with pytest.raises(UnbuiltShapeError, match="group"):
        flash_attention.require_trained(64, 2, torch.bfloat16, 128)
    with pytest.raises(UnbuiltShapeError, match="sequence lengths"):
        flash_attention.require_trained(64, 1, torch.bfloat16, 96, segments=True)
    cuda = torch.device("cuda")
    model.require_trainable(get_config("bert_1_5b"), 128, cuda)
    model.require_trainable(get_config("bert_large"), 512, cuda)
    with pytest.raises(UnbuiltShapeError, match="head dim 32"):
        model.require_trainable(get_smoke_config("bert_1_5b"), 128, cuda)
    model.require_trainable(get_smoke_config("bert_1_5b"), 33, torch.device("cpu"))


def test_launcher_trains_bert(capsys):
    """The port's launcher on the bert-1.5b smoke config with LANS, 2
    steps on the CPU; without ``--device cpu`` it is refused at parsing."""
    assert launch_train.main(["--arch", "bert-1.5b", "--optimizer", "lans", "--steps", "2",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=bert-1.5b-smoke" in out and "pattern=B" in out and "[train] loss" in out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "bert-1.5b", "--steps", "1"])
    assert "head dim 32 and group H/KV = 1" in capsys.readouterr().err
