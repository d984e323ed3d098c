"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's (``repro.train.checkpoint``) on the CPU: the reference's
round-trip cases on port trees; checkpoints written by either package read
by the other bit for bit (the model's parameters, each optimizer's state
with its ``count``, a bf16 tree); ``restore`` writing into the template's
tensors in place; and the trainer's resume: interrupted at step 20 of 40
and resumed, a run repeats the uninterrupted one exactly, and its drop
fractions and tau trajectory are the JAX run's.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import DropConfig as JDrop  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.resilience import ControllerConfig as JControllerConfig  # noqa: E402
from repro.train.resilience import make_scenario as jmake_scenario  # noqa: E402
from repro_torch import optim, train  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import DropConfig  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import ModelConfig, model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.resilience import ControllerConfig, make_scenario  # noqa: E402

torch.set_num_threads(1)


def tree():
    """The reference test's tree (``tests/test_checkpoint.py``) as a port
    tree: the optimizer's ``count`` is a host int."""
    return {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   "b": torch.ones(3)},
        "opt": {"m": [torch.zeros(2), torch.full((4,), 2.0)], "count": 7},
    }


def zeros_like(t):
    return tree_map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0, t)


class TestRoundtrip:
    def test_save_restore(self, tmp_path):
        t = tree()
        ckpt.save(str(tmp_path), t, step=42, extra={"tau": np.float32(1.5)})
        restored, step = ckpt.restore(str(tmp_path), zeros_like(t))
        assert step == 42
        assert restored["opt"]["count"] == 7
        for a, b in zip(tree_leaves(t), tree_leaves(restored)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        assert ckpt.load_extra(str(tmp_path)) == {"tau": 1.5}

    def test_latest_step(self, tmp_path):
        assert ckpt.latest_step(str(tmp_path)) is None
        ckpt.save(str(tmp_path), tree(), step=5)
        assert ckpt.latest_step(str(tmp_path)) == 5

    def test_shape_mismatch_rejected(self, tmp_path):
        ckpt.save(str(tmp_path), tree(), step=1)
        bad = tree()
        bad["params"]["w"] = torch.zeros((3, 3))
        with pytest.raises(ValueError):
            ckpt.restore(str(tmp_path), bad)

    def test_missing_key_rejected(self, tmp_path):
        ckpt.save(str(tmp_path), {"a": torch.ones(2)}, step=1)
        with pytest.raises(KeyError):
            ckpt.restore(str(tmp_path), {"a": torch.ones(2), "b": torch.ones(2)})

    def test_dtype_preserved_via_template(self, tmp_path):
        t = {"x": torch.ones((4,), dtype=torch.bfloat16)}
        ckpt.save(str(tmp_path), t, step=0)
        r, _ = ckpt.restore(str(tmp_path), t)
        assert r["x"].dtype == torch.bfloat16


def test_restore_writes_into_the_template_in_place(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), t, step=3)
    template = zeros_like(t)
    before = [x.data_ptr() for x in tree_leaves(template) if isinstance(x, torch.Tensor)]
    restored, _ = ckpt.restore(str(tmp_path), template)
    assert restored["params"]["w"] is template["params"]["w"]
    assert restored["opt"]["m"][1] is template["opt"]["m"][1]
    assert [x.data_ptr() for x in tree_leaves(template) if isinstance(x, torch.Tensor)] == before
    assert torch.equal(template["params"]["w"], t["params"]["w"])


# ---------------------------------------------------------------------------
# cross-loading: either package reads the other's checkpoints bit for bit
# ---------------------------------------------------------------------------

OPTIMIZERS = ["sgd", "adamw", "lamb", "lans"]


def _reference_tree(name: str):
    """JAX ``init_params`` of the qwen2.5-3b smoke config, ``opt.init`` of
    the optimizer with its moments filled from a seed and ``count`` 5, and
    the parameters' bf16 copy."""
    jc = jget_smoke("qwen2_5_3b")
    jp = jmodel.init_params(jax.random.PRNGKey(7), jc)
    state = joptim.make(name, 1e-3).init(jp)
    rng = np.random.default_rng(len(name))
    state = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32), x.dtype)
        if x.dtype != jnp.int32 else jnp.int32(5), state)
    return {"params": jp, "opt": state,
            "compute": jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)}


def _port_template(name: str):
    tc = get_smoke_config("qwen2_5_3b")
    params = model.init_params(tc, seed=1, device="cpu")
    return {"params": params, "opt": optim.make(name, 1e-3).init(params),
            "compute": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.bfloat16), params)}


def _bits(x) -> np.ndarray:
    """The leaf's bits (bf16 as uint16) as numpy, from JAX or the port."""
    if isinstance(x, torch.Tensor):
        return ckpt._to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_same(port_tree, jax_tree):
    tc = get_smoke_config("qwen2_5_3b")
    want = jax.tree.map(_bits, jax_tree)
    # the port's tree laid out as the reference's: params via params_from_jax's paths
    for key in ("params", "compute"):
        ref = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jax_tree[key]),
                              tc, device="cpu")
        for got, w in zip(tree_leaves(port_tree[key]), tree_leaves(ref)):
            assert np.array_equal(_bits(got), _bits(w.to(got.dtype)))
    flat_got = dict(ckpt._paths(port_tree["opt"]))
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want["opt"])
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        key = "/".join(jckpt._path_str(p) for p in path)
        got = _bits(flat_got[key]) if key != "count" else np.int32(flat_got[key])
        assert got.dtype == w.dtype and np.array_equal(got, w), key


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_port_reads_reference_checkpoint(tmp_path, name):
    jt = _reference_tree(name)
    jckpt.save(str(tmp_path), jt, step=9)
    restored, step = ckpt.restore(str(tmp_path), _port_template(name))
    assert step == 9 and restored["opt"]["count"] == 5
    assert isinstance(restored["opt"]["count"], int)
    assert restored["compute"]["final_norm"]["scale"].dtype == torch.bfloat16
    _assert_same(restored, jt)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_reference_reads_port_checkpoint(tmp_path, name):
    jt = _reference_tree(name)
    jckpt.save(str(tmp_path / "ref"), jt, step=9)
    port, _ = ckpt.restore(str(tmp_path / "ref"), _port_template(name))
    ckpt.save(str(tmp_path / "port"), port, step=11, extra={"x": 1})
    with open(tmp_path / "port" / "meta.json") as f:
        meta = json.load(f)
    with open(tmp_path / "ref" / "meta.json") as f:
        assert meta["keys"] == json.load(f)["keys"]  # the same paths, JAX's names
    zeros = jax.tree.map(jnp.zeros_like, jt)
    back, step = jckpt.restore(str(tmp_path / "port"), zeros)
    assert step == 11 and back["opt"]["count"].dtype == jnp.int32
    assert back["compute"]["final_norm"]["scale"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(jax.tree.map(_bits, jt)),
                    jax.tree.leaves(jax.tree.map(_bits, back))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert os.path.exists(tmp_path / "port" / "arrays.npz")


# ---------------------------------------------------------------------------
# the trainer's resume (the shape of tests/test_resilience.py:278)
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=131, dtype="float32", remat=False)


def _resume_cfgs(pkg, drop_cls, ctl_cls, scenario, **kw):
    base = dict(steps=40, n_workers=4, microbatches=4, lr=1e-3, seed=0, tc=0.5,
                telemetry_window=16, log_every=0,
                latency=scenario("pareto", seed=0, onset=10),
                drop=drop_cls(enabled=True, tau=float("inf")), online_tau=True,
                controller=ctl_cls(warmup_steps=8, check_every=4))
    base.update(kw)
    return pkg.TrainConfig(**base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_repeats_the_uninterrupted_run(tmp_path, dtype):
    """Interrupted at the midpoint and resumed, the port reproduces its
    uninterrupted run exactly: losses, drop fractions, tau and its
    trajectory (the adapted tau and the telemetry window ride the
    checkpoint); drop fractions and trajectory are the JAX run's.  In
    bf16 the compute copy is a copy, which must hold the restored weights
    from the resumed run's first step on."""
    tiny = dict(TINY, dtype=dtype)
    cfg, jcfg = ModelConfig(**tiny), JConfig(**tiny)
    data = DataConfig(vocab_size=131, seq_len=32, batch_size=32, strategy="pack", seed=0)
    jdata = JData(vocab_size=131, seq_len=32, batch_size=32, strategy="pack", seed=0)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)

    def port_params():
        return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")

    def cfgs(**kw):
        return _resume_cfgs(train, DropConfig, ControllerConfig, make_scenario, **kw)

    path = str(tmp_path / "ckpt")
    part = train.train(cfg, data, cfgs(steps=20, ckpt_dir=path, ckpt_every=20),
                       params=port_params(), device="cpu")
    assert ckpt.latest_step(path) == 20
    resumed = train.train(cfg, data, cfgs(resume_from=path), params=port_params(),
                          device="cpu")
    full = train.train(cfg, data, cfgs(), params=port_params(), device="cpu")
    want = jtrain.train(jcfg, jdata, _resume_cfgs(jtrain, JDrop, JControllerConfig,
                                                  jmake_scenario), params=jp)

    assert full.metrics["tau_changes"] >= 1  # the controller moved tau before step 20
    assert any(s < 20 for s, _ in full.tau_trajectory[1:])
    assert part.losses == full.losses[:20]
    assert resumed.losses == full.losses[20:]
    assert resumed.drop_fractions == full.drop_fractions[20:]
    assert resumed.tau == full.tau
    assert resumed.tau_trajectory == full.tau_trajectory
    assert full.drop_fractions == want.drop_fractions
    assert full.tau_trajectory == want.tau_trajectory
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        assert torch.equal(a, b)
