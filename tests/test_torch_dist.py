"""The port's data-parallel path (``repro_torch.dist``, ``launch.steps``,
the trainer's ``mesh=``) against the JAX package, on the CPU over gloo.

Each rank is a process (``dist.procs.spawn``, a time limit on every group);
what the ranks run is in ``test_torch_dist_util.py``.  The reference runs
its SPMD path on one CPU device: ``launch.steps.make_train_step`` jitted
(as ``tests/test_dist.py`` runs it) and ``train(mesh="1")``.  Parameters
come from the reference's ``init_params`` through ``params_from_jax``,
inputs from a seeded numpy stream, tolerances from ``TOL``.  Drop masks,
drop fractions, tau trajectories and simulated times are exact; losses and
parameters differ only by the order of the f32 sums over ranks.
"""
import dataclasses
import multiprocessing
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.dist import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import InputShape as JShape  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import make as jmake_opt  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.resilience import ControllerConfig as JController  # noqa: E402
from repro_torch import core, train  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    Distribution,
    IndivisibleWorkersError,
    NotEnoughDevicesError,
    ProcessGroupError,
    RankFailed,
    SpawnTimeout,
    UnsupportedDistError,
    make_mesh,
    procs,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import InputShape, ModelConfig  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.train.resilience import ControllerConfig  # noqa: E402
from test_torch_parity_util import assert_close, assert_tree_close  # noqa: E402
import test_torch_dist_util as ranks  # noqa: E402

torch.set_num_threads(1)

#: the time limit of every spawned group, seconds
GROUP_TIMEOUT_S = 120


def np_tree(jtree):
    return jax.tree.map(np.asarray, jtree)


def same_tree(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# the mesh and its refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["4", "4,1", "2,2,1"])
def test_from_spec_matches_reference(spec, monkeypatch):
    """The reference's parser and axis arithmetic over the port's mesh value
    (a JAX mesh of 4 devices needs 4 devices; the arithmetic reads only the
    axis names and sizes)."""
    monkeypatch.setattr(jmesh, "make_mesh", make_mesh)
    want, got = japi.Distribution.from_spec(spec), Distribution.from_spec(spec, device="cpu")
    assert got.mesh == want.mesh
    assert (got.dp_size, got.tp_size) == (want.dp_size, want.tp_size)
    assert jmesh.dp_axes(got.mesh) == tuple(a for a in ("pod", "data") if a in got.mesh.axis_names)


def test_bad_spec_and_model_axis_are_refused():
    with pytest.raises(ValueError) as want:
        japi.Distribution.from_spec("1,2,3,4")
    with pytest.raises(ValueError) as got:
        Distribution.from_spec("1,2,3,4")
    assert str(got.value) == str(want.value)
    with pytest.raises(UnsupportedDistError, match="model axis"):
        Distribution.from_spec("2,2", device="cpu")
    assert issubclass(train.UnsupportedDistError, UnsupportedDistError)


def test_workers_must_split_over_the_ranks():
    d = Distribution.from_spec("2", device="cpu")
    assert [d.workers_of(r, 6) for r in (0, 1)] == [range(0, 3), range(3, 6)]
    with pytest.raises(IndivisibleWorkersError, match="5 DropCompute workers .* 2 ranks"):
        d.workers_of(0, 5)


def test_nccl_refuses_more_ranks_than_gpus():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are present")
    with pytest.raises(NotEnoughDevicesError, match="2 ranks"):
        procs.spawn(ranks.fail_on_rank1, 2, backend="nccl", timeout_s=GROUP_TIMEOUT_S)
    with pytest.raises(NotEnoughDevicesError, match="one GPU"):
        procs.check_backend("nccl", 2, "cuda:0")


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    d = Distribution.from_spec("2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        procs.spawn(ranks.fail_on_rank1, 2, backend="gloo", timeout_s=GROUP_TIMEOUT_S)


def test_training_needs_its_process_group():
    cfg = get_smoke_config("qwen2_5_3b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, batch_size=8)
    with pytest.raises(ProcessGroupError, match="needs 2 ranks"):
        train.train(cfg, data, train.TrainConfig(steps=1, n_workers=2, microbatches=2, mesh="2"),
                    device="cpu")


def test_a_failed_rank_raises_and_a_hung_rank_is_killed():
    with pytest.raises(RankFailed, match="planted failure on rank 1"):
        procs.spawn(ranks.fail_on_rank1, 2, device="cpu", timeout_s=GROUP_TIMEOUT_S)
    t0 = time.monotonic()  # rank 0 may still be starting when the limit comes
    with pytest.raises(SpawnTimeout, match=r"ranks \[(0, )?1\] of 2 still running after 8"):
        procs.spawn(ranks.hang_on_rank1, 2, device="cpu", timeout_s=8)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()  # every rank was stopped


# ---------------------------------------------------------------------------
# one step: the port's make_train_step on R ranks against the reference's
# ---------------------------------------------------------------------------

SMALL = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
             vocab_size=101, dtype="float32", remat=False)
SHAPE = ("t", 16, 8, "train")
ONES = np.ones((4, 2), np.float32)  # each worker: keep 1 of 2 at tau 1.5
# ranks 1 (of 2) and 2-3 (of 4) keep nothing at tau 1.0 with no minimum
SKEWED = np.array([[0.1, 0.1], [0.1, 0.1], [5.0, 5.0], [5.0, 5.0]], np.float32)
# (drop, latencies, optimizer, lr).  SGD's update is -lr x the gradient, so
# at the reference test's lr 1e-2 it holds the all-reduced, normalised
# gradient itself to TOL (1.5e-8 apart at one rank).  AdamW's first step is
# lr x g / (|g| + eps): a gradient element near 0 turns its update by the
# order of its f32 sum (the reference sums a micro-batch over all workers'
# rows in one loss, the port each worker's block), 3.4e-4 on one element of
# 4,096 at lr 1e-2 with one rank; it is held at the trainer tests' 1e-3.
CASES = {
    "computed_sgd": (dict(tau=1.5), ONES, "sgd", 1e-2),
    "nominal_sgd": (dict(tau=1.5, normalize="nominal"), ONES, "sgd", 1e-2),
    "computed_adamw": (dict(tau=1.5), ONES, "adamw", 1e-3),
    "nominal_adamw": (dict(tau=1.5, normalize="nominal"), ONES, "adamw", 1e-3),
    "keeps_nothing": (dict(tau=1.0, min_microbatches=0), SKEWED, "adamw", 1e-3),
}


@pytest.fixture(scope="module")
def step_inputs():
    jc = JConfig(**SMALL)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 101, size=(8, 16)).astype(np.int32),
             "weights": (rng.random((8, 16)) > 0.1).astype(np.float32)}
    want = {}
    for name, (kw, lat, optimizer, lr) in CASES.items():
        opt, step = jsteps.make_train_step(jc, JShape(*SHAPE, microbatches=2),
                                           jcore.DropConfig(enabled=True, **kw), n_workers=4,
                                           optimizer=optimizer, lr=lr)
        p, _, m = jax.jit(step)(jp, opt.init(jp), batch, lat)
        want[name] = (p, float(m["loss"]), float(m["completed_fraction"]))
    return jp, batch, want


@pytest.fixture(scope="module", params=[2, 4])
def step_runs(request, step_inputs):
    jp, batch, _ = step_inputs
    cases = [{"drop": core.DropConfig(enabled=True, **kw), "latencies": lat,
              "optimizer": optimizer, "lr": lr}
             for kw, lat, optimizer, lr in CASES.values()]
    out = procs.spawn(ranks.run_steps, request.param, device="cpu", timeout_s=GROUP_TIMEOUT_S,
                      args=(ModelConfig(**SMALL), InputShape(*SHAPE, microbatches=2),
                            np_tree(jp), batch, cases))
    return request.param, {name: [r[i] for r in out] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_reference(step_inputs, step_runs, case):
    _, _, want = step_inputs
    world, runs = step_runs
    want_p, want_loss, want_frac = want[case]
    got = runs[case][0]
    assert_close(got["loss"], want_loss, "model_f32")
    assert got["completed_fraction"] == want_frac
    assert_tree_close(got["params"], want_p, "model_f32")
    for other in runs[case][1:]:  # the ranks' replicas agree exactly
        assert other["loss"] == got["loss"] and same_tree(other["params"], got["params"])
    kept = [r["kept_local"] for r in runs[case]]
    if case == "keeps_nothing":
        assert want_frac == 0.5 and kept[-1] == 0 and sum(kept) == 4
    else:
        assert want_frac == 0.5 and kept == [4 // world] * world


# ---------------------------------------------------------------------------
# the trainer: train(mesh="2") on 2 ranks against the reference's mesh="1"
# ---------------------------------------------------------------------------


def _tcfgs(pkg, cpkg, controller_cls):
    def tcfg(**kw):
        return pkg.TrainConfig(
            n_workers=4, microbatches=2, lr=1e-3, seed=3,
            latency=cpkg.LatencyModel(base=0.45, noise=cpkg.NoiseModel(kind="paper_lognormal")),
            **kw)
    return {
        "static": tcfg(steps=3, drop=cpkg.DropConfig(enabled=True, tau=1.0)),
        "auto": tcfg(steps=6, drop=cpkg.DropConfig(enabled=True), auto_threshold=True,
                     calibration_steps=3),
        "online": tcfg(steps=6, drop=cpkg.DropConfig(enabled=True), online_tau=True,
                       controller=controller_cls(warmup_steps=2, check_every=1,
                                                 recompile_cost_s=0.0)),
    }


DATA = dict(vocab_size=503, seq_len=16, batch_size=8, seed=2)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    jc, tc = jget_smoke("qwen2_5_3b"), get_smoke_config("qwen2_5_3b")
    jp = np_tree(jmodel.init_params(jax.random.PRNGKey(0), jc))
    # the reference's mesh path donates the parameters: each run its own copy
    want = {name: jtrain.train(jc, JData(**DATA), dataclasses.replace(t, mesh="1"),
                               params=jax.tree.map(jax.numpy.asarray, jp))
            for name, t in _tcfgs(jtrain, jcore, JController).items()}
    ckpt_dir = str(tmp_path_factory.mktemp("dp_ckpt"))
    got = procs.spawn(ranks.run_trains, 2, device="cpu", timeout_s=GROUP_TIMEOUT_S,
                      args=(tc, DataConfig(**DATA), jp,
                            _tcfgs(train, core, ControllerConfig), ckpt_dir))
    return jc, tc, jp, want, got, ckpt_dir


@pytest.mark.parametrize("run", ["static", "auto", "online"])
def test_train_matches_reference(train_runs, run):
    _, _, _, want, got, _ = train_runs
    w, g = want[run], got[0][run]
    assert g["drop_fractions"] == w.drop_fractions
    assert g["tau_trajectory"] == w.tau_trajectory and g["tau"] == w.tau
    assert g["sim_times"] == w.sim_times
    assert g["bundle_rebuilds"] == w.metrics["bundle_rebuilds"]
    np.testing.assert_allclose(g["losses"], w.losses, rtol=1e-4, atol=1e-4)
    assert_tree_close(g["params"], w.params, "model_f32")
    assert any(d > 0 for d in g["drop_fractions"])
    if run != "static":
        assert len(g["tau_trajectory"]) > 1  # tau was chosen mid-run
    # each rank computed its own kept micro-batches, all of them in sum
    kept = np.array([r[run]["kept_local"] for r in got]).sum(0)
    np.testing.assert_array_equal(kept, [round(8 * (1 - d)) for d in g["drop_fractions"]])
    assert all(len(r[run]["allreduce_s"]) == len(w.losses) for r in got)


@pytest.mark.parametrize("run", ["static", "auto", "online"])
def test_ranks_agree(train_runs, run):
    _, _, _, _, got, _ = train_runs
    a, b = got[0][run], got[1][run]
    for k in ("losses", "drop_fractions", "tau_trajectory", "sim_times", "bundle_rebuilds"):
        assert a[k] == b[k], k
    assert same_tree(a["params"], b["params"])


@pytest.fixture(scope="module")
def mamba_runs():
    """The static run through the mamba2-130m smoke config: the reference's
    ``train(mesh="1")`` and the port's on 2 gloo ranks."""
    jc, tc = jget_smoke("mamba2_130m"), get_smoke_config("mamba2_130m")
    jp = np_tree(jmodel.init_params(jax.random.PRNGKey(0), jc))
    t = _tcfgs(jtrain, jcore, JController)["static"]
    want = jtrain.train(jc, JData(**DATA), dataclasses.replace(t, mesh="1"),
                        params=jax.tree.map(jax.numpy.asarray, jp))
    got = procs.spawn(ranks.run_train, 2, device="cpu", timeout_s=GROUP_TIMEOUT_S,
                      args=(tc, DataConfig(**DATA), jp,
                            _tcfgs(train, core, ControllerConfig)["static"]))
    return want, got


def test_mamba_train_matches_reference(mamba_runs):
    """'M' layers through the data-parallel step: drop fractions exact,
    losses within 1e-4, every leaf within ``TOL["model_f32"]``."""
    want, got = mamba_runs
    g = got[0]
    assert g["drop_fractions"] == want.drop_fractions
    assert any(d > 0 for d in g["drop_fractions"])
    np.testing.assert_allclose(g["losses"], want.losses, rtol=1e-4, atol=1e-4)
    assert_tree_close(g["params"], want.params, "model_f32")


def test_mamba_ranks_agree(mamba_runs):
    _, (a, b) = mamba_runs
    for k in ("losses", "drop_fractions", "tau_trajectory", "sim_times"):
        assert a[k] == b[k], k
    assert same_tree(a["params"], b["params"])


def test_resume_equals_the_uninterrupted_run(train_runs):
    _, _, _, _, got, _ = train_runs
    full, part, resumed = got[0]["static"], got[0]["part"], got[0]["resumed"]
    assert part["losses"] == full["losses"][:1]
    assert resumed["losses"] == full["losses"][1:]
    assert resumed["drop_fractions"] == full["drop_fractions"][1:]
    assert resumed["tau"] == full["tau"] and resumed["tau_trajectory"] == [(1, full["tau"])]
    assert same_tree(resumed["params"], full["params"])


def test_dp_checkpoint_loads_in_both_single_device_trainers(train_runs):
    """The 2-rank run's checkpoint (step 1): the port's single-device trainer
    resumes from it to the 2-rank resumed run's results, and the reference's
    ``restore`` reads rank 0's parameters from it exactly."""
    jc, tc, jp, _, got, ckpt_dir = train_runs
    tcfg = dataclasses.replace(_tcfgs(train, core, ControllerConfig)["static"],
                               resume_from=ckpt_dir)
    res = train.train(tc, DataConfig(**DATA), tcfg, device="cpu")
    dp = got[0]["resumed"]
    assert res.drop_fractions == dp["drop_fractions"]
    np.testing.assert_allclose(res.losses, dp["losses"], rtol=1e-4, atol=1e-4)
    for g, w in zip(tree_leaves(res.params), tree_leaves(dp["params"])):
        assert_close(g, w, "model_f32")
    jopt = jmake_opt("adamw", 1e-3, weight_decay=0.01)
    restored, step = jckpt.restore(ckpt_dir, {"params": jp, "opt": jopt.init(jp)})
    assert step == 1
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(np.asarray(w), g.numpy()),
                 restored["params"], got[0]["part"]["params"])


def test_indivisible_workers_refused_on_every_rank(train_runs):
    _, _, _, _, got, _ = train_runs
    assert all("3 DropCompute workers" in r["indivisible"] and "2 ranks" in r["indivisible"]
               for r in got)


# ---------------------------------------------------------------------------
# one rank, and the launcher
# ---------------------------------------------------------------------------


def test_one_rank_equals_the_single_device_trainer_bit_for_bit():
    tc = get_smoke_config("qwen2_5_3b")
    tcfg = _tcfgs(train, core, ControllerConfig)["auto"]
    want = train.train(tc, DataConfig(**DATA), tcfg, device="cpu")
    with procs.local_group(device="cpu"):
        got = train.train(tc, DataConfig(**DATA), dataclasses.replace(tcfg, mesh="1"),
                          device="cpu")
    assert got.losses == want.losses and got.drop_fractions == want.drop_fractions
    assert got.tau_trajectory == want.tau_trajectory and got.sim_times == want.sim_times
    assert same_tree(got.params, want.params)
    assert got.metrics["kept_local"] == [round(8 * (1 - d)) for d in got.drop_fractions]


def test_launcher_mesh(capfd):
    argv = ["--arch", "qwen2.5-3b", "--batch", "8", "--seq", "8", "--workers", "4",
            "--microbatches", "2", "--drop-compute", "--tau", "1.0", "--steps", "2"]
    assert launch_train.main(argv + ["--device", "cpu", "--mesh", "2"]) == 0
    out = capfd.readouterr().out
    assert "ranks=2" in out and out.count("[train] loss") == 1  # rank 0 prints
    if not torch.cuda.is_available():  # --mesh without --device cpu wants a GPU a rank
        with pytest.raises(NotEnoughDevicesError, match="2 ranks, 0 visible GPUs"):
            launch_train.main(argv + ["--full-config", "--seq", "2048", "--mesh", "2"])
