"""The port's data-parallel path (``repro_torch.dist``, ``launch.steps``,
the trainer's ``mesh=``) against the JAX package, on the CPU over gloo.

Each rank is a process (``dist.procs.spawn``, a time limit on every group);
what the ranks run is in ``test_torch_dist_util.py``.  The reference runs
its SPMD path on one CPU device: ``launch.steps.make_train_step`` jitted
(as ``tests/test_dist.py`` runs it) and ``train(mesh="1")``.  Parameters
come from the reference's ``init_params`` through ``params_from_jax``,
inputs from a seeded numpy stream, tolerances from ``TOL``.  Drop masks,
drop fractions, tau trajectories and simulated times are exact; losses and
parameters differ only by the order of the f32 sums over ranks.  With more
than one data rank every rank holds its ZeRO slices of the masters and the
optimizer state (``dist.sharding``'s rules): the steps run on 2 ranks (data
2) and 4 (pod 2 x data 2), and are also held to the port's own one rank and
their norms to the whole leaves'.
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
from repro_torch.launch import steps as port_steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import InputShape, ModelConfig  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.optim import ShardNorms, global_norm, make as make_opt  # noqa: E402
from repro_torch.train.resilience import ControllerConfig  # noqa: E402
from test_torch_parity_util import TOL, assert_close, assert_tree_close  # noqa: E402
import test_torch_dist_util as ranks  # noqa: E402

torch.set_num_threads(1)

#: the time limit of every spawned group, seconds
GROUP_TIMEOUT_S = 120
#: a sharded run's leaves against one rank's: within this many times the one
#: rank's own gap under another order of its sums (``chip_smoke.py``'s
#: DP_ORDER_FACTOR), and never held below DP_ZERO_GAP_FLOOR of the leaf's
#: norm (four f32 spacings; the card's rule uses it where the order gap is
#: 0, and after one CPU step a leaf's order gap can sit far below one
#: spacing of its norm: bert's position table read 4.7e-11)
DP_ORDER_FACTOR = 4
DP_ZERO_GAP_FLOOR = 4 * 2.0 ** -23


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
#: the configs of the step cases: SMALL (its 101-row embedding does not split
#: over 2 ranks, so it stays whole), SMALL with an even vocabulary (the tied
#: embedding split, gathered in f32 for the compute copy) and bert-1.5b's
#: smoke config (appendix B.1's LANS model: 'B' blocks, LayerNorm, biases)
CONFIGS = {"small": SMALL, "even": dict(SMALL, vocab_size=128), "bert": "bert_1_5b"}
SHAPE = ("t", 16, 8, "train")
ONES = np.ones((4, 2), np.float32)  # each worker: keep 1 of 2 at tau 1.5
# ranks 1 (of 2) and 2-3 (of 4) keep nothing at tau 1.0 with no minimum
SKEWED = np.array([[0.1, 0.1], [0.1, 0.1], [5.0, 5.0], [5.0, 5.0]], np.float32)
# (config, drop, latencies, optimizer, lr).  SGD's update is -lr x the
# gradient, so at the reference test's lr 1e-2 it holds the all-reduced,
# normalised gradient itself to TOL (1.5e-8 apart at one rank).  AdamW's
# first step is lr x g / (|g| + eps): a gradient element near 0 turns its
# update by the order of its f32 sum (the reference sums a micro-batch over
# all workers' rows in one loss, the port each worker's block), 3.4e-4 on
# one element of 4,096 at lr 1e-2 with one rank; it is held at the trainer
# tests' 1e-3, as are LAMB and LANS (trust ratios of whole leaves).
CASES = {
    "computed_sgd": ("small", dict(tau=1.5), ONES, "sgd", 1e-2),
    "nominal_sgd": ("small", dict(tau=1.5, normalize="nominal"), ONES, "sgd", 1e-2),
    "computed_adamw": ("small", dict(tau=1.5), ONES, "adamw", 1e-3),
    "nominal_adamw": ("small", dict(tau=1.5, normalize="nominal"), ONES, "adamw", 1e-3),
    "keeps_nothing": ("small", dict(tau=1.0, min_microbatches=0), SKEWED, "adamw", 1e-3),
    "computed_lamb": ("small", dict(tau=1.5), ONES, "lamb", 1e-3),
    "computed_lans": ("small", dict(tau=1.5), ONES, "lans", 1e-3),
    "even_adamw": ("even", dict(tau=1.5), ONES, "adamw", 1e-3),
    "even_lans": ("even", dict(tau=1.5), ONES, "lans", 1e-3),
    "bert_sgd": ("bert", dict(tau=1.5), ONES, "sgd", 1e-2),
    "bert_adamw": ("bert", dict(tau=1.5), ONES, "adamw", 1e-3),
    "bert_lamb": ("bert", dict(tau=1.5), ONES, "lamb", 1e-3),
    "bert_lans": ("bert", dict(tau=1.5), ONES, "lans", 1e-3),
}
#: the meshes of the 2- and 4-rank spawns: data 2; pod 2 x data 2 (each
#: leaf split over a pod's two data ranks and the same on both pods)
MESHES = {2: "2", 4: "2,2,1"}


def _configs(name):
    c = CONFIGS[name]
    if isinstance(c, str):
        return jget_smoke(c), get_smoke_config(c)
    return JConfig(**c), ModelConfig(**c)


@pytest.fixture(scope="module")
def step_inputs():
    """Per config its reference parameters (numpy) and batch; per case the
    reference's jitted single-device step (parameters, loss, completed
    fraction)."""
    inputs = {}
    for name in CONFIGS:
        jc, tc = _configs(name)
        rng = np.random.default_rng(7)
        batch = {"tokens": rng.integers(0, jc.vocab_size, size=(8, 16)).astype(np.int32),
                 "weights": (rng.random((8, 16)) > 0.1).astype(np.float32)}
        inputs[name] = (jc, tc, jmodel.init_params(jax.random.PRNGKey(0), jc), batch)
    want = {}
    for case, (name, kw, lat, optimizer, lr) in CASES.items():
        jc, _, jp, batch = inputs[name]
        opt, step = jsteps.make_train_step(jc, JShape(*SHAPE, microbatches=2),
                                           jcore.DropConfig(enabled=True, **kw), n_workers=4,
                                           optimizer=optimizer, lr=lr)
        p, _, m = jax.jit(step)(jp, opt.init(jp), batch, lat)
        want[case] = (p, float(m["loss"]), float(m["completed_fraction"]))
    return inputs, want


def _jobs(inputs):
    jobs = []
    for name, kw, lat, optimizer, lr in CASES.values():
        _, tc, jp, batch = inputs[name]
        jobs.append({"cfg": tc, "shape": InputShape(*SHAPE, microbatches=2), "params": np_tree(jp),
                     "batch": batch, "drop": core.DropConfig(enabled=True, **kw),
                     "latencies": lat, "optimizer": optimizer, "lr": lr})
    return jobs


@pytest.fixture(scope="module")
def one_rank_runs(step_inputs):
    """Per case the port's step on this process: the single-device
    ``make_train_step`` (no collective: today's replicated path), one rank
    of a one-rank gloo group (every leaf whole), and, per mesh of
    ``MESHES``, that rank with its norms summed as the mesh's data ranks sum
    theirs (``chip_smoke.sliced_norms``), sound and with its micro-batches
    summed in the reverse order (``chip_smoke.reversed_sums``: the order
    gap)."""
    inputs, _ = step_inputs
    jobs = _jobs(inputs)
    smoke = ranks._smoke()
    single = []
    for job in jobs:
        opt, step = port_steps.make_train_step(job["cfg"], job["shape"], job["drop"], 4,
                                               optimizer=job["optimizer"], lr=job["lr"])
        p = ranks._params(job["params"], job["cfg"])
        step(p, opt.init(p), job["batch"], job["latencies"])
        single.append(p)
    sliced = {}
    with procs.local_group(device="cpu"):
        one = ranks.run_sharded(0, 1, "1", jobs, norm_job(inputs))["steps"]
        for world, mesh in MESHES.items():
            with smoke.sliced_norms(mesh):
                sound = ranks.run_sharded(0, 1, "1", jobs, norm_job(inputs))["steps"]
                with smoke.reversed_sums():
                    rev = ranks.run_sharded(0, 1, "1", jobs, norm_job(inputs))["steps"]
            sliced[world] = list(zip(sound, rev))
    return {case: (single[i], one[i], {w: runs[i] for w, runs in sliced.items()})
            for i, case in enumerate(CASES)}


def norm_job(inputs):
    """The norm check's inputs: the even config's reference parameters and
    gradients drawn from a seeded numpy stream, one a leaf."""
    _, tc, jp, _ = inputs["even"]
    leaves = tree_leaves(ranks._params(np_tree(jp), tc))
    rng = np.random.default_rng(11)
    return {"cfg": tc, "params": np_tree(jp),
            "grads": [rng.normal(size=tuple(x.shape)).astype(np.float32) for x in leaves]}


@pytest.fixture(scope="module", params=[2, 4])
def step_runs(request, step_inputs):
    inputs, _ = step_inputs
    world = request.param
    out = procs.spawn(ranks.run_sharded, world, device="cpu", timeout_s=GROUP_TIMEOUT_S,
                      args=(MESHES[world], _jobs(inputs), norm_job(inputs)))
    return world, {name: [r["steps"][i] for r in out] for i, name in enumerate(CASES)}, \
        [r["norms"] for r in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_reference(step_inputs, step_runs, case):
    _, want = step_inputs
    world, runs, _ = step_runs
    want_p, want_loss, want_frac = want[case]
    got = runs[case][0]
    assert_close(got["loss"], want_loss, "model_f32")
    assert got["completed_fraction"] == want_frac
    assert_tree_close(got["params"], want_p, "model_f32")
    for other in runs[case][1:]:  # the ranks' gathered trees agree exactly
        assert other["loss"] == got["loss"] and same_tree(other["params"], got["params"])
    kept = [r["kept_local"] for r in runs[case]]
    if case == "keeps_nothing":
        assert want_frac == 0.5 and kept[-1] == 0 and sum(kept) == 4
    else:
        assert want_frac == 0.5 and kept == [4 // world] * world
    assert all(r["split"] > 0 for r in runs[case])  # ZeRO: each rank holds slices


#: a leaf's gap to another, over the other's norm: by the largest element
#: and by the norm of the difference (``chip_smoke.DP_GAPS``)
GAPS = {"largest element": lambda a, b: (a - b).abs().max(),
        "norm of the difference": lambda a, b: torch.linalg.vector_norm(a - b)}


def order_faults(got, one, rev) -> list:
    """The leaves of ``got`` farther from the one-rank run ``one``, by either
    reading of ``GAPS``, than ``DP_ORDER_FACTOR`` times the one-rank run's
    own gap by that reading under another order of its sums (``rev``), and
    than ``DP_ZERO_GAP_FLOOR`` of the leaf's norm."""
    out = []
    for reading, diff in GAPS.items():
        def gap(a, b):
            return float(diff(a, b) / torch.linalg.vector_norm(b))

        for i, (g, o, r) in enumerate(zip(tree_leaves(got), tree_leaves(one),
                                          tree_leaves(rev))):
            limit = max(DP_ORDER_FACTOR * gap(r, o), DP_ZERO_GAP_FLOOR)
            if gap(g, o) >= limit:
                out.append((reading, i, gap(g, o), limit))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_one_rank(one_rank_runs, step_runs, case):
    """R sharded ranks against the port's one rank with its norms summed as
    theirs: the same kept counts and completed fraction exactly, every leaf
    within its order gap; one rank of a group against the single-device
    step bit for bit."""
    world, runs, _ = step_runs
    single, one, sliced = one_rank_runs[case]
    sound, rev = sliced[world]
    assert same_tree(one["params"], single)
    assert one["split"] == 0 and sound["split"] == 0
    got = runs[case][0]
    assert got["completed_fraction"] == sound["completed_fraction"]
    assert sum(r["kept_local"] for r in runs[case]) == sound["kept_local"]
    assert abs(got["loss"] - sound["loss"]) <= 1e-6 * abs(sound["loss"])
    assert order_faults(got["params"], sound["params"], rev["params"]) == []


def _norm_gaps(got: list, want: list) -> float:
    """The largest relative gap between two runs' recorded norms (the square
    roots of the reduced sums of squares) and between the trust ratios
    ||p|| / ||r|| they give (each pass's vector holds, per split leaf, the
    parameter's part, then its directions')."""
    worst = 0.0
    for g, w in zip(got, want):
        gn, wn = g.sqrt(), w.sqrt()
        worst = max(worst, float(((gn - wn).abs() / wn).max()))
    return worst


@pytest.mark.parametrize("what", ["lamb", "lans", "global"])
def test_shard_norms_are_the_whole_leaves(step_inputs, step_runs, what):
    """The norms the optimizer takes under ZeRO (every split leaf's sums of
    squares over its data ranks) equal the whole leaves' within rtol 1e-6;
    with the planted fault (each rank's own slice's norm) they do not."""
    inputs, _ = step_inputs
    world, _, norms = step_runs
    job = norm_job(inputs)
    split = [d is not None for d in Distribution.from_spec(MESHES[world], device="cpu")
             .split_dims(ranks._params(job["params"], job["cfg"]))]
    assert any(split) and not all(split)
    params = ranks._whole(job["params"], job["cfg"])
    grads = ranks._whole(job["params"], job["cfg"], job["grads"])
    want = []
    shards = ShardNorms(split, ranks._recorder(lambda v: None, want))
    if what == "global":
        global_norm(grads, shards)
        assert_close(want[0], torch.stack([torch.linalg.vector_norm(g).square() for g, s in
                                           zip(tree_leaves(grads), split) if s]), "kernel_f32")
    else:
        opt = make_opt(what, 1e-3)
        opt.step(grads, opt.init(params), params, shards=shards)
        if what == "lamb":  # trust ratios ||p|| / ||r|| of the whole leaves
            ratios = [want[0][0::2].sqrt() / want[0][1::2].sqrt()]
    assert len(want) == (2 if what == "lans" else 1)
    for r in norms:
        assert len(r[what, False]) == len(want)
        assert _norm_gaps(r[what, False], want) < 1e-6
        assert _norm_gaps(r[what, True], want) > 1e-6  # the planted local norm is caught
        if what == "lamb":
            got = r[what, False][0]
            np.testing.assert_allclose((got[0::2].sqrt() / got[1::2].sqrt()).numpy(),
                                       ratios[0].numpy(), rtol=1e-6)


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


@pytest.mark.parametrize("fault", ["shard_at_rank0_rows", "reduce_scatter_skipped"])
def test_planted_zero_faults_are_caught(train_runs, fault):
    """``chip_smoke.py``'s planted faults on the sharded path, (a) rank 1's
    slices written at rank 0's rows in every all-gather and (b) one split
    leaf's gradient left out of the reduce-scatter: the static run, whose
    sound leaves match the reference within ``TOL["model_f32"]``, moves
    leaves outside that tolerance of the sound run's, on every rank alike
    (so only the values show them)."""
    _, _, _, want, got, _ = train_runs
    w = want["static"]
    sound, planted = got[0]["static"], got[0][fault]
    assert_tree_close(sound["params"], w.params, "model_f32")
    assert planted["drop_fractions"] == w.drop_fractions
    off = [i for i, (g, x) in enumerate(zip(tree_leaves(planted["params"]),
                                            tree_leaves(sound["params"])))
           if not torch.allclose(g, x, **TOL["model_f32"])]
    assert off, f"{fault}: every leaf within the tolerance"
    assert same_tree(got[1][fault]["params"], planted["params"])


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
