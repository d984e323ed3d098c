"""What the ranks of ``tests/test_torch_dist.py`` run (``repro_torch.dist.
procs.spawn`` pickles these functions by their import path).  It imports
no JAX: each rank is a process that needs only the port.  Every function
returns plain values and CPU tensors; the parent holds them to the
reference and to each other."""
import dataclasses
import importlib.util
import pathlib
import time

import numpy as np
import torch

from repro_torch import train as ttrain
from repro_torch.dist import Distribution, IndivisibleWorkersError
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import ShardNorms, global_norm, make as make_opt


def _smoke():
    """``chip_smoke.py`` at the repository's root, as a module (its planted
    faults; it imports no JAX)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_dp_faults", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _params(params_np, cfg):
    return params_from_jax(params_np, cfg, device="cpu")


def _cpu(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def _whole(params_np, cfg, grads_np=None):
    """The whole tree on this rank: ``params_np`` as port parameters, or
    ``grads_np`` (numpy leaves in ``tree_leaves`` order) in their shape."""
    params = _params(params_np, cfg)
    if grads_np is None:
        return params
    return tree_unflatten(params, [torch.from_numpy(g.copy()) for g in grads_np])


def _recorder(reduce, out: list):
    """``reduce`` that keeps a copy of each vector it returns."""
    def run(vec):
        reduce(vec)
        out.append(vec.clone())
    return run


def run_sharded(rank, world, mesh, jobs, norms):
    """The sharded (ZeRO) path on ``mesh`` (a ``--mesh`` spec).  ``jobs``:
    one ``make_train_step`` step each (a dict of ``cfg``, ``shape``,
    ``params`` (numpy), ``batch``, ``drop``, ``latencies``, ``optimizer``,
    ``lr``) from ``dist.shard`` of the same parameters, through
    ``Distribution.train_step``: the loss, the completed fraction, this
    rank's kept count, how many of its master leaves are slices, and the
    updated parameters gathered whole.  ``norms`` (``cfg``, ``params``,
    ``grads``: numpy) is one LAMB and one LANS step and a ``global_norm``
    of the shards, with the split leaves' reduced sums of squares recorded
    as the optimizer takes them, sound and with the planted fault (each
    rank's own slice's sums, no collective).  It runs on one thread, as the
    test process does: every process then sums a product's terms the same
    way, and runs differ only by the order of the ranks' sums."""
    torch.set_num_threads(1)
    dist = Distribution.from_spec(mesh, device="cpu")
    out = {"steps": [], "norms": {}}
    for job in jobs:
        bundle = dist.train_step(job["cfg"], job["shape"], job["drop"], n_workers=4,
                                 optimizer=job["optimizer"], lr=job["lr"])
        whole = _params(job["params"], job["cfg"])
        specs = dist.param_shardings(whole)
        params = dist.shard(whole, specs)
        _, _, metrics = bundle(params, bundle.opt.init(params), job["batch"], job["latencies"])
        out["steps"].append({
            "loss": float(metrics["loss"]),
            "completed_fraction": float(metrics["completed_fraction"]),
            "kept_local": metrics["kept_local"],
            "split": sum(p.shape != w.shape for p, w in zip(tree_leaves(params),
                                                           tree_leaves(whole))),
            "params": _cpu(dist.gather(params, specs))})
    cfg = norms["cfg"]
    whole = _params(norms["params"], cfg)
    specs = dist.param_shardings(whole)
    split = [d is not None for d in dist.split_dims(whole)]
    for plant in (False, True):
        reduce = (lambda v: None) if plant else dist.sum_over_data
        for name in ("lamb", "lans"):
            got = []
            params = dist.shard(_whole(norms["params"], cfg), specs)
            grads = dist.shard(_whole(norms["params"], cfg, norms["grads"]), specs)
            opt = make_opt(name, 1e-3)
            opt.step(grads, opt.init(params), params, shards=ShardNorms(split, _recorder(reduce, got)))
            out["norms"][name, plant] = got
        got = []
        global_norm(grads, ShardNorms(split, _recorder(reduce, got)))
        out["norms"]["global", plant] = got
    return out


def _result(res):
    return {"losses": res.losses, "drop_fractions": res.drop_fractions,
            "tau_trajectory": res.tau_trajectory, "sim_times": res.sim_times, "tau": res.tau,
            "bundle_rebuilds": res.metrics["bundle_rebuilds"],
            "kept_local": res.metrics["kept_local"], "allreduce_s": res.metrics["allreduce_s"],
            "params": _cpu(res.params)}


def run_trains(rank, world, cfg, data, params_np, tcfgs, ckpt_dir):
    """``train(mesh=str(world))`` for each named TrainConfig; then the
    checkpoint round trip on the first one: run A saves after step 1, run
    B resumes from it; then the first one under each of ``chip_smoke.py``'s
    planted ZeRO faults, (a) and (b) of its phase 9.  Also the refusal of
    workers that do not split."""
    out = {}
    for name, tcfg in tcfgs.items():
        tcfg = dataclasses.replace(tcfg, mesh=str(world))
        out[name] = _result(ttrain.train(cfg, data, tcfg, params=_params(params_np, cfg),
                                         device="cpu"))
    tcfg = dataclasses.replace(next(iter(tcfgs.values())), mesh=str(world))
    out["part"] = _result(ttrain.train(cfg, data, dataclasses.replace(
        tcfg, steps=1, ckpt_dir=ckpt_dir, ckpt_every=1), params=_params(params_np, cfg),
        device="cpu"))
    out["resumed"] = _result(ttrain.train(cfg, data, dataclasses.replace(
        tcfg, resume_from=ckpt_dir), params=_params(params_np, cfg), device="cpu"))
    smoke = _smoke()
    for fault in ("shard_at_rank0_rows", "reduce_scatter_skipped"):
        with getattr(smoke, fault)(rank):
            out[fault] = _result(ttrain.train(cfg, data, tcfg, params=_params(params_np, cfg),
                                              device="cpu"))
    try:
        ttrain.train(cfg, dataclasses.replace(data, batch_size=3 * (world + 1)),
                     dataclasses.replace(tcfg, n_workers=world + 1, microbatches=3), device="cpu")
        out["indivisible"] = None
    except IndivisibleWorkersError as e:
        out["indivisible"] = str(e)
    return out


def run_train(rank, world, cfg, data, params_np, tcfg):
    """``train(mesh=str(world))`` of one TrainConfig."""
    tcfg = dataclasses.replace(tcfg, mesh=str(world))
    return _result(ttrain.train(cfg, data, tcfg, params=_params(params_np, cfg), device="cpu"))


def hang_on_rank1(rank, world):
    """Rank 1 never returns."""
    if rank == 1:
        time.sleep(600)


def fail_on_rank1(rank, world):
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    torch.distributed.all_reduce(torch.ones(1))
    return np.float32(rank)

