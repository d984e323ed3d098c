"""What the ranks of ``tests/test_torch_dist.py`` run (``repro_torch.dist.
procs.spawn`` pickles these functions by their import path).  It imports
no JAX: each rank is a process that needs only the port.  Every function
returns plain values and CPU tensors; the parent holds them to the
reference and to each other."""
import dataclasses
import time

import numpy as np
import torch

from repro_torch import train as ttrain
from repro_torch.dist import Distribution, IndivisibleWorkersError
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import tree_map


def _params(params_np, cfg):
    return params_from_jax(params_np, cfg, device="cpu")


def _cpu(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def run_steps(rank, world, cfg, shape, params_np, batch, cases):
    """One ``make_train_step`` step a case (a dict of ``drop``,
    ``latencies``, ``optimizer`` and ``lr``) from the same parameters,
    through ``Distribution.train_step``: the loss, the completed fraction,
    this rank's kept count and the updated parameters."""
    dist = Distribution.from_spec(str(world), device="cpu")
    out = []
    for case in cases:
        bundle = dist.train_step(cfg, shape, case["drop"], n_workers=4,
                                 optimizer=case["optimizer"], lr=case["lr"])
        params = _params(params_np, cfg)
        _, _, metrics = bundle(params, bundle.opt.init(params), batch, case["latencies"])
        out.append({"loss": float(metrics["loss"]),
                    "completed_fraction": float(metrics["completed_fraction"]),
                    "kept_local": metrics["kept_local"], "params": _cpu(params)})
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
    B resumes from it.  Also the refusal of workers that do not split."""
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

