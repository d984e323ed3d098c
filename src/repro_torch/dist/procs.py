"""Process groups for the data-parallel path (no counterpart in the
reference: JAX drives every device from one controller, PyTorch runs a
process a rank).

* :func:`spawn` starts ``world_size`` local ranks with the ``spawn`` start
  method, joined through a ``FileStore`` in a temporary directory (no
  network), runs ``fn(rank, world_size, *args)`` on each and returns their
  results in rank order.  It has a time limit: a rank that hangs (a
  collective another rank never joined) gets every rank killed and
  :class:`SpawnTimeout` raised; a rank that raises or dies gets the others
  killed and :class:`RankFailed` raised with its traceback.
* :func:`init_from_env` joins the group ``torchrun`` made.
* :func:`local_group` is a one-rank group inside this process.

A rank's device: ``None`` or ``"cuda"`` is the GPU of its local rank,
``"cuda:K"`` puts every rank on GPU K (gloo only: NCCL takes one rank a
GPU), ``"cpu"`` the CPU.  The backend is NCCL on CUDA and gloo on the CPU
unless the caller names one; NCCL with more ranks than GPUs raises
:class:`NotEnoughDevicesError` before any process starts.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["NotEnoughDevicesError", "RankFailed", "SpawnTimeout", "check_backend",
           "default_backend", "init_from_env", "local_group", "rank_device", "spawn"]

#: a collective that waits longer than this on its own (no ``timeout_s``) fails
_DEFAULT_TIMEOUT_S = 1800.0


class NotEnoughDevicesError(RuntimeError):
    """NCCL asked for more ranks than there are GPUs to give one each."""


class RankFailed(RuntimeError):
    """A spawned rank raised or died; the other ranks were killed."""


class SpawnTimeout(TimeoutError):
    """The ranks did not all finish within the time limit; all were killed."""


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank with ``local_rank`` (see the module's rules);
    CUDA raises without a GPU (``repro_torch.resolve_device``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise NotEnoughDevicesError(f"no {dev}: {torch.cuda.device_count()} visible GPUs")
    return dev


def default_backend(device) -> str:
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def check_backend(backend: str, world_size: int, device) -> None:
    """Refuse, before any work, a group NCCL cannot make: more ranks than
    visible GPUs, or two ranks on one GPU."""
    if backend != "nccl":
        return
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices, not {dev}; use backend='gloo'")
    n = torch.cuda.device_count()
    if world_size > n:
        raise NotEnoughDevicesError(f"NCCL wants one GPU a rank: {world_size} ranks, {n} "
                                    f"visible GPU{'s' if n != 1 else ''}")
    if dev.index is not None and world_size > 1:
        raise NotEnoughDevicesError(f"NCCL cannot put {world_size} ranks on one GPU ({dev}); "
                                    f"use backend='gloo'")


def _init(backend: str, dev: torch.device, timeout_s: Optional[float], **kw) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s or _DEFAULT_TIMEOUT_S), **kw)


def init_from_env(device=None) -> torch.device:
    """Join the group ``torchrun`` made (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment);
    returns this rank's device."""
    dev = rank_device(device, int(os.environ["LOCAL_RANK"]))
    backend = default_backend(dev)
    check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])),
                  device)
    _init(backend, dev, None, init_method="env://")
    return dev


@contextlib.contextmanager
def local_group(backend: Optional[str] = None, device=None):
    """A one-rank process group in this process for the block (a
    ``FileStore`` in a temporary directory); yields the rank's device."""
    dev = rank_device(device, 0)
    backend = backend or default_backend(dev)
    check_backend(backend, 1, device)
    with tempfile.TemporaryDirectory(prefix="repro-torch-group-") as tmp:
        _init(backend, dev, None, store=dist.FileStore(os.path.join(tmp, "store"), 1),
              rank=0, world_size=1)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _rank_entry(fn, rank, world_size, backend, device, store_path, out_path, timeout_s, args):
    """A spawned rank: join the group, run ``fn``, write its result (or its
    traceback) to ``out_path``, leave the group."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    try:
        dev = rank_device(device, rank)
        if dev.type == "cpu":  # ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        _init(backend, dev, timeout_s, store=dist.FileStore(store_path, world_size), rank=rank,
              world_size=world_size)
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out_path)  # the parent raises it
        raise
    torch.save({"result": result}, out_path)


def _kill(procs) -> None:
    procs = [p for p in procs if p.pid is not None]  # started
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn: Callable, world_size: int, backend: Optional[str] = None, device=None,
          timeout_s: Optional[float] = None, args: Sequence[Any] = (),
          workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new local
    ranks in one process group; returns their results in rank order.
    ``fn`` is pickled by its import path (a module-level function) and its
    result through ``torch.save`` (tensors come back on the CPU).
    ``timeout_s`` bounds the whole run and each collective (``None``: no
    limit on the run, 30 minutes a collective); ``workdir`` holds the store
    and the results (a temporary directory by default)."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    backend = backend or default_backend(device)
    check_backend(backend, world_size, device)
    if torch.device("cuda" if device is None else device).type == "cuda":
        rank_device(device, world_size - 1)  # raises without the GPUs
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-torch-spawn-", dir=workdir) as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(fn, r, world_size, backend, device, os.path.join(tmp, "store"),
                                   outs[r], timeout_s, tuple(args)))
                 for r in range(world_size)]
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        results: List[Any] = [None] * world_size
        try:
            for p in procs:
                p.start()
            running = list(procs)
            while running:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    ranks = [procs.index(p) for p in running]
                    raise SpawnTimeout(f"ranks {ranks} of {world_size} still running after "
                                       f"{timeout_s} s; every rank killed")
                for sentinel in multiprocessing.connection.wait([p.sentinel for p in running],
                                                                left):
                    p = next(q for q in running if q.sentinel == sentinel)
                    p.join()
                    running.remove(p)
                    r = procs.index(p)
                    out = _read(outs[r], p)
                    if "error" in out:
                        raise RankFailed(_failures(procs, outs, world_size))
                    results[r] = out["result"]
        finally:
            _kill(procs)
        return results


def _read(path: str, p) -> dict:
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=False)
    return {"error": f"exit code {p.exitcode}, no result"}


def _failures(procs, outs, world_size: int, grace_s: float = 5.0) -> str:
    """Every failed rank's error, in rank order, once the others have had
    ``grace_s`` to end on their own: the rank that failed first may be one
    that a peer's failure broke, not the cause."""
    end = time.monotonic() + grace_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    failed = [(r, _read(o, p)) for r, (p, o) in enumerate(zip(procs, outs))
              if p.exitcode is not None]
    return "\n".join(f"rank {r} of {world_size} failed:\n{out['error']}"
                     for r, out in failed if "error" in out)
