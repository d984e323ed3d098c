"""``Distribution``: the data-parallel path's one object (port of
``repro.dist.api``, ``api.py:57-162``, on the data axis).

A ``Distribution`` holds a mesh (``dist.mesh``), this rank's device and
the backend, and talks to the ``torch.distributed`` process group this
process belongs to (``dist.procs`` makes one).  Each rank is a process;
the mesh's data size is the number of ranks, and each rank computes the
micro-batches of ``W / R`` of the ``W`` DropCompute workers.  Parameters
and optimizer state are replicated: ``shard`` makes a tree the same on
every rank (a broadcast from rank 0, where the reference places it with
``jax.device_put``), and ``all_reduce_sum`` is the step's one gradient
All-Reduce.

    dist = Distribution.from_spec("2", device="cpu")   # --mesh 2, gloo
    bundle = dist.train_step(cfg, shape, drop, n_workers=4)
    params, opt_state, metrics = bundle(params, opt_state, batch, latencies)

The model axis (tensor parallelism), the FSDP rules and the serving steps
are not ported: a mesh with ``model > 1`` raises ``UnsupportedDistError``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.distributed as tdist

from ..launch import steps as S
from ..models.transformer import tree_leaves
from . import mesh as mesh_lib
from . import procs

Tree = Any


class UnsupportedDistError(NotImplementedError):
    """A mesh asks for what the port has not ported (the model axis)."""


class IndivisibleWorkersError(ValueError):
    """The DropCompute workers do not split evenly over the ranks."""


class ProcessGroupError(RuntimeError):
    """The data-parallel path runs without the process group it needs."""


@dataclasses.dataclass
class StepBundle:
    """A rank's step and its optimizer (the reference's, without the
    abstract inputs: lowering is the dry-run's)."""

    fn: Callable
    opt: Any = None

    def __call__(self, *args):
        return self.fn(*args)


@dataclasses.dataclass(frozen=True)
class Distribution:
    """A mesh, the device of this rank (``procs.rank_device``'s rules:
    ``None`` is the GPU of its local rank) and the backend (NCCL on CUDA,
    gloo on the CPU, unless named)."""

    mesh: mesh_lib.Mesh
    device_spec: Optional[str] = None
    backend: Optional[str] = None

    def __post_init__(self):
        if self.tp_size > 1:
            raise UnsupportedDistError(
                f"mesh {self.mesh.shape}: the model axis (tensor parallelism) is not ported "
                f"yet; the data axis is (see ROADMAP.md)")

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: Union[str, Tuple[int, ...]], device=None,
                  backend: Optional[str] = None) -> "Distribution":
        """Parse a ``--mesh`` flag: "4" -> (data=4,); "4,1" -> (data, model);
        "2,16,16" -> (pod, data, model)."""
        dims = tuple(int(x) for x in spec.split(",")) if isinstance(spec, str) else tuple(spec)
        names = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}
        if len(dims) not in names:
            raise ValueError(f"--mesh wants 1-3 comma-separated dims, got {spec!r}")
        return cls(mesh_lib.make_mesh(dims, names[len(dims)]),
                   None if device is None else str(device), backend)

    # -- topology -----------------------------------------------------------

    @property
    def dp_size(self) -> int:
        """Data parallelism: the number of ranks."""
        return mesh_lib.dp_size(self.mesh)

    @property
    def tp_size(self) -> int:
        return mesh_lib.tp_size(self.mesh)

    @property
    def rank(self) -> int:
        return tdist.get_rank() if tdist.is_initialized() else 0

    @property
    def world_size(self) -> int:
        return tdist.get_world_size() if tdist.is_initialized() else 1

    @property
    def device(self) -> torch.device:
        local = int(os.environ.get("LOCAL_RANK", self.rank))
        return procs.rank_device(self.device_spec, local)

    @property
    def backend_name(self) -> str:
        return self.backend or procs.default_backend(self.device)

    def check_group(self) -> None:
        """Refuse to run without a process group of ``dp_size`` ranks on the
        backend this distribution names (raises before any work)."""
        if not tdist.is_initialized():
            raise ProcessGroupError(
                f"mesh {self.mesh.shape} needs {self.dp_size} ranks in a torch.distributed "
                f"group: start them with repro_torch.dist.procs.spawn, torchrun, or "
                f"python -m repro_torch.launch.train --mesh {self.dp_size}")
        if self.world_size != self.dp_size:
            raise ProcessGroupError(f"mesh {self.mesh.shape} wants {self.dp_size} ranks, the "
                                    f"process group has {self.world_size}")
        if tdist.get_backend() != self.backend_name:
            raise ProcessGroupError(f"the process group runs {tdist.get_backend()}, this "
                                    f"distribution asks for {self.backend_name}")
        procs.check_backend(self.backend_name, self.world_size, self.device_spec)

    def workers_of(self, rank: int, n_workers: int) -> range:
        """The contiguous DropCompute workers (rows of the (W, M) latencies,
        blocks of the global batch) that ``rank`` computes."""
        r = self.dp_size
        if n_workers % r:
            raise IndivisibleWorkersError(
                f"{n_workers} DropCompute workers do not split evenly over {r} ranks")
        k = n_workers // r
        return range(rank * k, (rank + 1) * k)

    # -- collectives --------------------------------------------------------

    def shard(self, tree: Tree) -> Tree:
        """Make ``tree``'s tensors rank 0's on every rank, in place (a
        broadcast from rank 0; the reference's ``jax.device_put``)."""
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                tdist.broadcast(leaf, src=0)
        return tree

    def all_reduce_sum(self, tensors) -> None:
        """Sum each tensor over the ranks, in place: one collective each,
        in the order given, issued on the current stream's work."""
        for t in tensors:
            tdist.all_reduce(t, op=tdist.ReduceOp.SUM)

    def barrier(self) -> None:
        dev = self.device
        if self.backend_name == "nccl":
            tdist.barrier(device_ids=[dev.index])
        else:
            tdist.barrier()

    # -- step builders ------------------------------------------------------

    def train_step(self, cfg, shape, drop, **kw) -> StepBundle:
        """This rank's DropCompute train step (``launch.steps.make_train_step``;
        ``kw`` forwards optimizer, lr, clip_norm, weight_decay).
        ``n_workers`` defaults to the mesh's dp size."""
        n_workers = kw.pop("n_workers", None) or self.dp_size
        opt, step = S.make_train_step(cfg, shape, drop, n_workers, dist=self, **kw)
        return StepBundle(fn=step, opt=opt)
