"""``Distribution``: the data-parallel path's one object (port of
``repro.dist.api``, ``api.py:57-162``, on the pod and data axes).

A ``Distribution`` holds a mesh (``dist.mesh``), this rank's device and
the backend, and talks to the ``torch.distributed`` process group this
process belongs to (``dist.procs`` makes one).  Each rank is a process at
the mesh coordinates ``mesh.coords`` gives it; the product of the data
axes' sizes is the number of ranks, and each rank computes the
micro-batches of ``W / R`` of the ``W`` DropCompute workers.

Placements are the reference's path rules (``dist.sharding``): with a data
axis above 1, every leaf whose spec names "data" is stored as this rank's
slice along that dimension (ZeRO: the master parameters and the optimizer
moments alike), split over the data ranks of the rank's pod and the same on
every pod; the other leaves are whole on every rank.  ``shard`` turns rank
0's whole tree into this rank's slices, ``gather`` puts a whole tree back
together, and the step's collectives (``all_reduce_sum`` over every rank,
``reduce_scatter`` and ``all_gather`` of one leaf along its split
dimension, ``sum_over_data`` for norms) run on the subgroups of the mesh.
One rank, or a data axis of 1, splits nothing: every leaf is whole.

    dist = Distribution.from_spec("2", device="cpu")   # --mesh 2, gloo
    bundle = dist.train_step(cfg, shape, drop, n_workers=4)
    params = dist.shard(params)                         # this rank's slices
    params, opt_state, metrics = bundle(params, bundle.opt.init(params), batch, latencies)

The model axis (tensor parallelism) and the serving steps are not ported:
a mesh with ``model > 1`` raises ``UnsupportedDistError``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.distributed as tdist

from ..launch import steps as S
from ..optim import ShardNorms
from . import mesh as mesh_lib
from . import procs
from . import sharding as rules

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
    def for_devices(cls, n_devices: Optional[int] = None, model_parallel: int = 1, device=None,
                    backend: Optional[str] = None) -> "Distribution":
        """A (data, model) mesh over ``n_devices`` ranks (None: one a visible
        CUDA device).  ``model_parallel`` above 1 raises
        ``UnsupportedDistError`` (the model axis is not ported)."""
        n = torch.cuda.device_count() if n_devices is None else n_devices
        if n < 1 or n % model_parallel:
            raise ValueError(f"{n} devices do not split into a model axis of {model_parallel}")
        return cls(mesh_lib.make_mesh((n // model_parallel, model_parallel), ("data", "model")),
                   None if device is None else str(device), backend)

    @classmethod
    def production(cls, multi_pod: bool = False, device=None,
                   backend: Optional[str] = None) -> "Distribution":
        """The reference's production mesh, (data 16, model 16) or (pod 2,
        data 16, model 16).  Its 16-way model axis raises
        ``UnsupportedDistError`` until the model axis is ported."""
        dims = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        return cls(mesh_lib.make_mesh(dims, names), None if device is None else str(device),
                   backend)

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
    def data_size(self) -> int:
        """The ranks a split leaf is split over (a pod's data ranks)."""
        return self.mesh.shape.get("data", 1)

    @property
    def pod_size(self) -> int:
        return self.mesh.shape.get("pod", 1)

    @property
    def coords(self):
        """This rank's mesh coordinates (``mesh.coords``)."""
        return mesh_lib.coords(self.mesh, self.rank)

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

    # -- placements (ref ``api.py:102-126``) --------------------------------

    def spec_for_path(self, path: str, shape) -> tuple:
        return rules.spec_for_path(path, shape, self.mesh)

    def param_shardings(self, params: Tree) -> Tree:
        return rules.param_shardings(params, self.mesh)

    def opt_shardings(self, opt_state: Tree) -> Tree:
        return rules.opt_shardings(opt_state, self.mesh)

    def cache_shardings(self, cache: Tree, shard_seq: bool = False) -> Tree:
        return rules.cache_shardings(cache, self.mesh, shard_seq=shard_seq)

    def batch_shardings(self, cfg, shape) -> Tree:
        return S.batch_shardings(cfg, shape, self.mesh)

    def replicated(self) -> tuple:
        return ()

    def split_dim(self, spec) -> Optional[int]:
        """The dimension a leaf of ``spec`` is split along over the data
        ranks; None when the leaf is whole on every rank (no "data" entry,
        or a data axis of 1)."""
        if self.data_size == 1:
            return None
        return next((i for i, e in enumerate(spec) if e == "data"), None)

    def split_dims(self, whole: Tree) -> list:
        """``split_dim`` of every leaf of the whole parameter tree ``whole``
        (tensors or meta tensors), in ``tree_leaves`` order."""
        return [self.split_dim(s) for s in rules.leaf_specs(whole, self.mesh)]

    def own_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of the whole leaf ``x`` along ``dim``: a view."""
        n = x.shape[dim] // self.data_size
        return x.narrow(dim, self.coords["data"] * n, n)

    def part_of(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of the whole leaf ``x`` along ``dim``, as a
        tensor of its own."""
        return self.own_rows(x, dim).clone(memory_format=torch.contiguous_format)

    def whole_shape(self, part_shape, dim: int) -> tuple:
        shape = list(part_shape)
        shape[dim] *= self.data_size
        return tuple(shape)

    def shard(self, tree: Tree, shardings: Optional[Tree] = None) -> Tree:
        """This rank's slices of rank 0's tree (the reference's
        ``jax.device_put`` onto ``shardings``, by default
        ``param_shardings(tree)``): each tensor is broadcast from rank 0 in
        place, then a split leaf's slice is taken (``part_of``); whole
        leaves, and Python numbers, are returned as they are."""
        if shardings is None:
            shardings = self.param_shardings(tree)

        def leaf(x, spec):
            if not isinstance(x, torch.Tensor):
                return x
            tdist.broadcast(x, src=0)
            dim = self.split_dim(spec)
            return x if dim is None else self.part_of(x, dim)

        return rules.zip_map(leaf, tree, shardings)

    def gather(self, tree: Tree, shardings: Tree) -> Tree:
        """The whole tree from every rank's slices (``shardings``: the whole
        tree's specs, as ``shard`` took them): a split leaf gathered into a
        new tensor on every rank, a whole leaf returned as it is."""
        def leaf(x, spec):
            dim = self.split_dim(spec) if isinstance(x, torch.Tensor) else None
            if dim is None:
                return x
            out = torch.empty(self.whole_shape(x.shape, dim), dtype=x.dtype, device=x.device)
            self.all_gather(out, x, dim)
            return out

        return rules.zip_map(leaf, tree, shardings)

    def shard_norms(self, split) -> Optional[ShardNorms]:
        """The optimizer's ``ShardNorms`` for leaves that are split where
        ``split`` says (None when none is)."""
        return ShardNorms(list(split), self.sum_over_data) if any(split) else None

    # -- collectives --------------------------------------------------------

    @functools.cached_property
    def _groups(self):
        """(data group, pod group) of this rank: the ranks that share its pod
        (a split leaf's slices) and those that share its data coordinate
        (the same slices on the other pods); None is the default (world)
        group.  Every rank makes every subgroup, in the same order, as
        ``new_group`` asks."""
        pods, data = self.pod_size, self.data_size
        if pods == 1:
            return None, None
        me, mesh = self.coords, self.mesh
        data_group = pod_group = None
        for p in range(pods):
            g = tdist.new_group([mesh_lib.rank_of(mesh, pod=p, data=d) for d in range(data)])
            data_group = g if p == me["pod"] else data_group
        for d in range(data):
            g = tdist.new_group([mesh_lib.rank_of(mesh, pod=p, data=d) for p in range(pods)])
            pod_group = g if d == me["data"] else pod_group
        return data_group, pod_group

    def all_reduce_sum(self, tensors) -> None:
        """Sum each tensor over every rank, in place: one collective each,
        in the order given, issued on the current stream's work."""
        for t in tensors:
            tdist.all_reduce(t, op=tdist.ReduceOp.SUM)

    def sum_over_data(self, t: torch.Tensor) -> None:
        """Sum ``t`` over this rank's data group, in place: partial sums of
        split leaves (a pod holds every slice once)."""
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=self._groups[0])

    def reduce_scatter(self, out: torch.Tensor, whole: torch.Tensor, dim: int) -> None:
        """``out`` = this rank's slice along ``dim`` of the sum of every
        rank's ``whole``: a reduce-scatter over the rank's data group, then
        an all-reduce of the slice over its pod group, into a buffer of its
        own that is then copied to ``out`` (which may be ``whole``'s own
        rows).  The collective splits dim 0, so an inner ``dim`` is moved
        first through a contiguous copy."""
        data_group, pod_group = self._groups
        buf = torch.empty(out.movedim(dim, 0).shape, dtype=out.dtype, device=out.device)
        tdist.reduce_scatter_tensor(buf, whole if dim == 0 else whole.movedim(dim, 0).contiguous(),
                                    group=data_group)
        if self.pod_size > 1:
            tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=pod_group)
        out.copy_(buf.movedim(0, dim))

    def all_gather(self, out: torch.Tensor, part: torch.Tensor, dim: int) -> None:
        """``out`` (a whole leaf) = every data rank's ``part`` in its place
        along ``dim``, over this rank's data group (an inner ``dim`` through
        a contiguous buffer, as ``reduce_scatter``)."""
        data_group = self._groups[0]
        if dim == 0:
            tdist.all_gather_into_tensor(out, part.contiguous(), group=data_group)
            return
        buf = torch.empty(out.movedim(dim, 0).shape, dtype=out.dtype, device=out.device)
        tdist.all_gather_into_tensor(buf, part.movedim(dim, 0).contiguous(), group=data_group)
        out.copy_(buf.movedim(0, dim))

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
