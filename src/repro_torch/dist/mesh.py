"""Mesh arithmetic (port of ``repro.dist.mesh``).

A mesh here is a plain value, the dims and the names of its axes: the
ranks of the process group play the devices.  The axis names are the
reference's, (data,), (data, model) or (pod, data, model); the batch is
split over the data axes, and the product of their sizes is the number of
ranks that each compute a share of the DropCompute workers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

DATA_AXES: Tuple[str, ...] = ("pod", "data")  # batch is split over these


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The dims and names of a mesh's axes, outermost first."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} and names {self.axis_names} differ in length")
        if any(d < 1 for d in self.dims):
            raise ValueError(f"mesh dims must be >= 1, got {self.dims}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return axes_size(self, self.axis_names)


def coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """The mesh coordinates of ``rank``, row-major over the axes (the last
    axis fastest)."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} is not in mesh {mesh.shape}")
    out = {}
    for name, dim in zip(reversed(mesh.axis_names), reversed(mesh.dims)):
        rank, out[name] = divmod(rank, dim)
    return {name: out[name] for name in mesh.axis_names}


def rank_of(mesh: Mesh, **at: int) -> int:
    """The rank at mesh coordinates ``at`` (an axis left out is 0)."""
    r = 0
    for name, dim in zip(mesh.axis_names, mesh.dims):
        r = r * dim + at.get(name, 0)
    return r


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    return Mesh(tuple(int(d) for d in axis_shapes), tuple(axis_names))


def axes_size(mesh: Mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, outermost first."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    """Total data parallelism: the number of ranks the workers are split over."""
    return axes_size(mesh, DATA_AXES)


def tp_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)
