"""repro_torch.dist — the data-parallel path (port of ``repro.dist`` on
the pod and data axes).

* ``repro_torch.dist.mesh``     — mesh arithmetic (a mesh is the dims and
  names of its axes; ``coords`` places a rank on it, row-major).
* ``repro_torch.dist.sharding`` — the reference's path-based sharding rules
  (params, optimizer state, decode caches, batches) as plain-tuple specs.
* ``repro_torch.dist.api``      — ``Distribution``: mesh, device, backend,
  the placements, ``shard`` / ``gather`` of ZeRO slices, the step's
  collectives over the mesh's subgroups, and the train step builder.
* ``repro_torch.dist.procs``    — process groups: ``spawn`` local ranks,
  ``init_from_env`` under ``torchrun``, a one-rank ``local_group``.

Not ported yet: the model axis (tensor parallelism; ``production``'s
meshes need it), the serving steps under a ``Distribution`` and the
dry-run (``ROADMAP.md``, Queue 1).
"""
from .api import (
    Distribution,
    IndivisibleWorkersError,
    ProcessGroupError,
    StepBundle,
    UnsupportedDistError,
)
from .mesh import DATA_AXES, Mesh, axes_size, coords, dp_axes, dp_size, make_mesh, rank_of, tp_size
from .sharding import (
    batch_spec,
    cache_shardings,
    opt_shardings,
    param_shardings,
    spec_for_path,
)
from .procs import (
    NotEnoughDevicesError,
    RankFailed,
    SpawnTimeout,
    init_from_env,
    local_group,
    spawn,
)

__all__ = [
    "Distribution",
    "StepBundle",
    "IndivisibleWorkersError",
    "ProcessGroupError",
    "UnsupportedDistError",
    "DATA_AXES",
    "Mesh",
    "axes_size",
    "coords",
    "dp_axes",
    "dp_size",
    "make_mesh",
    "rank_of",
    "tp_size",
    "batch_spec",
    "cache_shardings",
    "opt_shardings",
    "param_shardings",
    "spec_for_path",
    "NotEnoughDevicesError",
    "RankFailed",
    "SpawnTimeout",
    "init_from_env",
    "local_group",
    "spawn",
]
