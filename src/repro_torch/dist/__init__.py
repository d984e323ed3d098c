"""repro_torch.dist — the data-parallel path (port of ``repro.dist`` on
the data axis).

* ``repro_torch.dist.mesh``  — mesh arithmetic (a mesh is the dims and
  names of its axes).
* ``repro_torch.dist.api``   — ``Distribution``: mesh, device, backend, the
  broadcast and the All-Reduce, and the train step builder.
* ``repro_torch.dist.procs`` — process groups: ``spawn`` local ranks,
  ``init_from_env`` under ``torchrun``, a one-rank ``local_group``.

Not ported yet: the model axis, the FSDP sharding rules and the serving
steps (``ROADMAP.md``, Queue 1 item 5).
"""
from .api import (
    Distribution,
    IndivisibleWorkersError,
    ProcessGroupError,
    StepBundle,
    UnsupportedDistError,
)
from .mesh import DATA_AXES, Mesh, axes_size, dp_axes, dp_size, make_mesh, tp_size
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
    "dp_axes",
    "dp_size",
    "make_mesh",
    "tp_size",
    "NotEnoughDevicesError",
    "RankFailed",
    "SpawnTimeout",
    "init_from_env",
    "local_group",
    "spawn",
]
