"""Production mesh factory.

A FUNCTION, not a module-level constant: importing this module touches
no device and no process group. The JAX package's ``make_production_mesh``
returns a jax mesh over 256 or 512 devices; the port runs one process a
rank, so it returns the layout (shape and axis names) and, when a
process group of that world is up (the dry run's, ``launch/dryrun.py``,
or a real one), this rank's place on it: ``train_mesh`` of the plan that
tiles it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ProductionMesh:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    # this rank on the training mesh; None without a process group of
    # the mesh's world
    rank_mesh: Optional[object] = None


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """(16, 16) over ('data', 'model'), or (2, 16, 16) over ('pod',
    'data', 'model'); with a process group of that world up, also this
    rank's ``train_mesh`` of the plan that tiles it (one data row an
    engine tile)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() != required_devices(multi_pod):
        return ProductionMesh(shape, axes)
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.training.train_step import train_mesh
    plan = ParallelPlan(tp_base=16, data_rows=16, pods=2 if multi_pod else 1)
    return ProductionMesh(shape, axes, train_mesh(plan))


def required_devices(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
