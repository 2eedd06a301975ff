"""Device meshes and shardings for patch sets.

The equivalent of the reference's (absent, Peano-delegated) distributed
layer (SURVEY.md §5): patches are data-parallel over a GSPMD mesh — the
leading grid axis of a :class:`~exahype_jax.parallel.grid.PatchGrid` state is
sharded across devices, halo-exchange rolls become collective permutes, and
scalar reductions (CFL dt) become all-reduces.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from exahype_jax.utils.errors import SemanticError

PATCH_AXIS = "patches"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = PATCH_AXIS,
    devices: Optional[Sequence] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
) -> Mesh:
    """A device mesh over the patch grid.

    Default: 1-D over ``n_devices``.  Multi-axis:
    ``make_mesh(shape=(2, 2), axis_names=("x", "y"))`` — shard successive
    grid axes over the mesh axes with
    :func:`state_sharding(..., axis_name=("x", "y"))`.
    """
    if devices is None:
        devices = jax.devices()
    if shape is not None:
        total = int(np.prod(shape))
        if total > len(devices):
            raise SemanticError(
                f"mesh shape {tuple(shape)} needs {total} devices, only "
                f"{len(devices)} available"
            )
        names = tuple(axis_names or (f"axis{i}" for i in range(len(shape))))
        return Mesh(np.array(devices[:total]).reshape(shape), names)
    if n_devices is not None:
        if n_devices > len(devices):
            raise SemanticError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def state_sharding(mesh: Mesh, grid, axis_name=PATCH_AXIS) -> NamedSharding:
    """Shard the grid state over devices along its leading grid axes.

    ``axis_name`` may be a single mesh-axis name (grid axis 0 sharded) or a
    tuple of names (successive grid axes sharded over successive mesh axes).

    - :class:`PatchGrid` (AoS): grid axes lead the tensor.
    - :class:`~exahype_jax.models.aderdg.ADERDGSolver` (SoA-P): grid axes
      trail the node/var axes (``grid.grid_axis(0)`` is the first).
    """
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for i, name in enumerate(names):
        n_dev = mesh.shape[name]
        if grid.grid_shape[i] % n_dev != 0:
            raise SemanticError(
                f"grid axis {i} ({grid.grid_shape[i]}) must be divisible by "
                f"mesh axis {name!r} ({n_dev})"
            )
    ndim = len(grid.state_shape)
    lead = grid.grid_axis(0) if hasattr(grid, "grid_axis") else 0
    spec_list = [None] * ndim
    for i, name in enumerate(names):
        spec_list[lead + i] = name
    return NamedSharding(mesh, PartitionSpec(*spec_list))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_state(Q, mesh: Mesh, grid, axis_name: str = PATCH_AXIS):
    return jax.device_put(Q, state_sharding(mesh, grid, axis_name))
