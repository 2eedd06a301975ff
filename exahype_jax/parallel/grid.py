"""Patch grids and halo exchange.

The reference materializes halos as array padding (``patch_size +
2*halo_size`` ranges, ``exahype/KernelBuilder.py:76-79``) and delegates
inter-patch / inter-rank halo exchange to the downstream Peano framework
(SURVEY.md §2, parallelism inventory).  This module supplies that missing
piece:

- a :class:`PatchGrid` arranges patches in a Cartesian grid
  ``[g0, g1(, g2)]`` with state shape ``[*grid, *extent, n_vars]``;
- ``halo_fill`` copies each neighbour's interior edge slab into the local
  halo padding.  Written as plain ``jnp.roll`` + slice updates on the global
  array: under ``jit`` with the leading grid axis sharded over a device mesh,
  GSPMD lowers the rolls to collective permutes between devices — the
  scaling-book recipe (annotate shardings, let XLA insert collectives);
- periodic boundaries come for free from the roll; reflective (wall)
  boundaries overwrite the outer faces after exchange.

Patches remain independent inside a time step (the reference's
"batched stateless" property), so the kernel itself needs no communication —
only ``halo_fill`` between steps does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal, Optional

import jax.numpy as jnp

from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.errors import SemanticError

Boundary = Literal["periodic", "reflective"]


def _axis_slice(ndim: int, axis: int, lo: int, hi: int) -> tuple:
    sl = [slice(None)] * ndim
    sl[axis] = slice(lo, hi)
    return tuple(sl)


@dataclasses.dataclass(frozen=True)
class PatchGrid:
    """A Cartesian arrangement of patches covering a global domain.

    ``boundary="reflective"`` mirrors the interior into the domain-face
    halos.  The plain mirror is a SYMMETRY (slip/zero-gradient) boundary;
    for a physical wall pass ``reflect_fn(slab, axis, var_axis)`` to
    transform the mirrored ghost state per variable — e.g.
    :func:`exahype_jax.models.aderdg.euler_reflect` negates the normal
    momentum, giving an exactly zero mass flux through the wall.
    """

    config: KernelConfig
    grid_shape: tuple[int, ...]
    boundary: Boundary = "periodic"
    #: Ghost-state transform applied after the mirror flip (see class doc).
    reflect_fn: Optional[Callable] = None

    def __post_init__(self):
        if len(self.grid_shape) != self.config.dim:
            raise SemanticError(
                f"grid_shape {self.grid_shape} must have {self.config.dim} axes"
            )
        if self.config.n_patches != math.prod(self.grid_shape):
            raise SemanticError(
                f"config.n_patches ({self.config.n_patches}) must equal "
                f"prod(grid_shape) ({math.prod(self.grid_shape)})"
            )

    @property
    def state_shape(self) -> tuple[int, ...]:
        cfg = self.config
        return self.grid_shape + (cfg.extent,) * cfg.dim + (cfg.n_vars,)

    @property
    def batched_shape(self) -> tuple[int, ...]:
        """Kernel-facing shape: grid axes flattened into the patch axis."""
        cfg = self.config
        return (cfg.n_patches,) + (cfg.extent,) * cfg.dim + (cfg.n_vars,)

    def to_batched(self, Q):
        return Q.reshape(self.batched_shape)

    def from_batched(self, Q):
        return Q.reshape(self.state_shape)

    # -------------------------------------------------------------- exchange

    def halo_fill(self, Q):
        """Fill every patch's halo padding from its grid neighbours.

        Axis-by-axis slab exchange; because each axis exchanges the full
        halo-extended transverse extent, corner/edge halos are propagated
        correctly after all axes have been processed.
        """
        cfg = self.config
        h, P = cfg.halo_size, cfg.patch_size
        if h == 0:
            return Q
        nd = Q.ndim
        for d in range(cfg.dim):
            grid_ax = d
            spat_ax = cfg.dim + d
            # Slice the interior edge slabs FIRST, then roll only the slabs —
            # traffic is h/extent of the state per exchange instead of 6 full
            # passes (the slab roll still lowers to collective_permute when
            # the grid axis is sharded).
            lo_halo = jnp.roll(
                Q[_axis_slice(nd, spat_ax, P, P + h)], shift=1, axis=grid_ax
            )
            hi_halo = jnp.roll(
                Q[_axis_slice(nd, spat_ax, h, 2 * h)], shift=-1, axis=grid_ax
            )
            Q = Q.at[_axis_slice(nd, spat_ax, 0, h)].set(lo_halo)
            Q = Q.at[_axis_slice(nd, spat_ax, P + h, P + 2 * h)].set(hi_halo)
            if self.boundary == "reflective":
                Q = self._reflect(Q, d)
        return Q

    def _mirror_slab(self, slab, d: int, spat_ax: int, var_axis: int):
        """Ghost slab for a wall along ``d``: mirror flip + optional
        per-variable transform (e.g. normal-momentum negation)."""
        out = jnp.flip(slab, axis=spat_ax)
        if self.reflect_fn is not None:
            out = self.reflect_fn(out, d, var_axis)
        return out

    def _reflect(self, Q, d: int):
        """Mirror the interior into the outer faces of the domain boundary."""
        cfg = self.config
        h, P = cfg.halo_size, cfg.patch_size
        nd = Q.ndim
        grid_ax, spat_ax = d, cfg.dim + d
        n_g = self.grid_shape[d]
        var_axis = nd - 1

        def sl(grid_rng, spat_rng):
            s = [slice(None)] * nd
            s[grid_ax] = slice(*grid_rng)
            s[spat_ax] = slice(*spat_rng)
            return tuple(s)

        # Low face of grid block 0 mirrors its first h interior layers;
        # high face of the last block mirrors its last h interior layers.
        interior_lo = self._mirror_slab(Q[sl((0, 1), (h, 2 * h))], d, spat_ax, var_axis)
        interior_hi = self._mirror_slab(
            Q[sl((n_g - 1, n_g), (P, P + h))], d, spat_ax, var_axis
        )
        Q = Q.at[sl((0, 1), (0, h))].set(interior_lo)
        Q = Q.at[sl((n_g - 1, n_g), (P + h, P + 2 * h))].set(interior_hi)
        return Q
