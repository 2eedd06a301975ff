"""Criteria-driven re-gridding: adaptive refinement over scan chunks.

The two-level hierarchy (:class:`NestedRefinement`) is static per
compilation — every shape is fixed so the coupled step jits.  Adaptivity
happens BETWEEN chunks, the standard recipe for AMR under XLA; the loop
lives in :class:`exahype_jax.parallel.refine.DynamicRefinement`: integrate
a chunk, score patches with a host-side criterion, move the refined region
to track the feature, rebuild the hierarchy (prolonging the new region from
the running coarse solution), and continue.  Compiled steps are cached per
region shape, so re-gridding costs one trace the first time each shape
appears.

Run: python examples/dynamic_refinement.py [--cpu]
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import hyperbolic
from exahype_jax.models.fv import build_fv_rusanov_kernel
from exahype_jax.parallel import GridSolver, PatchGrid
from exahype_jax.parallel.refine import DynamicRefinement
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.output import assemble_global, disassemble_global

GX = GY = 6
PATCH = 4
VELOCITY = (1.0, 0.0)

cfg = KernelConfig(
    dim=2, patch_size=PATCH, halo_size=1, n_real=1, n_aux=0, n_patches=GX * GY
)
grid = PatchGrid(config=cfg, grid_shape=(GX, GY))
flux, eig = hyperbolic.advection(VELOCITY)
kb = build_fv_rusanov_kernel(
    dim=2, patch_size=PATCH, halo_size=1, n_real=1, n_aux=0,
    n_patches=GX * GY, flux_impl=flux, eigenvalue_impl=eig,
)
solver = GridSolver(grid, kb, dx=1.0 / (GX * PATCH), kernel_dt="lambda")

# Gaussian bump near the left edge, advecting right.
n = GX * PATCH
x = (np.arange(n) + 0.5) / n
X, Y = np.meshgrid(x, x, indexing="ij")
u0 = np.exp(-(((X - 0.2) ** 2 + (Y - 0.5) ** 2) / 0.08**2))
coarse_Q = disassemble_global(grid, jnp.zeros(grid.state_shape), jnp.asarray(u0[..., None]))


dt = 2.5e-3
chunk = 8
n_chunks = 10

dyn = DynamicRefinement(solver)  # default criterion: gradient_indicator
coarse_Q, fine_Q, info = dyn.run(coarse_Q, n_chunks=n_chunks, chunk_steps=chunk, dt=dt)
regions = info["regions"]

g = np.asarray(assemble_global(grid, coarse_Q))[..., 0]
print("chunks:", n_chunks, "| refined regions visited:", sorted(set(regions)))
print(f"final max={g.max():.3f} at x={x[np.unravel_index(g.argmax(), g.shape)[0]]:.3f} "
      f"(bump started at 0.2, advected {dt * chunk * n_chunks:.3f})")
assert len(set(regions)) > 1, "region should track the moving bump"
print("refined region tracked the feature ✓")
