"""Tree-structured refinement: an arbitrary scattered set of fine patches.

The box-based hierarchy (``examples/dynamic_refinement.py``) refines one
rectangle.  :class:`exahype_jax.parallel.pool.PatchPoolRefinement` lifts
that restriction: ANY set of coarse patches refines into a static-capacity
pool of fine patches, and the pattern (slot coordinates / activity /
neighbour tables) is plain array data consumed by ONE jitted step — the
criteria-driven loop re-grids every chunk without ever recompiling.

This example advects a diagonal bump: the refinement set follows it as a
scattered cluster (not a box), mass is conserved to rounding through every
re-grid, and the run reports that a single compiled executable served all
patterns.

Run: python examples/tree_refinement.py [--cpu]
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import hyperbolic
from exahype_jax.models.fv import build_fv_rusanov_kernel
from exahype_jax.parallel import DynamicPoolRefinement, GridSolver, PatchGrid
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.output import assemble_global, disassemble_global

GX = GY = 6
PATCH = 4
VELOCITY = (1.0, 0.7)

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

# Gaussian bump off-centre so it crosses several patches diagonally.
n = GX * PATCH
x = (np.arange(n) + 0.5) / n
X, Y = np.meshgrid(x, x, indexing="ij")
u0 = np.exp(-(((X - 0.25) ** 2 + (Y - 0.3) ** 2) / 0.08**2))
Q = disassemble_global(grid, jnp.zeros(grid.state_shape), jnp.asarray(u0[..., None]))


def mass(state):
    return float(np.asarray(assemble_global(grid, state))[..., 0].sum()) * solver.dx**2


m0 = mass(Q)
dyn = DynamicPoolRefinement(solver, capacity=6, factor=2, rel_threshold=0.6)
Q, fine_Q, info = dyn.run(Q, n_chunks=10, chunk_steps=8, dt=2.0e-3)

for i, m in enumerate(info["masks"]):
    coords = [tuple(c) for c in np.argwhere(m)]
    print(f"chunk {i}: refined patches {coords}")

distinct = len({tuple(map(tuple, m)) for m in info["masks"]})
(chunk_fn,) = dyn._chunk.values()
print(f"distinct refinement sets: {distinct}")
print(f"compiled executables: {chunk_fn._cache_size()}")
print(f"mass drift: {mass(Q) - m0:.3e}")
assert distinct > 1 and chunk_fn._cache_size() == 1
assert abs(mass(Q) - m0) < 1e-12 * abs(m0)
print("tracked + conserved with one compile")
