"""The PRODUCTION limited configuration, as benched (bench.py's limited
cell): 3-D compressible-Euler ADER-DG p3 with

- the fused GPU cell stage supplying the candidate AND the per-direction
  face fluxes,
- a-posteriori MOOD detection (relaxed DMP + Euler admissibility),
- the ROW-GATHERED subcell FV fallback (``troubled_capacity`` counts
  last-axis rows; each gather moves whole contiguous rows), and
- DG/FV interface matching, so the composite conserves to rounding.

Run: python examples/limited_shock_production.py [--cpu]
(``--cpu`` runs the kernel in interpret mode on a smaller grid.)
"""

import sys

from exahype_jax.utils.gpu import select_platform

CPU = select_platform("--cpu" in sys.argv)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from exahype_jax.models.aderdg import ADERDGSolver, euler_physics  # noqa: E402
from exahype_jax.models.aderdg_triton import TritonADERDG  # noqa: E402
from exahype_jax.models.limiter import LimitedADERDG, euler_admissible  # noqa: E402

grid_shape = (16, 4, 8) if CPU else (64, 64, 64)
capacity_rows = 32 if CPU else 1024  # last-axis rows, not cells

flux, eig = euler_physics(dim=3, n_real=5)
solver = ADERDGSolver(
    dim=3, order=3, n_vars=5, grid_shape=grid_shape,
    flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / grid_shape[0],
)
limited = LimitedADERDG(
    solver,
    admissible=euler_admissible(dim=3, gamma=1.4),
    troubled_capacity=capacity_rows,
    troubled_granularity="row",
    accelerator=TritonADERDG(solver, interpret=CPU),
)

# Planar Sod-like shock along axis 0.
x = np.arange(grid_shape[0]).reshape(-1, 1, 1) / grid_shape[0]
left = np.broadcast_to(x < 0.5, grid_shape)
no_var = (
    solver.state_shape[: solver.var_axis]
    + solver.state_shape[solver.var_axis + 1 :]
)
rho = np.broadcast_to(np.where(left, 1.0, 0.125), no_var).astype(np.float32)
p = np.broadcast_to(np.where(left, 1.0, 0.1), no_var).astype(np.float32)
z = np.zeros(no_var, np.float32)
Q = jnp.asarray(np.stack([rho, z, z, z, p / 0.4], axis=solver.var_axis))
dt = jnp.asarray(0.04 / grid_shape[0], np.float32)


def main():
    m0 = np.asarray(solver.total_mass(Q))
    n_steps = 3 if CPU else 20
    out = jax.jit(lambda q: limited.run(q, n_steps, dt))(Q)
    m1 = np.asarray(solver.total_mass(out))
    ok = euler_admissible(dim=3, gamma=1.4)(out, solver.var_axis)
    print(f"steps: {n_steps}, grid: {grid_shape}, capacity: {capacity_rows} rows")
    print(f"mass drift:  {m1[0] - m0[0]:+.3e}")
    print(f"energy drift:{m1[4] - m0[4]:+.3e}")
    print(f"admissible everywhere: {bool(np.asarray(ok).all())}")
    assert bool(np.asarray(jnp.isfinite(out)).all())


if __name__ == "__main__":
    main()
