"""The production flagship config, end to end: LIMITED ADER-DG with the
fused GPU cell stage, reflective walls, on a 2-D Euler blast.

A high-pressure disc drives a shock into a closed box: the unlimited
high-order scheme would go inadmissible at the front; the MOOD limiter
redoes troubled cells with the Dumbser subcell FV fallback (wall-aware),
while the candidate step + face fluxes run through the fused kernel
(``LimitedADERDG(accelerator=TritonADERDG(...))``).  ``--cpu`` runs it on
the CPU with the kernel in interpret mode.

Run: python examples/limited_blast_walls.py [--cpu]
"""

import sys

from exahype_jax.utils.gpu import select_platform

CPU = select_platform("--cpu" in sys.argv)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from exahype_jax.models.aderdg import (  # noqa: E402
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
)
from exahype_jax.models.aderdg_triton import TritonADERDG  # noqa: E402
from exahype_jax.models.limiter import LimitedADERDG, euler_admissible  # noqa: E402

CELLS = 16
ORDER = 3

flux, eig = euler_physics(dim=2, n_real=4)
solver = ADERDGSolver(
    dim=2,
    order=ORDER,
    n_vars=4,
    grid_shape=(CELLS, CELLS),
    flux_fn=flux,
    max_eigenvalue_fn=eig,
    dx=1.0 / CELLS,
    boundary="reflective",
    reflect_fn=euler_reflect(2),
    reflect_flux_fn=euler_reflect_flux(2),
)
# Fused cell stage supplying the limiter's candidate + face fluxes (walls
# live in the boundary-aware XLA face stage).
accel = TritonADERDG(solver, interpret=CPU)
limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2), accelerator=accel)

# Pressurized disc at the box centre.
x, y = solver.nodes_meshgrid()
r2 = (np.asarray(x) - 0.5) ** 2 + (np.asarray(y) - 0.5) ** 2
inside = np.squeeze(r2 < 0.1**2, axis=solver.var_axis)
rho = np.where(inside, 1.0, 0.125)
p = np.where(inside, 10.0, 0.1)
z = np.zeros_like(rho)
Q0 = jnp.asarray(np.stack([rho, z, z, p / 0.4], axis=solver.var_axis))

dt = 2.5e-4  # blast wave speeds ~4: stay under the ADER CFL for order 3
n_steps = 20
m0 = np.asarray(solver.total_mass(Q0))

candidate = solver.step(Q0, dt)
frac = float(np.asarray(limited.troubled_mask(Q0, candidate)).mean())
Q = jax.jit(lambda u: limited.run(u, n_steps, dt))(Q0)
m1 = np.asarray(solver.total_mass(Q))

ok = euler_admissible(dim=2)(Q, solver.var_axis)
print(f"troubled fraction on step 1: {frac:.2%}")
print(f"mass drift: {abs(m1[0] - m0[0]) / m0[0]:.2e}  "
      f"energy drift: {abs(m1[3] - m0[3]) / m0[3]:.2e}")
assert bool(np.asarray(ok).all()), "limited blast left the admissible set"
tol = 1e-10 if jax.config.jax_enable_x64 else 1e-5  # f32 direct runs
assert abs(m1[0] - m0[0]) / m0[0] < tol
assert abs(m1[3] - m0[3]) / m0[3] < tol
assert frac > 0, "blast setup should trip the limiter"
print("limited ADER-DG blast in a closed box: admissible + conservative ✓")
