"""North-star demo: 3-D compressible Euler, ADER-DG order 3.

Runs the BASELINE.md target configuration end to end: a smooth density wave
on a periodic cell grid, integrated with the space-time predictor/corrector
through the fused GPU cell stage, reporting conservation drift and
throughput.  ``--cpu`` runs a tiny grid on the CPU with the kernel in
interpret mode.

Run: python examples/aderdg_euler3d.py [--cpu]
"""

import sys
import time

from exahype_jax.utils.gpu import select_platform

CPU = select_platform("--cpu" in sys.argv)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from exahype_jax.models.aderdg import ADERDGSolver, euler_physics  # noqa: E402
from exahype_jax.models.aderdg_triton import TritonADERDG  # noqa: E402

dim, order = 3, 3
grid_shape = (4, 4, 4) if CPU else (64, 64, 64)

flux, eig = euler_physics(dim=dim, n_real=5)
solver = ADERDGSolver(
    dim=dim,
    order=order,
    n_vars=5,
    grid_shape=grid_shape,
    flux_fn=flux,
    max_eigenvalue_fn=eig,
    dx=1.0 / grid_shape[0],
)

coords = solver.nodes_meshgrid()
phase = sum(coords)
no_var = solver.state_shape[: solver.var_axis] + solver.state_shape[solver.var_axis + 1 :]
rho = 1.0 + 0.2 * np.sin(2 * np.pi * np.broadcast_to(np.squeeze(phase, solver.var_axis), no_var))
Q = jnp.asarray(
    np.stack(
        [rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125],
        axis=solver.var_axis,
    ),
    dtype=None if CPU else jnp.float32,
)

dt = float(solver.cfl_dt(Q))
n_steps = 20
mass0 = np.asarray(solver.total_mass(Q))

fused = TritonADERDG(solver, interpret=CPU)
run = jax.jit(lambda q: fused.run(q, n_steps, dt))
out = run(Q)
out.block_until_ready()
t0 = time.perf_counter()
out = run(Q)
out.block_until_ready()
elapsed = time.perf_counter() - t0

drift = np.abs(np.asarray(solver.total_mass(out)) - mass0).max()
print(f"grid {grid_shape}, order {order}, dt={dt:.2e}")
print(f"conservation drift: {drift:.3e}")
print(f"throughput: {solver.dofs() * n_steps / elapsed / 1e9:.3f} GDOF/s "
      f"on {jax.devices()[0].device_kind}")
