"""High-order ADER-DG: order-5 Euler through the fused GPU cell stage.

The kernel pads the six p5 nodes per axis to eight (edge-replicated node
values, zero operator columns) and runs the Picard iterations as a loop
inside the kernel.  ``--cpu`` runs it in interpret mode on a tiny grid and
checks (order+1)-order accuracy against the exact advected density wave;
on the GPU it runs a 16³ grid and reports throughput.

Reference parity: the reference family exists to run high-order ADER-DG
(SURVEY.md §0); its xDSL prototype stops at kernel specs, this runs the
scheme end to end at p5.

Run: python examples/high_order_p5.py [--cpu]
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

if CPU:
    jax.config.update("jax_enable_x64", True)
dim, order = 3, 5
grid_shape = (4, 4, 4) if CPU else (16, 16, 16)

flux, eig = euler_physics(dim=dim, n_real=5)
solver = ADERDGSolver(
    dim=dim, order=order, n_vars=5, grid_shape=grid_shape,
    flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / grid_shape[0],
)
fused = TritonADERDG(solver, interpret=CPU)

# Exact smooth solution: density wave advecting at constant velocity.
vel = (1.0, 0.5, 0.25)
gamma, p0 = 1.4, 2.0


def wave_state(t):
    coords = solver.nodes_meshgrid()
    phase = sum(c - v * t for c, v in zip(coords, vel))
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    rho = np.broadcast_to(
        np.squeeze(1.0 + 0.2 * np.sin(2 * np.pi * phase), solver.var_axis),
        no_var,
    )
    E = p0 / (gamma - 1.0) + 0.5 * rho * sum(v * v for v in vel)
    comps = [rho] + [rho * v for v in vel] + [E]
    return jnp.asarray(np.stack(comps, axis=solver.var_axis),
                       None if CPU else jnp.float32)


dt = 2e-3 if CPU else 2e-4
n_steps = 10
Q0 = wave_state(0.0)

t0 = time.perf_counter()
Q = Q0
step = jax.jit(lambda q: fused.step(q, dt))
for _ in range(n_steps):
    Q = step(Q)
err = np.asarray(jnp.abs(Q - wave_state(n_steps * dt)).max())
elapsed = time.perf_counter() - t0

mass0 = float(np.asarray(solver.total_mass(Q0))[0])
mass1 = float(np.asarray(solver.total_mass(Q))[0])
print(f"p5 fused cell stage: max error vs exact wave {err:.3e}")
print(f"mass drift {abs(mass1 - mass0):.3e}")
print(f"{n_steps} steps in {elapsed:.2f}s "
      f"({solver.dofs() * n_steps / elapsed / 1e9:.3f} GDOF/s incl. compile, "
      f"{jax.devices()[0].device_kind})")
tol = 2e-5 if CPU else 5e-3
assert err < tol, err
assert abs(mass1 - mass0) < (1e-12 if CPU else 1e-5)
print("high-order p5: accurate + conservative")
