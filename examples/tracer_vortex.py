"""Tracer particles riding a 2-D isentropic Euler vortex.

The ExaHyPE2-toolbox capability this demonstrates: massless Lagrangian
tracers advected with the flow, recording the solution along their
trajectories — here seeded around a Gaussian isentropic vortex superposed
on a uniform background stream.  The exact Euler solution advects the
vortex rigidly with the background velocity, so:

- a tracer seeded at the vortex CENTRE drifts with exactly the background
  velocity (it sits at the zero of the rotational field), and
- ring tracers both drift AND circulate.

The script verifies the centre-tracer drift against the exact value and
prints the ring tracers' accumulated rotation angle.

Run on CPU with ``--cpu``; on the GPU the grid is larger.
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
from exahype_jax.models.tracers import TracerAdvector, euler_velocity

GAMMA = 1.4
dim, order = 2, 3
on_cpu = jax.default_backend() == "cpu"
grid_shape = (16, 16) if on_cpu else (128, 128)
# None = the platform default (f64 under the x64-enabled test suite).
dtype = None if on_cpu else np.float32

flux, eig = euler_physics(dim=dim, n_real=4)
solver = ADERDGSolver(
    dim=dim,
    order=order,
    n_vars=4,
    grid_shape=grid_shape,
    flux_fn=flux,
    max_eigenvalue_fn=eig,
    dx=1.0 / grid_shape[0],
)

# Gaussian isentropic vortex at (0.5, 0.5), strength beta, background (u0, v0).
u0, v0, beta = 0.4, 0.2, 0.15
coords = solver.nodes_meshgrid()
no_var = (
    solver.state_shape[: solver.var_axis]
    + solver.state_shape[solver.var_axis + 1 :]
)
X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
Y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)
r2 = ((X - 0.5) ** 2 + (Y - 0.5) ** 2) / 0.01
g = beta * np.exp(-0.5 * r2)
vx = u0 - g * (Y - 0.5) / 0.1
vy = v0 + g * (X - 0.5) / 0.1
T = 1.0 - (GAMMA - 1.0) / (2.0 * GAMMA) * g**2
rho = T ** (1.0 / (GAMMA - 1.0))
p = rho * T
E = p / (GAMMA - 1.0) + 0.5 * rho * (vx**2 + vy**2)
Q = jnp.asarray(
    np.stack([rho, rho * vx, rho * vy, E], axis=solver.var_axis), dtype
)

adv = TracerAdvector(solver, euler_velocity(dim))
# One centre tracer + a ring of 8 at radius 0.08.
ang = np.linspace(0.0, 2 * np.pi, 8, endpoint=False)
seeds = np.concatenate(
    [[[0.5, 0.5]], np.stack([0.5 + 0.08 * np.cos(ang), 0.5 + 0.08 * np.sin(ang)], -1)]
)
x0 = jnp.asarray(seeds, dtype)

dt = float(solver.cfl_dt(Q))
n_steps = 40

run = jax.jit(lambda q, xt: adv.trajectories(solver.step, q, xt, dt, n_steps))
Q1, x1, xs, vals = run(Q, x0)
xs = np.asarray(xs)

t_end = n_steps * dt
centre = np.asarray(x1[0])
want = np.mod(np.asarray([0.5 + u0 * t_end, 0.5 + v0 * t_end]), 1.0)
err = np.abs(centre - want).max()
print(f"centre tracer after t={t_end:.4f}: {centre}, exact {want}, err {err:.2e}")
assert err < 5e-3, "centre tracer should drift with the background stream"

# Ring rotation: angle about the (moving) vortex centre, unwrapped.
rel = xs[:, 1:, :] - (
    np.asarray([0.5, 0.5]) + np.arange(1, n_steps + 1)[:, None, None] * dt * np.asarray([u0, v0])
)
theta = np.unwrap(np.arctan2(rel[:, :, 1], rel[:, :, 0]), axis=0)
turns = (theta[-1] - theta[0]).mean() / (2 * np.pi)
print(f"ring tracers: mean rotation {turns:+.3f} turns over {n_steps} steps")
assert turns > 0.005, "ring tracers should circulate with the vortex"

dens = np.asarray(vals[:, 0, 0])
print(f"centre density along trajectory: min {dens.min():.6f} max {dens.max():.6f}")
print("OK")
