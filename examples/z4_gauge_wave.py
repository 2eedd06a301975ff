"""Dynamic spacetime: vacuum Z4 evolution of the AwA gauge wave.

The reference family's flagship astrophysics application (ExaGRyPE)
evolves the Einstein equations as a first-order fluxless NCP system with
ADER-DG.  This example runs that configuration end to end: the 38-variable first-order Z4 system (`models/z4.py`, harmonic
slicing, zero shift) on the canonical Apples-with-Apples gauge-wave
metric

    ds² = −H dt² + H dx² + dy² + dz²,   H = 1 − a·sin(2π(x−t)/L),

an exact solution the evolved state must track while the ADM constraints
(H, M_i) stay at rounding level (they vanish algebraically on this
data's sparsity pattern — see tests/test_z4.py).

Reference parity: the reference repo bundles only Euler physics
(`Unit test/Functions.cpp:9-62`); the downstream family's FO-CCZ4 runs
exactly this shape — pure NCP + algebraic source through ADER-DG.

Run: python examples/z4_gauge_wave.py [--cpu]
"""

import sys
import time

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from exahype_jax.models.z4 import (
    gauge_wave_state,
    make_z4_solver,
    solver_constraints,
)

on_cpu = jax.default_backend() == "cpu"
cells = 8 if on_cpu else 64
order = 3
t_end = 0.1

# impl="soa": the component-unrolled RHS; identical algebra to rounding,
# so the CPU accuracy assertions below hold for either layout.
solver = make_z4_solver(
    dim=2, order=order, grid_shape=(cells, 2), dx=1.0 / cells,
    slicing="harmonic", f=1.0, impl="einsum" if on_cpu else "soa",
)
Q0 = gauge_wave_state(solver, t=0.0, amplitude=0.01)
n_steps = 4 * cells
dt = t_end / n_steps

t0 = time.perf_counter()
Q = solver.run(Q0, n_steps, dt=dt)
Q.block_until_ready()
elapsed = time.perf_counter() - t0

exact = gauge_wave_state(solver, t=t_end, amplitude=0.01)
err = float(jnp.sqrt(jnp.mean((Q - exact) ** 2)))
H, M = solver_constraints(solver, Q)
cmax = max(float(jnp.abs(H).max()), float(jnp.abs(M).max()))

dofs = int(np.prod(solver.state_shape)) * n_steps
print(
    f"Z4 gauge wave: order {order}, {cells} cells, {n_steps} steps "
    f"in {elapsed:.2f}s ({dofs / elapsed / 1e6:.1f} MDOF-updates/s)"
)
print(f"  L2 error vs exact translated wave: {err:.3e}")
print(f"  max ADM constraint (H, M): {cmax:.3e}")
assert err < (5e-5 if on_cpu else 5e-4), err
assert cmax < 1e-10 if on_cpu else cmax < 1e-3, cmax
print("OK")
