"""Compressible Navier–Stokes: decaying Taylor–Green vortex.

The advection–diffusion application class (ExaHyPE's
CompressibleNavierStokes) end to end: the Euler hyperbolic flux plus
Stokes stress + Fourier heat flux (`models/navier_stokes.py`) through
the ADER-DG solver's viscous-flux contract, on a periodic 2-D box.

The low-Mach Taylor–Green velocity field decays at the exact
incompressible rate 2ν(2π)², so its kinetic energy (quadratic) decays
at 4ν(2π)² (to O(Mach²) compressible corrections); the run measures
the KE rate, checks
conservation (mass, momentum, total energy including viscous heating),
and writes a VTK snapshot of the vorticity-carrying momentum field.

Run: python examples/navier_stokes_vortex.py [--cpu]
"""

import sys
import tempfile

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import euler
from exahype_jax.models import navier_stokes as ns
from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.utils.output import write_vtk_aderdg

on_cpu = jax.default_backend() == "cpu"
cells = 8 if on_cpu else 32
order = 3
MU = 5e-3
V0 = 1e-2  # low Mach: compressible corrections O(V0²) below the anchor

f, e, vf, ve = ns.navier_stokes(dim=2, mu=MU, prandtl=0.7)
solver = ADERDGSolver(
    dim=2, order=order, n_vars=4, grid_shape=(cells, cells),
    flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
    visc_flux_fn=ns.wrap_visc_var_last(vf),
    visc_eigenvalue_fn=wrap_var_last(ve),
    dx=1.0 / cells,
)

coords = solver.nodes_meshgrid()
no_var = solver.state_shape[:2] + solver.state_shape[3:]
X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
Y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)
vx = V0 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
vy = -V0 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
rho = np.ones_like(X)
p = np.ones_like(X)
E = p / (euler.GAMMA - 1) + 0.5 * (vx**2 + vy**2)
u = jnp.asarray(np.stack([rho, vx, vy, E], axis=solver.var_axis))

dt = float(solver.cfl_dt(u))
T = 0.25
n_steps = max(1, int(round(T / dt)))
T = n_steps * dt


def kinetic(q):
    r = jnp.take(q, 0, solver.var_axis)
    mx = jnp.take(q, 1, solver.var_axis)
    my = jnp.take(q, 2, solver.var_axis)
    return float(jnp.sum(0.5 * (mx * mx + my * my) / r))


out = jax.jit(lambda q: solver.run(q, n_steps, dt))(u)
out.block_until_ready()

rate = np.log(kinetic(u) / kinetic(out)) / T
exact = 4.0 * MU * (2 * np.pi) ** 2  # KE is quadratic in the velocity
m0 = np.asarray(solver.total_mass(u))
m1 = np.asarray(solver.total_mass(out))
drift = np.abs(m1 - m0).max()

vtk = write_vtk_aderdg(
    tempfile.NamedTemporaryFile(suffix=".vtk", delete=False).name, solver, out,
    var_names=["rho", "mx", "my", "E"], points_per_cell=2,
)

print(f"steps={n_steps} dt={dt:.3e} T={T:.4f}")
print(f"KE decay rate measured={rate:.5f} exact=4nu(2pi)^2={exact:.5f} "
      f"rel err={abs(rate - exact) / exact:.2e}")
print(f"conservation drift (mass/momentum/energy) = {drift:.3e}")
print(f"VTK snapshot: {vtk}")
assert np.isfinite(np.asarray(out)).all()
assert abs(rate - exact) / exact < 2e-2, (rate, exact)
assert drift < 1e-11
print("OK")
