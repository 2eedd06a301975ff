"""Nonlinear flow over terrain: compressible Euler on a curvilinear mesh.

Round-5 demonstrator for the NONLINEAR curvilinear capability
(`curvilinear_physics` accepts any flux — here the full compressible
Euler system) with the Kopriva curl-form discrete metrics
(`metric_fields_curl`) on the Gauss–Lobatto basis: the configuration
where free stream over the hill holds to MACHINE precision (the curl
form's in-cell metric identity is exact, and on Lobatto nodes the face
normal metric is single-valued).

Two stages, checks printed at the end:

1. **Free stream over the hill**: a uniform wind (ρ, ρu, p constant)
   blown across the terrain-deformed mesh stays uniform to rounding —
   the discrete well-balancedness nonlinear terrain flows need.
2. **Density pulse over the hill**: a warm bubble advects across the
   terrain; the run stays finite/admissible and the densitized total
   mass ∫ρ dx is conserved to rounding.

Reference-family context: curvilinear meshes are the reference family's
seismic-topography configuration (`exahype/KernelBuilder.py`-built
kernels under ExaSeis); the reference repo itself bundles only Cartesian
Euler (`Unit test/Functions.cpp:9-37`).  Run on CPU with ``--cpu``.
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import euler
from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.curvilinear import (
    curvilinear_dissipation_mask,
    curvilinear_physics,
    densitize,
    metric_fields_curl,
    n_vars_curvilinear,
    undensitize,
)

on_cpu = jax.default_backend() == "cpu"
dtype = np.float64 if (on_cpu and jax.config.jax_enable_x64) else np.float32
cells = 8 if on_cpu else 64
order = 3
DIM, N_WAVE = 2, 4
NV = n_vars_curvilinear(N_WAVE, DIM)
HILL = 0.06


def hill_mapping(p):
    """Interior Gaussian-like dome, EXACTLY periodic: the x-profile is a
    period-1 function (Gaussian of sin) and the vertical displacement
    vanishes with all derivatives matching at the y seam (sin²) — so the
    periodic box topology is untouched (the seismic_topography pattern)
    and free stream can hold to rounding."""
    x, y = p[0], p[1]
    g = jnp.exp(-jnp.sin(np.pi * (x - 0.5)) ** 2 / 0.05)
    return (x, y + HILL * g * jnp.sin(np.pi * y) ** 2)


flux = euler.flux_v_fn(dim=DIM, n_real=N_WAVE)
eig = euler.max_eigenvalue_v_fn(dim=DIM)
cflux, ceig = curvilinear_physics(flux, eig, dim=DIM, n_wave=N_WAVE)

solver = ADERDGSolver(
    dim=DIM, order=order, n_vars=NV, grid_shape=(cells, cells),
    flux_fn=wrap_var_last(cflux), max_eigenvalue_fn=wrap_var_last(ceig),
    dx=1.0 / cells, basis="lobatto",
    dissipation_mask=curvilinear_dissipation_mask(N_WAVE, DIM),
)
metric, (X, Y) = metric_fields_curl(solver, hill_mapping)
metric = metric.astype(dtype)

# ---- stage 1: free stream over the hill --------------------------------
rho0, u0, p0 = 1.0, 0.4, 1.0
E0 = p0 / (euler.GAMMA - 1.0) + 0.5 * rho0 * u0 * u0
no_var = tuple(
    s for e, s in enumerate(solver.state_shape) if e != solver.var_axis
)
ones = np.ones(no_var, dtype)
q_uniform = np.stack(
    [rho0 * ones, rho0 * u0 * ones, 0.0 * ones, E0 * ones],
    axis=solver.var_axis,
)
Q = densitize(jnp.asarray(q_uniform), metric, solver.var_axis)
dt = 2e-3 / cells * 8
out = undensitize(solver.run(Q, 10, dt), N_WAVE, solver.var_axis)
fs_err = float(
    jnp.max(jnp.abs(out - jnp.asarray(q_uniform)))
)

# ---- stage 2: warm density pulse advecting over the hill ---------------
r2 = (X - 0.25) ** 2 + (Y - 0.55) ** 2
rho = (rho0 + 0.3 * np.exp(-r2 / 0.01)).astype(dtype)
p = (p0 + 0.0 * rho).astype(dtype)
E = p / (euler.GAMMA - 1.0) + 0.5 * rho * u0 * u0
q_pulse = np.stack(
    [rho, rho * u0, np.zeros_like(rho), E], axis=solver.var_axis
)
Qp = densitize(jnp.asarray(q_pulse), metric, solver.var_axis)
w = np.asarray(solver.ops.weights)
wgt = np.multiply.outer(w, w).astype(dtype)


def total_mass(Qs):
    """∫ ρ dx = Σ cells Σ nodes w_i w_j (J ρ) dξ² — densitized row 0."""
    dens_rho = jnp.take(Qs, 0, solver.var_axis)
    return float(
        jnp.sum(jnp.asarray(wgt)[..., None, None] * dens_rho)
        * solver._dxs[0] * solver._dxs[1]
    )


m0 = total_mass(Qp)
n_steps = 50 if on_cpu else 200
Qp = solver.run(Qp, n_steps, dt)
m1 = total_mass(Qp)
qp = np.asarray(undensitize(Qp, N_WAVE, solver.var_axis))
rho_f = np.take(qp, 0, solver.var_axis)

print(f"free-stream error over terrain : {fs_err:.3e}")
print(f"pulse run finite               : {bool(np.isfinite(qp).all())}")
print(f"rho range after {n_steps} steps: "
      f"[{rho_f.min():.4f}, {rho_f.max():.4f}]")
print(f"mass drift                     : {abs(m1 - m0) / m0:.3e}")

fs_tol = 1e-11 if dtype == np.float64 else 1e-4
assert fs_err < fs_tol, fs_err
assert np.isfinite(qp).all()
assert rho_f.min() > 0.5
assert abs(m1 - m0) / m0 < (1e-12 if dtype == np.float64 else 1e-5)
print("euler_topography: nonlinear curvilinear OK")
