"""Relativistic hydrostatic atmosphere on a Schwarzschild window.

The real astrophysics geometry end to end: GRHD on a conformally-flat
static background (`models/grhd_cfc.py`) over a WINDOW of the
isotropic-coordinate Schwarzschild exterior — the lapse α and conformal
factor ψ vary radially in both coordinates — with exact-solution
Dirichlet boundaries on all four walls (`boundary="dirichlet"` +
`make_dirichlet_fn`).

The Tolman profile p = p₀α^{−k} (ρ = p/c², k = 1/c² + γ/(γ−1)) is an
exact stationary solution in ANY conformally-flat static metric (the
conformal-trace source cancels ∂√γ from the pressure flux exactly), so
the run's momentum residual is pure discretization error: the script
measures it at two resolutions and reports the convergence rate, then
writes a VTK snapshot (lapse + density) for ParaView.

Run: python examples/schwarzschild_atmosphere.py [--cpu]
"""

import sys
import tempfile

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import grhd, grhd_cfc
from exahype_jax.models.aderdg import (
    ADERDGSolver,
    make_dirichlet_fn,
    wrap_var_last,
)
from exahype_jax.utils.output import write_vtk_aderdg

GAMMA = 5.0 / 3.0
C2 = 1.0
K = grhd.hydrostatic_exponent(C2, GAMMA)
M = 1.0
CENTER = (-3.5, -3.5)  # the window [0,1]² sits at r ≈ 5–7.8 M
on_cpu = jax.default_backend() == "cpu"
resolutions = (8, 16) if on_cpu else (16, 32)
n_steps = 10 if on_cpu else 40


def exact_state(x, y):
    rx, ry = x - CENTER[0], y - CENTER[1]
    r = np.sqrt(rx * rx + ry * ry)
    alpha, psi, dadr, dpdr = (
        np.asarray(v) for v in grhd_cfc.schwarzschild_isotropic(r, M)
    )
    nx, ny = rx / r, ry / r
    dalpha = np.stack([dadr * nx, dadr * ny], -1)
    dpsi = np.stack([dpdr * nx, dpdr * ny], -1)
    p = 0.2 * alpha ** (-K)
    rho = p / C2
    v = np.zeros(r.shape + (2,))
    return np.asarray(grhd_cfc.pack_state(
        jnp.asarray(rho), jnp.asarray(v), jnp.asarray(p),
        jnp.asarray(alpha), jnp.asarray(psi), jnp.asarray(dalpha),
        jnp.asarray(dpsi), gamma=GAMMA,
    ))


errs = []
solver = None
out = None
for cells in resolutions:
    flux, eig = grhd_cfc.grhd_cfc(dim=2, gamma=GAMMA)
    solver = ADERDGSolver(
        dim=2, order=3, n_vars=grhd_cfc.n_vars(2), grid_shape=(cells, cells),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / cells,
        dissipation_mask=grhd_cfc.grhd_cfc_dissipation_mask(2),
        boundary="dirichlet",
        dirichlet_fn=make_dirichlet_fn(
            exact_state, dim=2, order=3, grid_shape=(cells, cells),
            dx=1.0 / cells,
        ),
    )
    solver.source_fn = grhd_cfc.grhd_cfc_source(2, gamma=GAMMA)
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    Y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)
    u = jnp.asarray(np.moveaxis(exact_state(X, Y), -1, solver.var_axis))
    out = jax.jit(lambda q: solver.run(q, n_steps, 1e-3))(u)
    out.block_until_ready()
    dS = np.asarray(jnp.take(out, jnp.asarray([1, 2]), solver.var_axis)
                    - jnp.take(u, jnp.asarray([1, 2]), solver.var_axis))
    errs.append(np.abs(dS).max())
    print(f"{cells:3d}² cells: momentum residual after {n_steps} steps "
          f"= {errs[-1]:.3e}")

rate = np.log2(errs[0] / errs[1])
vtk = write_vtk_aderdg(
    tempfile.NamedTemporaryFile(suffix=".vtk", delete=False).name, solver, out,
    var_names=[f"q{i}" for i in range(grhd_cfc.n_vars(2))],
    points_per_cell=2,
)
print(f"convergence rate: {rate:.2f} (scheme order 3)")
print(f"VTK snapshot: {vtk}")
assert np.isfinite(np.asarray(out)).all()
assert rate > 3.0, rate
print("OK")
