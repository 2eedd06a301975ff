"""TOV star: the canonical strong-field stationarity validation.

A constant-density (interior-Schwarzschild) relativistic star in closed
isotropic-coordinate form (`models/tov.py`) evolved on a 3-D Cartesian
window through the stellar CORE with exact-solution Dirichlet walls:

1. **Cowling** (frozen metric, `grhd_cfc`): the fluid sits in the
   star's own gravity; the momentum residual after fixed steps measures
   how well the solver holds relativistic hydrostatic equilibrium.
2. **Coupled** (`--coupled`, dynamic spacetime, `z4_matter`): the SAME
   star evolved with the full 43-variable Z4+GRHD system — metric,
   extrinsic curvature, constraints, and fluid all move; the residual
   stays at discretization level ONLY if every sector balances (a wrong
   Ricci term, matter source, or first-order-variable definition
   destroys the equilibrium).

Both residuals converge above the scheme order under grid refinement
(tests/test_tov.py pins the rates); this example prints them at one
resolution together with the star's parameters.

Run: python examples/tov_star.py [--cpu] [--coupled] [--cells N]
"""

import sys

import jax

if "--cpu" in sys.argv or __name__ != "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from exahype_jax.models import grhd_cfc, tov
from exahype_jax.models.aderdg import (
    ADERDGSolver,
    make_dirichlet_fn,
    wrap_var_last,
)

GAMMA = 5.0 / 3.0
L = 0.3


def arg(flag, default, cast=int):
    if flag in sys.argv:
        return cast(sys.argv[sys.argv.index(flag) + 1])
    return default


def main():
    cells = arg("--cells", 6)
    star = tov.constant_density_star(M=0.15, R=1.0)
    print(
        f"star: M={star.M}, R_areal={star.R}, "
        f"r_iso_surface={star.r_iso_surface:.6f}, "
        f"compactness 2M/R={2 * star.M / star.R:.3f}"
    )
    center = (L / 2, L / 2, L / 2)
    coupled = "--coupled" in sys.argv

    if coupled:
        from exahype_jax.models.z4_matter import make_z4_matter_solver

        def state(x, y, z):
            return tov.tov_z4_matter_state(
                x, y, z, center=center, star=star, gamma=GAMMA
            )

        solver = make_z4_matter_solver(
            dim=3, order=2, grid_shape=(cells,) * 3, dx=L / cells,
            gamma=GAMMA, slicing="harmonic", f=1.0,
            boundary="dirichlet",
            dirichlet_fn=make_dirichlet_fn(
                state, dim=3, order=2, grid_shape=(cells,) * 3,
                dx=L / cells,
            ),
        )
    else:
        def state(x, y, z):
            return tov.tov_state(
                x, y, z, center=center, star=star, gamma=GAMMA
            )

        flux, eig = grhd_cfc.grhd_cfc(dim=3, gamma=GAMMA)
        solver = ADERDGSolver(
            dim=3, order=2, n_vars=grhd_cfc.n_vars(3),
            grid_shape=(cells,) * 3,
            flux_fn=wrap_var_last(flux),
            max_eigenvalue_fn=wrap_var_last(eig),
            dx=L / cells,
            dissipation_mask=grhd_cfc.grhd_cfc_dissipation_mask(3),
            boundary="dirichlet",
            dirichlet_fn=make_dirichlet_fn(
                state, dim=3, order=2, grid_shape=(cells,) * 3,
                dx=L / cells,
            ),
        )
        solver.source_fn = grhd_cfc.grhd_cfc_source(3, gamma=GAMMA)

    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:3] + solver.state_shape[4:]
    X, Y, Z = (
        np.broadcast_to(np.squeeze(coords[e], solver.var_axis), no_var)
        for e in range(3)
    )
    u = jnp.asarray(np.moveaxis(state(X, Y, Z), -1, solver.var_axis))
    n_steps, dt = 5, 1e-3
    out = jax.jit(lambda q: solver.run(q, n_steps, dt))(u)
    assert np.isfinite(np.asarray(out)).all()
    resid = float(np.abs(np.asarray(out - u)).max())
    mode = "coupled Z4+GRHD" if coupled else "Cowling (grhd_cfc)"
    print(
        f"{mode}: {cells}^3 window through the core, {n_steps} steps of "
        f"dt={dt}: max stationarity residual {resid:.3e}"
    )
    # Measured: Cowling 2.6e-8 at 4^3; coupled 7.7e-7 at 4^3 (the Z4
    # sector's gauge response dominates) — both converge above the
    # scheme order under refinement (tests/test_tov.py).
    bound = 3e-6 if coupled else 3e-8
    assert resid < bound, resid
    print("the star is held stationary at discretization level")


if __name__ == "__main__":
    main()
