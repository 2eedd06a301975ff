"""Sod shock tube: FV solver vs the exact Riemann solution.

The classic CFD acceptance test: left/right Sod states, evolve to t=0.15,
compare the density profile against the analytic self-similar solution.
First-order Rusanov smears discontinuities, so the criterion is an L1 bound
that tightens with resolution (also asserting first-order convergence).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models import euler
from exahype_jax.models.fv import build_fv_rusanov_kernel
from exahype_jax.models.riemann import SOD_LEFT, SOD_RIGHT, sample, star_state
from exahype_jax.parallel import GridSolver, PatchGrid
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.output import assemble_global, disassemble_global


def test_star_state_matches_toro_reference():
    """Toro's book value for Sod: p* ≈ 0.30313, u* ≈ 0.92745."""
    p_star, u_star = star_state(SOD_LEFT, SOD_RIGHT)
    assert p_star == pytest.approx(0.30313, abs=2e-5)
    assert u_star == pytest.approx(0.92745, abs=2e-5)


def run_sod_fv(gx, patch=4, t_end=0.15, gamma=1.4):
    """2-D FV run of the (y-invariant) Sod problem; returns (x, rho)."""
    gy = 1
    cfg = KernelConfig(
        dim=2, patch_size=patch, halo_size=1, n_real=4, n_aux=0,
        n_patches=gx * gy,
    )
    grid = PatchGrid(config=cfg, grid_shape=(gx, gy))
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=patch, halo_size=1, n_real=4, n_aux=0,
        n_patches=gx * gy,
        flux_impl=euler.flux_v_fn(dim=2, n_real=4, gamma=gamma),
        eigenvalue_impl=euler.max_eigenvalue_v_fn(dim=2, gamma=gamma),
    )
    n = gx * patch
    dx = 1.0 / n
    solver = GridSolver(grid, kb, dx=dx, kernel_dt="lambda")

    x = (np.arange(n) + 0.5) / n
    left = x < 0.5
    rho = np.where(left, SOD_LEFT.rho, SOD_RIGHT.rho)
    p = np.where(left, SOD_LEFT.p, SOD_RIGHT.p)
    E = p / (gamma - 1.0)
    glob = np.zeros((n, patch, 4))
    glob[..., 0] = rho[:, None]
    glob[..., 3] = E[:, None]
    Q = disassemble_global(grid, jnp.zeros(grid.state_shape), jnp.asarray(glob))

    cfl = 0.4
    # max speed ~ u*+a ~ 2; fixed dt for static shapes
    dt = cfl * dx / 2.0
    n_steps = int(np.ceil(t_end / dt))
    dt = t_end / n_steps
    Q, _ = solver.run(Q, n_steps, dt=dt)
    rho_num = np.asarray(assemble_global(grid, Q))[..., 0].mean(axis=1)
    return x, rho_num


def core(x, t_end, margin=0.02):
    """Mask of cells not yet reached by the spurious periodic-boundary waves
    (the domain edge x=0≡1 is itself a discontinuity under periodic BCs)."""
    reach = 2.0 * t_end + margin  # fastest wave speed < 2 for Sod
    return (x > reach) & (x < 1.0 - reach)


@pytest.mark.parametrize("gx,l1_bound", [(32, 0.045), (64, 0.035)])
def test_sod_density_profile(gx, l1_bound):
    t_end = 0.15
    x, rho_num = run_sod_fv(gx, t_end=t_end)
    rho_exact, _, _ = sample((x - 0.5) / t_end)
    m = core(x, t_end)
    l1 = np.abs(rho_num - rho_exact)[m].mean()
    assert np.isfinite(rho_num).all()
    assert l1 < l1_bound, f"Sod density L1 {l1:.4f} at {gx * 4} cells"


def test_sod_converges_first_order():
    t_end = 0.15
    errs = []
    for gx in (16, 32):
        x, rho_num = run_sod_fv(gx, t_end=t_end)
        rho_exact, _, _ = sample((x - 0.5) / t_end)
        m = core(x, t_end)
        errs.append(np.abs(rho_num - rho_exact)[m].mean())
    rate = np.log2(errs[0] / errs[1])
    # Discontinuities limit first-order schemes to O(h^0.5..1) in L1.
    assert rate > 0.25, f"Sod L1 convergence rate {rate:.2f}, errors {errs}"


def test_sod_limited_aderdg_beats_fv():
    """Limited order-3 ADER-DG at 16 cells resolves Sod better than
    first-order FV at 64 cells (measured: 0.035 vs 0.050 L1)."""
    from exahype_jax.models.aderdg import ADERDGSolver, _project, euler_physics
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    gamma = 1.4
    t_end = 0.15
    cells = 16
    flux, eig = euler_physics(dim=2, n_real=4, gamma=gamma)
    solver = ADERDGSolver(
        dim=2, order=3, n_vars=4, grid_shape=(cells, 2),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / cells,
    )
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], axis=solver.var_axis), no_var)
    left = X < 0.5
    rho = np.where(left, SOD_LEFT.rho, SOD_RIGHT.rho)
    p = np.where(left, SOD_LEFT.p, SOD_RIGHT.p)
    z = np.zeros_like(rho)
    Q0 = jnp.asarray(np.stack([rho, z, z, p / (gamma - 1.0)], axis=solver.var_axis))

    dt = 0.4 * (1.0 / cells) / (2 * 3 + 1) / 2.0
    n_steps = int(np.ceil(t_end / dt))
    Q = limited.run(Q0, n_steps, t_end / n_steps)

    means = Q
    for d in reversed(range(2)):
        means = _project(
            jnp.asarray(solver.ops.weights), means, solver.node_axis(d)
        )
    rho_num = np.asarray(means)[0].mean(axis=1)
    xc = (np.arange(cells) + 0.5) / cells
    rho_exact, _, _ = sample((xc - 0.5) / t_end)
    m = core(xc, t_end)
    l1_dg = np.abs(rho_num - rho_exact)[m].mean()

    x_fv, rho_fv = run_sod_fv(16, t_end=t_end)  # 64 FV cells
    ex_fv, _, _ = sample((x_fv - 0.5) / t_end)
    l1_fv = np.abs(rho_fv - ex_fv)[core(x_fv, t_end)].mean()

    assert np.isfinite(np.asarray(Q)).all()
    assert l1_dg < 0.045
    assert l1_dg < l1_fv, f"DG {l1_dg:.4f} should beat FV {l1_fv:.4f}"
