"""TOV-star initial data and the stationarity anchors.

The TOV star is the canonical strong-field validation of a GR-hydro
code: a self-gravitating static fluid whose discrete time derivative
must CONVERGE to zero at the scheme's order (a wrong metric, wrong
source, or wrong coupling plateaus instead).  `models/tov.py` supplies:

- the EXACT constant-density (interior-Schwarzschild) star in closed
  isotropic-coordinate form — machine-checked here (hydrostatic balance
  to rounding, C¹ surface match, Schwarzschild exterior),
- an RK4 polytrope integrator — validated against the exact star's
  invariants (exterior match, balance residual, ADM mass),
- window states for Cowling (`grhd_cfc`) and COUPLED
  (`z4_matter`, dynamic spacetime) evolution.

Reference-family context: the reference bundles only flat Euler physics
(`Unit test/Functions.cpp:9-62`); this is the ExaGRyPE family rung.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from exahype_jax.models import grhd_cfc, tov

GAMMA = 5.0 / 3.0


# ------------------------------------------------------------ exact star


def test_exact_star_hydrostatic_balance():
    """dp/dr̄ = −(ρ_E + p) ∂_r̄ ln α — the EOS-independent relativistic
    hydrostatic equilibrium — holds on the closed-form star to the
    finite-difference floor (the analytic identity is exact)."""
    star = tov.constant_density_star(M=0.15, R=1.0)
    r = np.linspace(0.02, star.r_iso_surface * 0.98, 400)
    h = 1e-6
    rhoE, p, alpha, psi, dalpha, dpsi = star.profile(r)
    _, pp, _, _, _, _ = star.profile(r + h)
    _, pm, _, _, _, _ = star.profile(r - h)
    dp = (pp - pm) / (2 * h)
    resid = dp + (rhoE + p) * dalpha / alpha
    assert np.abs(resid).max() < 1e-7 * np.abs(dp).max() + 1e-12


def test_exact_star_derivative_closed_forms():
    """The returned dα/dr̄, dψ/dr̄ match central differences of the
    returned α, ψ (interior AND exterior)."""
    star = tov.constant_density_star(M=0.15, R=1.0)
    r = np.concatenate([
        np.linspace(0.05, star.r_iso_surface * 0.95, 50),
        np.linspace(star.r_iso_surface * 1.05, 3.0, 50),
    ])
    h = 1e-6
    _, _, alpha, psi, dalpha, dpsi = star.profile(r)
    _, _, ap, pp_, _, _ = star.profile(r + h)
    _, _, am, pm_, _, _ = star.profile(r - h)
    np.testing.assert_allclose(dalpha, (ap - am) / (2 * h),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(dpsi, (pp_ - pm_) / (2 * h),
                               rtol=1e-7, atol=1e-10)


def test_exact_star_surface_c1_and_exterior():
    """α and ψ (values AND first derivatives) are continuous at the
    surface; outside, the profile IS the closed-form Schwarzschild
    exterior used everywhere else in the framework."""
    star = tov.constant_density_star(M=0.15, R=1.0)
    rs = star.r_iso_surface
    eps = 1e-9
    inner = star.profile(rs - eps)
    outer = star.profile(rs + eps)
    for i in (2, 3, 4, 5):  # α, ψ, dα, dψ
        np.testing.assert_allclose(inner[i], outer[i], rtol=1e-6)
    # Pressure vanishes at the surface; density jumps (by construction).
    assert abs(float(inner[1])) < 1e-7
    r = np.linspace(rs * 1.1, 4.0, 20)
    _, _, alpha, psi, dalpha, dpsi = star.profile(r)
    a_e, p_e, da_e, dp_e = (np.asarray(v) for v in
                            grhd_cfc.schwarzschild_isotropic(r, M=0.15))
    np.testing.assert_allclose(alpha, a_e, rtol=1e-13)
    np.testing.assert_allclose(psi, p_e, rtol=1e-13)
    np.testing.assert_allclose(dalpha, da_e, rtol=1e-13)
    np.testing.assert_allclose(dpsi, dp_e, rtol=1e-13)


def test_exact_star_regular_centre():
    """r̄ = 0 is evaluated without NaN; derivatives vanish there."""
    star = tov.constant_density_star(M=0.15, R=1.0)
    rhoE, p, alpha, psi, dalpha, dpsi = star.profile(np.array([0.0, 1e-12]))
    assert np.isfinite([rhoE, p, alpha, psi, dalpha, dpsi]).all()
    assert abs(dalpha[0]) < 1e-12 and abs(dpsi[0]) < 1e-12
    # Central pressure matches the closed form p_c = ρ_E(1−s_R)/(3s_R−1).
    sR = np.sqrt(1 - 0.3)
    rho_E = 3 * 0.15 / (4 * np.pi)
    np.testing.assert_allclose(p[0], rho_E * (1 - sR) / (3 * sR - 1),
                               rtol=1e-12)


# ------------------------------------------------------- polytrope star


@pytest.fixture(scope="module")
def poly_star():
    return tov.polytrope_star(rho_c=1.28e-3, K=100.0, Gamma=2.0,
                              n_steps=8_000)


def test_polytrope_star_invariants(poly_star):
    """The RK4 polytrope: classic Γ=2, K=100, ρ_c=1.28e-3 model has
    M ≈ 1.40, R ≈ 9.59 (the standard benchmark numbers); the exterior
    matches Schwarzschild; hydrostatic balance holds to the integration
    floor."""
    star = poly_star
    assert abs(star.M - 1.40) < 0.02, star.M
    assert abs(star.R - 9.59) < 0.1, star.R
    r = np.linspace(star.r_iso_surface * 1.2, 30.0, 10)
    _, _, alpha, psi, _, _ = star.profile(r)
    a_e, p_e, _, _ = (np.asarray(v) for v in
                      grhd_cfc.schwarzschild_isotropic(r, M=star.M))
    np.testing.assert_allclose(alpha, a_e, rtol=1e-9)
    np.testing.assert_allclose(psi, p_e, rtol=1e-9)
    # Balance residual on the interior (away from centre/surface).
    rr = np.linspace(0.3, star.r_iso_surface * 0.9, 200)
    h = 1e-5
    rhoE, p, alpha, _, dalpha, _ = star.profile(rr)
    _, pp, _, _, _, _ = star.profile(rr + h)
    _, pm, _, _, _, _ = star.profile(rr - h)
    dp = (pp - pm) / (2 * h)
    resid = dp + (rhoE + p) * dalpha / alpha
    assert np.abs(resid).max() < 5e-3 * np.abs(dp).max()


def test_polytrope_matches_exact_in_constant_density_check(poly_star):
    """ψ⁴γ̄-consistency: ψ² r̄ relates to the areal radius exactly
    (r = ψ²r̄) — check the profile's own self-consistency at the surface
    against TOVStar's closed-form r̄_R = R(1+s_R)²/4."""
    star = poly_star
    sR = np.sqrt(1 - 2 * star.M / star.R)
    np.testing.assert_allclose(star.r_iso_surface,
                               star.R * (1 + sR) ** 2 / 4, rtol=1e-12)
    _, _, _, psi_s, _, _ = star.profile(np.array([star.r_iso_surface]))
    np.testing.assert_allclose(psi_s**2 * star.r_iso_surface, star.R,
                               rtol=1e-8)


# ------------------------------------------- Cowling window stationarity


def _window_state_fn(star, center):
    def state(x, y, z):
        return tov.tov_state(x, y, z, center=center, star=star,
                             gamma=GAMMA)
    return state


def test_tov_window_stationary_cowling():
    """A 3-D Cartesian window through the star's CORE (r̄ = 0 inside the
    domain), Dirichlet exact-solution walls, Cowling (`grhd_cfc`)
    evolution: the residual after fixed steps decays above the scheme
    order — the Michel-window pattern (test_models.py) on a
    self-gravitating interior."""
    from exahype_jax.models.aderdg import (
        ADERDGSolver,
        make_dirichlet_fn,
        wrap_var_last,
    )

    star = tov.constant_density_star(M=0.15, R=1.0)
    L = 0.3
    center = (L / 2, L / 2, L / 2)  # star core at the window centre
    state = _window_state_fn(star, center)
    errs = []
    for cells in (4, 8):
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
        out = jax.jit(lambda q: solver.run(q, 5, 2e-3))(u)
        assert np.isfinite(np.asarray(out)).all()
        dS = np.asarray(
            jnp.take(out, jnp.asarray([1, 2, 3]), solver.var_axis)
            - jnp.take(u, jnp.asarray([1, 2, 3]), solver.var_axis)
        )
        errs.append(np.abs(dS).max())
    rate = np.log2(errs[0] / errs[1])
    assert rate > 1.7, (errs, rate)
    # Measured 5.9e-9 at 8³ (rate 1.81): larger than the Michel window's
    # 1e-11 because the interior's pressure gradient is steeper relative
    # to the window size — the discriminating property is the RATE.
    assert errs[1] < 5e-8, errs


# ------------------------------------- coupled (dynamic spacetime) anchor


@pytest.mark.slow
def test_tov_window_stationary_coupled():
    """THE flagship anchor: the same TOV core window evolved with the
    COUPLED Z4+GRHD system — dynamic metric, matter sources, harmonic
    slicing — stays stationary at a residual that converges above the
    scheme order.  Every sector participates: a wrong Ricci term, matter
    source, coupling sign, or first-order-variable definition breaks the
    balance and the residual plateaus."""
    from exahype_jax.models.aderdg import make_dirichlet_fn
    from exahype_jax.models.z4_matter import (
        N_VARS,
        make_z4_matter_solver,
    )

    star = tov.constant_density_star(M=0.15, R=1.0)
    L = 0.3
    center = (L / 2, L / 2, L / 2)

    def state(x, y, z):
        return tov.tov_z4_matter_state(x, y, z, center=center, star=star,
                                       gamma=GAMMA)

    errs = []
    for cells in (4, 8):
        solver = make_z4_matter_solver(
            dim=3, order=2, grid_shape=(cells,) * 3, dx=L / cells,
            gamma=GAMMA, slicing="harmonic", f=1.0,
            boundary="dirichlet",
            dirichlet_fn=make_dirichlet_fn(
                state, dim=3, order=2, grid_shape=(cells,) * 3,
                dx=L / cells,
            ),
        )
        coords = solver.nodes_meshgrid()
        no_var = solver.state_shape[:3] + solver.state_shape[4:]
        X, Y, Z = (
            np.broadcast_to(np.squeeze(coords[e], solver.var_axis), no_var)
            for e in range(3)
        )
        u = jnp.asarray(np.moveaxis(state(X, Y, Z), -1, solver.var_axis))
        out = jax.jit(lambda q: solver.run(q, 5, 1e-3))(u)
        assert np.isfinite(np.asarray(out)).all()
        d = np.asarray(out - u)
        errs.append(np.abs(d).max())
    rate = np.log2(errs[0] / errs[1])
    assert rate > 1.7, (errs, rate)


def test_tov_state_builders_guard_surface_crossing():
    star = tov.constant_density_star(M=0.15, R=1.0)
    x = np.array([0.0, 2.0])  # 2.0 > r̄_surface
    with pytest.raises(ValueError):
        tov.tov_state(x, x, x, center=(0, 0, 0), star=star)
    with pytest.raises(ValueError):
        tov.tov_z4_matter_state(x, x, x, center=(0, 0, 0), star=star)
    # With atmosphere floors the same window packs finite states.
    Q = tov.tov_state(x, x, x, center=(0, 0, 0), star=star,
                      rho_atm=1e-10, p_atm=1e-12)
    assert np.isfinite(Q).all()
