"""ADER-DG nested refinement tests: exactness of the coupling operators,
conservation with refluxing, and error reduction in the refined region."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
from exahype_jax.models.aderdg_amr import ADERDGNestedRefinement
from exahype_jax.utils.errors import SemanticError
from tests.test_aderdg import euler_density_wave_solver, euler_density_wave_state


def make_amr(cells=6, order=2, lo=(1, 1), hi=(4, 4), factor=3, **kw):
    solver = euler_density_wave_solver(cells=cells, order=order)
    return solver, ADERDGNestedRefinement(
        solver, region_lo=lo, region_hi=hi, factor=factor, **kw
    )


def test_refine_operators_projection_identity():
    """R @ P = I: restriction of the prolonged coarse solution reproduces
    it exactly (polynomial interpolation + L2 projection)."""
    from exahype_jax.models.dg import refine_interpolation, refine_restriction

    for order in (1, 2, 3):
        for r in (2, 3):
            P = refine_interpolation(order, r)
            R = refine_restriction(order, r)
            np.testing.assert_allclose(
                np.einsum("jki,kil->jl", R, P), np.eye(order + 1), atol=1e-12
            )


def test_prolong_restrict_roundtrip_exact():
    solver, amr = make_amr(order=3)
    rng = np.random.default_rng(0)
    uc = jnp.asarray(rng.normal(size=solver.state_shape))
    uf = amr.prolong_ext(uc)
    assert uf.shape == solver.state_shape[: solver.var_axis + 1] + amr.ext_shape
    back = amr.restrict_into(jnp.zeros_like(uc), uf)
    region = (slice(None),) * (solver.dim + 1) + tuple(
        slice(lo, hi) for lo, hi in zip(amr.region_lo, amr.region_hi)
    )
    np.testing.assert_allclose(
        np.asarray(back[region]), np.asarray(uc[region]), atol=1e-12
    )


def test_constant_state_is_exact_steady_state():
    """A uniform Euler state is a steady state of the COUPLED step (fluxes
    cancel and the reflux delta is identically zero)."""
    solver, amr = make_amr(order=2)
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    ones = np.ones(no_var)
    uc = jnp.asarray(
        np.stack([ones, 0.3 * ones, 0.1 * ones, 5.0 * ones], axis=solver.var_axis)
    )
    uf = amr.prolong_initial(uc)
    nc, nf = jax.jit(amr.step)(uc, uf, 1e-3)
    np.testing.assert_allclose(np.asarray(nc), np.asarray(uc), atol=1e-11)
    interior = (slice(None),) * (solver.dim + 1) + tuple(
        slice(1, e - 1) for e in amr.ext_shape
    )
    np.testing.assert_allclose(
        np.asarray(nf[interior]), np.asarray(uf[interior]), atol=1e-11
    )


def test_refluxing_conserves_composite_mass():
    """Composite mass/energy drift ~rounding WITH refluxing; measurably
    larger without (the reflux correction is what restores conservation)."""
    solver = euler_density_wave_solver(cells=6, order=2)
    uc0 = euler_density_wave_state(solver)
    dt = 1e-3

    def drift(reflux):
        amr = ADERDGNestedRefinement(
            solver, region_lo=(1, 1), region_hi=(4, 4), reflux=reflux
        )
        uf = amr.prolong_initial(uc0)
        uc, uf = jax.jit(lambda a, b: amr.run(a, b, 10, dt))(uc0, uf)
        m0 = np.asarray(amr.composite_mass(uc0, amr.prolong_initial(uc0)))
        m1 = np.asarray(amr.composite_mass(uc, uf))
        return np.abs(m1 - m0) / np.abs(m0)

    d_reflux = drift(True)
    d_plain = drift(False)
    assert d_reflux[0] < 1e-12, d_reflux  # mass
    assert d_reflux[3] < 1e-12, d_reflux  # energy
    assert d_plain[0] > 10 * max(d_reflux[0], 1e-15), (d_plain, d_reflux)


def _fine_exact_state(amr, t=0.0, vel=(1.0, 0.5), p=2.0, gamma=1.4):
    """The density-wave solution evaluated at the EXT fine grid's own nodes."""
    coords = amr.fine_coords()
    phase = sum(np.asarray(c) - v * t for c, v in zip(coords, vel))
    rho_b = 1.0 + 0.2 * np.sin(2 * np.pi * phase)
    sol = amr.fine
    no_var = sol.state_shape[: sol.var_axis] + sol.state_shape[sol.var_axis + 1 :]
    rho = np.broadcast_to(np.squeeze(rho_b, axis=sol.var_axis), no_var)
    u, v = vel
    E = p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v)
    return jnp.asarray(np.stack([rho, rho * u, rho * v, E], axis=sol.var_axis))


def test_refined_region_reduces_error():
    """With exact initial data on both levels, the FINE solution deep inside
    the region (its rim is fed by first-order coarse boundary data — the
    standard AMR caveat) beats the coarse-only solution evaluated there."""
    solver = euler_density_wave_solver(cells=6, order=1)
    amr = ADERDGNestedRefinement(solver, region_lo=(1, 1), region_hi=(5, 5))
    uc0 = euler_density_wave_state(solver)
    uf0 = _fine_exact_state(amr)  # exact at fine nodes, not prolonged coarse
    dt = 2e-3
    n = 10
    t_end = n * dt

    coarse_only = jax.jit(lambda u: solver.run(u, n, dt))(uc0)
    uc, uf = jax.jit(lambda a, b: amr.run(a, b, n, dt))(uc0, uf0)

    fine_exact = _fine_exact_state(amr, t=t_end)
    coarse_at_fine = amr.prolong_ext(coarse_only)
    # Core: skip the ghost ring AND the outermost refined cell ring.
    r = amr.factor
    core = (slice(None),) * (solver.dim + 1) + tuple(
        slice(1 + r, e - 1 - r) for e in amr.ext_shape
    )

    def err(u):
        return float(jnp.sqrt(jnp.mean((u[core] - fine_exact[core]) ** 2)))

    e_fine = err(uf)
    e_coarse = err(coarse_at_fine)
    assert e_fine < 0.5 * e_coarse, (e_fine, e_coarse)


def test_region_validation():
    solver = euler_density_wave_solver(cells=6, order=2)
    with pytest.raises(SemanticError):
        ADERDGNestedRefinement(solver, region_lo=(0, 0), region_hi=(6, 6))
    with pytest.raises(SemanticError):
        ADERDGNestedRefinement(solver, region_lo=(2, 2), region_hi=(2, 2))


def test_dynamic_aderdg_refinement_tracks_and_conserves():
    """Dynamic re-gridding on the ADER-DG hierarchy: the refined box follows
    an advecting density pulse across >= 2 distinct regions while the
    composite mass/energy stay conserved to rounding across re-grid events
    (restrict-before / polynomial-prolong-after preserve means; refluxing
    conserves within chunks)."""
    from exahype_jax.models.aderdg_amr import DynamicADERDGRefinement

    solver = euler_density_wave_solver(cells=8, order=2)
    # A localized density pulse (sharper score peak than the global wave).
    x, y = solver.nodes_meshgrid()
    r2 = (np.asarray(x) - 0.25) ** 2 + (np.asarray(y) - 0.5) ** 2
    bump = 1.0 + 0.4 * np.exp(-r2 / 0.02)
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    rho = np.broadcast_to(np.squeeze(bump, axis=solver.var_axis), no_var)
    E = 2.0 / 0.4 + 0.5 * rho * (1.0 + 0.0)
    uc0 = jnp.asarray(
        np.stack([rho, rho * 1.0, rho * 0.0, E], axis=solver.var_axis)
    )
    m0 = np.asarray(solver.total_mass(uc0))

    dyn = DynamicADERDGRefinement(solver, half_width=1)
    uc, uf, info = dyn.run(uc0, n_chunks=6, chunk_steps=8, dt=2e-3)
    regions = info["regions"]
    assert len(set(regions)) > 1, f"region never moved: {regions}"
    m1 = np.asarray(info["nested"].composite_mass(uc, uf))
    # uc already holds the restricted fine state after each step.
    np.testing.assert_allclose(np.asarray(solver.total_mass(uc)), m1, rtol=1e-12)
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-11)
    np.testing.assert_allclose(m1[3], m0[3], rtol=1e-11)
    assert bool(jnp.isfinite(uc).all()) and bool(jnp.isfinite(uf).all())


def test_limited_fine_level_box_conserves():
    """fine_factory / coarse_factory on the box hierarchy: a LimitedADERDG
    at both levels keeps the refluxed composite mass exact and engages the
    limiter (differs from the unlimited hierarchy)."""
    import jax.numpy as jnp

    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    solver = euler_density_wave_solver(cells=6, order=2)
    # A pressure bump steep enough to fire the subcell limiter.
    X, Y = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    Xb = jnp.broadcast_to(jnp.squeeze(X, axis=2), no_var)
    Yb = jnp.broadcast_to(jnp.squeeze(Y, axis=2), no_var)
    rho = jnp.ones(no_var)
    p = 0.1 + 10.0 * jnp.exp(-(((Xb - 0.5) ** 2 + (Yb - 0.5) ** 2) / 0.09**2))
    uc0 = jnp.stack(
        [rho, jnp.zeros_like(rho), jnp.zeros_like(rho), p / 0.4], axis=2
    )
    adm = euler_admissible(dim=solver.dim)

    def run(factory):
        amr = ADERDGNestedRefinement(
            solver, region_lo=(2, 2), region_hi=(4, 4),
            fine_factory=factory, coarse_factory=factory,
        )
        uf0 = amr.prolong_initial(uc0)
        return amr.run(uc0, uf0, 6, 1e-3)

    m0 = np.asarray(solver.total_mass(uc0))
    c_lim, f_lim = run(lambda s: LimitedADERDG(s, admissible=adm))
    assert bool(jnp.isfinite(c_lim).all()) and bool(jnp.isfinite(f_lim).all())
    m1 = np.asarray(solver.total_mass(c_lim))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12)

    c_unl, _ = run(None)
    assert float(jnp.max(jnp.abs(c_lim - c_unl))) > 1e-10
