"""Exact relativistic Riemann solver: first-principles machine checks, then
validation of the numeric SRHD solver family against it.

No literature constants are trusted: shocks must satisfy the lab-frame
Rankine–Hugoniot conditions exactly, rarefactions the isentrope and the
self-similarity relation, the contact must carry continuous (v, p), and
weak waves must reduce to linear acoustics.
"""

import numpy as np
import pytest

from exahype_jax.models import riemann_sr as ex
from exahype_jax.models.riemann_sr import MM_LEFT, MM_RIGHT, PrimState

GAMMA = 5.0 / 3.0


def test_star_pressure_brackets_and_matches():
    p_star = ex.star_pressure(MM_LEFT, MM_RIGHT, GAMMA)
    assert MM_RIGHT.p < p_star < MM_LEFT.p
    vl = ex._wave_velocity(MM_LEFT, p_star, GAMMA, -1)
    vr = ex._wave_velocity(MM_RIGHT, p_star, GAMMA, +1)
    np.testing.assert_allclose(vl, vr, rtol=1e-10)
    assert 0.0 < vl < 1.0


def test_shock_rankine_hugoniot_lab_frame():
    """F(U_b) − F(U_a) = V_s (U_b − U_a) across the right-going shock —
    the defining jump condition, checked in conserved variables."""
    p_star = ex.star_pressure(MM_LEFT, MM_RIGHT, GAMMA)
    rho_b, v_b, Vs = ex._shock_state(MM_RIGHT, p_star, GAMMA, +1)
    assert Vs > v_b > 0
    Ua, Fa = ex.cons_and_flux(MM_RIGHT.rho, MM_RIGHT.v, MM_RIGHT.p, GAMMA)
    Ub, Fb = ex.cons_and_flux(rho_b, v_b, p_star, GAMMA)
    np.testing.assert_allclose(Fb - Fa, Vs * (Ub - Ua), rtol=1e-9, atol=1e-12)


def test_shock_rankine_hugoniot_left_going():
    """Same for a LEFT-going shock (built from a reversed problem)."""
    left = PrimState(1.0, 0.0, 0.1)
    right = PrimState(1.0, -0.5, 0.1)  # inflow → two shocks
    p_star = ex.star_pressure(left, right, GAMMA)
    assert p_star > left.p
    rho_b, v_b, Vs = ex._shock_state(left, p_star, GAMMA, -1)
    Ua, Fa = ex.cons_and_flux(left.rho, left.v, left.p, GAMMA)
    Ub, Fb = ex.cons_and_flux(rho_b, v_b, p_star, GAMMA)
    np.testing.assert_allclose(Fb - Fa, Vs * (Ub - Ua), rtol=1e-9, atol=1e-12)
    assert Vs < v_b  # left shock trails the post-shock flow


def test_rarefaction_isentrope_and_self_similarity():
    p_star = ex.star_pressure(MM_LEFT, MM_RIGHT, GAMMA)
    v_star = ex._wave_velocity(MM_LEFT, p_star, GAMMA, -1)
    # Points inside the left fan.
    cs_L = ex._cs(MM_LEFT.rho, MM_LEFT.p, GAMMA)
    head = ex._xi(MM_LEFT.v, cs_L, -1)
    rho_t, _ = ex._rarefaction_state(MM_LEFT, p_star, GAMMA, -1)
    tail = ex._xi(v_star, ex._cs(rho_t, p_star, GAMMA), -1)
    assert head < tail
    xis = np.linspace(head + 1e-6, tail - 1e-6, 7)
    rho, v, p = ex.sample(MM_LEFT, MM_RIGHT, xis, GAMMA)
    # Isentrope: p/ρ^γ constant at the left state's entropy.
    np.testing.assert_allclose(
        p / rho**GAMMA, MM_LEFT.p / MM_LEFT.rho**GAMMA, rtol=1e-9
    )
    # Self-similarity: the sampled point's C− characteristic speed is ξ.
    cs = ex._cs(rho, p, GAMMA)
    np.testing.assert_allclose(ex._xi(v, cs, -1), xis, atol=1e-9)


def test_contact_carries_continuous_velocity_and_pressure():
    p_star = ex.star_pressure(MM_LEFT, MM_RIGHT, GAMMA)
    v_star = ex._wave_velocity(MM_LEFT, p_star, GAMMA, -1)
    eps = 1e-9
    rho, v, p = ex.sample(
        MM_LEFT, MM_RIGHT, [v_star - eps, v_star + eps], GAMMA
    )
    np.testing.assert_allclose(v, v_star, atol=1e-7)
    np.testing.assert_allclose(p, p_star, rtol=1e-7)
    assert abs(rho[1] - rho[0]) > 1e-3  # density jumps at the contact


def test_weak_waves_reduce_to_acoustics():
    """Tiny pressure perturbation: dv = ±dp/(ρ h c_s) at v=0 (+ for the
    right-going family, − for the left) — the relativistic acoustic
    impedance ρhc_s (catches any sign/branch error)."""
    base = PrimState(1.0, 0.0, 1.0)
    h = ex._h(base.rho, base.p, GAMMA)
    cs = ex._cs(base.rho, base.p, GAMMA)
    dp = 1e-8
    for sign, p_b in ((-1, base.p - dp), (-1, base.p + dp),
                      (+1, base.p - dp), (+1, base.p + dp)):
        v_b = ex._wave_velocity(base, p_b, GAMMA, sign)
        expect = sign * (p_b - base.p) / (base.rho * h * cs)
        np.testing.assert_allclose(v_b, expect, rtol=1e-4, atol=1e-15)


def test_symmetric_problem_is_mirror_symmetric():
    left = PrimState(1.0, 0.4, 1.0)
    right = PrimState(1.0, -0.4, 1.0)
    p_star = ex.star_pressure(left, right, GAMMA)
    assert p_star > 1.0  # colliding flows compress
    v_star = ex._wave_velocity(left, p_star, GAMMA, -1)
    np.testing.assert_allclose(v_star, 0.0, atol=1e-10)
    xis = np.asarray([-0.3, -0.1, 0.1, 0.3])
    rho, v, p = ex.sample(left, right, xis, GAMMA)
    np.testing.assert_allclose(rho, rho[::-1], rtol=1e-9)
    np.testing.assert_allclose(v, -v[::-1], atol=1e-9)


def test_srhd_solver_converges_to_exact():
    """The numeric SRHD family (MUSCL FV subcell kernel via the limiter's
    machinery is overkill here — use the limited ADER-DG directly) must
    converge in L1 to the exact Martí–Müller solution."""
    import jax
    import jax.numpy as jnp

    from exahype_jax.models import srhd
    from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
    from exahype_jax.models.limiter import LimitedADERDG

    t_end = 0.15
    sod_l = PrimState(1.0, 0.0, 1.0)
    sod_r = PrimState(0.125, 0.0, 0.1)
    errs = []
    for cells in (32, 64):
        flux, eig = srhd.srhd(dim=2, gamma=GAMMA)
        solver = ADERDGSolver(
            dim=2, order=2, n_vars=4, grid_shape=(cells, 4),
            flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
            dx=1.0 / cells,
        )
        limited = LimitedADERDG(
            solver, admissible=srhd.srhd_admissible(gamma=GAMMA)
        )
        coords = solver.nodes_meshgrid()
        no_var = solver.state_shape[:2] + solver.state_shape[3:]
        X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
        leftside = X < 0.5
        rho0 = np.where(leftside, sod_l.rho, sod_r.rho)
        p0 = np.where(leftside, sod_l.p, sod_r.p)
        v0 = np.zeros(no_var + (2,))
        Q = jnp.asarray(np.moveaxis(np.asarray(srhd.prim_to_cons(
            jnp.asarray(rho0), jnp.asarray(v0), jnp.asarray(p0),
            gamma=GAMMA,
        )), -1, solver.var_axis))
        dt = float(solver.cfl_dt(Q)) * 0.9
        n = int(np.ceil(t_end / dt))
        dt = t_end / n

        @jax.jit
        def run(q):
            def body(c, _):
                return limited.step(c, dt), None
            return jax.lax.scan(body, q, None, length=n)[0]

        out = run(Q)
        # Cell-mean density along x (average nodes and the y direction).
        w = jnp.asarray(solver.ops.weights, out.dtype)
        means = jnp.tensordot(
            w, jnp.tensordot(w, out, axes=(0, 0)), axes=(0, 0)
        )
        D = np.asarray(means[0]).mean(axis=1)  # conserved density D
        xc = (np.arange(cells) + 0.5) / cells
        rho_e, v_e, p_e = ex.sample(
            sod_l, sod_r, (xc - 0.5) / t_end, GAMMA
        )
        D_e = rho_e / np.sqrt(1.0 - v_e**2)
        # The periodic wrap at x=0|1 is a SECOND Riemann problem whose waves
        # contaminate the edges; compare the central window only.
        win = (xc > 0.2) & (xc < 0.8)
        errs.append(np.abs(D - D_e)[win].mean())
    assert errs[1] < 0.65 * errs[0], errs
    assert errs[1] < 0.02  # absolute accuracy on the finer grid
