"""Cauchy–Kovalewski (linear-kernel) predictor tests.

The reference family's kernel generator ships a LINEAR aderdg kernel
class alongside the nonlinear Picard one (ExaHyPE2 specification files
select ``linear``/``nonlinear`` per solver; ExaSeis runs on the linear
kernels).  ``ADERDGSolver(predictor_mode="ck")`` is the counterpart
here: a time-Taylor recursion of N spatial-operator applications
on the spatial nodal array — no space-time array exists.  These tests
pin

- exactness order: the CK and Picard predictors are DIFFERENT degree-N
  space-time polynomials agreeing to the scheme order, so one-step
  outputs must converge to each other at rate >= N+2 in dt,
- convergence at scheme order on exact linear solutions (advection,
  elastic plane waves) including the pure-NCP branch,
- the frozen-material injection (``ck_material_slots``) against the
  homogeneous system on constant materials (exact),
- composition with walls, sources, and conservation,
- construction-time guards.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.utils.errors import SemanticError


def _coords(solver):
    coords = solver.nodes_meshgrid()
    no_var = tuple(
        s for e, s in enumerate(solver.state_shape) if e != solver.var_axis
    )
    return [
        np.broadcast_to(np.squeeze(np.asarray(c), solver.var_axis), no_var)
        for c in coords
    ]


def _advection_solver(cells, order, mode, *, as_ncp=False, dim=2):
    """Scalar advection ∂t q + v·∇q = 0, either in flux form or as a
    pure-NCP system (B_d = v_d, zero flux) — both exactly linear."""
    v = (1.0, 0.5, 0.25)[:dim]

    def flux(Q, axis, var_axis):
        if as_ncp:
            return jnp.zeros_like(Q)
        return v[axis] * Q

    def eig(Q, axis, var_axis):
        # Contract: the var axis is REDUCED away (cellwise scalar).
        return jnp.full_like(Q.sum(axis=var_axis), abs(v[axis]))

    kw = {}
    if as_ncp:
        kw["ncp_fn"] = lambda Q, dq, axis, var_axis: v[axis] * dq
    return ADERDGSolver(
        dim=dim, order=order, n_vars=1, grid_shape=(cells,) * dim,
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / cells,
        predictor_mode=mode, **kw,
    ), v


@pytest.mark.parametrize("as_ncp", [False, True])
def test_ck_advection_convergence_at_order(as_ncp):
    """CK-predicted advection converges at the scheme order (flux form and
    the pure-NCP branch)."""
    order = 3
    errs = []
    for cells in (4, 8):
        solver, v = _advection_solver(cells, order, "ck", as_ncp=as_ncp)
        X, Y = _coords(solver)

        def state(t):
            return jnp.asarray(
                np.sin(2 * np.pi * (X - v[0] * t))
                * np.cos(2 * np.pi * (Y - v[1] * t))
            )[..., None, :, :].reshape(solver.state_shape)

        t_end = 0.1
        n_steps = 8 * (cells // 4)
        out = solver.run(state(0.0), n_steps, t_end / n_steps)
        errs.append(float(jnp.max(jnp.abs(out - state(t_end)))))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order + 0.5, (errs, rate)


def test_ck_vs_picard_one_step_superconvergent_difference():
    """The Taylor and Galerkin space-time polynomials differ at the scheme
    order: one-step outputs converge to each other at rate >= N+2."""
    order = 2
    diffs = []
    for dt in (2e-3, 1e-3):
        outs = []
        for mode in ("picard", "ck"):
            solver, v = _advection_solver(8, order, mode)
            X, Y = _coords(solver)
            q0 = jnp.asarray(
                np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
            ).reshape(solver.state_shape)
            outs.append(np.asarray(solver.step(q0, dt)))
        diffs.append(float(np.max(np.abs(outs[0] - outs[1]))))
    rate = np.log2(diffs[0] / diffs[1])
    assert rate > order + 1.5, (diffs, rate)


def test_ck_elastic_plane_wave():
    """Exact P-wave through the CK predictor at Picard-level accuracy."""
    from exahype_jax.models.elastic import elastic, plane_p_wave

    rho, lam, mu = 1.0, 2.0, 1.0
    flux, eig = elastic(rho=rho, lam=lam, mu=mu)
    cells = 8
    solver = ADERDGSolver(
        dim=2, order=3, n_vars=5, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / cells, predictor_mode="ck",
    )
    X, Y = _coords(solver)

    def state(t):
        return jnp.asarray(
            np.moveaxis(
                plane_p_wave(X, Y, t, rho=rho, lam=lam, mu=mu),
                -1, solver.var_axis,
            )
        )

    t_end = 0.05
    n_steps = 40
    out = solver.run(state(0.0), n_steps, t_end / n_steps)
    err = float(jnp.max(jnp.abs(out - state(t_end))))
    assert err < 0.02 * 1e-3, err


def test_ck_material_slots_match_homogeneous():
    """Heterogeneous elasticity with CONSTANT per-cell materials equals the
    homogeneous CK solver on the evolved slots to rounding — pins the
    material-injection plumbing (inject into every L-operand, zero every
    L-output row)."""
    from exahype_jax.models.elastic import (
        N_VARS_HET,
        elastic,
        elastic_heterogeneous,
        plane_p_wave,
    )

    rho, lam, mu = 1.2, 2.1, 0.9
    cells = 4
    fh, eh = elastic_heterogeneous()
    het = ADERDGSolver(
        dim=2, order=3, n_vars=N_VARS_HET, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(fh), max_eigenvalue_fn=wrap_var_last(eh),
        dx=1.0 / cells, predictor_mode="ck", ck_material_slots=(5, 6, 7),
        dissipation_mask=(1, 1, 1, 1, 1, 0, 0, 0),
    )
    fl, el = elastic(rho=rho, lam=lam, mu=mu)
    hom = ADERDGSolver(
        dim=2, order=3, n_vars=5, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(fl), max_eigenvalue_fn=wrap_var_last(el),
        dx=1.0 / cells, predictor_mode="ck",
    )
    X, Y = _coords(hom)
    wave = np.moveaxis(plane_p_wave(X, Y, 0.0, rho=rho, lam=lam, mu=mu),
                       -1, hom.var_axis)
    q_hom = jnp.asarray(wave)
    mats = np.stack(
        [np.full(X.shape, val) for val in (rho, lam, mu)],
        axis=hom.var_axis,
    )
    q_het = jnp.asarray(np.concatenate([wave, mats], axis=hom.var_axis))
    out_het = np.asarray(het.run(q_het, 5, 1e-3))
    out_hom = np.asarray(hom.run(q_hom, 5, 1e-3))
    sl = [slice(None)] * out_het.ndim
    sl[het.var_axis] = slice(0, 5)
    np.testing.assert_allclose(out_het[tuple(sl)], out_hom, atol=1e-13)
    # Frozen material slots are bitwise untouched.
    sl[het.var_axis] = slice(5, 8)
    np.testing.assert_array_equal(
        out_het[tuple(sl)], np.asarray(q_het)[tuple(sl)]
    )


def test_ck_source_exponential_decay():
    """Linear source S = −a·Q on a constant state: fluxes vanish and the
    CK polynomial is the truncated exponential — one step matches
    exp(−a·dt) to O(dt^{N+2})."""
    a = 3.0

    def flux(Q, axis, var_axis):
        return jnp.zeros_like(Q)

    def eig(Q, axis, var_axis):
        return jnp.ones_like(Q)

    solver = ADERDGSolver(
        dim=2, order=3, n_vars=1, grid_shape=(2, 2),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=0.5,
        predictor_mode="ck",
        source_fn=lambda Q, var_axis: -a * Q,
    )
    q0 = jnp.ones(solver.state_shape)
    dt = 0.01
    out = np.asarray(solver.step(q0, dt))
    exact = np.exp(-a * dt)
    err = float(np.max(np.abs(out - exact)))
    assert err < 10 * (a * dt) ** 5 / 120.0, (err, exact)


def test_ck_free_surface_walls_compose():
    """CK flows through the wall face stage (reflective free-surface box):
    parity with the Picard solver at the predictor-difference level and
    exact horizontal-momentum conservation."""
    from exahype_jax.models.elastic import (
        elastic,
        elastic_free_surface,
        plane_p_wave,
    )

    flux, eig = elastic()
    cells = 6
    kw = dict(
        dim=2, order=2, n_vars=5, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / cells, boundary="reflective",
        reflect_fn=elastic_free_surface()[0],
        reflect_flux_fn=elastic_free_surface()[1],
    )
    ck = ADERDGSolver(predictor_mode="ck", **kw)
    pc = ADERDGSolver(predictor_mode="picard", **kw)
    X, Y = _coords(ck)
    q0 = jnp.asarray(
        np.moveaxis(plane_p_wave(X, Y, 0.0), -1, ck.var_axis)
    )
    out_ck = np.asarray(ck.run(q0, 10, 1e-3))
    out_pc = np.asarray(pc.run(q0, 10, 1e-3))
    assert np.isfinite(out_ck).all()
    # Same scheme order: tiny predictor-polynomial difference only.
    assert float(np.max(np.abs(out_ck - out_pc))) < 1e-9
    m0 = np.asarray(ck.total_mass(q0))
    m1 = np.asarray(ck.total_mass(jnp.asarray(out_ck)))
    np.testing.assert_allclose(m1[0], m0[0], rtol=0, atol=1e-15)


def test_ck_conservation_periodic():
    solver, _ = _advection_solver(6, 3, "ck")
    X, Y = _coords(solver)
    q0 = jnp.asarray(1.0 + 0.3 * np.sin(2 * np.pi * X)).reshape(
        solver.state_shape
    )
    out = solver.run(q0, 10, 1e-3)
    np.testing.assert_allclose(
        np.asarray(solver.total_mass(out)),
        np.asarray(solver.total_mass(q0)),
        rtol=0, atol=1e-13,
    )


def test_ck_guards():
    def flux(Q, axis, var_axis):
        return jnp.zeros_like(Q)

    def eig(Q, axis, var_axis):
        return jnp.ones_like(Q)

    kw = dict(dim=2, order=2, n_vars=2, grid_shape=(2, 2),
              flux_fn=flux, max_eigenvalue_fn=eig, dx=0.5)
    with pytest.raises(SemanticError, match="predictor_mode"):
        ADERDGSolver(predictor_mode="taylor", **kw)
    with pytest.raises(SemanticError, match="viscous"):
        ADERDGSolver(
            predictor_mode="ck",
            visc_flux_fn=lambda Q, g, a, va: jnp.zeros_like(Q),
            visc_eigenvalue_fn=lambda Q, a, va: jnp.ones_like(Q),
            **kw,
        )
    with pytest.raises(SemanticError, match="ck_material_slots"):
        ADERDGSolver(ck_material_slots=(1,), **kw)
    with pytest.raises(SemanticError, match="ck_material_slots"):
        ADERDGSolver(predictor_mode="ck", ck_material_slots=(7,), **kw)


