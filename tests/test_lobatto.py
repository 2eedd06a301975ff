"""Gauss-Lobatto basis option (`ADERDGSolver(basis="lobatto")`).

The downstream ExaHyPE2 kernel generator offers both Gauss-Legendre and
Gauss-Lobatto ADER-DG bases; this framework mirrors that with
`DGOperators(order, basis=...)` threaded through the whole stack
(predictor/corrector, limiter projections, AMR transfer matrices, point
sources, tracers).  These tests validate the Lobatto operator algebra from
first principles and then the solver-level invariants: convergence at the
scheme's order, exact conservation, fused-Pallas parity, limiter
conservation, and the point-source/tracer duality — all of which the
Legendre suite already pins.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import ADERDGSolver
from exahype_jax.models.dg import (
    basis_nodes,
    gauss_lobatto,
    lagrange_eval,
    refine_interpolation,
    refine_restriction,
    subcell_projection,
    subcell_reconstruction,
)


# --------------------------------------------------------------- operators


@pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
def test_lobatto_nodes_and_weights(n):
    x, w = gauss_lobatto(n)
    # Endpoints included, sorted, symmetric about 1/2.
    assert x[0] == 0.0 and x[-1] == 1.0
    assert np.all(np.diff(x) > 0)
    np.testing.assert_allclose(x + x[::-1], 1.0, atol=1e-14)
    np.testing.assert_allclose(w, w[::-1], atol=1e-14)
    # Quadrature exact through degree 2n-3: ∫ x^k = 1/(k+1).
    for k in range(2 * n - 2):
        np.testing.assert_allclose(
            np.sum(w * x**k), 1.0 / (k + 1), rtol=0, atol=1e-13,
            err_msg=f"degree {k}",
        )
    # Lumped weights integrate the basis exactly: w_i = ∫ ℓ_i (degree n-1).
    qx, qw = np.polynomial.legendre.leggauss(n + 2)
    qx, qw = (qx + 1) / 2, qw / 2
    ints = sum(wq * lagrange_eval(x, xq) for xq, wq in zip(qx, qw))
    np.testing.assert_allclose(w, ints, rtol=0, atol=1e-13)


@pytest.mark.parametrize("basis", ["legendre", "lobatto"])
@pytest.mark.parametrize("order,factor", [(2, 2), (3, 2), (3, 3)])
def test_refine_restriction_projection_identity(basis, order, factor):
    """R·P = I: restricting a prolongated polynomial returns it exactly —
    for the Lobatto basis this requires the exact-L2 assembly (the lumped
    collocation adjoint is not a projection there)."""
    P = refine_interpolation(order, factor, basis)  # [factor, n, n]
    R = refine_restriction(order, factor, basis)  # [n, factor, n]
    RP = np.einsum("jki,kim->jm", R, P)
    np.testing.assert_allclose(RP, np.eye(order + 1), rtol=0, atol=1e-12)
    # Restriction conserves the lumped cell mean (mass bookkeeping): for a
    # piecewise state f, Σ_j w_j (R f)_j = (1/factor) Σ_{k,i} w_i f_{k,i}.
    _, w = basis_nodes(order + 1, basis)
    lhs = np.einsum("j,jki->ki", w, R)
    rhs = np.broadcast_to(w / factor, lhs.shape)
    np.testing.assert_allclose(lhs, rhs, rtol=0, atol=1e-13)


@pytest.mark.parametrize("order", [2, 3])
def test_subcell_projection_lobatto_roundtrip(order):
    """Subcell means of the Lobatto nodal polynomial are exact, and the
    reconstruction is a left inverse."""
    rng = np.random.default_rng(0)
    nodes, _ = gauss_lobatto(order + 1)
    coeffs = rng.standard_normal(order + 1)  # poly in the nodal basis
    P = subcell_projection(order, basis="lobatto")
    R = subcell_reconstruction(order, basis="lobatto")
    np.testing.assert_allclose(
        R @ (P @ coeffs), coeffs, rtol=0, atol=1e-12
    )
    # Means match dense quadrature of the interpolant.
    n_sub = 2 * order + 1
    qx, qw = np.polynomial.legendre.leggauss(order + 3)
    qx, qw = (qx + 1) / 2, qw / 2
    for s in range(n_sub):
        val = sum(
            wq * lagrange_eval(nodes, (s + xq) / n_sub) @ coeffs
            for xq, wq in zip(qx, qw)
        )
        np.testing.assert_allclose((P @ coeffs)[s], val, rtol=0, atol=1e-12)


# ----------------------------------------------------------------- solver


def _advection_solver(cells, order, basis, velocity=(1.0, 0.5)):
    a = np.asarray(velocity, dtype=np.float64)

    def flux(Q, axis, var_axis):
        return float(a[axis]) * Q

    def eig(Q, axis, var_axis):
        shape = Q.shape[:var_axis] + Q.shape[var_axis + 1 :]
        return jnp.full(shape, float(abs(a[axis])), Q.dtype)

    return ADERDGSolver(
        dim=2, order=order, n_vars=1, grid_shape=(cells,) * 2,
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / cells, basis=basis,
    )


def _advection_init(solver, velocity=(1.0, 0.5), t=0.0):
    coords = solver.nodes_meshgrid()
    phase = sum(c - v * t for c, v in zip(coords, velocity))
    return jnp.asarray(
        np.broadcast_to(np.sin(2 * np.pi * phase), solver.state_shape)
    )


def _l2_error(solver, u, u_exact):
    w = solver.ops.weights
    err2 = np.asarray((u - u_exact) ** 2)
    for d in reversed(range(solver.dim)):
        err2 = np.tensordot(w, err2, axes=([0], [solver.node_axis(d)]))
    return float(np.sqrt(err2.sum() * solver.dx**solver.dim))


@pytest.mark.parametrize("order,min_rate", [(2, 1.8), (3, 2.8)])
def test_lobatto_advection_convergence_rate(order, min_rate):
    """Measured asymptotic rate for the Lobatto basis is exactly N (2.00 at
    order 2, 3.00 at order 3 on the 8→16-cell pair): the diagonal mass is
    the LUMPED mass (Lobatto collocation is only (2N−1)-exact), which costs
    one order relative to the Legendre basis's N+1.  That is the documented
    trade: nodal face values (no extrapolation) for one order — Legendre
    stays the default and the production basis."""
    errors = []
    for cells in (4, 8, 16):
        solver = _advection_solver(cells, order, "lobatto")
        u = _advection_init(solver)
        n_steps, dt = 10 * (cells // 4), 1e-3 / (cells // 4)
        u = solver.run(u, n_steps, dt)
        exact = _advection_init(solver, t=n_steps * dt)
        errors.append(_l2_error(solver, u, exact))
    # The asymptotic rate is the FINEST pair (8→16); the 4→8 pair is
    # pre-asymptotic and only required to be monotone.
    assert errors[0] > errors[1] > errors[2]
    rate = np.log2(errors[1] / errors[2])
    assert rate > min_rate, f"lobatto order-{order} rate {rate:.2f}, {errors}"


def test_lobatto_conservation_and_face_nodal_values():
    solver = _advection_solver(6, 3, "lobatto")
    u0 = _advection_init(solver)
    mass0 = np.asarray(solver.total_mass(u0))
    u = solver.run(u0, 20, dt=1e-3)
    np.testing.assert_allclose(
        np.asarray(solver.total_mass(u)), mass0, rtol=0, atol=1e-12
    )
    # Lobatto face extrapolation is a unit-vector pick: phi0/phi1 = e_0/e_n.
    n = solver.n_nodes
    np.testing.assert_allclose(solver.ops.phi0, np.eye(n)[0], atol=1e-13)
    np.testing.assert_allclose(solver.ops.phi1, np.eye(n)[-1], atol=1e-13)


def _euler_wave_solver(cells, order, basis):
    from exahype_jax.models.aderdg import euler_physics

    flux, eig = euler_physics(dim=2, n_real=4)
    return ADERDGSolver(
        dim=2, order=order, n_vars=4, grid_shape=(cells,) * 2,
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / cells, basis=basis,
    )


def _euler_wave_state(solver, t=0.0, vel=(1.0, 0.5), p=2.0, gamma=1.4):
    coords = solver.nodes_meshgrid()
    phase = sum(c - v * t for c, v in zip(coords, vel))
    rho_b = 1.0 + 0.2 * np.sin(2 * np.pi * phase)
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    rho = np.broadcast_to(np.squeeze(rho_b, axis=solver.var_axis), no_var)
    u, v = vel
    E = p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v)
    return jnp.asarray(
        np.stack([rho, rho * u, rho * v, E], axis=solver.var_axis)
    )


def test_lobatto_pallas_parity():
    """The fused Pallas cell stage consumes only `solver.ops` — the
    Lobatto matrices must flow through unchanged."""
    from exahype_jax.models.aderdg_triton import TritonADERDG

    solver = _euler_wave_solver(8, 3, "lobatto")
    Q0 = _euler_wave_state(solver)
    ref = np.asarray(solver.step(Q0, 1e-3))
    fused = TritonADERDG(solver, interpret=True)
    got = np.asarray(fused.step(Q0, 1e-3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)


def test_lobatto_limited_step_conserves():
    """The MOOD limiter's subcell projection/reconstruction follow the
    solver's basis; a limited step with forced troubled cells conserves."""
    from exahype_jax.models.limiter import LimitedADERDG

    solver = _euler_wave_solver(6, 2, "lobatto")
    lim = LimitedADERDG(solver)
    Q0 = _euler_wave_state(solver)
    # Sharpen a blob so DMP actually flags cells.
    X, Y = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    bump = 1.0 + 2.0 * ((X == 3) & (Y == 3))
    Q0 = Q0 * jnp.asarray(
        np.broadcast_to(
            bump.reshape((1,) * solver.dim + (1,) + (6, 6)),
            solver.state_shape,
        )
    )
    mass0 = np.asarray(solver.total_mass(Q0))
    mask = lim.troubled_mask(Q0, solver.step(Q0, 2e-3))
    assert int(np.asarray(mask).sum()) > 0, "limiter never engaged — vacuous"
    Q1 = lim.step(Q0, 2e-3)
    np.testing.assert_allclose(
        np.asarray(solver.total_mass(Q1)), mass0, rtol=0, atol=1e-11
    )


def test_lobatto_point_source_duality_and_tracer_sampling():
    """delta_field duality and tracer interpolation hold in the solver's
    lumped (Lobatto) inner product."""
    from exahype_jax.models.point_source import PointSources
    from exahype_jax.models.tracers import TracerAdvector

    solver = _euler_wave_solver(6, 3, "lobatto")
    pos = jnp.asarray([[0.37, 0.61]])
    amp = jnp.asarray([[1.0, 0.0, 0.0, 2.0]])
    ps = PointSources(solver, pos, amp, wavelet=lambda t: 1.0)
    field = ps.delta_field(jnp.float64)
    # Weak test against a smooth polynomial p(x, y) = x²·y of degree ≤ order:
    # Σ w·field·p(nodes) (lumped inner product, cell-scaled) == p(x_s)·amp.
    coords = solver.nodes_meshgrid()
    p = coords[0] ** 2 * coords[1]
    w = solver.ops.weights
    integrand = np.asarray(field) * np.broadcast_to(p, solver.state_shape)
    for d in reversed(range(solver.dim)):
        integrand = np.tensordot(w, integrand, axes=([0], [solver.node_axis(d)]))
    total = integrand.sum(axis=(-2, -1)) * solver.dx**solver.dim
    expect = float(pos[0, 0]) ** 2 * float(pos[0, 1]) * np.asarray(amp[0])
    np.testing.assert_allclose(total, expect, rtol=0, atol=1e-12)

    tr = TracerAdvector(solver, velocity_fn=lambda v: v[:, 1:3] / v[:, 0:1])
    u = _euler_wave_state(solver)
    xq = jnp.asarray([[0.13, 0.52], [0.77, 0.05]])
    got = np.asarray(tr.sample(u, xq))
    # rho is sin-based (not polynomial): compare against the DG interpolant
    # only where the state IS polynomial per cell — use a nodal polynomial.
    coords = solver.nodes_meshgrid()
    poly = coords[0] * coords[1] ** 2 + 0.5
    upoly = jnp.asarray(np.broadcast_to(poly, solver.state_shape))
    got_poly = np.asarray(tr.sample(upoly, xq))
    expect_poly = (
        np.asarray(xq[:, 0]) * np.asarray(xq[:, 1]) ** 2 + 0.5
    )[:, None]
    np.testing.assert_allclose(
        got_poly, np.broadcast_to(expect_poly, got_poly.shape),
        rtol=0, atol=1e-12,
    )
    assert np.all(np.isfinite(got))
