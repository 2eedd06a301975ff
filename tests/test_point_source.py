"""Point sources: weak-form duality of the delta deposit, exact injected
totals, wavefield symmetry, and composition with the solver/tracers.

The ExaSeis-style capability (Ricker point force driving the elastic
system) validated from first principles: the nodal delta must be the true
L2-dual of point evaluation on the DG space, the split-step injection must
add exactly ∫ψ·amplitude of each conserved variable on a periodic domain,
and a centred vertical point force must radiate a mirror-symmetric field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.elastic import elastic
from exahype_jax.models.point_source import PointSources, ricker
from exahype_jax.models.tracers import TracerAdvector
from exahype_jax.utils.errors import SemanticError

from tests.test_aderdg import advection_physics


def make_solver(order=3, cells=8, n_vars=1, dim=2):
    flux, eig = advection_physics((1.0,) * dim)
    return ADERDGSolver(
        dim=dim, order=order, n_vars=n_vars, grid_shape=(cells,) * dim,
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / cells,
    )


def make_elastic_solver(order=3, cells=8):
    flux, eig = elastic(rho=1.0, lam=2.0, mu=1.0)
    return ADERDGSolver(
        dim=2, order=order, n_vars=5, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / cells,
    )


def weak_inner(solver, a, b):
    """⟨a, b⟩ under the diagonal GL mass matrix (nodal quadrature × dx^dim)."""
    w = solver.ops.weights
    prod = np.asarray(a * b)
    for d in reversed(range(solver.dim)):
        prod = np.tensordot(w, prod, axes=([0], [solver.node_axis(d)]))
    return float(prod.sum()) * float(np.prod(solver._dxs))


# ------------------------------------------------------------------ duality


@pytest.mark.parametrize("dim", [2, 3])
def test_delta_deposit_is_dual_to_point_evaluation(dim):
    """⟨delta_field, φ⟩ = φ(x₀) for every tensor polynomial φ up to the
    scheme's degree — the defining weak-form property of the deposit."""
    order = 3
    solver = make_solver(order=order, cells=4, dim=dim)
    x0 = np.asarray([[0.3173, 0.642, 0.109][:dim]])
    ps = PointSources(
        solver, x0, np.ones((1, 1)), wavelet=lambda t: 1.0
    )
    delta = ps.delta_field(jnp.float64)

    def poly(*xs):
        out = 1.0
        for x in xs:
            out = out * (0.7 - 1.3 * x + 2.2 * x**2 - 0.4 * x**3)
        return out

    coords = solver.nodes_meshgrid()
    phi = np.broadcast_to(
        poly(*coords), solver.state_shape
    )
    got = weak_inner(solver, np.asarray(delta), phi)
    want = float(poly(*[x0[0, d] for d in range(dim)]))
    np.testing.assert_allclose(got, want, rtol=1e-11)


def test_deposit_multiple_sources_linearity_and_shared_cell():
    """Two sources in the SAME cell accumulate (scatter-add semantics)."""
    solver = make_solver(order=2, cells=4)
    xa, xb = [0.30, 0.30], [0.32, 0.29]  # both in cell (1,1)
    both = PointSources(
        solver, [xa, xb], np.ones((2, 1)), wavelet=lambda t: 1.0
    ).delta_field(jnp.float64)
    one_a = PointSources(
        solver, [xa], np.ones((1, 1)), wavelet=lambda t: 1.0
    ).delta_field(jnp.float64)
    one_b = PointSources(
        solver, [xb], np.ones((1, 1)), wavelet=lambda t: 1.0
    ).delta_field(jnp.float64)
    np.testing.assert_allclose(
        np.asarray(both), np.asarray(one_a + one_b), atol=1e-12
    )


# ---------------------------------------------------------------- injection


def test_injected_total_exact_for_polynomial_wavelet():
    """On a periodic domain the elastic fluxes conserve every variable, so
    the total of the forced variable grows by exactly amp·∫ψ — and the GL
    time quadrature makes that exact for polynomial ψ."""
    solver = make_elastic_solver(order=2, cells=4)
    amp = np.zeros((1, 5))
    amp[0, 1] = 2.5  # vertical force on v_y

    def psi(t):
        return 3.0 * t**2 - t + 0.25  # degree 2 < 2·order+1

    ps = PointSources(solver, [[0.41, 0.77]], amp, wavelet=psi)
    u = jnp.zeros(solver.state_shape, jnp.float64)
    t0, dt, n = 0.2, 0.013, 9
    u_out, t_out = jax.jit(
        lambda u: ps.run(u, t0, dt, n)
    )(u)
    ones = np.ones(solver.state_shape[:2] + solver.state_shape[3:])
    sel = tuple(
        slice(None) if a != solver.var_axis else slice(1, 2)
        for a in range(len(solver.state_shape))
    )
    got = weak_inner(solver, np.asarray(u_out)[sel][:, :, 0], ones)
    t1 = t0 + n * dt
    exact = 2.5 * ((t1**3 - t0**3) - (t1**2 - t0**2) / 2 + 0.25 * (t1 - t0))
    np.testing.assert_allclose(got, exact, rtol=1e-11)
    np.testing.assert_allclose(float(t_out), t1, rtol=1e-12)
    # The untouched variables stay identically conserved (zero total).
    sel0 = tuple(
        slice(None) if a != solver.var_axis else slice(0, 1)
        for a in range(len(solver.state_shape))
    )
    assert abs(weak_inner(solver, np.asarray(u_out)[sel0][:, :, 0], ones)) < 1e-13


def test_per_source_wavelet_vector():
    """ψ may return [n_sources]: each source gets its own time function."""
    solver = make_solver(order=2, cells=4)
    ps = PointSources(
        solver,
        [[0.2, 0.2], [0.7, 0.7]],
        np.ones((2, 1)),
        wavelet=lambda t: jnp.stack([t, 2.0 * t]),
    )
    u = ps.inject(jnp.zeros(solver.state_shape, jnp.float64), 0.0, 1.0)
    ones = np.ones(solver.state_shape[:2] + solver.state_shape[3:])
    total = weak_inner(
        solver, np.asarray(u)[:, :, 0], ones
    )
    np.testing.assert_allclose(total, 0.5 + 1.0, rtol=1e-12)


# ----------------------------------------------------------------- symmetry


def test_vertical_point_force_radiates_symmetric_field():
    """A centred vertical force: v_y is mirror-symmetric in x about the
    source, v_x antisymmetric — checked at receiver pairs via the tracer
    sampler (receivers = fixed probes).  Odd cell count puts the source at
    a cell CENTRE (on a face the deposit itself would be one-sided)."""
    solver = make_elastic_solver(order=3, cells=9)
    amp = np.zeros((1, 5))
    amp[0, 1] = 1.0
    ps = PointSources(solver, [[0.5, 0.5]], amp, wavelet=ricker(8.0))
    u = jnp.zeros(solver.state_shape, jnp.float64)
    dt = float(solver.cfl_dt(jnp.ones(solver.state_shape)))
    u, _ = jax.jit(lambda u: ps.run(u, 0.0, dt, 30))(u)

    probes = TracerAdvector(solver, lambda v: v[:, :2])
    rec = np.asarray(
        probes.sample(u, jnp.asarray([[0.5 - 0.21, 0.37], [0.5 + 0.21, 0.37]]))
    )
    assert np.abs(rec).max() > 1e-8, "wave should have reached the receivers"
    np.testing.assert_allclose(rec[0, 1], rec[1, 1], rtol=1e-9)   # v_y even
    np.testing.assert_allclose(rec[0, 0], -rec[1, 0], rtol=1e-9)  # v_x odd


# ------------------------------------------------------------------- errors


def test_bad_shapes_rejected():
    solver = make_solver()
    with pytest.raises(SemanticError):
        PointSources(solver, [0.5, 0.5], np.ones((1, 1)), lambda t: 1.0)
    with pytest.raises(SemanticError):
        PointSources(solver, [[0.5, 0.5]], np.ones((2, 1)), lambda t: 1.0)


def test_accelerator_unwrapped_and_step_fn_hook():
    """PointSources accepts the fused accelerator; step_fn override works
    (the split form composes with ANY homogeneous step)."""
    from exahype_jax.models.aderdg_triton import TritonADERDG

    solver = make_elastic_solver(order=2, cells=4)
    accel = TritonADERDG(solver, interpret=True)
    amp = np.zeros((1, 5))
    amp[0, 0] = 1.0
    ps = PointSources(accel, [[0.5, 0.5]], amp, wavelet=ricker(4.0))
    assert ps.solver is solver
    u = jnp.zeros(solver.state_shape, jnp.float32)
    out = ps.step(u, 0.0, 1e-3, step_fn=accel.step)
    assert np.isfinite(np.asarray(out)).all()


def test_3d_free_surface_source_momentum_bookkeeping():
    """3-D free-surface box + point force: the walls pass no momentum, so
    total v_z momentum equals EXACTLY the injected ∫ψ (polynomial wavelet
    ⇒ exact quadrature) — the full ExaSeis configuration's budget closes
    to rounding."""
    from exahype_jax.models.elastic import elastic3d, elastic3d_free_surface

    flux, eig = elastic3d()
    refl, refl_f = elastic3d_free_surface()
    cells = 4
    solver = ADERDGSolver(
        dim=3, order=2, n_vars=9, grid_shape=(cells,) * 3,
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / cells, boundary="reflective",
        reflect_fn=refl, reflect_flux_fn=refl_f,
    )
    amp = np.zeros((1, 9))
    amp[0, 2] = 1.5  # force on v_z

    def psi(t):
        return 2.0 * t + 0.1

    ps = PointSources(solver, [[0.4, 0.6, 0.55]], amp, wavelet=psi)
    u = jnp.zeros(solver.state_shape, jnp.float64)
    dt, n = 0.004, 12
    u_out, _ = jax.jit(lambda u: ps.run(u, 0.0, dt, n))(u)
    totals = np.asarray(solver.total_mass(u_out))
    t1 = n * dt
    exact = 1.5 * (t1**2 + 0.1 * t1)
    np.testing.assert_allclose(totals[2], exact, rtol=1e-12)
    np.testing.assert_allclose(totals[:2], 0.0, atol=1e-14)
