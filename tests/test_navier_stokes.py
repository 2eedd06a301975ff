"""Compressible Navier–Stokes / viscous-flux ADER-DG tests.

Anchors: pure-diffusion Fourier-mode decay at exactly κ(2π)² (validates
the Gassner diffusive treatment in isolation), the transverse shear mode
decaying at exactly ν(2π)² (full NS system), exact conservation, and the
bitwise Euler reduction at μ = 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models import euler, navier_stokes as ns
from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.utils.errors import SemanticError


def make_ns_solver(cells=16, order=3, mu=1e-2, prandtl=0.7, dim=2):
    f, e, vf, ve = ns.navier_stokes(dim=dim, mu=mu, prandtl=prandtl)
    return ADERDGSolver(
        dim=dim, order=order, n_vars=dim + 2, grid_shape=(cells,) * dim,
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=ns.wrap_visc_var_last(vf),
        visc_eigenvalue_fn=wrap_var_last(ve),
        dx=1.0 / cells,
    )


def shear_state(solver, V=1e-3):
    """Uniform (ρ=1, p=1) + transverse shear v_y = V sin(2πx)."""
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    rho = np.ones_like(X)
    my = V * np.sin(2 * np.pi * X)
    p = np.ones_like(X)
    E = p / (euler.GAMMA - 1.0) + 0.5 * my**2
    Qv = np.stack([rho, np.zeros_like(X), my, E], axis=-1)
    return jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))


def test_zero_viscosity_reduces_to_euler():
    """μ = 0: the viscous solver's step equals the plain Euler solver's."""
    cells, order = 8, 3
    visc = make_ns_solver(cells=cells, order=order, mu=0.0)
    plain = ADERDGSolver(
        dim=2, order=order, n_vars=4, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(euler.flux_v_fn(dim=2, n_real=4)),
        max_eigenvalue_fn=wrap_var_last(euler.max_eigenvalue_v_fn(dim=2)),
        dx=1.0 / cells,
    )
    rng = np.random.default_rng(0)
    no_var = visc.state_shape[:2] + visc.state_shape[3:]
    rho = 1.0 + 0.2 * rng.random(no_var)
    m = 0.2 * rng.standard_normal(no_var + (2,))
    p = 1.0 + 0.2 * rng.random(no_var)
    E = p / (euler.GAMMA - 1) + 0.5 * (m**2).sum(-1) / rho
    Qv = np.concatenate([rho[..., None], m, E[..., None]], -1)
    u = jnp.asarray(np.moveaxis(Qv, -1, visc.var_axis))
    dt = 1e-3
    np.testing.assert_allclose(
        np.asarray(visc.step(u, dt)), np.asarray(plain.step(u, dt)),
        rtol=0, atol=0,
    )


def test_pure_diffusion_fourier_decay_rate_converges():
    """Scalar heat equation through the viscous machinery alone (zero
    hyperbolic flux): u = sin(2πx) decays at exactly κ(2π)²; the measured
    rate converges to it with resolution."""
    kappa = 0.02
    errs = []
    for cells in (4, 8):
        solver = ADERDGSolver(
            dim=2, order=3, n_vars=1, grid_shape=(cells, cells),
            flux_fn=lambda Q, d, va: jnp.zeros_like(Q),
            max_eigenvalue_fn=lambda Q, d, va: jnp.zeros(
                Q.shape[:va] + Q.shape[va + 1:], Q.dtype
            ),
            visc_flux_fn=lambda Q, grads, d, va: -kappa * grads[d],
            visc_eigenvalue_fn=lambda Q, d, va: jnp.full(
                Q.shape[:va] + Q.shape[va + 1:], kappa, Q.dtype
            ),
            dx=1.0 / cells,
        )
        coords = solver.nodes_meshgrid()
        X = np.broadcast_to(
            np.squeeze(coords[0], solver.var_axis),
            solver.state_shape[:2] + solver.state_shape[3:],
        )
        u = jnp.asarray(np.sin(2 * np.pi * X)[
            (slice(None),) * 2 + (None,) + (slice(None),) * 2
        ])
        dt = float(solver.cfl_dt(u))
        n_steps = max(1, int(round(0.5 / dt)))
        T = n_steps * dt
        out = jax.jit(lambda u: solver.run(u, n_steps, dt))(u)
        n0 = float(jnp.sqrt(jnp.mean(u * u)))
        n1 = float(jnp.sqrt(jnp.mean(out * out)))
        rate = np.log(n0 / n1) / T
        exact = kappa * (2 * np.pi) ** 2
        errs.append(abs(rate - exact) / exact)
    assert errs[0] < 0.05, errs
    assert errs[1] < errs[0] / 4, errs  # better than 2nd-order decay
    assert errs[1] < 5e-3, errs


def test_ns_shear_mode_decay_rate():
    """Transverse shear v_y = V sin(2πx) at uniform (ρ, p): exact NS
    solution (to O(V²)) decaying at ν(2π)²."""
    mu = 0.01
    solver = make_ns_solver(cells=8, order=3, mu=mu)
    u = shear_state(solver, V=1e-3)
    dt = float(solver.cfl_dt(u))
    n_steps = max(1, int(round(0.4 / dt)))
    T = n_steps * dt
    out = jax.jit(lambda u: solver.run(u, n_steps, dt))(u)

    def vy_norm(q):
        vy = jnp.take(q, 2, solver.var_axis) / jnp.take(q, 0, solver.var_axis)
        return float(jnp.sqrt(jnp.mean(vy * vy)))

    rate = np.log(vy_norm(u) / vy_norm(out)) / T
    exact = mu * (2 * np.pi) ** 2
    assert abs(rate - exact) / exact < 5e-3, (rate, exact)


def test_ns_viscous_conservation():
    """The viscous flux is a pure divergence: mass, momentum, AND total
    energy (including viscous heating) conserved to rounding."""
    solver = make_ns_solver(cells=8, order=2, mu=0.05)
    rng = np.random.default_rng(3)
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    rho = 1.0 + 0.3 * rng.random(no_var)
    m = 0.3 * rng.standard_normal(no_var + (2,))
    p = 1.0 + 0.3 * rng.random(no_var)
    E = p / (euler.GAMMA - 1) + 0.5 * (m**2).sum(-1) / rho
    Qv = np.concatenate([rho[..., None], m, E[..., None]], -1)
    u = jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))
    dt = float(solver.cfl_dt(u))
    out = jax.jit(lambda u: solver.run(u, 20, dt))(u)
    assert np.isfinite(np.asarray(out)).all()
    m0 = np.asarray(solver.total_mass(u))
    m1 = np.asarray(solver.total_mass(out))
    np.testing.assert_allclose(m1, m0, rtol=1e-12, atol=1e-14)


def test_ns_3d_shear_decay_and_conservation():
    """The viscous machinery is dim-generic: a 3-D shear mode
    v_z = V sin(2πx) decays at ν(2π)² and everything conserves."""
    mu = 0.02
    dim = 3
    f, e, vf, ve = ns.navier_stokes(dim=dim, mu=mu)
    solver = ADERDGSolver(
        dim=dim, order=2, n_vars=dim + 2, grid_shape=(6, 4, 4),
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=ns.wrap_visc_var_last(vf),
        visc_eigenvalue_fn=wrap_var_last(ve),
        dx=(1.0 / 6, 1.0 / 4, 1.0 / 4),
    )
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:dim] + solver.state_shape[dim + 1:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    V = 1e-3
    mz = V * np.sin(2 * np.pi * X)
    rho = np.ones_like(X)
    p = np.ones_like(X)
    E = p / (euler.GAMMA - 1.0) + 0.5 * mz**2
    Qv = np.stack(
        [rho, np.zeros_like(X), np.zeros_like(X), mz, E], axis=-1
    )
    u = jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))
    dt = float(solver.cfl_dt(u))
    n_steps = max(1, int(round(0.25 / dt)))
    T = n_steps * dt
    out = jax.jit(lambda u: solver.run(u, n_steps, dt))(u)

    def vz_norm(q):
        vz = jnp.take(q, 3, solver.var_axis) / jnp.take(q, 0, solver.var_axis)
        return float(jnp.sqrt(jnp.mean(vz * vz)))

    rate = np.log(vz_norm(u) / vz_norm(out)) / T
    exact = mu * (2 * np.pi) ** 2
    assert abs(rate - exact) / exact < 2e-2, (rate, exact)
    m0 = np.asarray(solver.total_mass(u))
    m1 = np.asarray(solver.total_mass(out))
    np.testing.assert_allclose(m1, m0, rtol=1e-12, atol=1e-14)


def test_ns_sharded_matches_single_device():
    """GSPMD-sharded viscous step (grid axis 0 over the 8-device mesh):
    the gradient evaluation is cell-local and the face exchange partitions
    into collectives, so parity vs single device is 1e-12."""
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    solver = make_ns_solver(cells=8, order=2, mu=0.02)
    rng = np.random.default_rng(9)
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    rho = 1.0 + 0.3 * rng.random(no_var)
    m = 0.3 * rng.standard_normal(no_var + (2,))
    p = 1.0 + 0.3 * rng.random(no_var)
    E = p / (euler.GAMMA - 1) + 0.5 * (m**2).sum(-1) / rho
    Qv = np.concatenate([rho[..., None], m, E[..., None]], -1)
    u = jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))
    dt = 5e-4
    ref = np.asarray(jax.jit(lambda q: solver.step(q, dt))(u))

    mesh = make_mesh(8)
    spec = [None] * len(solver.state_shape)
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    us = jax.device_put(u, sharding)
    got = np.asarray(
        jax.jit(lambda q: solver.step(q, dt),
                in_shardings=(sharding,), out_shardings=sharding)(us)
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _smooth_ns_state(solver):
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    Y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)
    rho = 1.0 + 0.2 * np.sin(2 * np.pi * (X + Y))
    mx = 0.2 * np.cos(2 * np.pi * X)
    my = -0.1 * np.sin(2 * np.pi * Y)
    p = 1.0 + 0.2 * np.cos(2 * np.pi * Y)
    E = p / (euler.GAMMA - 1) + 0.5 * (mx**2 + my**2) / rho
    Qv = np.stack([rho, mx, my, E], axis=-1)
    return jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))


def test_limited_ns_untroubled_equals_plain_step():
    """Limited viscous step with nothing troubled returns the DG candidate
    unchanged."""
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    solver = make_ns_solver(cells=8, order=2, mu=0.02)
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    u = shear_state(solver, V=1e-3)  # near-uniform: genuinely untroubled
    dt = 2e-4
    assert not bool(np.asarray(
        limited.troubled_mask(u, solver.step(u, dt))
    ).any())
    np.testing.assert_allclose(
        np.asarray(limited.step(u, dt)), np.asarray(solver.step(u, dt)),
        rtol=0, atol=0,
    )


def test_limited_ns_all_troubled_conserves_and_decays():
    """Force every cell troubled: the viscous subcell fallback conserves
    mass/momentum/energy to rounding (diffusive face fluxes telescope) and
    the shear mode still decays at ~the physical rate (ν dominates the
    first-order numerical diffusion at this μ)."""
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    mu = 0.05
    solver = make_ns_solver(cells=8, order=2, mu=mu)
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    u = shear_state(solver, V=1e-3)
    dt = float(solver.cfl_dt(u))
    n_steps = max(1, int(round(0.1 / dt)))
    T = n_steps * dt

    force_all = lambda t: jnp.ones_like(t)

    @jax.jit
    def run(q):
        def body(c, _):
            return limited.step(c, dt, troubled_transform=force_all), None
        return jax.lax.scan(body, q, None, length=n_steps)[0]

    out = run(u)
    assert np.isfinite(np.asarray(out)).all()
    m0 = np.asarray(solver.total_mass(u))
    m1 = np.asarray(solver.total_mass(out))
    np.testing.assert_allclose(m1, m0, rtol=1e-12, atol=1e-13)

    def vy_norm(q):
        vy = jnp.take(q, 2, solver.var_axis) / jnp.take(q, 0, solver.var_axis)
        return float(jnp.sqrt(jnp.mean(vy * vy)))

    rate = np.log(vy_norm(u) / vy_norm(out)) / T
    exact = mu * (2 * np.pi) ** 2
    assert 0.7 * exact < rate < 1.5 * exact, (rate, exact)
    # The means overflow/fallback variant conserves too.
    lim_means = LimitedADERDG(solver, admissible=euler_admissible(dim=2),
                              fallback="means")
    out2 = lim_means.step(u, dt, troubled_transform=force_all)
    m2 = np.asarray(solver.total_mass(out2))
    np.testing.assert_allclose(m2, m0, rtol=1e-12, atol=1e-13)
    # And the order-2 MUSCL fallback: conserves, and its all-troubled
    # decay rate is CLOSER to the physical one than first order's.
    lim2 = LimitedADERDG(solver, admissible=euler_admissible(dim=2),
                         fallback_order=2)

    @jax.jit
    def run2(q):
        def body(c, _):
            return lim2.step(c, dt, troubled_transform=force_all), None
        return jax.lax.scan(body, q, None, length=n_steps)[0]

    out2 = run2(u)
    m2 = np.asarray(solver.total_mass(out2))
    np.testing.assert_allclose(m2, m0, rtol=1e-12, atol=1e-13)
    rate2 = np.log(vy_norm(u) / vy_norm(out2)) / T
    assert abs(rate2 - exact) <= abs(rate - exact) + 1e-12, (rate2, rate)
    assert abs(rate2 - exact) / exact < 0.25, (rate2, exact)


def test_limited_ns_viscous_shock_stable():
    """A strong viscous shock tube under the limiter: finite, conservative,
    admissible — the ExaHyPE CompressibleNavierStokes shock configuration."""
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    solver = make_ns_solver(cells=12, order=3, mu=2e-3)
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    left = (X > 0.25) & (X < 0.75)
    rho = np.where(left, 1.0, 0.125)
    p = np.where(left, 1.0, 0.1)
    E = p / (euler.GAMMA - 1.0)
    Qv = np.stack([rho, np.zeros_like(X), np.zeros_like(X), E], -1)
    u = jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))
    dt = float(solver.cfl_dt(u)) * 0.5
    cand = solver.step(u, dt)
    assert bool(np.asarray(limited.troubled_mask(u, cand)).any())

    @jax.jit
    def run(q):
        def body(c, _):
            return limited.step(c, dt), None
        return jax.lax.scan(body, q, None, length=15)[0]

    out = run(u)
    assert np.isfinite(np.asarray(out)).all()
    m0 = np.asarray(solver.total_mass(u))
    m1 = np.asarray(solver.total_mass(out))
    np.testing.assert_allclose(m1, m0, rtol=1e-12, atol=1e-13)
    from exahype_jax.models.limiter import euler_admissible as ea
    ok = ea(dim=2)(out, solver.var_axis)
    assert bool(np.asarray(ok).all())


def make_ns_wall_solver(cells=8, order=3, mu=1e-2, wall_axes=(0,),
                        boundary="reflective"):
    """NS solver with no-slip walls on ``wall_axes`` (round 4: viscous
    fluxes compose with walls — the former periodic-only guard is gone)."""
    f, e, vf, ve = ns.navier_stokes(dim=2, mu=mu)
    kw = {}
    if boundary == "reflective":
        kw = dict(reflect_fn=ns.noslip_reflect(2),
                  reflect_flux_fn=ns.noslip_reflect_flux(2))
    return ADERDGSolver(
        dim=2, order=order, n_vars=4, grid_shape=(cells,) * 2,
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=ns.wrap_visc_var_last(vf),
        visc_eigenvalue_fn=wrap_var_last(ve),
        dx=1.0 / cells, boundary=boundary, wall_axes=wall_axes, **kw,
    )


def test_ns_noslip_channel_shear_decay():
    """The canonical viscous-wall anchor: a channel with no-slip walls at
    x = 0, 1 (periodic in y) carrying the transverse shear
    v_y = V sin(πx) — an exact incompressible-limit NS solution satisfying
    the no-slip condition at both walls — decays at exactly ν π²
    (Stokes' mode; half the periodic mode's wavenumber).  Validates the
    one-sided wall viscous flux + advective-symmetry split end to end."""
    mu = 0.01
    solver = make_ns_wall_solver(cells=8, order=3, mu=mu)
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    V = 1e-3
    rho = np.ones_like(X)
    my = V * np.sin(np.pi * X)
    E = 1.0 / (euler.GAMMA - 1.0) + 0.5 * my**2
    Qv = np.stack([rho, np.zeros_like(X), my, E], axis=-1)
    u = jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))
    dt = float(solver.cfl_dt(u))
    n_steps = max(1, int(round(1.0 / dt)))
    T = n_steps * dt
    out = jax.jit(lambda u: solver.run(u, n_steps, dt))(u)

    def vy_norm(q):
        vy = jnp.take(q, 2, solver.var_axis) / jnp.take(q, 0, solver.var_axis)
        return float(jnp.sqrt(jnp.mean(vy * vy)))

    rate = np.log(vy_norm(u) / vy_norm(out)) / T
    exact = mu * np.pi**2
    assert abs(rate - exact) / exact < 2e-2, (rate, exact)


def test_ns_noslip_box_mass_conserved_ke_decays():
    """A closed no-slip box: the wall mass flux is exactly zero (the
    ghost's advective mass flux is the negation, the viscous mass flux is
    zero, and the ρ-jump vanishes), so total mass conserves to rounding;
    the stirred kinetic energy decays monotonically (viscous dissipation
    with no inflow)."""
    solver = make_ns_wall_solver(cells=8, order=2, mu=0.05,
                                 wall_axes=(0, 1))
    # Divergence-free Taylor–Green velocity at uniform (ρ, p): no acoustic
    # sloshing (pressure↔kinetic exchange is O(V²)), so viscosity + the
    # no-slip walls drain KE cleanly.
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    Y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)
    V = 1e-3
    mx = V * np.sin(np.pi * X) * np.cos(np.pi * Y)
    my = -V * np.cos(np.pi * X) * np.sin(np.pi * Y)
    rho = np.ones_like(X)
    E = 1.0 / (euler.GAMMA - 1) + 0.5 * (mx**2 + my**2)
    Qv = np.stack([rho, mx, my, E], axis=-1)
    u = jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))
    dt = float(solver.cfl_dt(u))

    def ke(q):
        r = np.asarray(jnp.take(q, 0, solver.var_axis))
        k = sum(
            np.asarray(jnp.take(q, 1 + j, solver.var_axis)) ** 2
            for j in range(2)
        )
        return float((0.5 * k / r).mean())

    out = jax.jit(lambda u: solver.run(u, 160, dt))(u)
    assert np.isfinite(np.asarray(out)).all()
    m0 = np.asarray(solver.total_mass(u))
    m1 = np.asarray(solver.total_mass(out))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12, atol=1e-14)
    assert ke(np.asarray(out)) < 0.8 * ke(np.asarray(u))


def test_ns_outflow_walls_compact_support_parity():
    """Viscous + outflow walls: while a compact disturbance has not yet
    reached the walls, the walled run is identical to the periodic run
    (zero-gradient ghosts at a constant-state wall are exact) — a
    differential test of the whole viscous wall plumbing."""
    f, e, vf, ve = ns.navier_stokes(dim=2, mu=5e-3)
    kw = dict(
        dim=2, order=3, n_vars=4, grid_shape=(16, 8),
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=ns.wrap_visc_var_last(vf),
        visc_eigenvalue_fn=wrap_var_last(ve), dx=1.0 / 16,
    )
    walled = ADERDGSolver(boundary="outflow", wall_axes=(0,), **kw)
    periodic = ADERDGSolver(**kw)
    coords = walled.nodes_meshgrid()
    no_var = walled.state_shape[:2] + walled.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], walled.var_axis), no_var)
    bump = 0.2 * np.exp(-(((X - 0.5) / 0.05) ** 2))
    rho = 1.0 + bump
    p = np.ones_like(rho)
    E = p / (euler.GAMMA - 1.0)
    Qv = np.stack([rho, np.zeros_like(X), np.zeros_like(X), E], axis=-1)
    u = jnp.asarray(np.moveaxis(Qv, -1, walled.var_axis))
    dt = 5e-4
    a = np.asarray(walled.run(u, 3, dt))
    b = np.asarray(periodic.run(u, 3, dt))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_viscous_guards():
    solver = make_ns_solver(cells=4, order=2)
    from exahype_jax.models.limiter import LimitedADERDG

    adm = lambda Q, va: jnp.ones(Q.shape[:va] + Q.shape[va + 1:], bool)
    with pytest.raises(SemanticError, match="gathered"):
        LimitedADERDG(solver, admissible=adm, troubled_capacity=4,
                      troubled_granularity="row")
    f, e, vf, ve = ns.navier_stokes(dim=2)
    with pytest.raises(SemanticError, match="together"):
        ADERDGSolver(
            dim=2, order=2, n_vars=4, grid_shape=(4, 4),
            flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
            visc_flux_fn=ns.wrap_visc_var_last(vf),
        )
    from exahype_jax.models.aderdg import euler_reflect, euler_reflect_flux

    # Round 4: viscous + walls is now supported (the former periodic-only
    # guard is gone) — construction succeeds and the wall machinery engages.
    s = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(4, 4),
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=ns.wrap_visc_var_last(vf),
        visc_eigenvalue_fn=wrap_var_last(ve),
        boundary="reflective",
        reflect_fn=euler_reflect(2),
        reflect_flux_fn=euler_reflect_flux(2),
    )
    assert s.is_wall(0) and s.is_wall(1)
