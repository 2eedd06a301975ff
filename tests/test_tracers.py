"""Tracer particles: interpolation exactness, trajectory accuracy,
solver composition, and sharding.

The reference DSL repo has no particle code; the downstream ExaHyPE2
toolbox's tracers are the capability being matched (massless particles
advected with the flow, recording the solution).  Validation is from first
principles: single-cell DG evaluation must be EXACT on polynomials up to
the scheme's order, constant-velocity trajectories must be exact up to
rounding, and the RK2 integrator must show second-order dt convergence on
a rotating field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
from exahype_jax.models.tracers import (
    TracerAdvector,
    euler_velocity,
    uniform_tracers,
)
from exahype_jax.utils.errors import SemanticError

from tests.test_aderdg import advection_physics


def make_solver(dim=2, order=3, cells=6, n_vars=1, dx=None):
    flux, eig = advection_physics((1.0,) * dim)
    return ADERDGSolver(
        dim=dim,
        order=order,
        n_vars=n_vars,
        grid_shape=(cells,) * dim,
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        dx=dx if dx is not None else 1.0 / cells,
    )


def nodal_field(solver, fn):
    """State whose nodal values are fn(x0, x1[, x2]) in variable 0."""
    coords = solver.nodes_meshgrid()
    vals = fn(*coords)
    return jnp.asarray(np.broadcast_to(vals, solver.state_shape))


# ----------------------------------------------------------------- sampling


@pytest.mark.parametrize("dim", [2, 3])
def test_sample_exact_on_polynomials(dim):
    """Single-cell DG evaluation is exact for tensor polynomials of the
    scheme's degree — the defining property of the Lagrange contraction."""
    order = 3
    solver = make_solver(dim=dim, order=order, cells=4)

    def poly(*xs):
        out = 1.0
        for x in xs:
            out = out * (0.3 + 1.7 * x - 2.1 * x**2 + 0.9 * x**3)
        return out

    u = nodal_field(solver, poly)
    adv = TracerAdvector(solver, euler_velocity(dim))
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random((50, dim)))  # anywhere in [0,1)^dim
    got = np.asarray(adv.sample(u, x))[:, 0]
    want = poly(*[np.asarray(x)[:, d] for d in range(dim)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_sample_above_scheme_degree_not_exact():
    """Sanity: a degree-(order+1) polynomial is NOT reproduced (guards
    against a test that would pass for any interpolant)."""
    solver = make_solver(dim=2, order=2, cells=4)
    u = nodal_field(solver, lambda x, y: x**3 + 0.0 * y)
    adv = TracerAdvector(solver, euler_velocity(2))
    x = jnp.asarray([[0.37, 0.5]])
    got = float(adv.sample(u, x)[0, 0])
    assert abs(got - 0.37**3) > 1e-6


def test_sample_periodic_wrap_and_anisotropic_dx():
    """Out-of-domain positions wrap; anisotropic cell widths locate
    correctly."""
    solver = ADERDGSolver(
        dim=2,
        order=2,
        n_vars=1,
        grid_shape=(4, 8),
        flux_fn=advection_physics((1.0, 1.0))[0],
        max_eigenvalue_fn=advection_physics((1.0, 1.0))[1],
        dx=(0.25, 0.0625),  # domain 1.0 × 0.5
    )
    u = nodal_field(solver, lambda x, y: 1.0 + x + 2.0 * y)
    adv = TracerAdvector(solver, euler_velocity(2))
    x = jnp.asarray([[0.3, 0.2], [0.3 + 1.0, 0.2 + 0.5], [-0.7, -0.3]])
    got = np.asarray(adv.sample(u, x))[:, 0]
    np.testing.assert_allclose(got, 1.0 + 0.3 + 0.4, rtol=1e-12)


def test_clamp_boundary_locates_edge():
    solver = make_solver(dim=2, order=2, cells=4)
    u = nodal_field(solver, lambda x, y: x + 0.0 * y)
    adv = TracerAdvector(solver, euler_velocity(2), boundary="clamp")
    x = jnp.asarray([[1.5, 0.5], [-0.5, 0.5]])
    got = np.asarray(adv.sample(u, x))[:, 0]
    np.testing.assert_allclose(got, [1.0, 0.0], atol=1e-6)


def test_bad_boundary_rejected():
    solver = make_solver()
    with pytest.raises(SemanticError):
        TracerAdvector(solver, euler_velocity(2), boundary="reflect")


# ---------------------------------------------------------------- advection


def test_constant_velocity_trajectory_exact():
    """Uniform Euler flow: tracers move at exactly the fluid velocity,
    including across the periodic wrap."""
    dim = 2
    flux, eig = euler_physics(dim=dim, n_real=4)
    solver = ADERDGSolver(
        dim=dim,
        order=2,
        n_vars=4,
        grid_shape=(4, 4),
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        dx=0.25,
    )
    rho, vx, vy, p = 1.0, 0.8, -0.3, 1.0
    comps = [rho, rho * vx, rho * vy, p / 0.4 + 0.5 * rho * (vx**2 + vy**2)]
    no_var = (solver.n_nodes,) * dim + solver.grid_shape
    u = jnp.stack(
        [jnp.full(no_var, c) for c in comps], axis=solver.var_axis
    )
    adv = TracerAdvector(solver, euler_velocity(dim))
    x0 = jnp.asarray([[0.9, 0.1], [0.2, 0.7]])
    dt, n = 0.05, 7
    x = x0
    for _ in range(n):
        x = adv.advect(u, x, dt)
    want = np.mod(np.asarray(x0) + n * dt * np.asarray([vx, vy]), 1.0)
    np.testing.assert_allclose(np.asarray(x), want, rtol=0, atol=1e-12)


def test_rk2_convergence_on_rotation():
    """Solid-body rotation about the domain centre: halving dt divides the
    trajectory error by ~4 (the field is linear, hence represented exactly —
    the measured error is purely the integrator's)."""
    solver = make_solver(dim=2, order=1, cells=8, n_vars=2)

    def vfield(x, y):
        return np.stack(
            [-(y - 0.5), (x - 0.5)], axis=solver.var_axis
        )

    coords = solver.nodes_meshgrid()
    xg = np.broadcast_to(coords[0], (2, 2) + (1,) + solver.grid_shape)
    yg = np.broadcast_to(coords[1], (2, 2) + (1,) + solver.grid_shape)
    u = jnp.asarray(
        np.concatenate(
            [-(yg - 0.5), (xg - 0.5)], axis=solver.var_axis
        )
    )
    adv = TracerAdvector(solver, lambda vals: vals)
    x0 = jnp.asarray([[0.75, 0.5]])  # radius 0.25
    t_end = 1.0

    def err(n_steps):
        dt = t_end / n_steps
        x = x0
        for _ in range(n_steps):
            x = adv.advect(u, x, dt)
        ang = t_end
        want = np.asarray(
            [[0.5 + 0.25 * np.cos(ang), 0.5 + 0.25 * np.sin(ang)]]
        )
        return float(np.abs(np.asarray(x) - want).max())

    e1, e2 = err(40), err(80)
    rate = np.log2(e1 / e2)
    assert 1.8 < rate < 2.3, (e1, e2, rate)


# -------------------------------------------------------------- composition


def test_trajectories_with_solver_step():
    """Tracers + ADER-DG advance together in one jitted scan; on a smooth
    Euler density wave with uniform velocity the tracers track the flow."""
    dim = 2
    flux, eig = euler_physics(dim=dim, n_real=4)
    solver = ADERDGSolver(
        dim=dim,
        order=2,
        n_vars=4,
        grid_shape=(8, 8),
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        dx=0.125,
    )
    vx, vy, p = 0.5, 0.25, 1.0
    coords = solver.nodes_meshgrid()
    rho = 1.0 + 0.1 * np.sin(2 * np.pi * (coords[0] + coords[1]))
    rho = np.broadcast_to(rho, (3, 3, 1) + solver.grid_shape)
    e = p / 0.4 + 0.5 * rho * (vx**2 + vy**2)
    u = jnp.asarray(
        np.concatenate([rho, rho * vx, rho * vy, e], axis=solver.var_axis)
    )
    adv = TracerAdvector(solver, euler_velocity(dim))
    x0 = uniform_tracers((1.0, 1.0), (3, 3), dtype=u.dtype)
    dt, n = 2e-3, 5

    run = jax.jit(
        lambda u, x: adv.trajectories(solver.step, u, x, dt, n)
    )
    u_out, x_out, xs, vals = run(u, x0)
    assert xs.shape == (n, 9, 2) and vals.shape == (n, 9, 4)
    assert np.isfinite(np.asarray(x_out)).all()
    # Uniform velocity: every tracer displaces by ~v·t.  The tolerance is
    # the DG solution error of the wave at this resolution (the velocity
    # field is uniform only in the exact solution).
    drift = np.asarray(x_out) - np.asarray(x0)
    np.testing.assert_allclose(
        drift, np.broadcast_to([vx * n * dt, vy * n * dt], (9, 2)),
        atol=1e-4,
    )
    # Recording contract: step k's values are sampled from the PRE-step
    # field at the post-advection positions.
    _, _, xs1, vals1 = adv.trajectories(solver.step, u, x0, dt, 1)
    np.testing.assert_allclose(
        np.asarray(vals1[0]),
        np.asarray(adv.sample(u, xs1[0])),
        atol=1e-12,
    )


def test_sample_under_grid_sharding_matches():
    """Sampling from a mesh-sharded state (gather over the sharded grid
    axis) matches the single-device result."""
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    solver = make_solver(dim=2, order=2, cells=8)
    u = nodal_field(solver, lambda x, y: jnp.sin(x) + y**2)
    adv = TracerAdvector(solver, euler_velocity(2))
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random((64, 2)))

    ref = np.asarray(adv.sample(u, x))

    mesh = make_mesh(8)
    spec = [None] * len(solver.state_shape)
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    us = jax.device_put(u, sharding)
    got = np.asarray(jax.jit(adv.sample)(us, x))
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


def test_pallas_accelerator_unwrapped():
    """TracerAdvector accepts the fused accelerator and uses its base
    solver's layout."""
    from exahype_jax.models.aderdg_triton import TritonADERDG

    flux, eig = euler_physics(dim=2, n_real=4)
    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(8, 8),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=0.125,
    )
    accel = TritonADERDG(solver, interpret=True)
    adv = TracerAdvector(accel, euler_velocity(2))
    assert adv.solver is solver


# ------------------------------------------------------------- AMR tracers


def make_amr(order=3, cells=6, factor=3):
    from exahype_jax.models.aderdg_amr import ADERDGNestedRefinement

    solver = make_solver(dim=2, order=order, cells=cells)
    return ADERDGNestedRefinement(
        coarse=solver, region_lo=(1, 2), region_hi=(4, 5), factor=factor
    )


def test_nested_sampler_consistent_on_polynomials():
    """A degree<=order field is represented exactly on BOTH levels, so the
    composite sampler must agree with the coarse one everywhere — a strong
    check of the fine grid's ghost-extended origin offset."""
    from exahype_jax.models.tracers import NestedTracerAdvector

    amr = make_amr()
    uc = nodal_field(amr.coarse, lambda x, y: 0.4 + x * y - 1.3 * x**2 * y)
    uf = amr.prolong_initial(uc)
    nested = NestedTracerAdvector(amr, euler_velocity(2))
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.random((80, 2)))
    got = np.asarray(nested.sample((uc, uf), x))
    want = np.asarray(nested.coarse_adv.sample(uc, x))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)


def test_nested_sampler_selects_fine_inside_region():
    """For a rough field the two levels disagree; the composite must return
    the FINE values strictly inside the refined box and coarse outside."""
    from exahype_jax.models.tracers import NestedTracerAdvector

    amr = make_amr(order=2)
    uc = nodal_field(amr.coarse, lambda x, y: np.sin(9 * x) * np.cos(7 * y))
    uf = amr.prolong_initial(uc)
    # Perturb the fine level so the levels are distinguishable.
    uf = uf + 0.01
    nested = NestedTracerAdvector(amr, euler_velocity(2))
    dxc = amr.coarse._dxs[0]
    inside = jnp.asarray([[1.5 * dxc, 3.0 * dxc], [3.9 * dxc, 2.1 * dxc]])
    outside = jnp.asarray([[0.2 * dxc, 0.5 * dxc], [5.5 * dxc, 5.5 * dxc]])
    vi = np.asarray(nested.sample((uc, uf), inside))
    vo = np.asarray(nested.sample((uc, uf), outside))
    fi = np.asarray(
        nested.fine_adv.sample(uf, inside - jnp.asarray(nested._origin))
    )
    ci = np.asarray(nested.coarse_adv.sample(uc, inside))
    co = np.asarray(nested.coarse_adv.sample(uc, outside))
    np.testing.assert_allclose(vi, fi, atol=1e-12)
    np.testing.assert_allclose(vo, co, atol=1e-12)
    assert np.abs(vi - ci).max() > 1e-3  # levels genuinely differ inside


def test_nested_trajectories_with_amr_step():
    """Tracers + the coupled AMR step advance together in one jitted scan."""
    from exahype_jax.models.aderdg_amr import ADERDGNestedRefinement
    from exahype_jax.models.tracers import NestedTracerAdvector

    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics

    flux, eig = euler_physics(dim=2, n_real=4)
    coarse = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(6, 6),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / 6,
    )
    amr = ADERDGNestedRefinement(
        coarse=coarse, region_lo=(2, 2), region_hi=(4, 4), factor=2
    )
    vx, vy, p = 0.3, -0.2, 1.0
    no_var = (3, 3) + coarse.grid_shape
    rho = jnp.ones(no_var)
    uc = jnp.stack(
        [rho, rho * vx, rho * vy,
         p / 0.4 + 0.5 * rho * (vx**2 + vy**2)],
        axis=coarse.var_axis,
    )
    uf = amr.prolong_initial(uc)
    nested = NestedTracerAdvector(amr, euler_velocity(2))
    x0 = jnp.asarray([[0.45, 0.55], [0.1, 0.9]])  # one in-region, one out
    dt, n = 2e-3, 4
    run = jax.jit(
        lambda s, x: nested.trajectories(
            lambda st, d: amr.step(*st, d), s, x, dt, n
        )
    )
    (uc1, uf1), x1, xs, vals = run((uc, uf), x0)
    assert xs.shape == (n, 2, 2) and vals.shape == (n, 2, 4)
    drift = np.asarray(x1) - np.asarray(x0)
    np.testing.assert_allclose(
        drift, np.broadcast_to([vx * n * dt, vy * n * dt], (2, 2)), atol=1e-6
    )


def test_sample_under_particle_sharding_matches():
    """Millions of tracers scale by sharding the PARTICLE axis: positions
    sharded over the 8-device mesh (field replicated) match single-device
    sampling and advection exactly."""
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    solver = make_solver(dim=2, order=2, cells=8)
    u = nodal_field(solver, lambda x, y: jnp.cos(3 * x) * (1.0 + y))
    adv = TracerAdvector(solver, lambda vals: jnp.concatenate(
        [vals, -0.5 * vals], axis=-1
    ))
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.random((64, 2)))

    ref_s = np.asarray(adv.sample(u, x))
    ref_a = np.asarray(adv.advect(u, x, 1e-2))

    mesh = make_mesh(8)
    xs = jax.device_put(x, NamedSharding(mesh, PartitionSpec("patches", None)))
    got_s = np.asarray(jax.jit(adv.sample)(u, xs))
    got_a = np.asarray(jax.jit(lambda u, x: adv.advect(u, x, 1e-2))(u, xs))
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=1e-14)
    np.testing.assert_allclose(got_a, ref_a, rtol=0, atol=1e-14)


# --------------------------------------------------------------- FV tracers


def make_fv_grid(gx=3, gy=2, patch=4, halo=1, n_vars=3):
    from exahype_jax.parallel import PatchGrid
    from exahype_jax.utils.config import KernelConfig

    cfg = KernelConfig(
        dim=2, patch_size=patch, halo_size=halo, n_real=n_vars, n_aux=0,
        n_patches=gx * gy,
    )
    return PatchGrid(config=cfg, grid_shape=(gx, gy))


def fv_cell_field(grid, dx, fn):
    """State whose INTERIOR cell means are fn(xc, yc); halos zeroed (the
    sampler must not read them)."""
    cfg = grid.config
    h, P = cfg.halo_size, cfg.patch_size
    Q = np.zeros(grid.state_shape)
    for gx in range(grid.grid_shape[0]):
        for gy in range(grid.grid_shape[1]):
            for i in range(P):
                for j in range(P):
                    xc = (gx * P + i + 0.5) * dx
                    yc = (gy * P + j + 0.5) * dx
                    Q[gx, gy, h + i, h + j, :] = fn(xc, yc)
    return jnp.asarray(Q)


def test_fv_sample_exact_on_linear_fields():
    """Multilinear interpolation of cell means reproduces per-axis-linear
    fields exactly — including across patch boundaries and the periodic
    wrap corner (corners gather from their own patches, so halos are
    never read: they are zeroed here)."""
    from exahype_jax.models.tracers import FVTracerAdvector

    grid = make_fv_grid()
    NX, NY = 12, 8
    dx = 1.0 / NX  # domain 1.0 × 2/3
    f = lambda x, y: np.stack([2.0 + 3.0 * x, 1.0 - y, x + 0.0 * y], -1)
    Q = fv_cell_field(grid, dx, f)
    adv = FVTracerAdvector(grid, dx, lambda v: v[:, :2])
    rng = np.random.default_rng(13)
    # Stay a half-cell inside so the periodic wrap (where linear fields
    # are discontinuous) is not sampled.
    x = jnp.asarray(np.stack([
        rng.uniform(0.5 * dx, 1.0 - 0.5 * dx, 40),
        rng.uniform(0.5 * dx, 2.0 / 3.0 - 0.5 * dx, 40),
    ], -1))
    got = np.asarray(adv.sample(Q, x))
    want = f(np.asarray(x)[:, 0], np.asarray(x)[:, 1])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_fv_constant_advection_trajectory():
    """Uniform velocity field stored in the state: trajectories are exact,
    including the periodic wrap."""
    from exahype_jax.models.tracers import FVTracerAdvector

    grid = make_fv_grid(n_vars=2)
    dx = 1.0 / 12
    Q = fv_cell_field(grid, dx, lambda x, y: np.stack(
        [0.6 + 0.0 * x, -0.4 + 0.0 * y], -1
    ))
    adv = FVTracerAdvector(grid, dx, lambda v: v)
    x0 = jnp.asarray([[0.9, 0.1], [0.3, 0.55]])
    dt, n = 0.05, 6
    x = x0
    for _ in range(n):
        x = adv.advect(Q, x, dt)
    ext = np.asarray(adv.extents)
    want = np.mod(np.asarray(x0) + n * dt * np.asarray([0.6, -0.4]), ext)
    np.testing.assert_allclose(np.asarray(x), want, atol=1e-12)


def test_fv_trajectories_with_grid_solver():
    """FV tracers + the spec-DSL GridSolver advance together in one scan."""
    import jax

    from exahype_jax.models.fv import build_fv_rusanov_kernel
    from exahype_jax.models.tracers import FVTracerAdvector, euler_velocity
    from exahype_jax.parallel import GridSolver

    grid = make_fv_grid(gx=2, gy=2, patch=4, n_vars=4)
    dx = 1.0 / 8
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=4, n_aux=0, n_patches=4,
    )
    solver = GridSolver(grid, kb, dx=dx)
    rho, vx, vy, p = 1.0, 0.4, -0.2, 1.0
    Q = fv_cell_field(grid, dx, lambda x, y: np.stack(
        [rho + 0 * x, rho * vx + 0 * x, rho * vy + 0 * x,
         p / 0.4 + 0.5 * rho * (vx**2 + vy**2) + 0 * x], -1
    ))
    adv = FVTracerAdvector(grid, dx, euler_velocity(2))
    x0 = jnp.asarray([[0.25, 0.5], [0.7, 0.3]])
    dt, n = 5e-3, 4
    run = jax.jit(lambda q, x: adv.trajectories(solver.step, q, x, dt, n))
    Q1, x1, xs, vals = run(Q, x0)
    drift = np.asarray(x1) - np.asarray(x0)
    np.testing.assert_allclose(
        drift, np.broadcast_to([vx * n * dt, vy * n * dt], (2, 2)), atol=1e-7
    )
