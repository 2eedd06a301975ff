"""ADER-DG tree-structured (pool) refinement tests.

Defining checks: a box-shaped refinement set reproduces the box path
(`ADERDGNestedRefinement`) to rounding; arbitrary scattered sets conserve
the refluxed composite mass; one compiled executable serves all patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.aderdg_amr import ADERDGNestedRefinement
from exahype_jax.models.aderdg_pool import ADERDGPoolRefinement, DynamicADERDGPool
from exahype_jax.models import hyperbolic
from exahype_jax.utils.errors import SemanticError


def make_solver(g=6, order=2, velocity=(1.0, 0.4)):
    flux, eig = hyperbolic.advection(velocity)
    return ADERDGSolver(
        dim=2,
        order=order,
        n_vars=1,
        grid_shape=(g, g),
        flux_fn=wrap_var_last(flux),
        max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / g,
    )


def gaussian_state(solver, centre=(0.5, 0.5), width=0.15):
    X, Y = solver.nodes_meshgrid()
    u = jnp.exp(-(((X - centre[0]) ** 2 + (Y - centre[1]) ** 2) / width**2))
    return jnp.broadcast_to(u, solver.state_shape).astype(jnp.float64)


def mass(solver, u):
    return float(solver.total_mass(u)[0])


def test_constant_state_exact():
    solver = make_solver()
    pool = ADERDGPoolRefinement(solver, capacity=4, factor=3)
    mask = np.zeros((6, 6), bool)
    mask[1, 1] = mask[3, 4] = mask[5, 0] = True  # scattered
    tables = pool.build_tables(mask)
    uc = jnp.full(solver.state_shape, 2.5)
    fs = pool.init_pool(uc, tables)
    c, f = pool.step(uc, fs, tables, 1e-3)
    np.testing.assert_allclose(np.asarray(c), 2.5, atol=1e-12)
    # Active block interiors stay constant.
    x = np.asarray(pool.unstack(f))
    r = pool.factor
    act = np.asarray(tables.active)
    interior = x[:, :, :, act, 1 : 1 + r, 1 : 1 + r]
    np.testing.assert_allclose(interior, 2.5, atol=1e-12)


def test_box_mask_matches_nested_refinement():
    """A 2x2 cell box refined via the pool must reproduce the box path."""
    solver = make_solver()
    lo, hi = (2, 2), (4, 4)
    nested = ADERDGNestedRefinement(solver, region_lo=lo, region_hi=hi, factor=3)
    pool = ADERDGPoolRefinement(solver, capacity=4, factor=3)
    mask = np.zeros((6, 6), bool)
    mask[2:4, 2:4] = True
    tables = pool.build_tables(mask)

    uc = gaussian_state(solver)
    uf_box = nested.prolong_initial(uc)
    fs = pool.init_pool(uc, tables)

    n_steps, dt = 4, 2e-3
    c_box, f_box = nested.run(uc, uf_box, n_steps, dt)
    c_pool, f_pool = pool.run(uc, fs, tables, n_steps, dt)

    np.testing.assert_allclose(
        np.asarray(c_pool), np.asarray(c_box), atol=1e-11, rtol=0
    )
    # Fine interiors agree cell by cell: pool block of coarse cell (i,j)
    # vs the box ext grid (offset by the ghost ring and region origin).
    xp = np.asarray(pool.unstack(f_pool))
    xb = np.asarray(f_box)
    r = pool.factor
    coords = np.asarray(tables.coords)
    for m in range(tables.n_active):
        ci, cj = coords[m]
        bi, bj = (ci - lo[0]) * r, (cj - lo[1]) * r
        blk = xp[:, :, :, m, 1 : 1 + r, 1 : 1 + r]
        box = xb[:, :, :, 1 + bi : 1 + bi + r, 1 + bj : 1 + bj + r]
        np.testing.assert_allclose(blk, box, atol=1e-11, rtol=0)


def test_scattered_set_conserves_mass():
    solver = make_solver()
    mask = np.zeros((6, 6), bool)
    mask[1, 1:4] = True  # L-shape
    mask[2:4, 1] = True
    mask[5, 5] = True    # detached, periodic-wrap neighbours
    pool = ADERDGPoolRefinement(solver, capacity=8, factor=3)
    tables = pool.build_tables(mask)

    uc = gaussian_state(solver, centre=(0.3, 0.35))
    fs = pool.init_pool(uc, tables)
    m0 = mass(solver, uc)

    c, f = pool.run(uc, fs, tables, 8, 2e-3)
    assert np.isfinite(np.asarray(c)).all()
    drift = mass(solver, c) - m0
    assert abs(drift) < 1e-12, f"refluxed drift {drift}"

    pool.reflux = False
    c2, _ = pool.run(uc, fs, tables, 8, 2e-3)
    pool.reflux = True
    assert abs(mass(solver, c2) - m0) > 1e-9, (
        "without reflux a measurable drift is expected"
    )


def test_refinement_improves_core_accuracy():
    """With exact fine initial data, blocks whose face neighbours are all
    refined (the cluster core — their rims see fine data, the standard AMR
    caveat applies only to the cluster boundary) beat the coarse-only
    solution evaluated at the same fine nodes."""
    velocity = (1.0, 0.4)
    solver = make_solver(order=1, velocity=velocity)
    dt, n_steps = 2e-3, 10
    t_end = dt * n_steps
    w = 0.15

    def exact_at(coords_list, t):
        X, Y = coords_list
        return jnp.exp(
            -(((X - 0.5 - velocity[0] * t) ** 2 + (Y - 0.5 - velocity[1] * t) ** 2)
              / w**2)
        )

    uc0 = gaussian_state(solver, width=w)
    mask = np.zeros((6, 6), bool)
    mask[1:5, 1:5] = True
    mask[1:3, 5] = True  # non-box appendage
    pool = ADERDGPoolRefinement(solver, capacity=18, factor=3)
    tables = pool.build_tables(mask)

    coords_list = pool.block_nodes_meshgrid(tables)
    fs0 = pool.stack(
        jnp.broadcast_to(
            exact_at(coords_list, 0.0),
            pool.unstack(jnp.zeros(pool.fine.state_shape)).shape,
        ).astype(jnp.float64)
    )

    c_only = jax.jit(lambda u: solver.run(u, n_steps, dt))(uc0)
    _, f_pool = jax.jit(lambda a, b: pool.run(a, b, tables, n_steps, dt))(uc0, fs0)

    fine_exact = np.asarray(exact_at(coords_list, t_end))
    coarse_at_fine = np.asarray(pool.prolong_blocks(c_only, tables.coords))
    xp = np.asarray(pool.unstack(f_pool))

    nb = np.asarray(tables.neighbor)
    act = np.asarray(tables.active)
    core = [
        m for m in range(len(act))
        if act[m] and (nb[m] >= 0).all()
    ]
    assert core, "test needs at least one interior cluster block"
    r = pool.factor
    interior = (slice(None), slice(None), slice(None))  # nodes + V
    e_fine = e_coarse = 0.0
    for m in core:
        sl = interior + (m, slice(1, 1 + r), slice(1, 1 + r))
        ex = np.broadcast_to(fine_exact, xp.shape)[sl]
        e_fine += float(((xp[sl] - ex) ** 2).mean())
        cx = np.broadcast_to(coarse_at_fine, xp.shape)[sl]
        e_coarse += float(((cx - ex) ** 2).mean())
    assert e_fine < 0.5 * e_coarse, (e_fine, e_coarse)


def test_one_executable_serves_all_patterns():
    solver = make_solver()
    pool = ADERDGPoolRefinement(solver, capacity=4, factor=3)
    mask_a = np.zeros((6, 6), bool)
    mask_a[1, 1] = mask_a[2, 2] = True
    mask_b = np.zeros((6, 6), bool)
    mask_b[4, 4] = mask_b[4, 5] = mask_b[0, 3] = True

    uc = gaussian_state(solver)
    # Count actual traces, not jit _cache_size() — the cache proxy is
    # eviction-sensitive in long suites (see tests/test_pool.py).
    n_traces = [0]

    def counted_step(cq, fq, tables, dt):
        n_traces[0] += 1
        return pool.step(cq, fq, tables, dt)

    step = jax.jit(counted_step)
    for mask in (mask_a, mask_b):
        tables = pool.build_tables(mask)
        fs = pool.init_pool(uc, tables)
        c, f = step(uc, fs, tables, 1e-3)
        assert np.isfinite(np.asarray(c)).all()
    assert n_traces[0] == 1, "re-gridding must not retrace"


def test_regrid_carries_and_conserves():
    solver = make_solver()
    pool = ADERDGPoolRefinement(solver, capacity=4, factor=3)
    mask_a = np.zeros((6, 6), bool)
    mask_a[2, 2] = mask_a[2, 3] = True
    mask_b = np.zeros((6, 6), bool)
    mask_b[2, 3] = mask_b[2, 4] = mask_b[3, 3] = True

    uc = gaussian_state(solver, centre=(0.45, 0.55))
    ta = pool.build_tables(mask_a)
    fs = pool.init_pool(uc, ta)
    uc, fs = pool.run(uc, fs, ta, 3, 2e-3)
    m_before = mass(solver, uc)

    tb = pool.build_tables(mask_b)
    fs_b = pool.regrid(uc, fs, ta, tb)
    # The surviving cell (2,3) keeps its block bitwise.
    xa = np.asarray(pool.unstack(fs))
    xb = np.asarray(pool.unstack(fs_b))
    slot_a = [tuple(c) for c in np.asarray(ta.coords)].index((2, 3))
    slot_b = [tuple(c) for c in np.asarray(tb.coords)].index((2, 3))
    np.testing.assert_array_equal(
        xb[:, :, :, slot_b, 1:-1, 1:-1], xa[:, :, :, slot_a, 1:-1, 1:-1]
    )
    uc2, _ = pool.run(uc, fs_b, tb, 3, 2e-3)
    np.testing.assert_allclose(mass(solver, uc2), m_before, atol=1e-12)


def test_dynamic_pool_tracks_and_conserves():
    solver = make_solver(order=1, velocity=(1.0, 0.0))
    uc = gaussian_state(solver, centre=(0.3, 0.5), width=0.1)
    m0 = mass(solver, uc)

    dyn = DynamicADERDGPool(
        solver, capacity=6, factor=3, rel_threshold=0.7
    )
    n_traces = [0]

    def counted_chunk(cq, fq, tables, dt):
        n_traces[0] += 1
        return dyn.pool.run(cq, fq, tables, 5, dt)

    dyn._chunk[5] = jax.jit(counted_chunk)
    c, f, info = dyn.run(uc, n_chunks=6, chunk_steps=5, dt=2e-3)
    masks = [tuple(map(tuple, m)) for m in info["masks"]]
    assert len(set(masks)) > 1, "refinement set never moved"
    np.testing.assert_allclose(mass(solver, c), m0, atol=1e-11)
    assert len(dyn._chunk) == 1
    assert n_traces[0] == 1, "re-gridding retraced the chunk"


def test_3d_smoke():
    flux, eig = hyperbolic.advection((1.0, 0.5, 0.25))
    solver = ADERDGSolver(
        dim=3, order=1, n_vars=1, grid_shape=(4, 4, 4),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=0.25,
    )
    pool = ADERDGPoolRefinement(solver, capacity=2, factor=2)
    mask = np.zeros((4, 4, 4), bool)
    mask[1, 1, 1] = mask[2, 3, 0] = True
    tables = pool.build_tables(mask)

    uc = jnp.full(solver.state_shape, 1.5)
    fs = pool.init_pool(uc, tables)
    c, f = pool.step(uc, fs, tables, 1e-3)
    np.testing.assert_allclose(np.asarray(c), 1.5, atol=1e-12)

    rng = np.random.default_rng(0)
    uc2 = jnp.asarray(1.0 + 0.1 * rng.random(solver.state_shape))
    fs2 = pool.init_pool(uc2, tables)
    m0 = mass(solver, uc2)
    c2, _ = pool.run(uc2, fs2, tables, 3, 1e-3)
    assert np.isfinite(np.asarray(c2)).all()
    np.testing.assert_allclose(mass(solver, c2), m0, atol=1e-12)


def test_validation():
    solver = make_solver()
    pool = ADERDGPoolRefinement(solver, capacity=1, factor=3)
    mask = np.zeros((6, 6), bool)
    mask[0, 0] = mask[1, 1] = True
    with pytest.raises(SemanticError):
        pool.build_tables(mask)
    with pytest.raises(SemanticError):
        pool.build_tables(np.zeros((3, 3), bool))


def test_aderdg_pool_sharded_matches_single_device():
    """GSPMD partitions the coupled pool step (coarse state sharded on grid
    axis 0) bitwise-identically to single-device."""
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel.mesh import PATCH_AXIS, make_mesh

    solver = make_solver(g=8, order=1)
    pool = ADERDGPoolRefinement(solver, capacity=3, factor=3)
    mask = np.zeros((8, 8), bool)
    mask[2, 2] = mask[5, 6] = True
    tables = pool.build_tables(mask)
    uc = gaussian_state(solver)
    fs = pool.init_pool(uc, tables)
    ref_c, ref_f = jax.jit(pool.step)(uc, fs, tables, 1e-3)

    mesh = make_mesh(4)
    spec_list = [None] * len(solver.state_shape)
    spec_list[solver.grid_axis(0)] = PATCH_AXIS
    sh = NamedSharding(mesh, PartitionSpec(*spec_list))
    Qs = jax.device_put(uc, sh)
    c, f = jax.jit(pool.step, in_shardings=(sh, None, None, None))(
        Qs, fs, tables, 1e-3
    )
    np.testing.assert_array_equal(np.asarray(c), np.asarray(ref_c))
    np.testing.assert_array_equal(np.asarray(f), np.asarray(ref_f))


def _euler_blast_solver(g=6, order=2):
    from exahype_jax.models.aderdg import euler_physics

    flux, eig = euler_physics(dim=2, n_real=4)

    # 2-D Euler with 4 vars: [rho, mx, my, E].
    def flux2(Q, axis, var_axis):
        import exahype_jax.models.euler as euler

        return euler.flux_soa(Q, axis, dim=2, n_real=4, var_axis=var_axis)

    def eig2(Q, axis, var_axis):
        import exahype_jax.models.euler as euler

        return euler.max_eigenvalue_soa(Q, axis, dim=2, var_axis=var_axis)

    return ADERDGSolver(
        dim=2, order=order, n_vars=4, grid_shape=(g, g),
        flux_fn=flux2, max_eigenvalue_fn=eig2, dx=1.0 / g,
    )


def test_limited_fine_level_conserves_and_stays_admissible():
    """The production AMR configuration: a LimitedADERDG fine level inside
    the tree pool (fine_factory).  A strong pressure blast in the refined
    cells triggers the subcell limiter on the fine grid; the composite
    mass/energy stay conserved to rounding (the limiter's EFFECTIVE face
    fluxes feed the refluxing) and density/pressure stay positive."""
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    solver = _euler_blast_solver()
    X, Y = solver.nodes_meshgrid()
    rho = jnp.ones(solver.state_shape[:2] + solver.state_shape[3:])
    shape = rho.shape
    Xb = jnp.broadcast_to(jnp.squeeze(X, axis=2), shape)
    Yb = jnp.broadcast_to(jnp.squeeze(Y, axis=2), shape)
    p = 0.1 + 10.0 * jnp.exp(
        -(((Xb - 0.5) ** 2 + (Yb - 0.5) ** 2) / 0.09**2)
    )
    gamma = 1.4
    u0 = jnp.stack(
        [rho, jnp.zeros_like(rho), jnp.zeros_like(rho), p / (gamma - 1.0)],
        axis=2,
    )
    assert u0.shape == solver.state_shape

    mask = np.zeros((6, 6), bool)
    mask[2:4, 2:4] = True
    mask[2, 4] = True  # non-box

    def run_pool(factory):
        pool = ADERDGPoolRefinement(
            solver, capacity=6, factor=3,
            fine_factory=factory, coarse_factory=factory,
        )
        tables = pool.build_tables(mask)
        fs = pool.init_pool(u0, tables)
        return pool.run(u0, fs, tables, 6, 4e-4)

    m0 = np.asarray(solver.total_mass(u0))
    adm = euler_admissible(dim=2)
    c_lim, f_lim = run_pool(lambda s: LimitedADERDG(s, admissible=adm))
    assert bool(jnp.isfinite(c_lim).all()) and bool(jnp.isfinite(f_lim).all())
    m1 = np.asarray(solver.total_mass(c_lim))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12)   # mass
    np.testing.assert_allclose(m1[3], m0[3], rtol=1e-12)   # energy

    # The limiter really engaged: the limited run differs from unlimited.
    c_unl, _ = run_pool(None)
    assert float(jnp.max(jnp.abs(c_lim - c_unl))) > 1e-8

    # Admissibility: the limited FINE solution is nodally admissible in
    # every active block interior; the coarse composite is admissible in
    # the cell-MEAN sense (restriction is an L2 projection, so nodal
    # values may transiently overshoot — the family's standard guarantee
    # is on the means the MOOD detector controls).
    pool = ADERDGPoolRefinement(
        solver, capacity=6, factor=3,
        fine_factory=lambda s: LimitedADERDG(s, admissible=adm),
        coarse_factory=lambda s: LimitedADERDG(s, admissible=adm),
    )
    tables = pool.build_tables(mask)
    xf = pool.unstack(f_lim)
    act = np.asarray(tables.active)
    r = pool.factor
    fine_interior = np.asarray(xf)[:, :, :, act, 1 : 1 + r, 1 : 1 + r]
    ok = np.asarray(adm(jnp.asarray(fine_interior), 2))
    assert ok.all(), "limited fine blocks must stay nodally admissible"

    w = np.asarray(solver.ops.weights)
    means = np.asarray(c_lim)
    for d in reversed(range(2)):
        means = np.tensordot(w, means, axes=([0], [d]))
    rho_m, mx_m, my_m, E_m = (means[k] for k in range(4))
    assert rho_m.min() > 0.0
    p_mean = (gamma - 1.0) * (E_m - 0.5 * (mx_m**2 + my_m**2) / rho_m)
    assert p_mean.min() > 0.0


def test_wall_pool_conserves_mass_and_energy():
    """Reflective walls on the ADER-DG pool (the box path is periodic-only
    — the pool EXCEEDS it here): refined cells on the domain wall get
    mirror ghost cells (nodal flip + reflect_fn), which reproduce the
    wall-aware face stage exactly for reflection-symmetric physics.  Euler
    in a closed box conserves mass and energy to rounding; wall pressure
    changes momentum."""
    from exahype_jax.models.aderdg import euler_reflect, euler_reflect_flux
    from exahype_jax.models import euler

    def flux2(Q, axis, var_axis):
        return euler.flux_soa(Q, axis, dim=2, n_real=4, var_axis=var_axis)

    def eig2(Q, axis, var_axis):
        return euler.max_eigenvalue_soa(Q, axis, dim=2, var_axis=var_axis)

    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(6, 6),
        flux_fn=flux2, max_eigenvalue_fn=eig2, dx=1.0 / 6,
        boundary="reflective",
        reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2),
    )
    pool = ADERDGPoolRefinement(solver, capacity=5, factor=3)
    mask = np.zeros((6, 6), bool)
    mask[0, 0] = mask[0, 1] = True  # wall corner + wall edge
    mask[3, 3] = True               # interior
    tables = pool.build_tables(mask)
    assert bool(np.asarray(tables.wall).any())

    X, Y = solver.nodes_meshgrid()
    shape = (3, 3) + tuple(solver.grid_shape)
    Xb = jnp.broadcast_to(jnp.squeeze(X, axis=2), shape)
    Yb = jnp.broadcast_to(jnp.squeeze(Y, axis=2), shape)
    gamma = 1.4
    rho = jnp.ones(shape)
    p = 1.0 + 2.0 * jnp.exp(-(((Xb - 0.25) ** 2 + (Yb - 0.3) ** 2) / 0.15**2))
    mx = 0.3 * jnp.ones(shape)  # directed flow exercises the wall flux
    u0 = jnp.stack(
        [rho, mx, jnp.zeros(shape), p / (gamma - 1.0) + 0.5 * mx**2 / rho],
        axis=2,
    )

    m0 = np.asarray(solver.total_mass(u0))
    fs = pool.init_pool(u0, tables)
    c, f = pool.run(u0, fs, tables, 8, 1e-3)
    assert bool(jnp.isfinite(c).all())
    m1 = np.asarray(solver.total_mass(c))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12)  # mass
    np.testing.assert_allclose(m1[3], m0[3], rtol=1e-12)  # energy
    assert abs(m1[1] - m0[1]) > 1e-8  # wall pressure


def test_pallas_accelerated_fine_pool():
    """The fused Pallas cell stage drives the pool's fine level:
    TritonADERDG wraps the stacked fine solver through the same
    fine_factory hook (interpret mode on CPU), matching the base pool to
    rounding."""
    from exahype_jax.models.aderdg_triton import TritonADERDG

    solver = make_solver(g=6, order=2)
    mask = np.zeros((6, 6), bool)
    mask[1, 1] = mask[3, 4] = True

    uc = gaussian_state(solver)

    def run(factory):
        pool = ADERDGPoolRefinement(
            solver, capacity=2, factor=3, fine_factory=factory
        )
        tables = pool.build_tables(mask)
        fs = pool.init_pool(uc, tables)
        return pool.run(uc, fs, tables, 3, 2e-3)

    c_ref, f_ref = run(None)
    c_pal, f_pal = run(lambda s: TritonADERDG(s, interpret=True))
    np.testing.assert_allclose(
        np.asarray(c_pal), np.asarray(c_ref), atol=1e-11, rtol=0
    )
    np.testing.assert_allclose(
        np.asarray(f_pal), np.asarray(f_ref), atol=1e-11, rtol=0
    )


def test_wall_pool_3d_smoke():
    """3-D walled ADER-DG pool: constant state exact, Euler box conserves."""
    from exahype_jax.models.aderdg import euler_reflect, euler_reflect_flux
    from exahype_jax.models import euler

    def flux3(Q, axis, var_axis):
        return euler.flux_soa(Q, axis, dim=3, n_real=5, var_axis=var_axis)

    def eig3(Q, axis, var_axis):
        return euler.max_eigenvalue_soa(Q, axis, dim=3, var_axis=var_axis)

    solver = ADERDGSolver(
        dim=3, order=1, n_vars=5, grid_shape=(4, 4, 4),
        flux_fn=flux3, max_eigenvalue_fn=eig3, dx=0.25,
        boundary="reflective",
        reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3),
    )
    pool = ADERDGPoolRefinement(solver, capacity=3, factor=2)
    mask = np.zeros((4, 4, 4), bool)
    mask[0, 0, 0] = mask[1, 2, 3] = True  # wall corner + wall face
    tables = pool.build_tables(mask)
    assert bool(np.asarray(tables.wall).any())

    shape = (2, 2, 2) + tuple(solver.grid_shape)
    rng = np.random.default_rng(3)
    rho = jnp.asarray(1.0 + 0.1 * rng.random(shape))
    mx = 0.2 * jnp.ones(shape)
    gamma = 1.4
    u0 = jnp.stack(
        [rho, mx, jnp.zeros(shape), jnp.zeros(shape),
         2.0 / (gamma - 1.0) + 0.5 * mx**2 / rho],
        axis=3,
    )
    assert u0.shape == solver.state_shape

    m0 = np.asarray(solver.total_mass(u0))
    fs = pool.init_pool(u0, tables)
    c, f = pool.run(u0, fs, tables, 3, 1e-3)
    assert bool(jnp.isfinite(c).all())
    m1 = np.asarray(solver.total_mass(c))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12)  # mass
    np.testing.assert_allclose(m1[4], m0[4], rtol=1e-12)  # energy


def test_closed_box_limited_pool_conserves():
    """VERDICT r2 item 9 capstone: limited AMR in a CLOSED BOX — reflective
    coarse solver, LimitedADERDG on BOTH levels, refluxing on.  The
    limiter's wall-face flux convention (high-wall flux in the last slot,
    single owner, no matching partner) keeps the composite mass and energy
    conserved to rounding with a blast near the wall driving real
    limiting."""
    from exahype_jax.models import euler
    from exahype_jax.models.aderdg import euler_reflect, euler_reflect_flux
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    def flux2(Q, axis, var_axis):
        return euler.flux_soa(Q, axis, dim=2, n_real=4, var_axis=var_axis)

    def eig2(Q, axis, var_axis):
        return euler.max_eigenvalue_soa(Q, axis, dim=2, var_axis=var_axis)

    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(6, 6),
        flux_fn=flux2, max_eigenvalue_fn=eig2, dx=1.0 / 6,
        boundary="reflective",
        reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2),
    )
    adm = euler_admissible(dim=2)
    factory = lambda s: LimitedADERDG(s, admissible=adm)
    pool = ADERDGPoolRefinement(
        solver, capacity=5, factor=3,
        fine_factory=factory, coarse_factory=factory,
    )
    mask = np.zeros((6, 6), bool)
    mask[0, 0] = mask[0, 1] = True  # refined cells ON the wall
    mask[1, 1] = True
    tables = pool.build_tables(mask)
    assert bool(np.asarray(tables.wall).any())

    X, Y = solver.nodes_meshgrid()
    shape = (3, 3) + tuple(solver.grid_shape)
    Xb = jnp.broadcast_to(jnp.squeeze(X, axis=2), shape)
    Yb = jnp.broadcast_to(jnp.squeeze(Y, axis=2), shape)
    gamma = 1.4
    rho = jnp.ones(shape)
    # Strong blast close to the refined wall corner: triggers limiting on
    # both levels and real wall fluxes.
    p = 0.1 + 8.0 * jnp.exp(-(((Xb - 0.2) ** 2 + (Yb - 0.2) ** 2) / 0.1**2))
    u0 = jnp.stack(
        [rho, jnp.zeros(shape), jnp.zeros(shape), p / (gamma - 1.0)],
        axis=2,
    )
    m0 = np.asarray(solver.total_mass(u0))
    fs = pool.init_pool(u0, tables)
    c, f = pool.run(u0, fs, tables, 8, 4e-4)
    assert bool(jnp.isfinite(c).all()) and bool(jnp.isfinite(f).all())
    m1 = np.asarray(solver.total_mass(c))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12)  # mass
    np.testing.assert_allclose(m1[3], m0[3], rtol=1e-12)  # energy

    # The limiter really engaged on this run.
    pool_unl = ADERDGPoolRefinement(solver, capacity=5, factor=3)
    fs_u = pool_unl.init_pool(u0, pool_unl.build_tables(mask))
    c_u, _ = pool_unl.run(u0, fs_u, pool_unl.build_tables(mask), 8, 4e-4)
    assert float(jnp.max(jnp.abs(c - c_u))) > 1e-8


def test_limiter_wall_face_fluxes_contract():
    """The lifted guard: a reflective LimitedADERDG returns effective face
    fluxes; the last slot per direction is the HIGH-WALL flux (zero mass
    component for Euler walls), and untroubled wall rows carry the DG wall
    flux unchanged."""
    from exahype_jax.models import euler
    from exahype_jax.models.aderdg import euler_reflect, euler_reflect_flux
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    def flux2(Q, axis, var_axis):
        return euler.flux_soa(Q, axis, dim=2, n_real=4, var_axis=var_axis)

    def eig2(Q, axis, var_axis):
        return euler.max_eigenvalue_soa(Q, axis, dim=2, var_axis=var_axis)

    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(8, 8),
        flux_fn=flux2, max_eigenvalue_fn=eig2, dx=1.0 / 8,
        boundary="reflective",
        reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2),
    )
    lim = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    X, Y = solver.nodes_meshgrid()
    shape = (3, 3) + tuple(solver.grid_shape)
    Xb = jnp.broadcast_to(jnp.squeeze(X, axis=2), shape)
    gamma = 1.4
    rho = jnp.where(Xb < 0.5, 1.0, 0.125) * jnp.ones(shape)
    p = jnp.where(Xb < 0.5, 1.0, 0.1) * jnp.ones(shape)
    u0 = jnp.stack(
        [rho, jnp.zeros(shape), jnp.zeros(shape), p / (gamma - 1.0)],
        axis=2,
    )
    out, eff = lim.step(u0, 2e-3, return_face_fluxes=True)
    assert len(eff) == 2
    assert bool(jnp.isfinite(out).all())
    # Mass component of the high-wall flux is zero for both directions
    # (the Riemann flux against the Euler mirror ghost carries momentum
    # only) — on the DG rows and the FV rows alike.
    for d in range(2):
        f = np.asarray(eff[d])
        # Face arrays: [n_nodes, V, g0, g1] in 2-D; grid axis d at 2 + d.
        wall = np.take(f, -1, axis=2 + d)
        np.testing.assert_allclose(wall[:, 0, :], 0.0, atol=1e-12)


def test_ghost_fill_composed_map_matches_sequential():
    """The composed-index-map ghost fill must be BITWISE identical to the
    sequential axis-by-axis fill (pure copies compose exactly), including
    corner ghosts between diagonally refined neighbours and wall mirrors."""
    from exahype_jax.models import euler
    from exahype_jax.models.aderdg import euler_reflect, euler_reflect_flux

    def flux2(Q, axis, var_axis):
        return euler.flux_soa(Q, axis, dim=2, n_real=4, var_axis=var_axis)

    def eig2(Q, axis, var_axis):
        return euler.max_eigenvalue_soa(Q, axis, dim=2, var_axis=var_axis)

    for boundary in ("periodic", "reflective"):
        kw = {}
        if boundary == "reflective":
            kw = dict(
                boundary="reflective",
                reflect_fn=euler_reflect(2),
                reflect_flux_fn=euler_reflect_flux(2),
            )
        solver = ADERDGSolver(
            dim=2, order=2, n_vars=4, grid_shape=(6, 6),
            flux_fn=flux2, max_eigenvalue_fn=eig2, dx=1.0 / 6, **kw,
        )
        pool = ADERDGPoolRefinement(solver, capacity=6, factor=3)
        mask = np.zeros((6, 6), bool)
        # Adjacent pair (fine-fine faces), a diagonal pair (corner ghosts),
        # and wall-touching cells.
        mask[2, 2] = mask[2, 3] = mask[3, 4] = True
        mask[0, 0] = mask[5, 5] = True
        tables = pool.build_tables(mask)
        rng = np.random.default_rng(7)
        fs = jnp.asarray(rng.normal(size=pool.fine.state_shape))
        up = jnp.asarray(rng.normal(size=pool.fine.state_shape))
        want = np.asarray(pool.ghost_fill_sequential(fs, up, tables))
        got = np.asarray(pool.ghost_fill(fs, up, tables))
        np.testing.assert_array_equal(got, want, err_msg=boundary)


def test_dynamic_pool_with_row_gathered_coarse_limiter():
    """The capstone composition with the ROW-GATHERED coarse limiter: a
    criteria-driven pool run with the gathered production fallback on the
    coarse level conserves and stays admissible (pinned on CPU at f64)."""
    from exahype_jax.models import euler
    from exahype_jax.models.aderdg_pool import DynamicADERDGPool
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    def flux2(Q, axis, var_axis):
        return euler.flux_soa(Q, axis, dim=2, n_real=4, var_axis=var_axis)

    def eig2(Q, axis, var_axis):
        return euler.max_eigenvalue_soa(Q, axis, dim=2, var_axis=var_axis)

    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=(8, 8),
        flux_fn=flux2, max_eigenvalue_fn=eig2, dx=1.0 / 8,
    )
    adm = euler_admissible(dim=2)
    dyn = DynamicADERDGPool(
        solver, capacity=6, factor=3, rel_threshold=0.5,
        fine_factory=lambda s: LimitedADERDG(s, admissible=adm),
        coarse_factory=lambda s: LimitedADERDG(
            s, admissible=adm, troubled_capacity=4,
            troubled_granularity="row",
            # This test pins EXACT conservation (rtol 1e-12) with a
            # capacity small enough to overflow; only the "candidate"
            # policy keeps overflowed cells exactly conservative (the
            # default "means" trades ~1e-5 flux accounting for
            # unconditional stability).
            overflow_fallback="candidate",
        ),
    )
    X, Y = solver.nodes_meshgrid()
    shape = (3, 3) + tuple(solver.grid_shape)
    Xb = jnp.broadcast_to(jnp.squeeze(jnp.asarray(X), axis=2), shape)
    Yb = jnp.broadcast_to(jnp.squeeze(jnp.asarray(Y), axis=2), shape)
    rho = jnp.ones(shape)
    p = 0.1 + 8.0 * jnp.exp(-(((Xb - 0.4) ** 2 + (Yb - 0.55) ** 2) / 0.1**2))
    u0 = jnp.stack(
        [rho, jnp.zeros(shape), jnp.zeros(shape), p / 0.4], axis=2
    )
    m0 = np.asarray(solver.total_mass(u0))
    c, f, info = dyn.run(u0, n_chunks=3, chunk_steps=3, dt=6e-4)
    m1 = np.asarray(solver.total_mass(c))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12)
    np.testing.assert_allclose(m1[3], m0[3], rtol=1e-12)
    assert bool(jnp.isfinite(c).all()) and bool(jnp.isfinite(f).all())
