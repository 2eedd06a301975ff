"""Static nested refinement tests.

Validation from first principles: coupling operators are exact on constant
states, prolongation picks the containing coarse cell, and refining a
region around a feature reduces the error there versus the coarse-only run.
"""

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.models import hyperbolic
from exahype_jax.models.fv import build_fv_rusanov_kernel
from exahype_jax.parallel import GridSolver, PatchGrid
from exahype_jax.parallel.refine import NestedRefinement
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.output import assemble_global


def make_advection_setup(gx=4, gy=4, patch=4, factor=3, velocity=(1.0, 0.0)):
    cfg = KernelConfig(
        dim=2, patch_size=patch, halo_size=1, n_real=1, n_aux=0, n_patches=gx * gy
    )
    grid = PatchGrid(config=cfg, grid_shape=(gx, gy))
    flux, eig = hyperbolic.advection(velocity)
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=patch, halo_size=1, n_real=1, n_aux=0,
        n_patches=gx * gy, flux_impl=flux, eigenvalue_impl=eig,
    )
    solver = GridSolver(grid, kb, dx=1.0 / (gx * patch), kernel_dt="lambda")
    nested = NestedRefinement(
        solver, region_lo=(1, 1), region_hi=(3, 3), factor=factor
    )
    return solver, nested


def test_constant_state_exact():
    solver, nested = make_advection_setup()
    coarse_Q = jnp.full(solver.grid.state_shape, 2.5)
    fine_Q = nested.prolong_initial(coarse_Q)
    fine_Q = nested.prolong_halo_overwrite(nested.fine_grid.halo_fill(fine_Q), coarse_Q)
    c, f = nested.step(coarse_Q, fine_Q, 1e-3)
    np.testing.assert_allclose(np.asarray(c), 2.5, rtol=0, atol=1e-13)
    # Fine interiors stay constant (halos are overwritten each substep).
    h = solver.grid.config.halo_size
    np.testing.assert_allclose(
        np.asarray(f)[:, :, h:-h, h:-h, :], 2.5, rtol=0, atol=1e-13
    )


def test_prolongation_picks_containing_coarse_cell():
    solver, nested = make_advection_setup(factor=3)
    cfg = solver.grid.config
    # Coarse global field = global x-cell index.
    n_cells = solver.grid.grid_shape[0] * cfg.patch_size
    glob = np.broadcast_to(
        np.arange(n_cells, dtype=float)[:, None, None], (n_cells, n_cells, 1)
    )
    from exahype_jax.utils.output import disassemble_global

    coarse_Q = disassemble_global(
        solver.grid, jnp.zeros(solver.grid.state_shape), jnp.asarray(glob)
    )
    fine_Q = nested.prolong_initial(coarse_Q)
    fine_glob = np.asarray(assemble_global(nested.fine_grid, fine_Q))
    # Fine cell m along x lies in coarse cell region_lo*P + m//r.
    r, P = nested.factor, cfg.patch_size
    m = np.arange(fine_glob.shape[0])
    expect = nested.region_lo[0] * P + m // r
    np.testing.assert_array_equal(fine_glob[:, 0, 0], expect)


def gaussian_coarse_state(solver, t=0.0, velocity=(1.0, 0.0), width=0.08):
    """Gaussian bump centred in the refined region, advected by ``t``."""
    cfg = solver.grid.config
    n = solver.grid.grid_shape[0] * cfg.patch_size
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    cx, cy = 0.5 + velocity[0] * t, 0.5 + velocity[1] * t
    u = np.exp(-(((X - cx) ** 2 + (Y - cy) ** 2) / width**2))
    from exahype_jax.utils.output import disassemble_global

    return disassemble_global(
        solver.grid, jnp.zeros(solver.grid.state_shape), jnp.asarray(u[..., None])
    )


def region_error(nested, solver, result_global, exact_global):
    """L2 error over the refined region at coarse resolution."""
    P = solver.grid.config.patch_size
    sl = tuple(
        slice(lo * P, hi * P) for lo, hi in zip(nested.region_lo, nested.region_hi)
    )
    diff = result_global[sl] - exact_global[sl]
    return float(np.sqrt((diff**2).mean()))


def gaussian_fine_state(nested, t=0.0, velocity=(1.0, 0.0), width=0.08):
    """Exact initial data sampled at fine resolution inside the region."""
    from exahype_jax.utils.output import disassemble_global

    cfg = nested.coarse.grid.config
    P, r = cfg.patch_size, nested.factor
    n_coarse = nested.coarse.grid.grid_shape[0] * P
    lo = nested.region_lo[0] * P * r
    n_f = nested.fine_grid.grid_shape[0] * P
    xf = (lo + np.arange(n_f) + 0.5) / (n_coarse * r)
    X, Y = np.meshgrid(xf, xf, indexing="ij")
    cx, cy = 0.5 + velocity[0] * t, 0.5 + velocity[1] * t
    u = np.exp(-(((X - cx) ** 2 + (Y - cy) ** 2) / width**2))
    return disassemble_global(
        nested.fine_grid,
        jnp.zeros(nested.fine_grid.state_shape),
        jnp.asarray(u[..., None]),
    )


def test_refinement_reduces_region_error():
    """First-order diffusion dominates; refining the region around the bump
    must cut the error there substantially versus coarse-only."""
    velocity = (1.0, 0.0)
    solver, nested = make_advection_setup(gx=4, gy=4, patch=4, factor=3, velocity=velocity)
    t_end = 0.1
    n_steps = 40
    dt = t_end / n_steps

    coarse_Q = gaussian_coarse_state(solver, velocity=velocity)
    exact = np.asarray(
        assemble_global(solver.grid, gaussian_coarse_state(solver, t=t_end, velocity=velocity))
    )[..., 0]

    # Coarse-only run.
    c_only = coarse_Q
    for _ in range(n_steps):
        c_only = solver.step(c_only, dt)
    err_coarse = region_error(
        nested, solver, np.asarray(assemble_global(solver.grid, c_only))[..., 0], exact
    )

    # Two-level run with fine-resolution initial data in the region.
    fine_Q = gaussian_fine_state(nested, velocity=velocity)
    c2, f2 = nested.run(coarse_Q, fine_Q, n_steps, dt)
    err_nested = region_error(
        nested, solver, np.asarray(assemble_global(solver.grid, c2))[..., 0], exact
    )

    assert np.isfinite(np.asarray(c2)).all() and np.isfinite(np.asarray(f2)).all()
    assert err_nested < 0.6 * err_coarse, (
        f"refined-region error {err_nested:.4g} not better than coarse-only "
        f"{err_coarse:.4g}"
    )


def test_two_level_step_jits():
    solver, nested = make_advection_setup()
    coarse_Q = gaussian_coarse_state(solver)
    fine_Q = nested.prolong_initial(coarse_Q)
    stepped = jax.jit(nested.step)
    c, f = stepped(coarse_Q, fine_Q, 1e-3)
    assert c.shape == coarse_Q.shape and f.shape == fine_Q.shape


def test_nested_refinement_3d_smoke():
    cfg = KernelConfig(
        dim=3, patch_size=3, halo_size=1, n_real=1, n_aux=0, n_patches=27
    )
    grid = PatchGrid(config=cfg, grid_shape=(3, 3, 3))
    flux, eig = hyperbolic.advection((1.0, 0.5, 0.25))
    kb = build_fv_rusanov_kernel(
        dim=3, patch_size=3, halo_size=1, n_real=1, n_aux=0,
        n_patches=27, flux_impl=flux, eigenvalue_impl=eig,
    )
    solver = GridSolver(grid, kb, dx=1.0 / 9, kernel_dt="lambda")
    nested = NestedRefinement(solver, region_lo=(1, 1, 1), region_hi=(2, 2, 2), factor=2)
    rng = np.random.default_rng(0)
    coarse_Q = jnp.asarray(rng.normal(size=grid.state_shape))
    fine_Q = nested.prolong_initial(coarse_Q)
    c, f = nested.step(coarse_Q, fine_Q, 1e-3)
    assert np.isfinite(np.asarray(c)).all() and np.isfinite(np.asarray(f)).all()
    # Constant input -> constant output, 3-D.
    coarse_C = jnp.full(grid.state_shape, 1.5)
    fine_C = nested.prolong_initial(coarse_C)
    c2, f2 = nested.step(coarse_C, fine_C, 1e-3)
    np.testing.assert_allclose(np.asarray(c2), 1.5, atol=1e-13)


def test_region_validation():
    solver, _ = make_advection_setup()
    import pytest

    from exahype_jax.utils.errors import SemanticError

    with pytest.raises(SemanticError):
        NestedRefinement(solver, region_lo=(0, 0), region_hi=(9, 2), factor=3)


def test_refinement_criteria():
    from exahype_jax.parallel.criteria import (
        gradient_indicator,
        jump_indicator,
        region_around_max,
    )

    solver, nested = make_advection_setup()
    Q = gaussian_coarse_state(solver)
    for indicator in (gradient_indicator, jump_indicator):
        scores = indicator(solver.grid, Q)
        assert scores.shape == solver.grid.grid_shape
        lo, hi = region_around_max(scores, solver.grid.grid_shape)
        # The bump sits at the domain centre: patches (1..2, 1..2).
        assert 1 <= lo[0] + 1 <= 3 and 1 <= lo[1] + 1 <= 3
        assert all(0 <= a < b <= g for a, b, g in zip(lo, hi, solver.grid.grid_shape))


def test_three_level_hierarchy():
    """Recursive nesting: coarse -> fine (factor 3) -> finer (factor 3).
    Constant states are exact through the whole hierarchy; a Gaussian run
    stays finite and the deepest level tracks the solution."""
    solver, nested = make_advection_setup(gx=4, gy=4)
    inner = nested.nest(region_lo=(2, 2), region_hi=(4, 4), factor=2)
    assert nested.inner is inner

    coarse_C = jnp.full(solver.grid.state_shape, 3.25)
    state_C = nested.init_state(coarse_C)
    c, (f, ff) = nested.step(coarse_C, state_C, 1e-3)
    np.testing.assert_allclose(np.asarray(c), 3.25, atol=1e-13)
    h = solver.grid.config.halo_size
    np.testing.assert_allclose(
        np.asarray(ff)[:, :, h:-h, h:-h, :], 3.25, atol=1e-13
    )

    coarse_Q = gaussian_coarse_state(solver)
    state = nested.init_state(coarse_Q)
    c2, (f2, ff2) = nested.run(coarse_Q, state, 6, 1e-3)
    for arr in (c2, f2, ff2):
        assert np.isfinite(np.asarray(arr)).all()
    # The deepest grid has the expected shape: inner region 2x2 fine
    # patches at factor 2 -> 4x4 finer patches.
    assert ff2.shape[:2] == (4, 4)


def hierarchy_mass(nested, solver, c, f):
    """Conserved quantity of the two-level composite: coarse mass outside
    the region + fine mass inside."""
    P = solver.grid.config.patch_size
    r = nested.factor
    cg = np.asarray(assemble_global(solver.grid, c))[..., 0]
    fg = np.asarray(assemble_global(nested.fine_grid, f))[..., 0]
    mask = np.ones_like(cg, dtype=bool)
    sl = tuple(
        slice(lo * P, hi * P) for lo, hi in zip(nested.region_lo, nested.region_hi)
    )
    mask[sl] = False
    return cg[mask].sum() * solver.dx**2 + fg.sum() * (solver.dx / r) ** 2


def test_refluxing_conserves_to_machine_precision():
    """Berger-Colella refluxing: the composite coarse+fine mass is conserved
    exactly (drift was ~7e-6 without flux correction)."""
    solver, nested = make_advection_setup(gx=4, gy=4)
    coarse_Q = gaussian_coarse_state(solver)
    fine_Q = gaussian_fine_state(nested)
    m0 = hierarchy_mass(nested, solver, coarse_Q, fine_Q)

    c, f = nested.run(coarse_Q, fine_Q, 20, 1e-3)
    drift = hierarchy_mass(nested, solver, c, f) - m0
    assert abs(drift) < 1e-13, f"refluxed drift {drift}"

    nested.reflux = False
    c2, f2 = nested.run(coarse_Q, fine_Q, 20, 1e-3)
    drift2 = hierarchy_mass(nested, solver, c2, f2) - m0
    nested.reflux = True
    assert abs(drift2) > 1e-7, "without reflux a measurable drift is expected"


def test_three_level_refluxing_conserves():
    """Refluxing applies recursively: the coarse+fine+finer composite mass
    is conserved to machine precision through both interfaces."""
    solver, nested = make_advection_setup(gx=4, gy=4)
    inner = nested.nest(region_lo=(2, 2), region_hi=(4, 4), factor=2)

    coarse_Q = gaussian_coarse_state(solver)
    fine_Q = gaussian_fine_state(nested)
    finer_Q = inner.init_state(fine_Q)

    P = solver.grid.config.patch_size
    r1, r2 = nested.factor, inner.factor

    def composite_mass(c, f, ff):
        cg = np.asarray(assemble_global(solver.grid, c))[..., 0]
        fg = np.asarray(assemble_global(nested.fine_grid, f))[..., 0]
        ffg = np.asarray(assemble_global(inner.fine_grid, ff))[..., 0]
        cmask = np.ones_like(cg, dtype=bool)
        cmask[tuple(
            slice(lo * P, hi * P)
            for lo, hi in zip(nested.region_lo, nested.region_hi)
        )] = False
        fmask = np.ones_like(fg, dtype=bool)
        fmask[tuple(
            slice(lo * P, hi * P)
            for lo, hi in zip(inner.region_lo, inner.region_hi)
        )] = False
        dx = solver.dx
        return (
            cg[cmask].sum() * dx**2
            + fg[fmask].sum() * (dx / r1) ** 2
            + ffg.sum() * (dx / (r1 * r2)) ** 2
        )

    m0 = composite_mass(coarse_Q, fine_Q, finer_Q)
    c, (f, ff) = nested.run(coarse_Q, (fine_Q, finer_Q), 12, 1e-3)
    drift = composite_mass(np.asarray(c), np.asarray(f), np.asarray(ff)) - m0
    assert abs(drift) < 1e-13, f"3-level refluxed drift {drift}"


def test_nested_refinement_sharded_matches_single_device():
    """The whole coupled hierarchy step runs under GSPMD with the coarse
    state sharded over a device mesh, bitwise-equal to single-device."""
    from exahype_jax.parallel.mesh import make_mesh, state_sharding

    solver, nested = make_advection_setup(gx=4, gy=4)
    coarse_Q = gaussian_coarse_state(solver)
    fine_Q = gaussian_fine_state(nested)
    ref_c, ref_f = jax.jit(nested.step)(coarse_Q, fine_Q, 1e-3)

    mesh = make_mesh(4)
    sh = state_sharding(mesh, solver.grid)
    Qs = jax.device_put(coarse_Q, sh)
    c, f = jax.jit(nested.step, in_shardings=(sh, None, None))(Qs, fine_Q, 1e-3)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(ref_c))
    np.testing.assert_array_equal(np.asarray(f), np.asarray(ref_f))


def test_dynamic_refinement_tracks_and_conserves():
    """DynamicRefinement (re-gridding as API, round-1 review item 10): the
    refined region follows an advecting bump across >= 2 distinct boxes, and
    the composite solution conserves mass to rounding ACROSS re-grid events
    (restrict before / piecewise-constant prolong after preserve means;
    refluxing conserves within chunks)."""
    from exahype_jax.parallel.refine import DynamicRefinement

    solver, _ = make_advection_setup(gx=6, gy=6)
    grid = solver.grid
    n = 6 * grid.config.patch_size
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    u0 = np.exp(-(((X - 0.2) ** 2 + (Y - 0.5) ** 2) / 0.08**2))
    from exahype_jax.utils.output import disassemble_global

    coarse_Q = disassemble_global(
        grid, jnp.zeros(grid.state_shape), jnp.asarray(u0[..., None])
    )

    def mass(Q):
        g = np.asarray(assemble_global(grid, Q))[..., 0]
        return g.sum() * solver.dx**2

    m0 = mass(coarse_Q)
    dyn = DynamicRefinement(solver)
    coarse_Q, fine_Q, info = dyn.run(coarse_Q, n_chunks=8, chunk_steps=8, dt=2.5e-3)

    regions = info["regions"]
    assert len(set(regions)) > 1, f"region never moved: {regions}"
    # Region moved => at least one re-grid event happened mid-run.
    np.testing.assert_allclose(mass(coarse_Q), m0, rtol=1e-12)
    # The returned fine state matches the final hierarchy's shape.
    assert fine_Q.shape == info["nested"].fine_grid.state_shape
    assert bool(jnp.isfinite(coarse_Q).all()) and bool(jnp.isfinite(fine_Q).all())
