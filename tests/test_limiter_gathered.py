"""Gathered (capacity-based) subcell fallback — the production limiter path.

The whole-grid fallback runs the (2N+1)^d FV step over EVERY cell each
step; the gathered path runs it only on the troubled slots, with slot-table
ghost exchange.  These tests pin its contract:

- with every cell troubled and capacity == n_cells, the gathered step
  reproduces the whole-grid fallback exactly (the slot exchange then IS the
  periodic roll, just permuted into slot order);
- the full gathered limited step conserves mass to rounding on a shock
  (mixed DG/FV faces single-valued through the scattered flux table);
- overflow beyond the capacity degrades per `overflow_fallback`
  ("candidate" keeps the DG candidate; the default "means" applies the
  stable first-order cell-mean update);
- reflective walls use the same mirror convention as the whole-grid path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import (
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
    wrap_var_last,
)
from exahype_jax.models.limiter import LimitedADERDG, euler_admissible


def make_solver(cells=12, order=3, **kw):
    flux, eig = euler_physics(dim=2, n_real=4)
    return ADERDGSolver(
        dim=2, order=order, n_vars=4, grid_shape=(cells, cells),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / cells, **kw,
    )


def sod_like_state(solver):
    coords = solver.nodes_meshgrid()
    x = np.broadcast_to(
        np.squeeze(coords[0], axis=solver.var_axis),
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :],
    )
    left = x < 0.5
    rho = np.where(left, 1.0, 0.125)
    p = np.where(left, 1.0, 0.1)
    E = p / 0.4
    Q = np.stack(
        [rho, np.zeros_like(rho), np.zeros_like(rho), E],
        axis=solver.var_axis,
    )
    return jnp.asarray(Q)


def test_gathered_all_troubled_matches_whole_grid():
    solver = make_solver(cells=8, order=2)
    n_cells = 64
    whole = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    gathered = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=n_cells
    )
    Q0 = sod_like_state(solver)
    dt = 2e-3
    force_all = lambda t: jnp.ones_like(t)
    a = np.asarray(whole.step(Q0, dt, troubled_transform=force_all))
    b = np.asarray(gathered.step(Q0, dt, troubled_transform=force_all))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)


def test_gathered_all_troubled_face_fluxes_match():
    solver = make_solver(cells=8, order=2)
    whole = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    gathered = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=64
    )
    Q0 = sod_like_state(solver)
    force_all = lambda t: jnp.ones_like(t)
    _, eff_a = whole.step(
        Q0, 2e-3, return_face_fluxes=True, troubled_transform=force_all
    )
    _, eff_b = gathered.step(
        Q0, 2e-3, return_face_fluxes=True, troubled_transform=force_all
    )
    for a, b in zip(eff_a, eff_b):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=0, atol=1e-13
        )


def test_gathered_limited_step_exactly_conservative():
    solver = make_solver(cells=12, order=3)
    # On this 12x12 grid the full-height shock marks 50-100% of cells
    # troubled (realistic runs are 1-5% on grids 1000x larger) — capacity
    # must cover the troubled set or the overflow keeps inadmissible DG
    # candidates.
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=144
    )
    Q0 = sod_like_state(solver)
    m0 = np.asarray(solver.total_mass(Q0))
    Q = limited.run(Q0, 20, 4e-3)
    m1 = np.asarray(solver.total_mass(Q))
    np.testing.assert_allclose(m1, m0, rtol=0, atol=1e-12)
    ok = euler_admissible(dim=2)(Q, solver.var_axis)
    assert bool(np.asarray(ok).all())


def test_gathered_matches_whole_grid_where_untroubled():
    """Cells far from any troubled cell must be identical between the two
    paths (they take the pure DG candidate in both)."""
    solver = make_solver(cells=12, order=3)
    whole = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    gathered = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=60
    )
    Q0 = sod_like_state(solver)
    dt = 4e-3
    candidate = solver.step(Q0, dt)
    troubled = np.asarray(whole.troubled_mask(Q0, candidate))
    a = np.asarray(whole.step(Q0, dt))
    b = np.asarray(gathered.step(Q0, dt))
    # Mask of cells with no troubled cell in their face neighbourhood
    # (those cells see neither the fallback nor interface matching).
    near = troubled.copy()
    for d in range(2):
        near |= np.roll(troubled, 1, axis=d) | np.roll(troubled, -1, axis=d)
    far = ~near
    assert far.any() and troubled.any()
    np.testing.assert_array_equal(a[..., far], b[..., far])


def test_gathered_overflow_keeps_dg_candidate():
    solver = make_solver(cells=12, order=3)
    cap = 4
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=cap,
        overflow_fallback="candidate",
    )
    Q0 = sod_like_state(solver)
    dt = 4e-3
    candidate = solver.step(Q0, dt)
    troubled = limited.troubled_mask(Q0, candidate)
    assert int(np.asarray(troubled).sum()) > cap
    tables = limited._gather_tables(troubled)
    assert int(np.asarray(tables["active"]).sum()) == cap
    gathered_mask = np.asarray(tables["mask"])
    assert gathered_mask.sum() == cap
    assert (gathered_mask <= np.asarray(troubled)).all()
    out = np.asarray(limited.step(Q0, dt))
    assert np.isfinite(out).all()
    # Troubled-but-overflowed cells hold the DG candidate — except where
    # they neighbour a gathered cell, whose interface matching (correctly)
    # rewrites the shared face's flux to keep it single-valued.
    near_gathered = gathered_mask.copy()
    for d in range(2):
        near_gathered |= np.roll(gathered_mask, 1, axis=d)
        near_gathered |= np.roll(gathered_mask, -1, axis=d)
    skipped = np.asarray(troubled) & ~near_gathered
    assert skipped.any()
    np.testing.assert_array_equal(
        out[..., skipped], np.asarray(candidate)[..., skipped]
    )


def test_gathered_reflective_walls_conserve():
    solver = make_solver(
        cells=8, order=2, boundary="reflective",
        reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2),
    )
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=64
    )
    Q0 = sod_like_state(solver)
    m0 = np.asarray(solver.total_mass(Q0))[0]  # mass: zero wall flux
    Q = limited.run(Q0, 15, 3e-3)
    m1 = np.asarray(solver.total_mass(Q))[0]
    np.testing.assert_allclose(m1, m0, rtol=0, atol=1e-12)
    ok = euler_admissible(dim=2)(Q, solver.var_axis)
    assert bool(np.asarray(ok).all())


def test_gathered_rejects_unsupported_configs():
    solver = make_solver(cells=8, order=2)
    with pytest.raises(ValueError, match="troubled_capacity"):
        LimitedADERDG(solver, fallback="means", troubled_capacity=8)
    with pytest.raises(ValueError, match="troubled_capacity"):
        LimitedADERDG(solver, fallback_order=2, troubled_capacity=8)


def test_gathered_with_bfo_accelerator_matches():
    """The full production stack: gathered fallback + the fused Pallas
    cell stage, whose face-flux contract composes with the limiter."""
    from exahype_jax.models.aderdg_triton import TritonADERDG

    solver = make_solver(cells=8, order=2)
    plain = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=64
    )
    accel = TritonADERDG(solver, interpret=True)
    fast = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=64,
        accelerator=accel,
    )
    Q0 = sod_like_state(solver)
    dt = 2e-3
    ref = np.asarray(plain.step(Q0, dt))
    got = np.asarray(fast.step(Q0, dt))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11)


def test_row_gathered_with_sharded_accelerator_matches():
    """The complete multi-device stack: fused cell stage under shard_map
    (ppermute edge exchange) + row-gathered fallback + matching, all
    GSPMD-partitioned around the shard_map region — matches the
    single-device accelerated gathered step to 1e-12."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.models.aderdg_triton import TritonADERDG
    from exahype_jax.parallel import make_mesh
    from exahype_jax.parallel.shard import ShardedADERDG

    solver = make_solver(cells=8, order=2)
    ref_lim = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2),
        troubled_capacity=8, troubled_granularity="row",
        accelerator=TritonADERDG(solver, interpret=True),
    )
    Q0 = sod_like_state(solver)
    dt = 2e-3
    ref = np.asarray(jax.jit(ref_lim.step)(Q0, dt))

    mesh = make_mesh(8)
    accel = ShardedADERDG(
        solver, mesh,
        cell_stage=lambda s: TritonADERDG(s, interpret=True).cell_stage,
    )
    lim = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2),
        troubled_capacity=8, troubled_granularity="row",
        accelerator=accel,
    )
    ndim = len(solver.state_shape)
    spec = [None] * ndim
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    Qs = jax.device_put(Q0, sharding)
    stepped = jax.jit(
        lim.step, in_shardings=(sharding, None), out_shardings=sharding
    )
    got = np.asarray(stepped(Qs, dt))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    hlo = stepped.lower(Qs, dt).compile().as_text()
    assert "collective-permute" in hlo


# -------------------------------- row-granular gathering (the production path)


def test_row_gathered_all_troubled_matches_whole_grid():
    solver = make_solver(cells=8, order=2)
    whole = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    gathered = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=8,
        troubled_granularity="row",
    )
    Q0 = sod_like_state(solver)
    dt = 2e-3
    force_all = lambda t: jnp.ones_like(t)
    a = np.asarray(whole.step(Q0, dt, troubled_transform=force_all))
    b = np.asarray(gathered.step(Q0, dt, troubled_transform=force_all))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)
    _, eff_a = whole.step(
        Q0, dt, return_face_fluxes=True, troubled_transform=force_all
    )
    _, eff_b = gathered.step(
        Q0, dt, return_face_fluxes=True, troubled_transform=force_all
    )
    for x, y in zip(eff_a, eff_b):
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(x), rtol=0, atol=1e-13
        )


def test_row_gathered_conserves_and_admissible():
    solver = make_solver(cells=12, order=3)
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=12,
        troubled_granularity="row",
    )
    Q0 = sod_like_state(solver)
    m0 = np.asarray(solver.total_mass(Q0))
    Q = limited.run(Q0, 20, 4e-3)
    m1 = np.asarray(solver.total_mass(Q))
    np.testing.assert_allclose(m1, m0, rtol=0, atol=1e-12)
    ok = euler_admissible(dim=2)(Q, solver.var_axis)
    assert bool(np.asarray(ok).all())


def test_row_gathered_untroubled_cells_keep_dg():
    """Untroubled cells INSIDE a gathered row keep the DG candidate (the
    per-cell mask decides, not the row)."""
    solver = make_solver(cells=12, order=3)
    lim = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=12,
        troubled_granularity="row",
    )
    Q0 = sod_like_state(solver)
    dt = 4e-3
    candidate = solver.step(Q0, dt)
    troubled = np.asarray(lim.troubled_mask(Q0, candidate))
    assert troubled.any() and not troubled.all()
    out = np.asarray(lim.step(Q0, dt))
    # Cells with no troubled neighbour anywhere near: untouched candidate.
    near = troubled.copy()
    for d in range(2):
        near |= np.roll(troubled, 1, axis=d) | np.roll(troubled, -1, axis=d)
    far = ~near
    assert far.any()
    np.testing.assert_array_equal(
        out[..., far], np.asarray(candidate)[..., far]
    )


def test_row_gathered_overflow_and_walls():
    solver = make_solver(
        cells=8, order=2, boundary="reflective",
        reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2),
    )
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=8,
        troubled_granularity="row",
    )
    Q0 = sod_like_state(solver)
    m0 = np.asarray(solver.total_mass(Q0))[0]
    Q = limited.run(Q0, 15, 3e-3)
    m1 = np.asarray(solver.total_mass(Q))[0]
    np.testing.assert_allclose(m1, m0, rtol=0, atol=1e-12)
    ok = euler_admissible(dim=2)(Q, solver.var_axis)
    assert bool(np.asarray(ok).all())
    # Overflow: capacity 1 row on a shock spanning many rows stays finite
    # and conservative (ungathered rows keep the conservative DG update).
    tiny = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=1,
        troubled_granularity="row",
    )
    Q2 = tiny.step(Q0, 3e-3)
    assert bool(jnp.isfinite(Q2).all())


def test_row_gathered_3d_matches_cell_gathered_quality():
    """3-D smoke: the row path runs on a 3-D grid and conserves."""
    flux, eig = euler_physics(dim=3, n_real=5)
    solver = ADERDGSolver(
        dim=3, order=2, n_vars=5, grid_shape=(6, 4, 8),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / 6,
    )
    from exahype_jax.models.limiter import euler_admissible as adm3
    lim = LimitedADERDG(
        solver, admissible=adm3(dim=3), troubled_capacity=24,
        troubled_granularity="row",
    )
    x = np.arange(6).reshape(-1, 1, 1) / 6.0
    left = np.broadcast_to(x < 0.5, (6, 4, 8))
    no_var = solver.state_shape[: solver.var_axis] + solver.state_shape[solver.var_axis + 1 :]
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), no_var)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), no_var)
    z = np.zeros(no_var)
    Q0 = jnp.asarray(np.stack([rho, z, z, z, p / 0.4], axis=solver.var_axis))
    m0 = np.asarray(solver.total_mass(Q0))
    Q = lim.run(Q0, 10, 4e-3)
    m1 = np.asarray(solver.total_mass(Q))
    np.testing.assert_allclose(m1, m0, rtol=0, atol=1e-12)
    assert bool(jnp.isfinite(Q).all())


def test_row_gathered_sharded_matches_single_device():
    """The production limited path under GSPMD: grid axis 0 sharded over
    the 8-device mesh; the gathered row fallback's compaction, gathers and
    scatters partition through XLA collectives and match single-device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    solver = make_solver(cells=8, order=2)
    lim = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=8,
        troubled_granularity="row",
    )
    Q0 = sod_like_state(solver)
    dt = 2e-3
    ref = np.asarray(jax.jit(lambda q: lim.step(q, dt))(Q0))

    mesh = make_mesh(8)
    ndim = len(solver.state_shape)
    spec = [None] * ndim
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    Qs = jax.device_put(Q0, sharding)
    got = np.asarray(
        jax.jit(
            lambda q: lim.step(q, dt),
            in_shardings=(sharding,),
            out_shardings=sharding,
        )(Qs)
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("granularity", ["cell", "row"])
def test_gathered_source_ncp_mask_anisotropic_parity(granularity):
    """The gathered fallback handles source terms, non-conservative
    products, dissipation masks, and anisotropic dx exactly like the
    whole-grid fallback (all-troubled bitwise parity, one solver carrying
    all four features)."""
    def flux(Q, axis, va):
        return 0.5 * Q * Q  # Burgers-like, per component

    def eig(Q, axis, va):
        return jnp.max(jnp.abs(Q), axis=va)

    def ncp(Q, dQ, axis, va):
        return 0.1 * dQ

    def src(Q, va):
        return -0.2 * Q

    solver = ADERDGSolver(
        dim=2, order=2, n_vars=2, grid_shape=(6, 8),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=(0.2, 0.15),
        ncp_fn=ncp, source_fn=src, dissipation_mask=(1.0, 0.0),
    )
    whole = LimitedADERDG(solver)
    gathered = LimitedADERDG(
        solver, troubled_capacity=48 if granularity == "cell" else 6,
        troubled_granularity=granularity,
    )
    rng = np.random.default_rng(11)
    u0 = jnp.asarray(0.5 + rng.random(solver.state_shape))
    force_all = lambda t: jnp.ones_like(t)
    dt = 1e-3
    a = np.asarray(whole.step(u0, dt, troubled_transform=force_all))
    b = np.asarray(gathered.step(u0, dt, troubled_transform=force_all))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-14)


@pytest.mark.parametrize("granularity", ["cell", "row"])
def test_gathered_random_masks_conserve(granularity):
    """Randomized forced-troubled sets (scattered, clustered, wrapping):
    every pattern conserves mass to rounding through the gathered path —
    the mixed-face flux table must be single-valued for ARBITRARY sets,
    not just shock fronts."""
    solver = make_solver(cells=8, order=2)
    lim = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2),
        troubled_capacity=64 if granularity == "cell" else 8,
        troubled_granularity=granularity,
    )
    Q0 = sod_like_state(solver)
    m0 = np.asarray(solver.total_mass(Q0))
    rng = np.random.default_rng(17)
    for trial in range(4):
        mask = jnp.asarray(rng.random((8, 8)) < (0.15 + 0.2 * trial))
        out = lim.step(Q0, 2e-3, troubled_transform=lambda t: mask)
        m1 = np.asarray(solver.total_mass(out))
        np.testing.assert_allclose(
            m1, m0, rtol=0, atol=1e-12,
            err_msg=f"{granularity} trial {trial}",
        )
        assert bool(jnp.isfinite(out).all())


@pytest.mark.parametrize("granularity", ["cell", "row"])
def test_capacity_usage_diagnostic(granularity):
    solver = make_solver(cells=8, order=2)
    lim = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=4,
        troubled_granularity=granularity,
    )
    Q0 = sod_like_state(solver)
    import jax

    demand, cap = jax.jit(lim.capacity_usage)(Q0, 2e-3)
    assert cap == 4
    cand = solver.step(Q0, 2e-3)
    t = np.asarray(lim.troubled_mask(Q0, cand))
    want = t.any(axis=-1).sum() if granularity == "row" else t.sum()
    assert int(demand) == int(want)
    # The cell variant overflows capacity 4; the row variant's demand (4
    # rows on this 8x8 shock) exactly meets it.
    assert int(demand) >= cap

    plain = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    with pytest.raises(ValueError, match="requires troubled_capacity"):
        plain.capacity_usage(Q0, 2e-3)


def test_gathered_overflow_means_policy():
    """Default overflow policy: troubled-but-overflowed cells take the
    first-order cell-mean FV update (stable) instead of the failed DG
    candidate; a multi-step run under sustained overflow stays finite and
    admissible."""
    solver = make_solver(cells=12, order=3)
    cap = 4
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=cap
    )
    assert limited.overflow_fallback == "means"
    Q0 = sod_like_state(solver)
    dt = 4e-3
    candidate = solver.step(Q0, dt)
    troubled = np.asarray(limited.troubled_mask(Q0, candidate))
    tables = limited._gather_tables(jnp.asarray(troubled))
    gathered_mask = np.asarray(tables["mask"])
    over = troubled & ~gathered_mask
    assert over.any()
    out = np.asarray(limited.step(Q0, dt))
    fbm = np.asarray(limited.fv_fallback(Q0, dt))
    # One-ULP tolerance: the means branch is traced under lax.cond, so
    # XLA may fuse (FMA) differently than the standalone fv_fallback.
    np.testing.assert_allclose(
        out[..., over], fbm[..., over], rtol=0, atol=1e-14
    )
    # Sustained overflow (capacity 4 vs ~dozens troubled): 20 steps stay
    # finite and admissible under the means policy.
    Q = limited.run(Q0, 20, dt)
    assert bool(jnp.isfinite(Q).all())
    ok = euler_admissible(dim=2)(Q, solver.var_axis)
    assert bool(np.asarray(ok).all())


def test_row_gathered_overflow_means_policy():
    """Row granularity: overflowed troubled rows take the means update."""
    solver = make_solver(cells=8, order=2)
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=1,
        troubled_granularity="row",
    )
    Q0 = sod_like_state(solver)
    dt = 3e-3
    candidate = solver.step(Q0, dt)
    troubled = np.asarray(limited.troubled_mask(Q0, candidate))
    tables = limited._gather_tables_row(jnp.asarray(troubled))
    over = troubled & ~np.asarray(tables["mask"])
    assert over.any()
    out = np.asarray(limited.step(Q0, dt))
    fbm = np.asarray(limited.fv_fallback(Q0, dt))
    np.testing.assert_allclose(
        out[..., over], fbm[..., over], rtol=0, atol=1e-14
    )


def test_row_gathered_sharded_rmhd_matches_single_device():
    """The full production stack on the RELATIVISTIC magnetized family:
    row-gathered limited RMHD (AD-Newton con2prim inside detection,
    fallback sweeps, and interface matching) sharded over the 8-device
    mesh matches single-device to 1e-12."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.models import rmhd as m
    from exahype_jax.parallel import make_mesh

    GAMMA = 4.0 / 3.0
    flux, eig = m.rmhd(gamma=GAMMA, c_h=1.0, iters=8)
    solver = ADERDGSolver(
        dim=2, order=2, n_vars=9, grid_shape=(8, 8),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / 8,
    )
    lim = LimitedADERDG(
        solver, admissible=m.rmhd_admissible(gamma=GAMMA, iters=8),
        troubled_capacity=8, troubled_granularity="row",
    )
    # Magnetized shock-tube-like state: a pressure/density jump plus a
    # rotated field (trips the DMP at the front).
    coords = solver.nodes_meshgrid()
    no_var = solver.state_shape[:2] + solver.state_shape[3:]
    X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    left = X < 0.5
    rho = np.where(left, 1.0, 0.125)
    p = np.where(left, 1.0, 0.1)
    v = np.zeros(no_var + (3,))
    B = np.broadcast_to(np.asarray([0.3, 0.2, 0.0]), no_var + (3,))
    Q0 = jnp.asarray(np.moveaxis(np.asarray(m.prim_to_cons(
        jnp.asarray(rho), jnp.asarray(v), jnp.asarray(p), jnp.asarray(B),
        gamma=GAMMA,
    )), -1, solver.var_axis))
    dt = 2e-3
    ref = np.asarray(jax.jit(lambda q: lim.step(q, dt))(Q0))
    assert np.isfinite(ref).all()

    mesh = make_mesh(8)
    ndim = len(solver.state_shape)
    spec = [None] * ndim
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    Qs = jax.device_put(Q0, sharding)
    got = np.asarray(
        jax.jit(
            lambda q: lim.step(q, dt),
            in_shardings=(sharding,),
            out_shardings=sharding,
        )(Qs)
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
