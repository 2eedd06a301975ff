"""Parallel layer tests: halo exchange, grid solver, multi-device sharding.

Multi-chip behaviour is validated on the 8-virtual-device CPU mesh
(conftest): the sharded program must produce bitwise the same state as the
single-device run, and its compiled HLO must actually contain collectives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models import build_rusanov_kernel, euler
from exahype_jax.parallel import (
    GridSolver,
    PatchGrid,
    make_mesh,
    shard_state,
    state_sharding,
)
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.errors import SemanticError


def make_grid(gx=4, gy=2, patch=4, halo=1, n_real=5, n_aux=5, boundary="periodic"):
    cfg = KernelConfig(
        dim=2, patch_size=patch, halo_size=halo, n_real=n_real, n_aux=n_aux,
        n_patches=gx * gy,
    )
    return PatchGrid(config=cfg, grid_shape=(gx, gy), boundary=boundary)


def test_grid_validation():
    cfg = KernelConfig(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5, n_patches=7)
    with pytest.raises(SemanticError):
        PatchGrid(config=cfg, grid_shape=(4, 2))


def test_halo_fill_periodic_matches_manual():
    grid = make_grid(gx=3, gy=2)
    cfg = grid.config
    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.normal(size=grid.state_shape))
    out = np.asarray(grid.halo_fill(Q))
    h, P = cfg.halo_size, cfg.patch_size
    # Patch (1,0)'s low-x halo row must equal patch (0,0)'s high-x interior.
    np.testing.assert_array_equal(
        out[1, 0, 0:h, h : P + h, :], np.asarray(Q)[0, 0, P : P + h, h : P + h, :]
    )
    # Periodic wraparound: patch (0,0)'s low-x halo comes from patch (2,0).
    np.testing.assert_array_equal(
        out[0, 0, 0:h, h : P + h, :], np.asarray(Q)[2, 0, P : P + h, h : P + h, :]
    )
    # y-direction: patch (0,1) low-y halo from patch (0,0) high-y interior.
    np.testing.assert_array_equal(
        out[0, 1, h : P + h, 0:h, :], np.asarray(Q)[0, 0, h : P + h, P : P + h, :]
    )


def test_halo_fill_corners_propagate():
    """After both axis exchanges, diagonal-neighbour data reaches the corners."""
    grid = make_grid(gx=2, gy=2)
    cfg = grid.config
    h, P = cfg.halo_size, cfg.patch_size
    rng = np.random.default_rng(1)
    Q = jnp.asarray(rng.normal(size=grid.state_shape))
    out = np.asarray(grid.halo_fill(Q))
    # Patch (1,1)'s low-x/low-y corner halo should hold patch (0,0)'s
    # high-x/high-y interior corner.
    np.testing.assert_array_equal(
        out[1, 1, 0:h, 0:h, :], np.asarray(Q)[0, 0, P : P + h, P : P + h, :]
    )


def test_reflective_boundary():
    grid = make_grid(gx=2, gy=2, boundary="reflective")
    cfg = grid.config
    h, P = cfg.halo_size, cfg.patch_size
    rng = np.random.default_rng(2)
    Q = jnp.asarray(rng.normal(size=grid.state_shape))
    out = np.asarray(grid.halo_fill(Q))
    # Low-x outer face of grid block 0 mirrors its first interior layers.
    np.testing.assert_array_equal(
        out[0, 0, 0:h, h : P + h, :],
        np.asarray(out)[0, 0, h : 2 * h, h : P + h, :][::-1],
    )


def euler_init(grid, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=grid.state_shape)
    Q[..., 0] += 1.0
    Q[..., 3] += 5.0
    Q[..., 4] += 5.0
    return jnp.asarray(Q)


def make_solver(grid):
    kb = build_rusanov_kernel(
        dim=2,
        patch_size=grid.config.patch_size,
        halo_size=grid.config.halo_size,
        n_real=grid.config.n_real,
        n_aux=grid.config.n_aux,
        n_patches=grid.config.n_patches,
    )
    return GridSolver(
        grid,
        kb,
        dx=0.1,
        eigenvalue_fn=lambda cells: jnp.maximum(
            euler.max_eigenvalue_v(cells, 0), euler.max_eigenvalue_v(cells, 1)
        ),
    )


def test_solver_run_fixed_dt_finite():
    grid = make_grid(gx=2, gy=2)
    solver = make_solver(grid)
    Q = euler_init(grid)
    Qf, tf = jax.jit(lambda q: solver.run(q, 3, dt=1e-3))(Q)
    assert np.isfinite(np.asarray(Qf)).all()
    assert float(tf) == pytest.approx(3e-3)


def test_solver_adaptive_dt():
    grid = make_grid(gx=2, gy=2)
    solver = make_solver(grid)
    Q = euler_init(grid)
    dt = solver.compute_dt(Q)
    assert 0 < float(dt) < 1.0
    Qf, tf = jax.jit(lambda q: solver.run(q, 2))(Q)
    assert np.isfinite(np.asarray(Qf)).all()
    assert float(tf) > 0


def test_sharded_step_matches_single_device():
    """The full multi-chip step (halo collectives + kernel) must equal the
    unsharded run bit-for-bit."""
    grid = make_grid(gx=8, gy=2)
    solver = make_solver(grid)
    Q = euler_init(grid, seed=5)

    ref = np.asarray(jax.jit(solver.step)(Q, 1e-3))

    mesh = make_mesh(8)
    sharding = state_sharding(mesh, grid)
    Qs = shard_state(Q, mesh, grid)
    stepped = jax.jit(solver.step, in_shardings=(sharding, None), out_shardings=sharding)
    out = np.asarray(stepped(Qs, 1e-3))
    np.testing.assert_array_equal(out, ref)


def test_sharded_program_contains_collectives():
    grid = make_grid(gx=8, gy=2)
    solver = make_solver(grid)
    mesh = make_mesh(8)
    sharding = state_sharding(mesh, grid)
    Q = euler_init(grid, seed=6)
    Qs = shard_state(Q, mesh, grid)
    lowered = jax.jit(
        solver.step, in_shardings=(sharding, None), out_shardings=sharding
    ).lower(Qs, 1e-3)
    hlo = lowered.compile().as_text()
    assert "collective-permute" in hlo or "all-to-all" in hlo or "all-gather" in hlo, (
        "sharded halo exchange should lower to collectives"
    )


def test_two_axis_mesh_sharding():
    """2-D device mesh: two grid axes sharded over two named mesh axes;
    the GSPMD-partitioned step still matches exactly."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    grid = make_grid(gx=4, gy=2)
    solver = make_solver(grid)
    Q = euler_init(grid, seed=9)
    ref = np.asarray(jax.jit(solver.step)(Q, 1e-3))

    devices = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devices, ("x", "y"))
    ndim = len(grid.state_shape)
    spec = PartitionSpec("x", "y", *([None] * (ndim - 2)))
    sharding = NamedSharding(mesh, spec)
    Qs = jax.device_put(Q, sharding)
    stepped = jax.jit(solver.step, in_shardings=(sharding, None), out_shardings=sharding)
    hlo = stepped.lower(Qs, 1e-3).compile().as_text()
    assert "collective-permute" in hlo or "all-gather" in hlo
    np.testing.assert_array_equal(np.asarray(stepped(Qs, 1e-3)), ref)


def test_make_mesh_multi_axis_helpers():
    """Library-level multi-axis mesh + multi-axis state sharding."""
    grid = make_grid(gx=4, gy=2)
    solver = make_solver(grid)
    Q = euler_init(grid, seed=11)
    ref = np.asarray(jax.jit(solver.step)(Q, 1e-3))

    mesh = make_mesh(shape=(4, 2), axis_names=("x", "y"))
    sharding = state_sharding(mesh, grid, axis_name=("x", "y"))
    Qs = jax.device_put(Q, sharding)
    stepped = jax.jit(solver.step, in_shardings=(sharding, None), out_shardings=sharding)
    np.testing.assert_array_equal(np.asarray(stepped(Qs, 1e-3)), ref)


def test_sharded_pallas_aderdg_matches_single_device():
    """The fused Pallas cell stage under shard_map (axis-0 sharded,
    ppermute edge exchange) matches the unsharded fused step."""
    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
    from exahype_jax.models.aderdg_triton import TritonADERDG
    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    flux, eig = euler_physics(dim=3, n_real=5)
    solver = ADERDGSolver(
        dim=3, order=2, n_vars=5, grid_shape=(8, 4, 4), flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / 8,
    )
    Q0 = _aderdg_euler_state(solver)
    ref = np.asarray(TritonADERDG(solver, interpret=True).step(Q0, 1e-3))

    mesh = make_mesh(8)
    step, sharding = make_sharded_xla_aderdg_step(
        solver, mesh,
        cell_stage=lambda s: TritonADERDG(s, interpret=True).cell_stage,
    )
    Qs = jax.device_put(Q0, sharding)
    got = np.asarray(jax.jit(step)(Qs, 1e-3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)

    # collectives really appear in the compiled program
    hlo = jax.jit(step).lower(Qs, 1e-3).compile().as_text()
    assert "collective-permute" in hlo


def _aderdg_euler_state(solver, seed=4):
    rng = np.random.default_rng(seed)
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    rho = 1.0 + 0.2 * rng.random(no_var)
    comps = [rho, 0.4 * rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.66 * rho]
    return jnp.asarray(np.stack(comps, axis=solver.var_axis))


def test_sharded_aderdg_reflective_matches_single_device():
    """Reflective walls on the sharded step: the sharded axis-0 face stage
    must apply wall ghosts only on the first/last shard and ppermute
    elsewhere, and interior axes must use the LOCAL wall-aware face stage
    (they are unsharded)."""
    from exahype_jax.models.aderdg import (
        ADERDGSolver,
        euler_physics,
        euler_reflect,
        euler_reflect_flux,
    )
    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    flux, eig = euler_physics(dim=3, n_real=5)
    solver = ADERDGSolver(
        dim=3, order=2, n_vars=5, grid_shape=(8, 4, 4), flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / 8, boundary="reflective",
        reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3),
    )
    Q0 = _aderdg_euler_state(solver)
    ref = np.asarray(jax.jit(solver.step)(Q0, 1e-3))

    mesh = make_mesh(8)
    step, sharding = make_sharded_xla_aderdg_step(solver, mesh)
    Qs = jax.device_put(Q0, sharding)
    got = np.asarray(jax.jit(step)(Qs, 1e-3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_sharded_aderdg_outflow_and_farfield_match_single_device():
    """The wall plumbing is boundary-agnostic: outflow and farfield ghost
    hooks flow through the same per-shard wall gating as reflective, so
    the sharded step matches single-device for both."""
    from exahype_jax.models import euler
    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    flux, eig = euler_physics(dim=3, n_real=5)
    ff = (1.0, 2.0, 0.0, 0.0, 1.0 / (euler.GAMMA - 1) + 2.0)
    for kw in (
        dict(boundary="outflow"),
        dict(boundary="farfield", farfield_state=ff),
    ):
        solver = ADERDGSolver(
            dim=3, order=2, n_vars=5, grid_shape=(8, 4, 4), flux_fn=flux,
            max_eigenvalue_fn=eig, dx=1.0 / 8, wall_axes=(0,), **kw,
        )
        Q0 = _aderdg_euler_state(solver)
        ref = np.asarray(jax.jit(solver.step)(Q0, 1e-3))
        mesh = make_mesh(8)
        step, sharding = make_sharded_xla_aderdg_step(solver, mesh)
        Qs = jax.device_put(Q0, sharding)
        got = np.asarray(jax.jit(step)(Qs, 1e-3))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12,
                                   err_msg=str(kw))


def test_fv_wall_conserves_mass_and_energy():
    """Reflective walls with the Euler reflect hook (normal momentum
    negated): zero mass/energy flux through the wall, so both are conserved
    to rounding; the plain mirror (no hook) is only a symmetry boundary and
    leaks mass (round-1 advisory)."""
    from exahype_jax.models.aderdg import euler_reflect
    from exahype_jax.models.fv import build_fv_rusanov_kernel

    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0, n_patches=4
    )
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0, n_patches=4
    )
    rng = np.random.default_rng(5)
    Q0 = rng.uniform(0.1, 1.0, size=(2, 2, 6, 6, 5))
    Q0[..., 0] += 1.0
    Q0[..., 1] += 0.5  # directed x-velocity so wall flux is exercised
    Q0[..., 3] += 5.0
    Q0 = jnp.asarray(Q0)

    def totals(solver, Q):
        interior = solver._interior(Q)
        return np.asarray(jnp.sum(interior, axis=tuple(range(interior.ndim - 1))))

    wall_grid = PatchGrid(
        config=cfg, grid_shape=(2, 2), boundary="reflective",
        reflect_fn=euler_reflect(2),
    )
    solver = GridSolver(wall_grid, kb, dx=0.1, kernel_dt="lambda")
    Q = Q0
    before = totals(solver, Q)
    for _ in range(5):
        Q = solver.step(Q, 1e-3)
    after = totals(solver, Q)
    assert bool(jnp.isfinite(Q).all())
    np.testing.assert_allclose(after[0], before[0], rtol=1e-12)  # mass
    np.testing.assert_allclose(after[3], before[3], rtol=1e-12)  # energy
    # Momentum is NOT conserved (walls exert pressure).
    assert abs(after[1] - before[1]) > 1e-6

    # Plain mirror (no hook): a symmetry boundary — mass leaks through.
    sym_grid = PatchGrid(config=cfg, grid_shape=(2, 2), boundary="reflective")
    sym_solver = GridSolver(sym_grid, kb, dx=0.1, kernel_dt="lambda")
    Qs = Q0
    for _ in range(5):
        Qs = sym_solver.step(Qs, 1e-3)
    leaked = totals(sym_solver, Qs)
    assert abs(leaked[0] - before[0]) > 1e-6


def test_bf16_wire_sharded_aderdg():
    """wire_dtype on the ADER-DG edge exchange: close to the full-precision
    wire (the faces are computed quantities, so the bound is bf16-relative)
    and the collective payload is bf16 in the compiled program."""
    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    flux, eig = euler_physics(dim=3, n_real=5)
    solver = ADERDGSolver(
        dim=3, order=2, n_vars=5, grid_shape=(8, 4, 4), flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / 8,
    )
    Q0 = _aderdg_euler_state(solver)
    mesh = make_mesh(8)
    step_full, sharding = make_sharded_xla_aderdg_step(solver, mesh)
    step_bf16, _ = make_sharded_xla_aderdg_step(solver, mesh, wire_dtype=jnp.bfloat16)
    Qs = jax.device_put(Q0, sharding)
    ref = np.asarray(jax.jit(step_full)(Qs, 1e-3))
    got = np.asarray(jax.jit(step_bf16)(Qs, 1e-3))
    assert np.abs(got - ref).max() < 1e-2 * np.abs(ref).max()
    hlo = jax.jit(step_bf16).lower(Qs, 1e-3).compile().as_text()
    assert "collective-permute" in hlo and "bf16" in hlo


def _dirichlet_wall_solver(grid_shape=(8, 4, 8)):
    """3-D Euler box with SPATIALLY-VARYING prescribed wall rows (the
    variation is what exercises the per-shard row slicing)."""
    from exahype_jax.models.aderdg import (
        ADERDGSolver,
        euler_physics,
        make_dirichlet_fn,
    )

    flux, eig = euler_physics(dim=3, n_real=5)

    def state_fn(x, y, z):
        rho = 1.0 + 0.2 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
        p = 1.0 + 0.1 * np.cos(2 * np.pi * z)
        return np.stack(
            [rho, np.zeros_like(x), np.zeros_like(x), np.zeros_like(x),
             p / 0.4], axis=-1,
        )

    dfn = make_dirichlet_fn(state_fn, dim=3, order=2,
                            grid_shape=grid_shape, dx=1.0 / grid_shape[0])
    return ADERDGSolver(
        dim=3, order=2, n_vars=5, grid_shape=grid_shape, flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / grid_shape[0],
        boundary="dirichlet", dirichlet_fn=dfn,
    )


def test_sharded_aderdg_dirichlet_transverse_wall_matches():
    """A dirichlet wall on an UNSHARDED axis while grid axis 0 is sharded —
    the prescribed rows span the sharded axis and are sliced per shard."""
    from jax.sharding import Mesh

    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    solver = dataclasses.replace(_dirichlet_wall_solver(), wall_axes=(1,))
    Q0 = _aderdg_euler_state(solver)
    ref = np.asarray(jax.jit(solver.step)(Q0, 1e-3))
    mesh = Mesh(np.array(jax.devices()[:8]), ("patches",))
    step, sharding = make_sharded_xla_aderdg_step(solver, mesh)
    Qs = jax.device_put(Q0, sharding)
    got = np.asarray(jax.jit(step)(Qs, 1e-3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _noslip_ns_solver(cells=8, order=2, dim=2):
    from exahype_jax.models import navier_stokes as ns
    from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last

    f, e, vf, ve = ns.navier_stokes(dim=dim, mu=1e-2)
    return ADERDGSolver(
        dim=dim, order=order, n_vars=dim + 2, grid_shape=(cells,) * dim,
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=ns.wrap_visc_var_last(vf),
        visc_eigenvalue_fn=wrap_var_last(ve), dx=1.0 / cells,
        boundary="reflective", reflect_fn=ns.noslip_reflect(dim),
        reflect_flux_fn=ns.noslip_reflect_flux(dim),
    )


def _ns_state(solver, seed=2):
    rng = np.random.default_rng(seed)
    dim = solver.dim
    no_var = (solver.state_shape[: solver.var_axis]
              + solver.state_shape[solver.var_axis + 1 :])
    rho = 1.0 + 0.2 * rng.random(no_var)
    m = 0.1 * rng.standard_normal(no_var + (dim,))
    p = 1.0 + 0.2 * rng.random(no_var)
    E = p / 0.4 + 0.5 * (m**2).sum(-1) / rho
    Qv = np.concatenate([rho[..., None], m, E[..., None]], -1)
    return jnp.asarray(np.moveaxis(Qv, -1, solver.var_axis))


def test_sharded_aderdg_viscous_walls_match_base_solver():
    """No-slip viscous walls on the sharded step match the base solver."""
    from jax.sharding import Mesh

    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    solver = _noslip_ns_solver()
    Q0 = _ns_state(solver)
    want = np.asarray(solver.step(Q0, 1e-3))
    mesh = Mesh(np.array(jax.devices()[:8]), ("patches",))
    step, sharding = make_sharded_xla_aderdg_step(solver, mesh)
    Qs = jax.device_put(Q0, sharding)
    got = np.asarray(jax.jit(step)(Qs, 1e-3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sharded_aderdg_high_order_p5():
    """The sharded fused step is order-generic: at p5 (node axes padded to
    8) the shard_mapped kernel matches the unsharded fused step on the
    8-device mesh."""
    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics
    from exahype_jax.models.aderdg_triton import TritonADERDG
    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    flux, eig = euler_physics(dim=2, n_real=4)
    solver = ADERDGSolver(
        dim=2, order=5, n_vars=4, grid_shape=(8, 8), flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / 8,
    )
    rng = np.random.default_rng(4)
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    rho = 1.0 + 0.2 * rng.random(no_var)
    comps = [rho, rho, 0.5 * rho, 5.0 + 0.66 * rho]
    Q0 = jnp.asarray(np.stack(comps, axis=solver.var_axis))
    ref = np.asarray(TritonADERDG(solver, interpret=True).step(Q0, 1e-3))
    mesh = make_mesh(8)
    step, sharding = make_sharded_xla_aderdg_step(
        solver, mesh,
        cell_stage=lambda s: TritonADERDG(s, interpret=True).cell_stage,
    )
    Qs = jax.device_put(Q0, sharding)
    got = np.asarray(jax.jit(step)(Qs, 1e-3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _euler2d_solver(boundary="periodic", grid=(8, 4)):
    from exahype_jax.models.aderdg import (
        ADERDGSolver,
        euler_physics,
        euler_reflect,
        euler_reflect_flux,
    )

    flux, eig = euler_physics(dim=2, n_real=4)
    walls = {}
    if boundary == "reflective":
        walls = dict(boundary="reflective", reflect_fn=euler_reflect(2),
                     reflect_flux_fn=euler_reflect_flux(2))
    solver = ADERDGSolver(
        dim=2, order=2, n_vars=4, grid_shape=grid, flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / grid[0], **walls,
    )
    rng = np.random.default_rng(33)
    no_var = (solver.state_shape[: solver.var_axis]
              + solver.state_shape[solver.var_axis + 1 :])
    rho = 1.0 + 0.2 * rng.random(no_var)
    comps = [rho, 0.4 * rho, 0.5 * rho, 5.0 + 0.66 * rho]
    return solver, jnp.asarray(np.stack(comps, axis=solver.var_axis))


@pytest.mark.parametrize("boundary", ["periodic", "reflective"])
def test_bf16_wire_format_halo_exchange(boundary):
    """Mixed-precision communication: wire_dtype=bf16 on the sharded step's
    axis-0 edge exchange stays within a bf16-relative bound of the
    full-precision wire (the exchanged faces are computed quantities; wall
    ghosts are local and never quantized), and the collective payload is
    bf16 in the compiled program."""
    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    solver, Q0 = _euler2d_solver(boundary)
    mesh = make_mesh(8)
    step_full, sharding = make_sharded_xla_aderdg_step(solver, mesh)
    step_bf16, _ = make_sharded_xla_aderdg_step(
        solver, mesh, wire_dtype=jnp.bfloat16
    )
    Qs = jax.device_put(Q0, sharding)
    ref = np.asarray(jax.jit(step_full)(Qs, 1e-3))
    got = np.asarray(jax.jit(step_bf16)(Qs, 1e-3))
    diff = np.abs(got - ref)
    assert diff.max() > 0, "bf16 wire should differ on general data"
    assert diff.max() < 1e-2 * np.abs(ref).max()
    hlo = jax.jit(step_bf16).lower(Qs, 1e-3).compile().as_text()
    assert "collective-permute" in hlo and "bf16" in hlo


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_step_on_four_devices_matches_one(fused):
    """The four-device shard_map step (the layout of a four-GPU host)
    reproduces the same state stepped on one device, plain XLA cell stage
    or fused kernel (interpret mode)."""
    from exahype_jax.models.aderdg_triton import TritonADERDG
    from exahype_jax.parallel.shard import make_sharded_xla_aderdg_step

    solver, Q0 = _euler2d_solver(grid=(8, 4))
    factory = (lambda s: TritonADERDG(s, interpret=True).cell_stage) if fused else None
    one = TritonADERDG(solver, interpret=True).step if fused else solver.step
    ref = np.asarray(jax.jit(one)(Q0, 1e-3))
    mesh = make_mesh(4)
    step, sharding = make_sharded_xla_aderdg_step(solver, mesh, cell_stage=factory)
    out = jax.jit(step)(jax.device_put(Q0, sharding), 1e-3)
    assert len(out.sharding.device_set) == 4
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=1e-12)


def test_gspmd_aderdg_step_spans_four_devices():
    """GSPMD path: ADERDGSolver.step jitted over a state placed with
    state_sharding (grid axis 0 over four devices) stays sharded and
    matches the single-device step."""
    solver, Q0 = _euler2d_solver(grid=(8, 4))
    ref = np.asarray(jax.jit(solver.step)(Q0, 1e-3))
    mesh = make_mesh(4)
    sharding = state_sharding(mesh, solver)
    assert sharding.spec[solver.grid_axis(0)] is not None
    out = jax.jit(solver.step)(jax.device_put(Q0, sharding), 1e-3)
    assert len(out.sharding.device_set) == 4
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=1e-12)
