"""Native grid runtime tests: the C++ halo exchange + time loop
(`native/grid_runtime.cpp`) against the Python grid layer.

Differential pattern (SURVEY.md §4) applied to the runtime itself: the
native exchange must be element-identical to ``PatchGrid.halo_fill``, and
a chunked native run bitwise-equal to stepping the same compiled kernel
from Python between JAX-side exchanges.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.backends.cpp_runtime import NativeGridDriver, euler_sources
from exahype_jax.models.fv import build_fv_rusanov_kernel
from exahype_jax.parallel import GridSolver, PatchGrid
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.errors import SemanticError


def euler_grid_state(grid, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=grid.state_shape)
    Q[..., 0] += 1.0
    Q[..., -1] += 5.0
    return Q


@pytest.fixture(scope="module")
def driver2d(tmp_path_factory):
    gx, gy = 3, 2
    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0, n_patches=gx * gy
    )
    grid = PatchGrid(config=cfg, grid_shape=(gx, gy))
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0, n_patches=gx * gy
    )
    return NativeGridDriver(
        grid, kb,
        dx=1.0 / (gx * 4), kernel_dt="lambda",
        extra_sources=euler_sources(),
        defines={"EXA_DIM": 2, "EXA_NREAL": 5},
        workdir=tmp_path_factory.mktemp("native2d"),
    )


def test_native_halo_fill_matches_patchgrid(driver2d):
    grid = driver2d.grid
    Q = euler_grid_state(grid, seed=1)
    want = np.asarray(grid.halo_fill(jnp.asarray(Q)))
    got = driver2d.halo_fill(Q)
    np.testing.assert_array_equal(got, want)


def test_native_run_bitwise_vs_python_loop(driver2d):
    """exa_run_grid == {PatchGrid.halo_fill → same compiled kernel} loop."""
    grid = driver2d.grid
    Q0 = euler_grid_state(grid, seed=2)
    dt, n_steps = 1e-3, 5
    kdt = dt / driver2d.dx

    ref = Q0
    for _ in range(n_steps):
        filled = np.asarray(grid.halo_fill(jnp.asarray(ref)))
        ref = driver2d._native(filled.reshape(-1), kdt).reshape(grid.state_shape)

    got = driver2d.run(Q0, dt, n_steps)
    np.testing.assert_array_equal(got, ref)


def test_native_run_matches_grid_solver(driver2d):
    """The standalone native runtime reproduces GridSolver (JAX backend)."""
    grid = driver2d.grid
    kb = driver2d.kernel
    solver = GridSolver(grid, kb, dx=driver2d.dx, kernel_dt="lambda")
    Q0 = euler_grid_state(grid, seed=3)
    dt, n_steps = 1e-3, 5
    ref = jnp.asarray(Q0)
    for _ in range(n_steps):
        ref = solver.step(ref, dt)
    got = driver2d.run(Q0, dt, n_steps)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-12)


def test_native_runtime_3d(tmp_path):
    gx = (2, 2, 2)
    cfg = KernelConfig(
        dim=3, patch_size=3, halo_size=1, n_real=5, n_aux=0, n_patches=8
    )
    grid = PatchGrid(config=cfg, grid_shape=gx)
    kb = build_fv_rusanov_kernel(
        dim=3, patch_size=3, halo_size=1, n_real=5, n_aux=0, n_patches=8
    )
    driver = NativeGridDriver(
        grid, kb, dx=1.0 / 6, kernel_dt="lambda",
        extra_sources=euler_sources(),
        defines={"EXA_DIM": 3, "EXA_NREAL": 5},
        workdir=tmp_path,
    )
    Q = euler_grid_state(grid, seed=4)
    want = np.asarray(grid.halo_fill(jnp.asarray(Q)))
    np.testing.assert_array_equal(driver.halo_fill(Q), want)

    # Constant state is a fixed point of the full native step loop.
    const = np.full(grid.state_shape, 0.0)
    const[..., 0] = 1.0
    const[..., 4] = 5.0
    out = driver.run(const, 1e-3, 3)
    np.testing.assert_allclose(out, const, rtol=0, atol=1e-13)


def test_native_reflective_walls(tmp_path):
    """Native wall mirror (sign-table hook) is element-identical to the
    Python grid layer with the Euler reflect hook, and a closed-box native
    run conserves mass/energy while wall pressure changes momentum."""
    from exahype_jax.models.aderdg import euler_reflect

    cfg = KernelConfig(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0, n_patches=4
    )
    grid = PatchGrid(
        config=cfg, grid_shape=(2, 2), boundary="reflective",
        reflect_fn=euler_reflect(2),
    )
    kb = build_fv_rusanov_kernel(
        dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0, n_patches=4
    )
    # Missing sign table -> loud failure.
    with pytest.raises(SemanticError):
        NativeGridDriver(grid, kb)

    signs = np.ones((2, 5))
    signs[0, 1] = signs[1, 2] = -1.0  # negate the normal momentum
    driver = NativeGridDriver(
        grid, kb, dx=1.0 / 8, kernel_dt="lambda",
        extra_sources=euler_sources(),
        defines={"EXA_DIM": 2, "EXA_NREAL": 5},
        workdir=tmp_path, reflect_signs=signs,
    )
    Q = euler_grid_state(grid, seed=6)
    Q[..., 1] += 0.5  # directed flow exercises the wall flux
    want = np.asarray(grid.halo_fill(jnp.asarray(Q)))
    np.testing.assert_array_equal(driver.halo_fill(Q), want)

    def totals(arr):
        h, P = 1, 4
        interior = arr[:, :, h:h+P, h:h+P, :]
        return interior.sum(axis=(0, 1, 2, 3))

    before = totals(Q)
    out = driver.run(Q, 1e-3, 5)
    after = totals(out)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(after[0], before[0], rtol=1e-12)  # mass
    np.testing.assert_allclose(after[3], before[3], rtol=1e-12)  # energy
    assert abs(after[1] - before[1]) > 1e-8  # wall pressure
