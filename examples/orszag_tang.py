"""Orszag–Tang vortex: the canonical ideal-MHD benchmark.

Runs the 9-variable GLM-MHD system (`models/mhd.py`) through the FV
Rusanov pipeline on a patch grid: the smooth initial vortex steepens into
the familiar shock pattern while Dedner cleaning transports ∇·B errors
away.  Demonstrates a full nonlinear multi-physics run assembled from the
same spec/solver pieces as the Euler configurations — only the physics
callbacks change.

Run: python examples/orszag_tang.py [--cpu]
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import mhd as mhd_mod
from exahype_jax.models.fv import build_fv_rusanov_kernel
from exahype_jax.parallel import GridSolver, PatchGrid
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.output import assemble_global, disassemble_global

GAMMA = 5.0 / 3.0
GX = GY = 8
PATCH = 8
N = GX * PATCH  # 64x64 cells

cfg = KernelConfig(
    dim=2, patch_size=PATCH, halo_size=1, n_real=9, n_aux=0,
    n_patches=GX * GY,
)
grid = PatchGrid(config=cfg, grid_shape=(GX, GY))
flux, eig = mhd_mod.mhd(gamma=GAMMA, c_h=1.0)
kb = build_fv_rusanov_kernel(
    dim=2, patch_size=PATCH, halo_size=1, n_real=9, n_aux=0,
    n_patches=GX * GY, flux_impl=flux, eigenvalue_impl=eig,
)
solver = GridSolver(
    grid, kb, dx=1.0 / N, kernel_dt="lambda",
    eigenvalue_fn=lambda cells: jnp.maximum(eig(cells, 0), eig(cells, 1)),
    cfl=0.4,
)


def orszag_tang_state():
    x = (np.arange(N) + 0.5) / N
    X, Y = np.meshgrid(x, x, indexing="ij")
    rho = np.full_like(X, 25.0 / (36.0 * np.pi))
    p = np.full_like(X, 5.0 / (12.0 * np.pi))
    vx, vy, vz = -np.sin(2 * np.pi * Y), np.sin(2 * np.pi * X), 0.0 * X
    B0 = 1.0 / np.sqrt(4.0 * np.pi)
    Bx, By, Bz = -B0 * np.sin(2 * np.pi * Y), B0 * np.sin(4 * np.pi * X), 0.0 * X
    B2 = Bx**2 + By**2 + Bz**2
    kinetic = 0.5 * rho * (vx**2 + vy**2 + vz**2)
    E = p / (GAMMA - 1.0) + kinetic + 0.5 * B2
    Q = np.stack(
        [rho, rho * vx, rho * vy, rho * vz, E, Bx, By, Bz, 0.0 * X], axis=-1
    )
    return disassemble_global(grid, jnp.zeros(grid.state_shape), jnp.asarray(Q))


def div_B(Q):
    g = np.asarray(assemble_global(grid, Q))
    dx = solver.dx
    return (
        (np.roll(g[..., 5], -1, 0) - np.roll(g[..., 5], 1, 0)) / (2 * dx)
        + (np.roll(g[..., 6], -1, 1) - np.roll(g[..., 6], 1, 1)) / (2 * dx)
    )


def totals(Q):
    g = np.asarray(assemble_global(grid, Q))
    return g.sum(axis=(0, 1)) * solver.dx**2


def main():
    Q = orszag_tang_state()
    before = totals(Q)
    n_steps = 40
    Q, t = jax.jit(lambda q: solver.run(q, n_steps))(Q)
    after = totals(Q)
    g = np.asarray(assemble_global(grid, Q))
    print(f"t = {float(t):.4f} after {n_steps} CFL steps")
    print(f"mass drift:   {after[0] - before[0]:+.3e}")
    print(f"energy drift: {after[4] - before[4]:+.3e}")
    print(f"max |div B|:  {np.abs(div_B(Q)).max():.3f} (GLM-transported)")
    print(f"rho range:    [{g[..., 0].min():.4f}, {g[..., 0].max():.4f}]")
    assert np.isfinite(g).all()
    assert abs(after[0] - before[0]) < 1e-12
    assert abs(after[4] - before[4]) < 1e-12
    print("orszag-tang: finite + conservative")


if __name__ == "__main__":
    main()
