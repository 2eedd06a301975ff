"""3-D limited-AMR capstone: a blast in a cube, tracked by dynamic tree
refinement, with the host OFF the re-grid critical path.

The 3-D extension of `limited_amr_blast.py`:

- order-2 ADER-DG on 3-D Euler,
- MOOD subcell limiting on BOTH levels — the coarse level on the
  row-GATHERED production fallback (capacity-bounded FV region), the
  fine pool on the whole-grid fallback,
- criteria-driven tree refinement following the blast front
  (`models/aderdg_pool.py`, one compiled chunk for every pattern),
- `DriverConfig(overlap_regrid=True)`: the next chunk's refinement
  tables are built on the host WHILE the current chunk runs on device
  (one-chunk pattern lag, criterion buffer absorbs it) — the host
  table build moved off the critical path,
- checkpoint / metrics / recovery via `AdaptiveTimeLoopDriver`.

Prints per-chunk refinement counts, wall-clock, composite DOF/s, and
verifies conservation and mean-sense admissibility at the end.

Run: python examples/limited_amr_blast3d.py [--cpu] [--size N] [--chunks K]
                                            [--no-overlap]
(defaults are a small CPU-friendly config; a GPU capstone is e.g.
--size 24 --chunks 7.  ``--no-overlap`` runs
the same configuration with sequential host re-gridding so the overlap
win is a measured split, not an estimate.)
"""

import sys
import time

from exahype_jax.utils.gpu import select_platform

CPU = select_platform("--cpu" in sys.argv)

import jax  # noqa: E402

if CPU:
    jax.config.update("jax_enable_x64", True)

import logging
import tempfile

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import euler
from exahype_jax.models.aderdg import ADERDGSolver
from exahype_jax.models.aderdg_pool import DynamicADERDGPool
from exahype_jax.models.limiter import LimitedADERDG, euler_admissible
from exahype_jax.parallel.driver import AdaptiveTimeLoopDriver, DriverConfig

logging.basicConfig(level=logging.INFO, format="%(message)s")

GAMMA = 1.4


def arg(flag, default, cast=int):
    if flag in sys.argv:
        return cast(sys.argv[sys.argv.index(flag) + 1])
    return default


G = arg("--size", 8)
N_CHUNKS = arg("--chunks", 3)
CHUNK_STEPS = 4
CAPACITY = arg("--capacity", max(8, G * G // 4))
DT = 2.5e-4 * (24 / G) if G >= 24 else 5e-4


def flux3(Q, axis, var_axis):
    return euler.flux_soa(Q, axis, dim=3, n_real=5, var_axis=var_axis)


def eig3(Q, axis, var_axis):
    return euler.max_eigenvalue_soa(Q, axis, dim=3, var_axis=var_axis)


solver = ADERDGSolver(
    dim=3, order=2, n_vars=5, grid_shape=(G, G, G),
    flux_fn=flux3, max_eigenvalue_fn=eig3, dx=1.0 / G,
)

adm = euler_admissible(dim=3)
# Coarse level: the gathered production fallback (row granularity).
# Size the row capacity ABOVE the front's worst demand — a 3-D blast
# shell intersects O(G^2) of the G^2 (x,y)-rows, so small grids need
# nearly all of them (undersized capacity engages the means overflow
# policy, whose approximate flux accounting shows up as conservation
# drift — measured: 3.6e-4 relative energy drift at capacity 16 with
# demand 30 on the 8^3 config).  Fine pool blocks are small — the
# whole-grid fallback there.
COARSE_ROWS = arg("--coarse-rows", G * G if G <= 12 else G * G // 2)
# DMP slack calibrated between the measured parasitic-Gibbs band
# (<=2.6e-4) and real front violations (~1e-2): the default 1e-4 flags
# radiation noise, runs
# demand past any capacity, and the means overflow accounting then
# shows up as 1e-3-level conservation drift.
DMP_DELTA0 = 5e-4
coarse_factory = lambda s: LimitedADERDG(
    s, admissible=adm, troubled_capacity=COARSE_ROWS,
    troubled_granularity="row", dmp_delta0=DMP_DELTA0,
)
fine_factory = lambda s: LimitedADERDG(
    s, admissible=adm, dmp_delta0=DMP_DELTA0
)
dyn = DynamicADERDGPool(
    solver, capacity=CAPACITY, factor=3, rel_threshold=0.4,
    fine_factory=fine_factory, coarse_factory=coarse_factory,
)

# Off-centre blast.
X, Y, Z = solver.nodes_meshgrid()
shape = (3, 3, 3) + tuple(solver.grid_shape)
Xb = jnp.broadcast_to(jnp.squeeze(X, axis=3), shape)
Yb = jnp.broadcast_to(jnp.squeeze(Y, axis=3), shape)
Zb = jnp.broadcast_to(jnp.squeeze(Z, axis=3), shape)
rho = jnp.ones(shape)
r2 = (Xb - 0.45) ** 2 + (Yb - 0.55) ** 2 + (Zb - 0.5) ** 2
p = 0.1 + 10.0 * jnp.exp(-(r2 / 0.1**2))
u0 = jnp.stack(
    [rho, jnp.zeros(shape), jnp.zeros(shape), jnp.zeros(shape),
     p / (GAMMA - 1.0)], axis=3
)
if "--cpu" not in sys.argv:
    u0 = u0.astype(jnp.float32)


def main():
    m0 = np.asarray(solver.total_mass(u0), dtype=np.float64)
    driver = AdaptiveTimeLoopDriver(
        dyn,
        DriverConfig(
            checkpoint_every=2,
            checkpoint_dir=tempfile.mkdtemp(prefix="amr_blast3d_"),
            overlap_regrid="--no-overlap" not in sys.argv,
        ),
    )
    if "--warmup" in sys.argv:
        # Separate compile from steady state: a short run populates the
        # jit caches (chunk step for every pattern SHAPE is one program;
        # the first dispatch carries the compile), then the timed run
        # below measures the production rate.  The
        # warmup evolves its own state copy — the timed run restarts
        # from u0 with warm caches.
        driver.run(u0, n_chunks=2, chunk_steps=CHUNK_STEPS, dt=DT)
    t0 = time.perf_counter()
    c, f, info = driver.run(u0, n_chunks=N_CHUNKS, chunk_steps=CHUNK_STEPS,
                            dt=DT)
    jax.block_until_ready(c)
    wall = time.perf_counter() - t0

    n_ref = [int(m.sum()) for m in info["masks"]]
    for i, n in enumerate(n_ref):
        print(f"chunk {i}: {n} refined cells")
    steps = N_CHUNKS * CHUNK_STEPS
    coarse_dof = G**3 * 27 * 5
    fine_dof = int(np.mean(n_ref)) * 27 * 27 * 5  # r^3 cells x 27 nodes
    composite = (coarse_dof + 3 * fine_dof) * steps  # 3 fine substeps
    print(f"wall: {wall:.2f}s for {steps} coarse steps "
          f"({wall/steps*1e3:.1f} ms/step)")
    print(f"composite DOF-updates/s: {composite/wall:.3e}")
    m1 = np.asarray(solver.total_mass(c), dtype=np.float64)
    print(f"mass drift:   {(m1[0] - m0[0])/m0[0]:+.3e} rel")
    print(f"energy drift: {(m1[4] - m0[4])/m0[4]:+.3e} rel")
    # CPU f64: the algebra is conservative to rounding (measured 1e-16
    # here).  In f32 the limited path's rounding accumulates up to
    # ~1e-3-level drift on strong shocked states — energy, carried by
    # the 100:1 hot spot, drifts several x mass.
    if "--cpu" in sys.argv:
        tol_mass = tol_energy = 1e-12
    else:
        tol_mass, tol_energy = 5e-4, 1e-2
    assert abs(m1[0] - m0[0]) < tol_mass * abs(m0[0])
    assert abs(m1[4] - m0[4]) < tol_energy * abs(m0[4])
    # Mean-sense admissibility of the coarse composite.
    w = np.asarray(solver.ops.weights)
    means = np.asarray(c, dtype=np.float64)
    for d in reversed(range(3)):
        means = np.tensordot(w, means, axes=([0], [d]))
    rho_m = means[0]
    ke = (means[1] ** 2 + means[2] ** 2 + means[3] ** 2) / rho_m
    p_m = (GAMMA - 1.0) * (means[4] - 0.5 * ke)
    assert rho_m.min() > 0 and p_m.min() > 0
    print("3-D limited AMR blast: conservative + admissible")


if __name__ == "__main__":
    main()
