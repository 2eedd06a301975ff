"""The production configuration, end to end: a limited ADER-DG blast
tracked by dynamic tree refinement under the adaptive driver.

Composes the framework's flagship pieces in one run:

- order-2 ADER-DG on 2-D Euler (`models/aderdg.py`),
- MOOD subcell limiting on BOTH levels (`fine_factory`/`coarse_factory`
  with the Euler admissibility hook, `models/limiter.py`),
- criteria-driven tree refinement — an arbitrary scattered set of cells
  follows the blast front, ONE compiled chunk for every pattern
  (`models/aderdg_pool.py`),
- the adaptive driver's checkpoint / metrics / recovery subsystems
  (`parallel/driver.py::AdaptiveTimeLoopDriver`).

Prints the per-chunk refinement count and verifies conservation and
admissibility at the end.

Run: python examples/limited_amr_blast.py [--cpu]
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
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

G = 8
GAMMA = 1.4


def flux2(Q, axis, var_axis):
    return euler.flux_soa(Q, axis, dim=2, n_real=4, var_axis=var_axis)


def eig2(Q, axis, var_axis):
    return euler.max_eigenvalue_soa(Q, axis, dim=2, var_axis=var_axis)


solver = ADERDGSolver(
    dim=2, order=2, n_vars=4, grid_shape=(G, G),
    flux_fn=flux2, max_eigenvalue_fn=eig2, dx=1.0 / G,
)

adm = euler_admissible(dim=2)
factory = lambda s: LimitedADERDG(s, admissible=adm)
dyn = DynamicADERDGPool(
    solver, capacity=8, factor=3, rel_threshold=0.5,
    fine_factory=factory, coarse_factory=factory,
)

# Off-centre blast.
X, Y = solver.nodes_meshgrid()
shape = (3, 3) + tuple(solver.grid_shape)
Xb = jnp.broadcast_to(jnp.squeeze(X, axis=2), shape)
Yb = jnp.broadcast_to(jnp.squeeze(Y, axis=2), shape)
rho = jnp.ones(shape)
p = 0.1 + 10.0 * jnp.exp(-(((Xb - 0.4) ** 2 + (Yb - 0.55) ** 2) / 0.1**2))
u0 = jnp.stack(
    [rho, jnp.zeros(shape), jnp.zeros(shape), p / (GAMMA - 1.0)], axis=2
)


def main():
    m0 = np.asarray(solver.total_mass(u0))
    driver = AdaptiveTimeLoopDriver(
        dyn,
        DriverConfig(
            checkpoint_every=2,
            checkpoint_dir=tempfile.mkdtemp(prefix="amr_blast_"),
        ),
    )
    c, f, info = driver.run(u0, n_chunks=5, chunk_steps=4, dt=5e-4)

    for i, m in enumerate(info["masks"]):
        print(f"chunk {i}: {int(m.sum())} refined cells")
    m1 = np.asarray(solver.total_mass(c))
    print(f"mass drift:   {m1[0] - m0[0]:+.3e}")
    print(f"energy drift: {m1[3] - m0[3]:+.3e}")
    assert abs(m1[0] - m0[0]) < 1e-12 * abs(m0[0])
    assert abs(m1[3] - m0[3]) < 1e-12 * abs(m0[3])
    # Mean-sense admissibility of the composite.
    w = np.asarray(solver.ops.weights)
    means = np.asarray(c)
    for d in reversed(range(2)):
        means = np.tensordot(w, means, axes=([0], [d]))
    rho_m, mx_m, my_m, E_m = (means[k] for k in range(4))
    p_m = (GAMMA - 1.0) * (E_m - 0.5 * (mx_m**2 + my_m**2) / rho_m)
    assert rho_m.min() > 0 and p_m.min() > 0
    print("limited AMR blast: conservative + admissible")


if __name__ == "__main__":
    main()
