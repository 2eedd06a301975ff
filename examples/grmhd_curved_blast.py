"""Magnetized relativistic blast in a curved spacetime: limited ADER-DG
GRMHD on a conformally-flat static background (Cowling).

The deepest model configuration in the framework, end to end: the
15-variable (2-D) GRMHD-CFC system (`models/grmhd_cfc.py` — Valencia
variables, AD-Newton con2prim through the exact conformal hat-map, GLM
cleaning at the curved characteristic speed αψ⁻²c_h, geometric sources
with the magnetized stress trace) under the a-posteriori MOOD limiter
with the curved admissibility hook.  A strong central pressure jump
launches magnetosonic shocks through the varying (α, ψ) background;
the run reports conservation of the densitized D*, the troubled
fraction, and final-state admissibility.

Run: python examples/grmhd_curved_blast.py [--cpu]
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from exahype_jax.models import grmhd_cfc as m
from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.limiter import LimitedADERDG

GAMMA = 4.0 / 3.0
on_cpu = jax.default_backend() == "cpu"
cells = 8 if on_cpu else 48
order = 3
n_steps = 8 if on_cpu else 40

flux, eig = m.grmhd_cfc(dim=2, gamma=GAMMA, c_h=1.0, iters=12)
solver = ADERDGSolver(
    dim=2, order=order, n_vars=m.n_vars(2), grid_shape=(cells, cells),
    flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
    dx=1.0 / cells,
    dissipation_mask=m.grmhd_cfc_dissipation_mask(2),
)
solver.source_fn = m.grmhd_cfc_source(2, gamma=GAMMA, iters=12)
limited = LimitedADERDG(
    solver, admissible=m.grmhd_cfc_admissible(2, gamma=GAMMA, iters=12)
)

coords = solver.nodes_meshgrid()
no_var = solver.state_shape[:2] + solver.state_shape[3:]
X = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
Y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)

# Curved static background: both the lapse and the conformal factor vary.
alpha = 1.0 + 0.05 * np.sin(2 * np.pi * X)
dalpha = np.stack(
    [0.05 * 2 * np.pi * np.cos(2 * np.pi * X), np.zeros_like(X)], -1
)
psi = 1.0 + 0.06 * np.cos(2 * np.pi * Y)
dpsi = np.stack(
    [np.zeros_like(X), -0.06 * 2 * np.pi * np.sin(2 * np.pi * Y)], -1
)

# Central over-pressured magnetized region.
r2 = (X - 0.5) ** 2 + (Y - 0.5) ** 2
inside = r2 < 0.1**2
p = np.where(inside, 5.0, 0.1)
rho = np.where(inside, 1.0, 0.125)
v = np.zeros(no_var + (3,))
B = np.broadcast_to(np.asarray([0.2, 0.1, 0.0]), no_var + (3,))

Q0 = jnp.asarray(np.moveaxis(np.asarray(m.pack_state(
    jnp.asarray(rho), jnp.asarray(v), jnp.asarray(p), jnp.asarray(B),
    jnp.asarray(alpha), jnp.asarray(psi), jnp.asarray(dalpha),
    jnp.asarray(dpsi), gamma=GAMMA,
)), -1, solver.var_axis))

dt = float(solver.cfl_dt(Q0)) * 0.5


@jax.jit
def run(q):
    def body(c, _):
        return limited.step(c, dt), None

    return jax.lax.scan(body, q, None, length=n_steps)[0]


out = run(Q0)
out.block_until_ready()

cand = solver.step(Q0, dt)
troubled = float(jnp.mean(limited.troubled_mask(Q0, cand).astype(jnp.float64)))
m0 = np.asarray(solver.total_mass(Q0))
m1 = np.asarray(solver.total_mass(out))
drift = abs(m1[0] - m0[0]) / abs(m0[0])
ok = m.grmhd_cfc_admissible(2, gamma=GAMMA, iters=12)(out, solver.var_axis)
adm = bool(np.asarray(ok).all())

print(f"limited GRMHD-CFC blast: {cells}x{cells} p{order}, {n_steps} steps, "
      f"dt={dt:.3e}")
print(f"initial troubled fraction: {troubled:.3f}")
print(f"D* conservation drift: {drift:.3e}")
print(f"final state admissible: {adm}")
assert np.isfinite(np.asarray(out)).all()
assert adm and drift < 1e-12
print("OK")
