"""ExaSeis-style demonstrator: Ricker point source in an elastic medium,
recorded at a line of receivers.

The canonical seismic configuration of the ExaHyPE application family: a
vertical point force with a Ricker source-time function drives the 2-D
velocity–stress elastic-wave system; fixed receiver probes record
seismograms.  Built from three composable pieces of this framework —
`ADERDGSolver` (the wave propagator), `PointSources` (delta forcing,
Strang-split), and `TracerAdvector.sample` (the receivers).

Checks printed at the end: mirror symmetry of the radiated field across
the source axis, and the P-wave arrival time at the nearest receiver.

Run on CPU with ``--cpu``; on the GPU the grid is larger.
``--ck`` selects the Cauchy–Kovalewski linear predictor — the kernel
class the reference family's generator emits for seismic (linear) PDEs;
elasticity is exactly linear, so the physics checks are unchanged.
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.elastic import _speeds, elastic, elastic_free_surface
from exahype_jax.models.point_source import PointSources, ricker
from exahype_jax.models.tracers import TracerAdvector

on_cpu = jax.default_backend() == "cpu"
cells = 9 if on_cpu else 128
rho, lam, mu = 1.0, 2.0, 1.0
cp, cs = _speeds(rho, lam, mu)

# Traction-free (free-surface) box — the Earth's-surface boundary condition.
flux, eig = elastic(rho=rho, lam=lam, mu=mu)
reflect, reflect_flux = elastic_free_surface()
solver = ADERDGSolver(
    dim=2, order=3, n_vars=5, grid_shape=(cells, cells),
    flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
    dx=1.0 / cells, boundary="reflective",
    reflect_fn=reflect, reflect_flux_fn=reflect_flux,
    predictor_mode="ck" if "--ck" in sys.argv else "picard",
)

# Vertical point force at the domain centre (a cell centre for odd grids).
f0 = 8.0
amp = np.zeros((1, 5))
amp[0, 1] = 1.0
src = PointSources(solver, [[0.5, 0.5]], amp, wavelet=ricker(f0))

# Receiver line at y = 0.3, mirrored pairs about x = 0.5.
rx = np.asarray([0.3, 0.4, 0.6, 0.7])
receivers = jnp.asarray(np.stack([rx, np.full_like(rx, 0.3)], -1))
probe = TracerAdvector(solver, lambda v: v[:, :2])

dtype = None if on_cpu else np.float32
u = jnp.zeros(solver.state_shape, dtype)
dt = float(solver.cfl_dt(jnp.ones(solver.state_shape, dtype)))
n_steps = 110 if on_cpu else 400  # long enough for the P arrival check


def chunk(u, t):
    def body(carry, _):
        uu, tt = carry
        uu = src.step(uu, tt, dt)
        return (uu, tt + dt), probe.sample(uu, receivers)

    return jax.lax.scan(body, (u, t), None, length=n_steps)


(u, t), seismogram = jax.jit(chunk)(u, jnp.asarray(0.0, u.dtype))
seis = np.asarray(seismogram)  # [n_steps, n_receivers, 2]

# Mirror symmetry: v_y even, v_x odd across the source axis.
vy_sym = np.abs(seis[:, 1, 1] - seis[:, 2, 1]).max()
vx_asym = np.abs(seis[:, 1, 0] + seis[:, 2, 0]).max()
scale = max(np.abs(seis).max(), 1e-30)
print(f"mirror symmetry: |vy diff| {vy_sym:.2e}, |vx sum| {vx_asym:.2e} "
      f"(field max {scale:.2e})")
assert vy_sym < 1e-5 * scale and vx_asym < 1e-5 * scale  # f32 rounding

# P-wave arrival at the nearest receivers (distance 0.2236): first time
# the envelope exceeds 1 % of its maximum, compared with r/c_p plus the
# wavelet onset delay.
r = float(np.hypot(0.1, 0.2))
v_mag = np.abs(seis[:, 1, :]).max(axis=-1)
arrive_idx = int(np.argmax(v_mag > 0.01 * v_mag.max()))
t_arrive = (arrive_idx + 1) * dt
t_expect = r / cp + 0.35 / f0  # onset ≈ 0.65/f0 before the wavelet peak
print(f"P arrival at r={r:.3f}: measured t≈{t_arrive:.4f}, "
      f"kinematic estimate {t_expect:.4f} (c_p={cp:.3f})")
if float(t) > t_expect:
    assert abs(t_arrive - t_expect) < 0.5 * t_expect
print("OK")
