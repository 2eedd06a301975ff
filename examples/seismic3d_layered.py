"""ExaSeis production shape in 3-D: layered heterogeneous medium, linear
(Cauchy–Kovalewski) kernels, free surface, absorbing edges, point source,
surface receivers.

This is the configuration the reference family's seismic application
exists for — and every piece is the framework's own: the 12-variable
heterogeneous velocity–stress system (per-cell (ρ, λ, μ) as frozen
variables), `predictor_mode="ck"` (the generator's LINEAR kernel class;
`ck_material_slots` injects the materials into the Taylor recursion),
traction-free walls on the vertical axis (`wall_axes=(2,)` — the Earth's
surface), squared-cosine sponge absorbers on the horizontal edges, a
vertical Ricker point force at depth, and a line of surface receivers
recording seismograms through the tracer probes.

Checks printed at the end: frozen materials (bitwise), mirror symmetry
of the radiated field across the source axis, and the P-wave arrival
time at the nearest surface receiver from the upper-layer wave speed.

Run on CPU with ``--cpu``; on the GPU the grid is larger.
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.elastic import (
    N_VARS_3D_HET,
    _speeds,
    elastic3d_free_surface_het,
    elastic3d_heterogeneous,
    sponge_source,
)
from exahype_jax.models.point_source import PointSources, ricker
from exahype_jax.models.tracers import TracerAdvector

on_cpu = jax.default_backend() == "cpu"
cells = (9, 9, 6) if on_cpu else (63, 63, 36)
order = 3

# Upper layer (near the surface): soft. Lower layer: stiff (2x speeds).
up = dict(rho=1.0, lam=2.0, mu=1.0)
lo = dict(rho=1.2, lam=9.6, mu=4.8)
cp_up, _ = _speeds(**up)

flux, eig = elastic3d_heterogeneous()
reflect, reflect_flux = elastic3d_free_surface_het()
solver = ADERDGSolver(
    dim=3, order=order, n_vars=N_VARS_3D_HET, grid_shape=cells,
    flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
    dx=1.0 / cells[0],
    boundary="reflective", wall_axes=(2,),  # free surface top/bottom
    reflect_fn=reflect, reflect_flux_fn=reflect_flux,
    dissipation_mask=(1,) * 9 + (0, 0, 0),
    predictor_mode="ck", ck_material_slots=(9, 10, 11),
    source_fn=None,  # installed below (sponge needs the solver)
)
solver.source_fn = sponge_source(
    solver, width=0.12, rate=40.0, axes=(0, 1), n_wave=9
)

# Layered material fields on the nodal grid.
coords = solver.nodes_meshgrid()
no_var = tuple(
    s for e, s in enumerate(solver.state_shape) if e != solver.var_axis
)
Zc = np.broadcast_to(
    np.squeeze(np.asarray(coords[2]), solver.var_axis), no_var
)
zmax = cells[2] * solver._dxs[2]
upper = Zc > 0.5 * zmax
mats = np.stack(
    [
        np.where(upper, up["rho"], lo["rho"]),
        np.where(upper, up["lam"], lo["lam"]),
        np.where(upper, up["mu"], lo["mu"]),
    ],
    axis=solver.var_axis,
)
dtype = None if on_cpu else np.float32
u = jnp.asarray(
    np.concatenate(
        [np.zeros(no_var + (9,)).reshape(
            solver.state_shape[: solver.var_axis] + (9,)
            + solver.state_shape[solver.var_axis + 1:]
         ), mats],
        axis=solver.var_axis,
    ),
    dtype,
)

# Vertical point force at depth in the upper layer.
f0 = 8.0
src_z = 0.75 * zmax
amp = np.zeros((1, N_VARS_3D_HET))
amp[0, 2] = 1.0
src = PointSources(solver, [[0.5, 0.5, src_z]], amp, wavelet=ricker(f0))

# Surface receiver line along x (mirrored pairs about the source axis).
rx = np.asarray([0.3, 0.4, 0.6, 0.7])
zr = 0.95 * zmax
receivers = jnp.asarray(
    np.stack([rx, np.full_like(rx, 0.5), np.full_like(rx, zr)], -1)
)
probe = TracerAdvector(solver, lambda v: v[:, :3])

dt = float(solver.cfl_dt(u))
n_steps = 80 if on_cpu else 400


def chunk(u, t):
    def body(carry, _):
        uu, tt = carry
        uu = src.step(uu, tt, dt)
        return (uu, tt + dt), probe.sample(uu, receivers)

    return jax.lax.scan(body, (u, t), None, length=n_steps)


(uT, t), seismogram = jax.jit(chunk)(u, jnp.asarray(0.0, u.dtype))
seis = np.asarray(seismogram)  # [n_steps, n_receivers, 3]
uT = np.asarray(uT)
assert np.isfinite(uT).all() and np.isfinite(seis).all()

# Materials bitwise frozen through CK + walls + sponge + point source.
sel = lambda k: (slice(None),) * solver.var_axis + (k,)
for k in (9, 10, 11):
    np.testing.assert_array_equal(uT[sel(k)], np.asarray(u)[sel(k)])
print("materials frozen: OK")

# Mirror symmetry across the source axis: v_z even, v_x odd in x.
vz_sym = np.abs(seis[:, 1, 2] - seis[:, 2, 2]).max()
vx_asym = np.abs(seis[:, 1, 0] + seis[:, 2, 0]).max()
scale = max(np.abs(seis).max(), 1e-30)
print(f"mirror symmetry: |vz diff| {vz_sym:.2e}, |vx sum| {vx_asym:.2e} "
      f"(field max {scale:.2e})")
assert vz_sym < 1e-5 * scale and vx_asym < 1e-5 * scale

# P arrival at the nearest receivers: the direct path runs through the
# upper layer only.
r = float(np.hypot(0.1, zr - src_z))
v_mag = np.abs(seis[:, 1, :]).max(axis=-1)
arrive_idx = int(np.argmax(v_mag > 0.01 * v_mag.max()))
t_arrive = (arrive_idx + 1) * dt
t_expect = r / cp_up + 0.35 / f0
print(f"P arrival at r={r:.3f}: measured t≈{t_arrive:.4f}, "
      f"kinematic estimate {t_expect:.4f} (upper-layer c_p={cp_up:.3f})")
if float(t) > t_expect:
    assert abs(t_arrive - t_expect) < 0.5 * t_expect
print("OK")
