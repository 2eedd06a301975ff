"""Seismic wave propagation over topography: the curvilinear mesh in
action.

The curvilinear-ExaSeis configuration of the reference family: the
elastic velocity–stress system on a mesh deformed by a smooth interior
"hill" (the deformation vanishes at the domain edges, so the periodic
box topology is untouched), on the Cauchy–Kovalewski linear kernels with
the exact autodiff metric slots as frozen materials.  A vertical Ricker
point force radiates under the hill; receivers along a constant-ξ line
record seismograms, with their PHYSICAL positions reported through the
mapping.

Checks printed at the end: the flat limit (hill height 0) matches the
plain Cartesian solver to rounding, the metric slots stay bitwise
frozen, and the hill measurably deflects the recorded wavefield.

Run on CPU with ``--cpu``; on the GPU the grid is larger.
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.curvilinear import (
    curvilinear_dissipation_mask,
    curvilinear_material_slots,
    curvilinear_physics,
    densitize,
    metric_fields,
    n_vars_curvilinear,
)
from exahype_jax.models.elastic import elastic
from exahype_jax.models.point_source import PointSources, ricker
from exahype_jax.models.tracers import TracerAdvector

on_cpu = jax.default_backend() == "cpu"
cells = 9 if on_cpu else 96
N_WAVE = 5
NV = n_vars_curvilinear(N_WAVE, 2)


def hill_mapping(height):
    """Vertical displacement by a Gaussian hill, tapered to zero at the
    box edges (periodic-compatible): y-lines bunch under the summit."""

    def mp(p):
        bump = height * jnp.exp(-(((p[0] - 0.5) / 0.15) ** 2))
        taper = jnp.sin(np.pi * p[1]) ** 2
        return (p[0], p[1] + bump * taper * (1.0 - p[1]))

    return mp


def build(height, mode="ck"):
    flux, eig = elastic()
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=N_WAVE)
    solver = ADERDGSolver(
        dim=2, order=3, n_vars=NV, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(cflux), max_eigenvalue_fn=wrap_var_last(ceig),
        dx=1.0 / cells, predictor_mode=mode,
        ck_material_slots=(
            curvilinear_material_slots(N_WAVE, 2) if mode == "ck" else None
        ),
        dissipation_mask=curvilinear_dissipation_mask(N_WAVE, 2),
    )
    metric, (X, Y) = metric_fields(solver, hill_mapping(height))
    return solver, metric, X, Y


def run(height, n_steps, dt):
    solver, metric, X, Y = build(height)
    dtype = None if on_cpu else np.float32
    zeros = jnp.zeros(
        solver.state_shape[: solver.var_axis] + (N_WAVE,)
        + solver.state_shape[solver.var_axis + 1:]
    )
    u = densitize(zeros, metric, solver.var_axis)
    if dtype is not None:
        u = u.astype(dtype)
    f0 = 8.0
    amp = np.zeros((1, NV))
    amp[0, 1] = 1.0  # vertical force
    src = PointSources(solver, [[0.5, 0.35]], amp, wavelet=ricker(f0))
    rx = np.asarray([0.3, 0.4, 0.6, 0.7])
    receivers = jnp.asarray(np.stack([rx, np.full_like(rx, 0.6)], -1))
    probe = TracerAdvector(solver, lambda v: v[:, :2])

    def chunk(u, t):
        def body(carry, _):
            uu, tt = carry
            uu = src.step(uu, tt, dt)
            return (uu, tt + dt), probe.sample(uu, receivers)

        return jax.lax.scan(body, (u, t), None, length=n_steps)

    (uT, t), seis = jax.jit(chunk)(u, jnp.asarray(0.0, u.dtype))
    return solver, metric, np.asarray(uT), np.asarray(seis)


dt = 4e-4 if on_cpu else 1e-4
n_steps = 100 if on_cpu else 400

# Flat limit: height 0 == the plain Cartesian elastic solver (identical
# point source / receivers) to rounding.
solver0, metric0, uT0, seis0 = run(0.0, n_steps, dt)
flux, eig = elastic()
plain = ADERDGSolver(
    dim=2, order=3, n_vars=N_WAVE, grid_shape=(cells, cells),
    flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
    dx=1.0 / cells, predictor_mode="ck",
)
ampP = np.zeros((1, N_WAVE))
ampP[0, 1] = 1.0
srcP = PointSources(plain, [[0.5, 0.35]], ampP, wavelet=ricker(8.0))
rx = np.asarray([0.3, 0.4, 0.6, 0.7])
recv = jnp.asarray(np.stack([rx, np.full_like(rx, 0.6)], -1))
probeP = TracerAdvector(plain, lambda v: v[:, :2])


def chunkP(u, t):
    def body(carry, _):
        uu, tt = carry
        uu = srcP.step(uu, tt, dt)
        return (uu, tt + dt), probeP.sample(uu, recv)

    return jax.lax.scan(body, (u, t), None, length=n_steps)


uP = jnp.zeros(plain.state_shape, None if on_cpu else np.float32)
(_, _), seisP = jax.jit(chunkP)(uP, jnp.asarray(0.0, uP.dtype))
seisP = np.asarray(seisP)
scale = max(np.abs(seisP[..., :2]).max(), 1e-30)
flat_err = np.abs(seis0[..., :2] - seisP[..., :2]).max()
print(f"flat limit vs Cartesian solver: max seismogram diff "
      f"{flat_err:.2e} (field max {scale:.2e})")
assert flat_err < 1e-5 * scale

# Topography on: the hill deflects the field; metric slots stay frozen.
solver1, metric1, uT1, seis1 = run(0.04, n_steps, dt)
assert np.isfinite(uT1).all() and np.isfinite(seis1).all()
sel = (slice(None),) * solver1.var_axis + (slice(N_WAVE, NV),)
np.testing.assert_array_equal(
    uT1[sel],
    np.asarray(
        densitize(
            jnp.zeros_like(jnp.asarray(uT1)[
                (slice(None),) * solver1.var_axis + (slice(0, N_WAVE),)
            ]),
            metric1, solver1.var_axis,
        )
    )[sel],
)
print("metric slots frozen: OK")
topo_effect = np.abs(seis1[..., :2] - seis0[..., :2]).max()
print(f"topography effect on seismograms: {topo_effect:.2e} "
      f"(field max {scale:.2e})")
assert topo_effect > 1e-3 * scale

# Physical receiver positions through the mapping (reported).
mp = hill_mapping(0.04)
phys = [tuple(float(v) for v in mp(jnp.asarray(p))) for p in np.asarray(recv)]
print("receiver physical positions:",
      ", ".join(f"({x:.3f}, {y:.3f})" for x, y in phys))
print("OK")
