"""Benchmark: the three ADER-DG cells on one GPU, in DOF-updates/s.

The cells drive the main path through the entry points a user calls:

- ``euler``: p3 3-D compressible Euler, :class:`ADERDGSolver` stepped
  through the fused GPU cell stage (:class:`TritonADERDG`), 64³ cells
  (84 M DOF, a 336 MB f32 state), a smooth entropy wave;
- ``limited``: the same grid under :class:`LimitedADERDG` (a-posteriori DMP
  + admissibility detection, gathered ROW subcell-FV fallback, DG/FV
  interface matching, post-step guard) on a planar Sod shock, its
  candidate from the same fused cell stage;
- ``ck``: p3 3-D heterogeneous elasticity (12 variables, frozen per-cell
  ρ, λ, μ in a two-layer medium) on the Cauchy–Kovalewski predictor,
  32×16×16 cells.

Each cell steps ``CHUNK`` steps per dispatch (``lax.scan``, state donated),
compiles once (reported as set-up), and times ``ROUNDS`` dispatches ending in
``block_until_ready``.  Prints one JSON line naming the device.  Stops when
no GPU is found: a CPU run measures nothing this benchmark reports.

    python bench.py
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_DOF_PER_SEC = 1.0e9
CHUNK = 5
ROUNDS = 6

EULER_GRID = (64, 64, 64)
CK_GRID = (32, 16, 16)
#: Gathered-row capacity of the limited cell: a quarter of the 64² rows of
#: the 64³ grid, well above the planar front's demand (see chip_smoke.py,
#: which prints demand against it).
LIMITED_CAPACITY = 1024


def stable_dt(solver, Q):
    """The cells' time step: ``ADERDGSolver.cfl_dt`` with its default
    constant divided by the dimension.  The default bounds the largest
    per-axis Courant number, which is not stable in 3-D: rounding-level
    noise on a flat p3 Euler state grows about 1.6x per step at that dt
    and is non-finite within 50 steps, while at the constant / 3 it stays
    at its starting level over 150 steps (CPU, float64).  Divided by the
    dimension, the constant bounds the sum of the axes' Courant numbers."""
    cfl = min(0.4, 1.5 / (solver.order + 2)) / solver.dim
    return float(solver.cfl_dt(Q, cfl=cfl))


def _no_var(solver):
    s = solver.state_shape
    return s[: solver.var_axis] + s[solver.var_axis + 1 :]


def euler_setup(grid_shape=EULER_GRID, dtype=np.float32):
    """p3 3-D Euler on the periodic unit cube: a smooth entropy wave
    (density 1 + 0.2 sin 2π(x+y+z) carried at velocity (1, 1/2, 1/4) and
    pressure 1) — its exact solution is the translated profile."""
    from exahype_jax.models.aderdg import ADERDGSolver, euler_physics

    flux, eig = euler_physics(dim=3, n_real=5)
    solver = ADERDGSolver(
        dim=3, order=3, n_vars=5, grid_shape=tuple(grid_shape),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / grid_shape[0],
    )
    va = solver.var_axis
    x, y, z = (np.squeeze(np.asarray(c), va) for c in solver.nodes_meshgrid())
    rho = np.broadcast_to(1.0 + 0.2 * np.sin(2 * np.pi * (x + y + z)),
                          _no_var(solver))
    vel = (1.0, 0.5, 0.25)
    energy = 1.0 / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    comps = [rho] + [v * rho for v in vel] + [energy]
    Q = jnp.asarray(np.stack(comps, axis=va).astype(dtype))
    return solver, Q


def limited_setup(grid_shape=EULER_GRID, dtype=np.float32,
                  capacity=LIMITED_CAPACITY, fused=True):
    """Limited p3 3-D Euler with the row-gathered subcell fallback, on a
    planar Sod shock along axis 0 (the front is a grid-wide surface).
    ``fused`` takes the candidate from the GPU kernel (GPU only)."""
    from exahype_jax.models.aderdg_triton import TritonADERDG
    from exahype_jax.models.limiter import LimitedADERDG, euler_admissible

    solver, _ = euler_setup(grid_shape, dtype)
    limited = LimitedADERDG(
        solver,
        admissible=euler_admissible(dim=3, gamma=1.4),
        troubled_capacity=capacity,
        troubled_granularity="row",
        dmp_delta0=5e-4,
        accelerator=TritonADERDG(solver) if fused else None,
    )
    x = np.arange(grid_shape[0]).reshape(-1, 1, 1) / grid_shape[0]
    left = np.broadcast_to(x < 0.5, tuple(grid_shape))
    no_var = _no_var(solver)
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), no_var).astype(dtype)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), no_var).astype(dtype)
    zeros = np.zeros(no_var, dtype)
    Q = jnp.asarray(
        np.stack([rho, zeros, zeros, zeros, p / 0.4], axis=solver.var_axis)
    )
    return limited, Q


def ck_setup(grid_shape=CK_GRID, dtype=np.float32):
    """p3 3-D heterogeneous elasticity on CK kernels: a plane P wave in a
    two-layer medium (the lower half is stiffer).  Returns
    ``(solver, Q, (rho, lam, mu))`` with the material fields var-less."""
    from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
    from exahype_jax.models.elastic import (
        elastic3d_heterogeneous,
        plane_p_wave_3d,
    )

    flux, eig = elastic3d_heterogeneous()
    solver = ADERDGSolver(
        dim=3, order=3, n_vars=12, grid_shape=tuple(grid_shape),
        flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
        dx=1.0 / grid_shape[0], predictor_mode="ck",
        ck_material_slots=(9, 10, 11),
        dissipation_mask=(1,) * 9 + (0, 0, 0),
    )
    va = solver.var_axis
    coords = solver.nodes_meshgrid()
    no_var = _no_var(solver)
    X = np.broadcast_to(np.squeeze(np.asarray(coords[0]), va), no_var)
    Z = np.broadcast_to(np.squeeze(np.asarray(coords[2]), va), no_var)
    wave = np.moveaxis(plane_p_wave_3d(X, 0.0), -1, va)
    lower = Z < 0.5 * grid_shape[2] / grid_shape[0]
    mats = (np.where(lower, 1.2, 1.0), np.where(lower, 3.0, 2.0),
            np.where(lower, 1.5, 1.0))
    Q = jnp.asarray(np.concatenate([wave, np.stack(mats, axis=va)], axis=va),
                    dtype)
    return solver, Q, mats


def euler_integrity(solver):
    """Jitted ``q -> (all finite, total mass)``."""

    @jax.jit
    def check(q):
        return jnp.isfinite(q).all(), solver.total_mass(q)[0]

    return check


def limited_integrity(limited):
    """Jitted ``q -> (all finite, all admissible, min density, mass)``."""
    from exahype_jax.models.limiter import euler_admissible

    sol = limited.solver
    adm = euler_admissible(dim=sol.dim, gamma=1.4)

    @jax.jit
    def check(q):
        rho = jnp.take(q, 0, sol.var_axis)
        return (jnp.isfinite(q).all(), adm(q, sol.var_axis).all(),
                jnp.min(rho), sol.total_mass(q)[0])

    return check


def ck_integrity(solver, mats):
    """Jitted ``q -> (all finite, materials bitwise frozen, energy)``.

    The energy is the true seismic energy (×2), ρv² + σ:S:σ with the
    isotropic compliance S: σ:S:σ = [σ:σ − λ/(3λ+2μ)(tr σ)²]/(2μ)."""
    va = solver.var_axis

    def vslice(q, lo, hi):
        return jax.lax.slice_in_dim(q, lo, hi, axis=va)

    rho_m, lam_m, mu_m = mats

    @jax.jit
    def check(q):
        mat = jnp.stack([jnp.asarray(m, q.dtype) for m in mats], axis=va)
        frozen = (vslice(q, 9, 12) == mat).all()
        v2 = jnp.sum(jnp.asarray(np.expand_dims(rho_m, va), q.dtype)
                     * vslice(q, 0, 3) ** 2, axis=va)
        diag, off = vslice(q, 3, 6), vslice(q, 6, 9)
        s_dd = jnp.sum(diag**2, axis=va) + 2.0 * jnp.sum(off**2, axis=va)
        trs = jnp.sum(diag, axis=va)
        lam_a = jnp.asarray(lam_m, q.dtype)
        mu_a = jnp.asarray(mu_m, q.dtype)
        strain2 = (s_dd - lam_a / (3 * lam_a + 2 * mu_a) * trs**2) / (2.0 * mu_a)
        return jnp.isfinite(q).all(), frozen, jnp.sum(v2 + strain2)

    return check


def chunk_fn(step, chunk=CHUNK):
    """Jitted ``(q, dt) -> q`` running ``chunk`` steps, state donated."""

    def run(q, dt):
        def body(carry, _):
            return step(carry, dt), None

        out, _ = jax.lax.scan(body, q, None, length=chunk)
        return out

    return jax.jit(run, donate_argnums=0)


def time_cell(step, Q, dt, rounds=ROUNDS, chunk=CHUNK):
    """Compile and time ``chunk``-step dispatches of ``step``.

    Returns ``(Q_out, compile_s, step_s, compiled)``: compile seconds
    (set-up), seconds per step over ``rounds`` dispatches after one warm-up
    dispatch, each window ending in ``block_until_ready``."""
    dt = jnp.asarray(dt, Q.dtype)
    t0 = time.perf_counter()
    compiled = chunk_fn(step, chunk).lower(Q, dt).compile()
    compile_s = time.perf_counter() - t0
    Q = compiled(Q, dt)
    Q.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(rounds):
        Q = compiled(Q, dt)
    Q.block_until_ready()
    step_s = (time.perf_counter() - t0) / (rounds * chunk)
    return Q, compile_s, step_s, compiled


def bench_euler():
    from exahype_jax.models.aderdg_triton import TritonADERDG
    from exahype_jax.utils.roofline import aderdg_step_cost, peaks_for

    solver, Q = euler_setup()
    dt = stable_dt(solver, Q)
    Q, compile_s, step_s, _ = time_cell(TritonADERDG(solver).step, Q, dt)
    finite, _ = euler_integrity(solver)(Q)
    assert bool(finite), "euler cell: non-finite state"
    cost = aderdg_step_cost(solver)
    peaks = peaks_for(jax.devices()[0].device_kind)
    roofline_s = cost.roofline_seconds(peaks["f32_flops"],
                                       peaks["hbm_bytes_per_s"])
    return {
        "metric": "aderdg_p3_euler3d_dof_updates_per_sec",
        "value": solver.dofs() / step_s,
        "unit": "DOF-updates/s",
        "grid": list(solver.grid_shape),
        "step_seconds": step_s,
        "compile_seconds": compile_s,
        "roofline": {
            "model_flops_per_step": cost.flops,
            "min_bytes_per_step": cost.bytes_total,
            "bound": ("compute" if cost.flops / peaks["f32_flops"]
                      > cost.bytes_total / peaks["hbm_bytes_per_s"]
                      else "memory"),
            "share": roofline_s / step_s,
            "peaks_source": peaks["source"],
        },
    }


def bench_limited():
    limited, Q = limited_setup()
    sol = limited.solver
    dt = stable_dt(sol, Q)
    check = limited_integrity(limited)
    mass0 = float(check(Q)[3])
    Q, compile_s, step_s, _ = time_cell(limited.step, Q, dt)
    finite, adm, rho_min, mass1 = (np.asarray(v) for v in check(Q))
    assert bool(finite), "limited cell: non-finite state"
    assert bool(adm), f"limited cell: inadmissible state (rho_min={rho_min})"
    demand, capacity = (int(v) for v in jax.jit(
        limited.capacity_usage)(Q, jnp.asarray(dt, Q.dtype)))
    return {
        "metric": "limited_aderdg_p3_euler3d_dof_updates_per_sec",
        "value": sol.dofs() / step_s,
        "unit": "DOF-updates/s",
        "grid": list(sol.grid_shape),
        "step_seconds": step_s,
        "compile_seconds": compile_s,
        "rows_demand_final": demand,
        "rows_capacity": capacity,
        "mass_drift_rel": abs(float(mass1) - mass0) / abs(mass0),
    }


def bench_ck():
    solver, Q, mats = ck_setup()
    dt = stable_dt(solver, Q)
    check = ck_integrity(solver, mats)
    e0 = float(check(Q)[2])
    Q, compile_s, step_s, _ = time_cell(solver.step, Q, dt)
    finite, frozen, e1 = (np.asarray(v) for v in check(Q))
    assert bool(finite), "ck cell: non-finite state"
    assert bool(frozen), "ck cell: material slots changed"
    # DOF accounting: the 9 evolved wave variables (material slots are
    # storage, not updates).
    dof = int(np.prod(solver.grid_shape)) * solver.n_nodes**3 * 9
    return {
        "metric": "ck_p3_elastic3d_het_dof_updates_per_sec",
        "value": dof / step_s,
        "unit": "DOF-updates/s",
        "grid": list(solver.grid_shape),
        "step_seconds": step_s,
        "compile_seconds": compile_s,
        "energy_ratio": float(e1) / e0,
    }


def device_record():
    """Device identity for every result line."""
    from exahype_jax.utils.gpu import card_info

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def main():
    from exahype_jax.utils.gpu import require_gpu, use_compile_cache

    require_gpu()
    use_compile_cache()
    euler = bench_euler()
    print(json.dumps({
        **euler,
        "vs_baseline": euler["value"] / BASELINE_DOF_PER_SEC,
        "limited": bench_limited(),
        "ck": bench_ck(),
        "device": device_record(),
    }))


if __name__ == "__main__":
    main()
