"""Curvilinear (mapped-mesh) tests: exact metrics, identity reduction,
free-stream convergence, deformed-mesh accuracy, conservation, CK
composition — the validation set for the seismic-topography capability.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import ADERDGSolver, wrap_var_last
from exahype_jax.models.curvilinear import (
    curvilinear_dissipation_mask,
    curvilinear_material_slots,
    curvilinear_physics,
    densitize,
    metric_fields,
    metric_fields_curl,
    n_vars_curvilinear,
    undensitize,
)

A_DEF = 0.03  # periodic deformation amplitude (J stays within ~4 % of 1)


def _mapping(p):
    """Periodic-compatible smooth deformation of the unit square."""
    two_pi = 2 * np.pi
    return (
        p[0] + A_DEF * jnp.sin(two_pi * p[1]),
        p[1] + A_DEF * jnp.sin(two_pi * p[0]),
    )


def _advection_physics(v):
    def flux(q, normal):
        return v[int(normal)] * q

    def eig(q, normal):
        return jnp.full(q.shape[:-1], abs(v[int(normal)]))

    return flux, eig


def _solver(cells, order, n_wave, cflux, ceig, mode="picard", **kw):
    nv = n_vars_curvilinear(n_wave, 2)
    extra = {}
    if mode == "ck":
        extra["ck_material_slots"] = curvilinear_material_slots(n_wave, 2)
    return ADERDGSolver(
        dim=2, order=order, n_vars=nv, grid_shape=(cells, cells),
        flux_fn=wrap_var_last(cflux), max_eigenvalue_fn=wrap_var_last(ceig),
        dx=1.0 / cells, predictor_mode=mode,
        dissipation_mask=curvilinear_dissipation_mask(n_wave, 2),
        **extra, **kw,
    )


def test_identity_mapping_reduces_to_cartesian():
    """J = 1, a = I: the curvilinear step equals the plain Cartesian step
    on the wave slots to rounding.  Equal axis speeds, because the
    curvilinear eigenvalue is the isotropic bound ‖a^k‖·max_i λ_i — for
    anisotropic speeds it is a (valid) stronger Rusanov coefficient."""
    v = (0.8, 0.8)
    flux, eig = _advection_physics(v)
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=1)
    cells, order = 6, 3
    cur = _solver(cells, order, 1, cflux, ceig)
    metric, (X, Y) = metric_fields(cur, lambda p: (p[0], p[1]))
    np.testing.assert_allclose(
        np.take(metric, 0, cur.var_axis), 1.0, atol=1e-15
    )
    plain = ADERDGSolver(
        dim=2, order=order, n_vars=1, grid_shape=(cells, cells),
        flux_fn=lambda Q, a, va: v[a] * Q,
        max_eigenvalue_fn=lambda Q, a, va: jnp.full_like(
            Q.sum(axis=va), abs(v[a])
        ),
        dx=1.0 / cells,
    )
    q0 = np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    q0 = q0[..., None, :, :]  # var axis
    Q0 = densitize(jnp.asarray(q0), metric, cur.var_axis)
    out_c = np.asarray(
        undensitize(cur.step(Q0, 1e-3), 1, cur.var_axis)
    )
    out_p = np.asarray(plain.step(jnp.asarray(q0), 1e-3))
    np.testing.assert_allclose(out_c, out_p, atol=1e-13)


def test_free_stream_preservation_converges():
    """A constant physical state on the deformed mesh: the discrete
    metric-identity residual must converge at scheme order (analytic
    metrics ⇒ not exactly zero — the standard nodal-DG behavior)."""
    flux, eig = _advection_physics((1.0, 0.5))
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=1)
    order = 3
    res = []
    for cells in (4, 8):
        sol = _solver(cells, order, 1, cflux, ceig)
        metric, _ = metric_fields(sol, _mapping)
        q0 = jnp.ones(
            tuple(
                1 if e == sol.var_axis else s
                for e, s in enumerate(sol.state_shape)
            )
        )
        Q0 = densitize(jnp.broadcast_to(
            q0, sol.state_shape[: sol.var_axis] + (1,)
            + sol.state_shape[sol.var_axis + 1:]
        ), metric, sol.var_axis)
        out = undensitize(sol.step(Q0, 1e-3), 1, sol.var_axis)
        res.append(float(jnp.max(jnp.abs(out - 1.0))))
    rate = np.log2(res[0] / res[1])
    assert res[1] < 1e-6, res
    assert rate > order - 0.5, (res, rate)


@pytest.mark.parametrize("mode", ["picard", "ck"])
def test_advection_on_deformed_mesh_converges(mode):
    """Constant-velocity advection through the deformed mesh matches the
    exact physically-translated solution at scheme order; the CK linear
    kernels compose via the metric material slots."""
    v = (1.0, 0.5)
    flux, eig = _advection_physics(v)
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=1)
    order = 3
    errs = []
    for cells in (4, 8):
        sol = _solver(cells, order, 1, cflux, ceig, mode=mode)
        metric, (X, Y) = metric_fields(sol, _mapping)

        def q_exact(t):
            val = (
                np.sin(2 * np.pi * (X - v[0] * t))
                * np.cos(2 * np.pi * (Y - v[1] * t))
            )
            return jnp.asarray(val[..., None, :, :])

        Q0 = densitize(q_exact(0.0), metric, sol.var_axis)
        t_end = 0.1
        n_steps = 10 * (cells // 4)
        out = sol.run(Q0, n_steps, t_end / n_steps)
        q = undensitize(out, 1, sol.var_axis)
        errs.append(float(jnp.max(jnp.abs(q - q_exact(t_end)))))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order + 0.5, (errs, rate)


def test_conservation_of_densitized_total():
    """Σ w·Q̃ = ∫ q dx is exact on the periodic deformed mesh, and the
    metric slots are bitwise frozen."""
    flux, eig = _advection_physics((1.0, 0.5))
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=1)
    sol = _solver(6, 3, 1, cflux, ceig)
    metric, (X, Y) = metric_fields(sol, _mapping)
    q0 = jnp.asarray(
        (1.0 + 0.4 * np.sin(2 * np.pi * X))[..., None, :, :]
    )
    Q0 = densitize(q0, metric, sol.var_axis)
    out = sol.run(Q0, 10, 1e-3)
    m0 = np.asarray(sol.total_mass(Q0))
    m1 = np.asarray(sol.total_mass(out))
    np.testing.assert_allclose(m1[0], m0[0], rtol=0, atol=1e-13)
    sl = [slice(None)] * out.ndim
    sl[sol.var_axis] = slice(1, None)
    np.testing.assert_array_equal(
        np.asarray(out)[tuple(sl)], np.asarray(Q0)[tuple(sl)]
    )


def test_elastic_wave_on_deformed_mesh():
    """The seismic case: an exact elastic P-wave (physical coordinates)
    propagated through the deformed mesh — accuracy at the Cartesian
    test's level, CK and Picard agreeing at the superconvergent level."""
    from exahype_jax.models.elastic import elastic, plane_p_wave

    flux, eig = elastic()
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=5)
    cells, order = 8, 3
    outs = {}
    for mode in ("picard", "ck"):
        sol = _solver(cells, order, 5, cflux, ceig, mode=mode)
        metric, (X, Y) = metric_fields(sol, _mapping)

        def state(t):
            w = plane_p_wave(X, Y, t)
            return jnp.asarray(np.moveaxis(w, -1, sol.var_axis))

        Q0 = densitize(state(0.0), metric, sol.var_axis)
        t_end, n_steps = 0.05, 40
        out = sol.run(Q0, n_steps, t_end / n_steps)
        q = undensitize(out, 5, sol.var_axis)
        err = float(jnp.max(jnp.abs(q - state(t_end))))
        assert err < 0.05 * 1e-3, (mode, err)
        outs[mode] = np.asarray(q)
    assert float(np.max(np.abs(outs["ck"] - outs["picard"]))) < 1e-9


def test_mapping_must_be_orientation_preserving():
    flux, eig = _advection_physics((1.0, 0.5))
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=1)
    sol = _solver(4, 2, 1, cflux, ceig)
    with pytest.raises(ValueError, match="orientation"):
        metric_fields(sol, lambda p: (-p[0], p[1]))


def test_3d_deformed_advection_converges():
    """The 3-D lift (n+10 slots): deformed-mesh advection converges to the
    exact translated solution.  With analytic (autodiff) metrics the
    discrete metric-identity residual is O(h^N) and in 3-D it is the
    visible error floor (measured rate ≈ N here; the 2-D cases converge
    at N+1 because the identity defect there sits below the scheme error
    at these deformations) — the standard analytic-metric nodal-DG
    behavior, documented in the module docstring."""
    v = (1.0, 0.5, 0.25)

    def flux(q, normal):
        return v[int(normal)] * q

    def eig(q, normal):
        return jnp.full(q.shape[:-1], abs(v[int(normal)]))

    cflux, ceig = curvilinear_physics(flux, eig, dim=3, n_wave=1)
    order = 2
    two_pi = 2 * np.pi

    def mp(p):
        return (
            p[0] + 0.02 * jnp.sin(two_pi * p[1]),
            p[1] + 0.02 * jnp.sin(two_pi * p[2]),
            p[2] + 0.02 * jnp.sin(two_pi * p[0]),
        )

    errs = []
    for cells in (4, 8):
        sol = ADERDGSolver(
            dim=3, order=order, n_vars=n_vars_curvilinear(1, 3),
            grid_shape=(cells, cells, cells),
            flux_fn=wrap_var_last(cflux),
            max_eigenvalue_fn=wrap_var_last(ceig),
            dx=1.0 / cells,
            dissipation_mask=curvilinear_dissipation_mask(1, 3),
        )
        metric, (X, Y, Z) = metric_fields(sol, mp)

        def q_exact(t):
            val = np.sin(two_pi * (X - v[0] * t)) * np.cos(
                two_pi * (Y - v[1] * t)
            )
            return jnp.asarray(np.expand_dims(val, sol.var_axis))

        Q0 = densitize(q_exact(0.0), metric, sol.var_axis)
        n_steps = 10 * (cells // 4)
        t_end = 0.02
        out = sol.run(Q0, n_steps, t_end / n_steps)
        q = undensitize(out, 1, sol.var_axis)
        errs.append(float(jnp.max(jnp.abs(q - q_exact(t_end)))))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order - 0.5, (errs, rate)


# ----------------------------------------- Kopriva curl-form metrics (r5)


def _mapping3(p):
    two_pi = 2 * np.pi
    return (
        p[0] + A_DEF * jnp.sin(two_pi * p[1]) * jnp.cos(two_pi * p[2]),
        p[1] + A_DEF * jnp.sin(two_pi * p[2]) * jnp.cos(two_pi * p[0]),
        p[2] + A_DEF * jnp.sin(two_pi * p[0]) * jnp.cos(two_pi * p[1]),
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_curl_metric_in_cell_identity_exact(dim):
    """The core Kopriva property: Σ_k D_k(J a^k_i) = 0 to ROUNDING per
    cell (commuting tensor-product collocation derivatives), for any
    smooth mapping — where the analytic metrics leave an O(h^N) defect."""
    from exahype_jax.models.aderdg import _apply

    flux, eig = _advection_physics((1.0, 0.5, 0.25)[:dim])
    cflux, ceig = curvilinear_physics(flux, eig, dim=dim, n_wave=1)
    nv = n_vars_curvilinear(1, dim)
    sol = ADERDGSolver(
        dim=dim, order=3, n_vars=nv, grid_shape=(4,) * dim,
        flux_fn=wrap_var_last(cflux), max_eigenvalue_fn=wrap_var_last(ceig),
        dx=0.25, dissipation_mask=curvilinear_dissipation_mask(1, dim),
    )
    mp = _mapping if dim == 2 else _mapping3
    for mf in (metric_fields_curl, metric_fields):
        metric, _ = mf(sol, mp)
        m = jnp.moveaxis(jnp.asarray(metric), sol.var_axis, -1)
        defect = 0.0
        for i in range(dim):
            div = None
            for k in range(dim):
                Jak_i = m[..., 1 + k * dim + i]
                term = _apply(sol.ops.D, Jak_i, axis=k) / sol._dxs[k]
                div = term if div is None else div + term
            defect = max(defect, float(jnp.max(jnp.abs(div))))
        if mf is metric_fields_curl:
            assert defect < 1e-12, defect
        elif dim == 3:
            # The analytic-metric gap is real for non-separable mappings
            # (the separable 2-D test mapping satisfies the identity
            # per-axis by accident of its structure).
            assert defect > 1e-4, defect


@pytest.mark.parametrize("dim", [2, 3])
def test_free_stream_exact_with_curl_lobatto(dim):
    """Curl-form metrics + Lobatto basis: face nodes are shared, so the
    curl form's normal metric (tangential derivatives only) is
    single-valued — a constant state is preserved to MACHINE PRECISION
    on the deformed mesh, closing the 3-D free-stream floor the module
    previously documented as the analytic-metric trade."""
    flux, eig = _advection_physics((1.0, 0.5, 0.25)[:dim])
    cflux, ceig = curvilinear_physics(flux, eig, dim=dim, n_wave=1)
    nv = n_vars_curvilinear(1, dim)
    cells = 6 if dim == 2 else 4
    sol = ADERDGSolver(
        dim=dim, order=3, n_vars=nv, grid_shape=(cells,) * dim,
        flux_fn=wrap_var_last(cflux), max_eigenvalue_fn=wrap_var_last(ceig),
        dx=1.0 / cells, basis="lobatto",
        dissipation_mask=curvilinear_dissipation_mask(1, dim),
    )
    mp = _mapping if dim == 2 else _mapping3
    metric, _ = metric_fields_curl(sol, mp)
    shape_one = (sol.state_shape[: sol.var_axis] + (1,)
                 + sol.state_shape[sol.var_axis + 1:])
    Q0 = densitize(jnp.ones(shape_one), metric, sol.var_axis)
    out = undensitize(sol.run(Q0, 5, 1e-3), 1, sol.var_axis)
    assert float(jnp.max(jnp.abs(out - 1.0))) < 1e-12


def test_advection_curl_lobatto_converges():
    """Physics accuracy is retained on the curl-metric Lobatto
    configuration: deformed-mesh advection converges at ≥ N (the
    Lobatto rate — lumped mass)."""
    v = (1.0, 0.5)
    flux, eig = _advection_physics(v)
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=1)
    order = 3
    two_pi = 2 * np.pi
    errs = []
    for cells in (4, 8):
        sol = ADERDGSolver(
            dim=2, order=order, n_vars=n_vars_curvilinear(1, 2),
            grid_shape=(cells, cells),
            flux_fn=wrap_var_last(cflux),
            max_eigenvalue_fn=wrap_var_last(ceig),
            dx=1.0 / cells, basis="lobatto",
            dissipation_mask=curvilinear_dissipation_mask(1, 2),
        )
        metric, (X, Y) = metric_fields_curl(sol, _mapping)

        def q_exact(t):
            val = np.sin(two_pi * (X - v[0] * t)) * np.cos(
                two_pi * (Y - v[1] * t)
            )
            return jnp.asarray(np.expand_dims(val, sol.var_axis))

        Q0 = densitize(q_exact(0.0), metric, sol.var_axis)
        n_steps = 10 * (cells // 4)
        t_end = 0.02
        out = sol.run(Q0, n_steps, t_end / n_steps)
        q = undensitize(out, 1, sol.var_axis)
        errs.append(float(jnp.max(jnp.abs(q - q_exact(t_end)))))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order - 0.5, (errs, rate)


def test_euler_free_stream_over_topography_exact():
    """NONLINEAR curvilinear (round 5): 3-D compressible Euler with a
    uniform moving state over a terrain-deformed mesh — free stream to
    machine precision on curl metrics + Lobatto (the nonlinear flux of a
    constant state is constant, so the same metric identity applies)."""
    from exahype_jax.models import euler

    dim, n_wave = 3, 5
    flux = euler.flux_v_fn(dim=dim, n_real=n_wave)
    eig = euler.max_eigenvalue_v_fn(dim=dim)
    cflux, ceig = curvilinear_physics(flux, eig, dim=dim, n_wave=n_wave)
    nv = n_vars_curvilinear(n_wave, dim)
    cells = 4
    sol = ADERDGSolver(
        dim=dim, order=2, n_vars=nv, grid_shape=(cells,) * dim,
        flux_fn=wrap_var_last(cflux), max_eigenvalue_fn=wrap_var_last(ceig),
        dx=1.0 / cells, basis="lobatto",
        dissipation_mask=curvilinear_dissipation_mask(n_wave, dim),
    )
    metric, _ = metric_fields_curl(sol, _mapping3)
    rho, vx, p = 1.0, 0.3, 0.8
    E = p / 0.4 + 0.5 * rho * vx * vx
    shape_one = (sol.state_shape[: sol.var_axis] + (1,)
                 + sol.state_shape[sol.var_axis + 1:])
    one = jnp.ones(shape_one)
    q0 = jnp.concatenate(
        [rho * one, rho * vx * one, 0.0 * one, 0.0 * one, E * one],
        axis=sol.var_axis,
    )
    Q0 = densitize(q0, metric, sol.var_axis)
    out = undensitize(sol.run(Q0, 5, 1e-3), n_wave, sol.var_axis)
    want = np.moveaxis(
        np.broadcast_to(
            np.array([rho, rho * vx, 0.0, 0.0, E]),
            np.moveaxis(np.asarray(out), sol.var_axis, -1).shape,
        ), -1, sol.var_axis,
    )
    assert float(jnp.max(jnp.abs(out - want))) < 1e-12


def test_curvilinear_sharded_parity():
    """The metric slots shard with the state: the GSPMD curvilinear step
    over an 8-device mesh matches single-device to rounding."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    flux, eig = _advection_physics((1.0, 0.5))
    cflux, ceig = curvilinear_physics(flux, eig, dim=2, n_wave=1)
    sol = _solver(8, 3, 1, cflux, ceig)
    metric, (X, Y) = metric_fields(sol, _mapping)
    q0 = jnp.asarray(
        np.expand_dims(
            np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y), sol.var_axis
        )
    )
    Q0 = densitize(q0, metric, sol.var_axis)
    ref = np.asarray(jax.jit(lambda q: sol.step(q, 1e-3))(Q0))
    mesh = make_mesh(8)
    spec = [None] * Q0.ndim
    spec[sol.grid_axis(0)] = "patches"
    sh = NamedSharding(mesh, PartitionSpec(*spec))
    got = np.asarray(
        jax.jit(
            lambda q: sol.step(q, 1e-3), in_shardings=(sh,),
            out_shardings=sh,
        )(jax.device_put(Q0, sh))
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
