"""Limiter × wall-boundary composition (round 4).

Round 3 guarded the limiter out of every non-periodic, non-reflective
boundary and out of per-axis ``wall_axes``; these tests pin the lifted
guards.  Reference context: the reference framework delegates boundary
treatment to Peano's mesh traversal (reference
``exahype/printers/CPPPrinter.py:321-347`` emits the Peano boundary
include block); here the boundary contract must compose with the
a-posteriori MOOD limiter's DMP detection, subcell ghosts, and slope/
gradient ghosts instead.

Physics of each pin:

- outflow walls: zero-gradient ghosts are EXACT while a disturbance is
  compact, so walled limited runs must match periodic limited runs
  bitwise until the wave reaches a wall — and a blast that does reach
  the wall must leave (mass decreases, state stays admissible);
- farfield walls: a state identically equal to the prescribed farfield
  state is a steady solution of every path (free-stream preservation),
  and held boundary data must never false-flag the DMP;
- dirichlet walls: prescribed rows matching a constant state are
  likewise steady through the subcell fallback;
- ``wall_axes``: axes outside the tuple stay EXACTLY periodic.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import (
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
    make_dirichlet_fn,
)
from exahype_jax.models.limiter import LimitedADERDG, euler_admissible
from exahype_jax.utils.errors import SemanticError


def make_solver(cells=8, order=2, **kw):
    flux, eig = euler_physics(dim=2, n_real=4)
    return ADERDGSolver(
        dim=2, order=order, n_vars=4, grid_shape=(cells, cells),
        flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / cells, **kw,
    )


def centered_blast(solver, strong=True):
    """Pressure blast centered in the domain (compact until it spreads)."""
    coords = solver.nodes_meshgrid()
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    x = np.broadcast_to(np.squeeze(coords[0], solver.var_axis), no_var)
    y = np.broadcast_to(np.squeeze(coords[1], solver.var_axis), no_var)
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
    p = np.where(r2 < 0.01, 10.0 if strong else 1.5, 0.1)
    rho = np.ones_like(p)
    E = p / 0.4
    Q = np.stack([rho, np.zeros_like(p), np.zeros_like(p), E],
                 axis=solver.var_axis)
    return jnp.asarray(Q)


def uniform_state(solver, vals):
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    Q = np.stack([np.full(no_var, v) for v in vals], axis=solver.var_axis)
    return jnp.asarray(Q)


FF = (1.0, 0.1, 0.0, 2.6)  # rho, mx, my, E — subsonic inflow state


# ---------------------------------------------------------------- outflow


@pytest.mark.parametrize("fb_order", [1, 2])
def test_limited_outflow_compact_parity(fb_order):
    """Forced all-cell FV fallback, walled (outflow on x) vs periodic:
    bitwise equal while the blast has not reached the walls — outflow
    ghosts of a constant edge state equal the periodic wrap exactly, in
    the state ghosts, the slope ghosts, and the DMP window."""
    walled = make_solver(boundary="outflow", wall_axes=(0,))
    periodic = make_solver()
    lw = LimitedADERDG(walled, admissible=euler_admissible(dim=2),
                       fallback_order=fb_order)
    lp = LimitedADERDG(periodic, admissible=euler_admissible(dim=2),
                       fallback_order=fb_order)
    Q0 = centered_blast(walled)
    force_all = lambda t: jnp.ones_like(t)
    dt = 1e-3
    a, b = Q0, Q0
    for _ in range(3):
        a = lw.step(a, dt, troubled_transform=force_all)
        b = lp.step(b, dt, troubled_transform=force_all)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=0, atol=1e-13)


def test_limited_blast_outflow_walls_shock_leaves():
    """The VERDICT round-4 anchor: a strong limited blast in a fully
    outflow-walled box stays admissible while the shock crosses the walls
    and LEAVES — total mass strictly decreases once the front reaches the
    boundary (no periodic re-entry, no wall reflection)."""
    solver = make_solver(cells=12, order=3, boundary="outflow")
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    Q = centered_blast(solver, strong=True)
    m0 = float(np.asarray(solver.total_mass(Q))[0])
    adm = euler_admissible(dim=2)
    dt = 5e-4
    # Probed trajectory (x64, this exact config): the front reaches the
    # walls near t ≈ 0.22 (step ~450); mass_frac 0.9999 at step 400,
    # 0.990 at 500, 0.904 at 600, 0.785 at 700 — and the state stays
    # finite + admissible through step 1200 (mass_frac 0.35).
    n_steps = 700
    import jax
    Q = jax.jit(lambda q: limited.run(q, n_steps, dt))(Q)
    Qn = np.asarray(Q)
    assert np.isfinite(Qn).all()
    assert bool(np.asarray(adm(Q, solver.var_axis)).all())
    m1 = float(np.asarray(solver.total_mass(Q))[0])
    assert m1 < 0.90 * m0, (m0, m1)  # mass actually left the box


def test_gathered_outflow_all_troubled_matches_whole_grid():
    """The gathered (troubled_capacity) production path reproduces the
    whole-grid fallback exactly with outflow walls — the slot-table wall
    flags route the outflow copy ghosts identically."""
    solver = make_solver(boundary="outflow")
    whole = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    gathered = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=64
    )
    Q0 = centered_blast(solver)
    force_all = lambda t: jnp.ones_like(t)
    a = np.asarray(whole.step(Q0, 1e-3, troubled_transform=force_all))
    b = np.asarray(gathered.step(Q0, 1e-3, troubled_transform=force_all))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)


@pytest.mark.parametrize("granularity", ["cell", "row"])
def test_gathered_blast_outflow_stable(granularity):
    """Gathered limited blast with outflow walls: the real production
    configuration (capacity-bounded FV region tracking the shock through
    the wall) stays admissible as the front exits."""
    solver = make_solver(cells=12, order=2, boundary="outflow")
    cap = 72 if granularity == "cell" else 10
    limited = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2),
        troubled_capacity=cap, troubled_granularity=granularity,
    )
    Q = centered_blast(solver, strong=True)
    import jax
    Q = jax.jit(lambda q: limited.run(q, 120, 5e-4))(Q)
    assert np.isfinite(np.asarray(Q)).all()
    adm = euler_admissible(dim=2)
    assert bool(np.asarray(adm(Q, solver.var_axis)).all())


# --------------------------------------------------------------- farfield


def test_limited_farfield_free_stream_preserved():
    """State ≡ farfield state is steady through the DG path, the forced
    subcell fallback (orders 1 and 2), and the means fallback: every
    ghost equals the interior, every face flux cancels."""
    for fallback, fb_order in (("subcell", 1), ("subcell", 2), ("means", 1)):
        solver = make_solver(boundary="farfield", farfield_state=FF)
        limited = LimitedADERDG(
            solver, admissible=euler_admissible(dim=2),
            fallback=fallback, fallback_order=fb_order,
        )
        Q0 = uniform_state(solver, FF)
        force_all = lambda t: jnp.ones_like(t)
        Q1 = limited.step(Q0, 1e-3, troubled_transform=force_all)
        np.testing.assert_allclose(
            np.asarray(Q1), np.asarray(Q0), rtol=0, atol=1e-12,
            err_msg=f"{fallback}/{fb_order}",
        )


def test_limited_farfield_no_false_flags_and_inflow_feeds():
    """(a) Smooth flow matching the farfield at the boundary never
    trips the DMP (the window admits the held state); (b) a genuinely
    mismatched farfield drives the interior toward the prescribed state
    and the run stays admissible."""
    solver = make_solver(cells=8, order=2, boundary="farfield",
                         farfield_state=FF)
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    Q0 = uniform_state(solver, FF)
    candidate = solver.step(Q0, 1e-3)
    mask = np.asarray(limited.troubled_mask(Q0, candidate))
    assert not mask.any()

    lower = (1.0, 0.1, 0.0, 2.0)  # interior at lower energy than farfield
    solver2 = make_solver(cells=8, order=2, boundary="farfield",
                          farfield_state=FF)
    limited2 = LimitedADERDG(solver2, admissible=euler_admissible(dim=2))
    Q = uniform_state(solver2, lower)
    E0 = float(np.asarray(solver2.total_mass(Q))[3])
    import jax
    Q = jax.jit(lambda q: limited2.run(q, 60, 1e-3))(Q)
    assert np.isfinite(np.asarray(Q)).all()
    E1 = float(np.asarray(solver2.total_mass(Q))[3])
    assert E1 > E0  # the higher-energy farfield pushes energy in


def test_gathered_farfield_all_troubled_matches_whole_grid():
    solver = make_solver(boundary="farfield", farfield_state=FF)
    whole = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    gathered = LimitedADERDG(
        solver, admissible=euler_admissible(dim=2), troubled_capacity=64
    )
    Q0 = centered_blast(solver)
    force_all = lambda t: jnp.ones_like(t)
    a = np.asarray(whole.step(Q0, 1e-3, troubled_transform=force_all))
    b = np.asarray(gathered.step(Q0, 1e-3, troubled_transform=force_all))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)


# -------------------------------------------------------------- dirichlet


def test_limited_dirichlet_constant_steady():
    """Dirichlet rows prescribing the SAME constant as the interior:
    steady through the forced subcell fallback at both orders (the
    precomputed subcell/mean ghost rows reproduce the constant; ghost
    slopes are zero by the prescribed-wall contract)."""
    state_fn = lambda x, y: np.stack(
        [np.ones_like(x), 0.1 * np.ones_like(x),
         np.zeros_like(x), 2.6 * np.ones_like(x)], axis=-1
    )
    for fb_order in (1, 2):
        dfn = make_dirichlet_fn(state_fn, dim=2, order=2,
                                grid_shape=(8, 8), dx=1.0 / 8)
        solver = make_solver(boundary="dirichlet", dirichlet_fn=dfn)
        limited = LimitedADERDG(
            solver, admissible=euler_admissible(dim=2),
            fallback_order=fb_order,
        )
        Q0 = uniform_state(solver, FF)
        force_all = lambda t: jnp.ones_like(t)
        Q1 = limited.step(Q0, 1e-3, troubled_transform=force_all)
        np.testing.assert_allclose(
            np.asarray(Q1), np.asarray(Q0), rtol=0, atol=1e-12,
            err_msg=f"order {fb_order}",
        )


def test_limited_dirichlet_blast_stable():
    """Limited blast in a box with held (free-stream) dirichlet walls:
    finite and admissible as the shock interacts with the held rows."""
    state_fn = lambda x, y: np.stack(
        [np.ones_like(x), np.zeros_like(x),
         np.zeros_like(x), 0.25 * np.ones_like(x)], axis=-1
    )
    dfn = make_dirichlet_fn(state_fn, dim=2, order=2,
                            grid_shape=(12, 12), dx=1.0 / 12)
    solver = make_solver(cells=12, order=2, boundary="dirichlet",
                         dirichlet_fn=dfn)
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    Q = centered_blast(solver, strong=True)
    import jax
    Q = jax.jit(lambda q: limited.run(q, 120, 5e-4))(Q)
    assert np.isfinite(np.asarray(Q)).all()
    adm = euler_admissible(dim=2)
    assert bool(np.asarray(adm(Q, solver.var_axis)).all())


def test_limited_dirichlet_gathered_still_rejected():
    """The one documented hole: gathered fallback + dirichlet raises a
    clear SemanticError instead of silently using wrong ghosts."""
    state_fn = lambda x, y: np.stack(
        [np.ones_like(x), np.zeros_like(x),
         np.zeros_like(x), np.ones_like(x)], axis=-1
    )
    dfn = make_dirichlet_fn(state_fn, dim=2, order=2,
                            grid_shape=(8, 8), dx=1.0 / 8)
    solver = make_solver(boundary="dirichlet", dirichlet_fn=dfn)
    with pytest.raises(SemanticError, match="dirichlet"):
        LimitedADERDG(solver, admissible=euler_admissible(dim=2),
                      troubled_capacity=16)


# -------------------------------------------------------------- wall_axes


@pytest.mark.parametrize("boundary", ["reflective", "outflow"])
def test_limited_wall_axes_periodic_axis_exact(boundary):
    """Per-axis walls: with walls on x only, a y-compact blast evolved in
    a domain periodic in y matches the SAME run shifted by half the
    domain in y (discrete translation equivariance of the periodic axis
    — fails if any wall ghost leaks onto axis 1)."""
    kw = dict(boundary=boundary, wall_axes=(0,))
    if boundary == "reflective":
        kw.update(reflect_fn=euler_reflect(2),
                  reflect_flux_fn=euler_reflect_flux(2))
    solver = make_solver(cells=8, order=2, **kw)
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    Q0 = centered_blast(solver)
    ga = solver.grid_axis(1)
    roll = lambda q: jnp.roll(q, 4, axis=ga)
    force_all = lambda t: jnp.ones_like(t)
    a, b = Q0, roll(Q0)
    for _ in range(3):
        a = limited.step(a, 1e-3, troubled_transform=force_all)
        b = limited.step(b, 1e-3, troubled_transform=force_all)
    np.testing.assert_allclose(
        np.asarray(roll(a)), np.asarray(b), rtol=0, atol=1e-13
    )


def test_limited_wall_axes_reflective_conserves_transverse_momentum():
    """Slip walls (normal momentum negated) on x only: the y-momentum has
    no wall source, and mass/energy conserve to rounding through the
    forced fallback (periodic in y, pressure-sealed in x)."""
    solver = make_solver(
        cells=8, order=2, boundary="reflective", wall_axes=(0,),
        reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2),
    )
    limited = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    rng = np.random.default_rng(7)
    no_var = (
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :]
    )
    rho = 1.0 + 0.1 * rng.random(no_var)
    Q0 = jnp.asarray(np.stack(
        [rho, 0.3 * rho, 0.1 * rho, 5.0 + 0.5 * rho], axis=solver.var_axis
    ))
    m0 = np.asarray(solver.total_mass(Q0))
    force_all = lambda t: jnp.ones_like(t)
    Q = Q0
    for _ in range(3):
        Q = limited.step(Q, 5e-4, troubled_transform=force_all)
    m1 = np.asarray(solver.total_mass(Q))
    np.testing.assert_allclose(m1[0], m0[0], rtol=1e-12)  # mass
    np.testing.assert_allclose(m1[2], m0[2], rtol=1e-10)  # y-momentum
    np.testing.assert_allclose(m1[3], m0[3], rtol=1e-12)  # energy
    assert abs(m1[1] - m0[1]) > 1e-9  # x walls push back
