"""Shallow water equations with bathymetry for the ADER-DG solver.

The SWE system with a non-flat bottom is the canonical non-conservative
hyperbolic model (reference parity: the reference DSL ships only Euler
physics, ``Unit test/Functions.cpp:9-62``; this extends the model family
the way the downstream framework family does):

    ∂t h    + ∇·(h u)                  = 0
    ∂t(h u) + ∇·(h u ⊗ u + ½ g h² I)   = −g h ∇b
    ∂t b    = 0                                    (bathymetry, frozen)

The bathymetry coupling −g·h·∇b is genuinely non-conservative — it enters
through :class:`~exahype_jax.models.aderdg.ADERDGSolver`'s ``ncp_fn``
(path-conservative fluctuations), while ``b`` rides along as a frozen
variable: zero flux, zero NCP slot, and a ``dissipation_mask`` zero so the
Rusanov jump viscosity never smears it.

State layout follows the SoA-P physics contract ``fn(Q, axis, var_axis)``
with variables ``[h, h·u_1, …, h·u_dim, b]`` at position ``var_axis``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from exahype_jax.models.aderdg import ADERDGSolver

GRAVITY = 9.81


def _v(Q, k, va):
    return jax.lax.index_in_dim(Q, k, va, keepdims=False)


def swe_physics(dim: int, g: float = GRAVITY):
    """(flux_fn, max_eigenvalue_fn, ncp_fn) for SWE+bathymetry.

    Variables: ``[h, h·u_1, …, h·u_dim, b]`` (``n_vars = dim + 2``).
    """

    def flux(Q, axis, va):
        h = _v(Q, 0, va)
        hu_d = _v(Q, 1 + axis, va)
        u_d = hu_d / h
        comps = [hu_d]
        for k in range(dim):
            m = _v(Q, 1 + k, va) * u_d
            if k == axis:
                m = m + 0.5 * g * h * h
            comps.append(m)
        comps.append(jnp.zeros_like(h))  # b does not flux
        return jnp.stack(comps, axis=va)

    def eig(Q, axis, va):
        h = _v(Q, 0, va)
        u_d = _v(Q, 1 + axis, va) / h
        return jnp.abs(u_d) + jnp.sqrt(g * h)

    def ncp(Q, dQ, axis, va):
        """B_axis(Q)·dQ: the bathymetry gradient forces the axis momentum."""
        h = _v(Q, 0, va)
        db = _v(dQ, 1 + dim, va)
        zero = jnp.zeros_like(h)
        comps = [zero]
        for k in range(dim):
            comps.append(g * h * db if k == axis else zero)
        comps.append(zero)
        return jnp.stack(comps, axis=va)

    return flux, eig, ncp


def make_swe_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    g: float = GRAVITY,
    **kwargs,
) -> ADERDGSolver:
    """A fully-configured SWE+bathymetry ADER-DG solver (periodic)."""
    flux, eig, ncp = swe_physics(dim, g=g)
    mask = (1,) * (1 + dim) + (0,)
    return ADERDGSolver(
        dim=dim,
        order=order,
        n_vars=dim + 2,
        grid_shape=grid_shape,
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        ncp_fn=ncp,
        dissipation_mask=mask,
        dx=dx,
        **kwargs,
    )


def lake_at_rest(solver: ADERDGSolver, surface: float = 1.0, amp: float = 0.1):
    """The steady 'lake at rest' state: h + b = surface, u = 0, over a
    smooth sinusoidal bathymetry of amplitude ``amp``."""
    import numpy as np

    coords = solver.nodes_meshgrid()
    phase = sum(coords)
    b = amp * np.sin(2 * np.pi * np.asarray(phase))
    b = np.broadcast_to(
        np.squeeze(b, axis=solver.var_axis),
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :],
    )
    h = surface - b
    zeros = np.zeros_like(h)
    comps = [h] + [zeros] * solver.dim + [b]
    return jnp.asarray(np.stack(comps, axis=solver.var_axis))
