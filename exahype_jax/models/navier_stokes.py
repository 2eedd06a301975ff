"""Compressible Navier–Stokes: the advection–diffusion model family
(ExaHyPE's ``CompressibleNavierStokes`` application class).

State (var-last): ``[ρ, m_1..dim, E]`` — the Euler variables.  The
hyperbolic part IS the Euler flux (``models/euler.py``); this module adds
the viscous flux in the :class:`~exahype_jax.models.aderdg.ADERDGSolver`
``visc_flux_fn(Q, grads, axis, var_axis)`` contract:

    F_v(m_j) along d = −τ_dj,
    F_v(E)   along d = −τ_dj v_j + q_d,
    τ_ij = μ (∂_i v_j + ∂_j v_i − (2/3) δ_ij ∇·v)      (Stokes hypothesis)
    q_d  = −κ_T ∂_d T,   T = p/ρ  (R = 1),  κ_T = μ γ c_v / Pr,
    c_v = 1/(γ−1)

Velocity/temperature gradients come from the conserved-variable chain
rule: ∂v_j = (∂m_j − v_j ∂ρ)/ρ, ∂T = ((γ−1)(∂E − v·∂m + q²∂ρ/2) − T∂ρ)/ρ
with q² = v·v.  The diffusion eigenvalue (face penalty + parabolic dt)
is ``max(4ν/3, γν/Pr)`` with ν = μ/ρ.

Exact anchors (tested): a low-amplitude transverse shear mode
v_y(x) = V sin(2πx) at uniform (ρ, p) is an exact incompressible-limit
solution decaying at exactly ν(2π)² (to O(V²) compressible corrections);
total mass/momentum/energy are conserved to rounding (the viscous flux
is a pure divergence — viscous heating is exactly the work the stress
extracts from the momenta); μ→0 recovers the Euler solver bitwise.

Citation: the reference repo (SURVEY.md §0) has no diffusive capability;
this supplies the ExaHyPE-engine application class on the ADER-DG solver.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exahype_jax.models import euler


def viscous_flux(Q, grads, normal, *, dim: int = 2, mu: float = 1e-2,
                 prandtl: float = 0.7, gamma: float = euler.GAMMA):
    """Var-last viscous flux along ``normal`` from physical gradients."""
    rho = Q[..., 0]
    inv_rho = 1.0 / rho
    v = [Q[..., 1 + j] * inv_rho for j in range(dim)]
    E = Q[..., 1 + dim]
    q2 = sum(vj * vj for vj in v)
    T = (gamma - 1.0) * (E * inv_rho - 0.5 * q2)  # p/ρ with R = 1

    # dv[e][j] = ∂_e v_j ; dT[e] = ∂_e T (conserved-variable chain rule).
    dv = [[None] * dim for _ in range(dim)]
    dT = [None] * dim
    for e in range(dim):
        g = grads[e]
        drho = g[..., 0]
        dE = g[..., 1 + dim]
        v_dot_dm = jnp.zeros_like(drho)
        for j in range(dim):
            dv[e][j] = (g[..., 1 + j] - v[j] * drho) * inv_rho
            v_dot_dm = v_dot_dm + v[j] * g[..., 1 + j]
        dT[e] = (
            (gamma - 1.0) * (dE - v_dot_dm + 0.5 * q2 * drho) - T * drho
        ) * inv_rho

    div_v = sum(dv[e][e] for e in range(dim))
    d = normal
    # τ_dj and the viscous work/heat row.
    tau_d = [
        mu * (dv[d][j] + dv[j][d] - (2.0 / 3.0) * (div_v if j == d else 0.0))
        for j in range(dim)
    ]
    kappa_T = mu * gamma / ((gamma - 1.0) * prandtl)
    rows = [jnp.zeros_like(rho)]
    rows += [-tau_d[j] for j in range(dim)]
    rows.append(-sum(tau_d[j] * v[j] for j in range(dim)) - kappa_T * dT[d])
    return jnp.stack(rows, axis=-1)


def viscous_eigenvalue(Q, normal, *, dim: int = 2, mu: float = 1e-2,
                       prandtl: float = 0.7, gamma: float = euler.GAMMA):
    """Max diffusion eigenvalue max(4ν/3, γν/Pr), ν = μ/ρ (var-last)."""
    nu = mu / Q[..., 0]
    return jnp.maximum(4.0 / 3.0, gamma / prandtl) * nu


def navier_stokes(dim: int = 2, mu: float = 1e-2, prandtl: float = 0.7,
                  gamma: float = euler.GAMMA):
    """(flux, max_eigenvalue, visc_flux, visc_eigenvalue) — var-last
    batch-native callbacks for the full compressible NS system."""
    return (
        partial(euler.flux_v, dim=dim, n_real=dim + 2, gamma=gamma),
        partial(euler.max_eigenvalue_v, dim=dim, gamma=gamma),
        partial(viscous_flux, dim=dim, mu=mu, prandtl=prandtl, gamma=gamma),
        partial(viscous_eigenvalue, dim=dim, mu=mu, prandtl=prandtl,
                gamma=gamma),
    )


def noslip_reflect(dim: int):
    """Mirror ghost STATE for no-slip (viscous) walls: negate ALL momentum
    components (the ghost velocity is the full reversal, so the wall-face
    average velocity vanishes — the standard ghost-cell no-slip; a slip /
    free-surface wall negates only the normal momentum, see
    :func:`~exahype_jax.models.aderdg.euler_reflect`).  ρ and E are copied
    (impermeable, adiabatic-to-leading-order)."""

    def reflect(Q, axis, var_axis):
        signs = [1.0] + [-1.0] * dim + [1.0]
        parts = [
            s * jax.lax.index_in_dim(Q, k, var_axis, keepdims=True)
            for k, s in enumerate(signs)
        ]
        return jnp.concatenate(parts, axis=var_axis)

    return reflect


def noslip_reflect_flux(dim: int):
    """Mirror ghost ADVECTIVE flux for no-slip walls: under the full
    velocity reversal u → −u the Euler flux obeys ``F(reflect(q)) = S·F(q)``
    with S = −1 on the mass and energy rows (ρu_d and u_d(E+p) are odd in
    u) and +1 on every momentum row (ρ u_d u_j + p δ_dj is even).  The
    viscous part of the wall flux is handled one-sided by the solver's
    face stage and never passes through this hook."""

    def reflect(F, axis, var_axis):
        signs = [-1.0] + [1.0] * dim + [-1.0]
        parts = [
            s * jax.lax.index_in_dim(F, k, var_axis, keepdims=True)
            for k, s in enumerate(signs)
        ]
        return jnp.concatenate(parts, axis=var_axis)

    return reflect


def wrap_visc_var_last(batch_fn):
    """Adapt a var-last ``(Q, grads, normal)`` viscous callback to the
    solver's ``(Q, grads, axis, var_axis)`` contract."""

    def fn(Q, grads, axis, var_axis):
        out = batch_fn(
            jnp.moveaxis(Q, var_axis, -1),
            tuple(jnp.moveaxis(g, var_axis, -1) for g in grads),
            axis,
        )
        return jnp.moveaxis(out, -1, var_axis)

    return fn
