"""GRHD in a static CONFORMALLY-FLAT background spacetime (Cowling),
``ds² = −α(x)² dt² + ψ(x)⁴ δ_ij dx^i dx^j`` — the second GR rung, the
geometry class that contains the isotropic-coordinate Schwarzschild
exterior (α = (1−M/2r)/(1+M/2r), ψ = 1+M/2r).

The design is the frozen-variable pattern of `grhd`/`grmhd`:
the metric (α, ψ) and its analytic gradients ride the state as frozen
variables, so one jitted step serves any background.  The whole curved
solver reduces to the flat `srhd` machinery through one exact map:

    undensitize by √γ = ψ^{2·dim},  then  Ŝ_j = ψ⁻² S_j

turns the curved conserved state into a VALID flat SRHD state (the hat
velocity v̂^i = ψ² v^i satisfies δ_ij v̂^i v̂^j = γ_ij v^i v^j, so W and
the recovery are identical).  Consequences, each machine-verified:

- con2prim is the flat bracketed-Newton recovery applied to the hatted
  state (all of its boundedness guarantees carry over);
- fluxes are the flat fluxes with per-row scalings:
  F(D*,τ*) = α ψ^{2·dim−2} F̂,  F(S*_j) = α ψ^{2·dim} F̂;
- the max characteristic speed is exactly α ψ⁻² · λ̂_flat (coordinate
  light cone of the conformal metric);
- the geometric sources close over (α, ψ, ∂α, ∂ψ):
  s(S*_j) = −(τ*+D*) ∂_jα + 2αψ⁻¹∂_jψ (ρhW²v̂² + dim·p)·ψ^{2·dim},
  s(τ*)   = −ψ^{2·dim−2} ρhW² v̂^j ∂_jα;
- the conformal-trace source cancels ∂_j√γ from the pressure flux
  EXACTLY, so the Tolman hydrostatic profile p = p₀α^{−k} (ρ = p/c²,
  k = 1/c² + γ/(γ−1)) is an exact equilibrium in ANY conformally-flat
  static metric — ψ drops out of the balance.  This is the closed-form
  anchor the convergence test uses.

Citation: the reference repo has no GR capability (SURVEY.md §0); this
extends `models/grhd.py` (lapse-only) toward the ExaHyPE astrophysics
applications' curved static backgrounds.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp

from exahype_jax.models import srhd


def n_vars(dim: int) -> int:
    """[D*, S*_1..dim, τ*, α, ψ, ∂α_1..dim, ∂ψ_1..dim]."""
    return (dim + 2) + 2 + 2 * dim


def _split(Q, dim: int):
    nh = dim + 2
    return (Q[..., :nh], Q[..., nh], Q[..., nh + 1],
            Q[..., nh + 2:nh + 2 + dim], Q[..., nh + 2 + dim:nh + 2 + 2 * dim])


def hat_state(Q, dim: int):
    """Densitized curved conserved block → the equivalent FLAT SRHD state."""
    hydro, _, psi, _, _ = _split(Q, dim)
    inv_vol = psi[..., None] ** (-2 * dim)
    flat = hydro * inv_vol
    s_scale = psi[..., None] ** (-2.0)
    return jnp.concatenate(
        [flat[..., :1], flat[..., 1:1 + dim] * s_scale, flat[..., 1 + dim:]],
        axis=-1,
    )


def pack_state(rho, v, p, alpha, psi, dalpha, dpsi, *,
               gamma: float = 5.0 / 3.0):
    """Primitives (v = CONTRAVARIANT coordinate velocity v^i) + metric →
    the densitized var-last state."""
    rho, p = jnp.asarray(rho), jnp.asarray(p)
    v = jnp.asarray(v)
    dim = v.shape[-1]
    alpha = jnp.broadcast_to(jnp.asarray(alpha), rho.shape)
    psi = jnp.broadcast_to(jnp.asarray(psi), rho.shape)
    vhat = psi[..., None] ** 2 * v
    flat = srhd.prim_to_cons(rho, vhat, p, gamma=gamma)
    vol = psi[..., None] ** (2 * dim)
    s_scale = psi[..., None] ** 2
    hydro = jnp.concatenate(
        [flat[..., :1], flat[..., 1:1 + dim] * s_scale, flat[..., 1 + dim:]],
        axis=-1,
    ) * vol
    return jnp.concatenate(
        [hydro, alpha[..., None], psi[..., None],
         jnp.asarray(dalpha), jnp.asarray(dpsi)], axis=-1,
    )


def con2prim(Q, *, dim: int = 2, gamma: float = 5.0 / 3.0, iters: int = 10):
    """(ρ, v^i, p, W) — flat recovery on the hatted state, v unhatted."""
    _, _, psi, _, _ = _split(Q, dim)
    rho, vhat, p, W = srhd.con2prim(hat_state(Q, dim), gamma=gamma,
                                    iters=iters)
    return rho, vhat * psi[..., None] ** (-2.0), p, W


def grhd_cfc_flux(Q, normal, *, dim: int = 2, gamma: float = 5.0 / 3.0,
                  iters: int = 10):
    hydro, alpha, psi, _, _ = _split(Q, dim)
    fhat = srhd.srhd_flux(hat_state(Q, dim), normal, gamma=gamma,
                          iters=iters)
    a = alpha[..., None]
    lo = a * psi[..., None] ** (2 * dim - 2)   # D*, τ* rows
    hi = a * psi[..., None] ** (2 * dim)       # S*_j rows
    f = jnp.concatenate(
        [lo * fhat[..., :1], hi * fhat[..., 1:1 + dim],
         lo * fhat[..., 1 + dim:]], axis=-1,
    )
    zeros = jnp.zeros(Q.shape[:-1] + (2 + 2 * dim,), Q.dtype)
    return jnp.concatenate([f, zeros], axis=-1)


def grhd_cfc_eigenvalue(Q, normal, *, dim: int = 2,
                        gamma: float = 5.0 / 3.0, iters: int = 10):
    _, alpha, psi, _, _ = _split(Q, dim)
    return alpha * psi ** (-2.0) * srhd.srhd_eigenvalue(
        hat_state(Q, dim), normal, gamma=gamma, iters=iters
    )


def grhd_cfc(dim: int = 2, gamma: float = 5.0 / 3.0, iters: int = 10):
    """(flux, max_eigenvalue) batch-native pair."""
    return (
        partial(grhd_cfc_flux, dim=dim, gamma=gamma, iters=iters),
        partial(grhd_cfc_eigenvalue, dim=dim, gamma=gamma, iters=iters),
    )


def grhd_cfc_source(dim: int = 2, gamma: float = 5.0 / 3.0,
                    iters: int = 10):
    """Geometric sources in the ``ADERDGSolver.source_fn`` contract.

    With E* = τ* + D* and (v̂, p) from the hatted recovery:
      s(S*_j) = −E* ∂_jα + 2αψ^{2·dim−1}∂_jψ (ρhW² v̂² + dim·p)
      s(τ*)   = −ψ^{2·dim−2} ρhW² v̂^j ∂_jα      (ρhW² = τ + D + p)
    """
    nh = dim + 2

    def source(q, var_axis):
        Q = jnp.moveaxis(q, var_axis, -1)
        hydro, alpha, psi, dalpha, dpsi = _split(Q, dim)
        _, vhat, p, _ = srhd.con2prim(hat_state(Q, dim), gamma=gamma,
                                      iters=iters)
        Estar = hydro[..., 0] + hydro[..., 1 + dim]
        vol = psi ** (2 * dim)
        rhohW2 = Estar / vol + p                  # undensitized τ + D + p
        v2 = jnp.sum(vhat * vhat, axis=-1)
        trace = rhohW2 * v2 + dim * p
        zero = jnp.zeros_like(Estar)
        sS = [
            -Estar * dalpha[..., d]
            + 2.0 * alpha * psi ** (2 * dim - 1) * dpsi[..., d] * trace
            for d in range(dim)
        ]
        s_tau = -psi ** (2 * dim - 2) * rhohW2 * jnp.sum(
            vhat * dalpha, axis=-1
        )
        parts = [zero] + sS + [s_tau] + [zero] * (2 + 2 * dim)
        return jnp.moveaxis(jnp.stack(parts, axis=-1), -1, var_axis)

    return source


def grhd_cfc_dissipation_mask(dim: int = 2) -> tuple:
    """Freeze the metric slots against Rusanov smearing."""
    return (1.0,) * (dim + 2) + (0.0,) * (2 + 2 * dim)


def grhd_cfc_admissible(dim: int = 2, gamma: float = 5.0 / 3.0,
                        iters: int = 10):
    """Limiter hook: flat admissibility on the hatted state + positive
    lapse and conformal factor."""

    def ok(Q, var_axis):
        q = jnp.moveaxis(Q, var_axis, -1)
        _, alpha, psi, _, _ = _split(q, dim)
        rho, vhat, p, _ = srhd.con2prim(hat_state(q, dim), gamma=gamma,
                                        iters=iters)
        v2 = jnp.sum(vhat * vhat, axis=-1)
        fin = jnp.all(jnp.isfinite(q), axis=-1)
        return (fin & (rho > 0) & (p > 0) & (v2 < 1.0)
                & (alpha > 0) & (psi > 0))

    return ok


def schwarzschild_isotropic(r, M: float = 1.0):
    """(α, ψ, dα/dr, dψ/dr) of the Schwarzschild exterior in isotropic
    coordinates: ψ = 1 + M/2r, α = (1 − M/2r)/(1 + M/2r)."""
    r = jnp.asarray(r)
    u = M / (2.0 * r)
    psi = 1.0 + u
    alpha = (1.0 - u) / (1.0 + u)
    du = -M / (2.0 * r * r)
    dpsi = du
    dalpha = -2.0 * du / (1.0 + u) ** 2
    return alpha, psi, dalpha, dpsi
