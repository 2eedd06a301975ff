"""GRMHD in a static CONFORMALLY-FLAT background spacetime (Cowling),
``ds² = −α(x)² dt² + ψ(x)⁴ δ_ij dx^i dx^j`` — the full ExaHyPE
astrophysics configuration: magnetized relativistic matter on a curved
static metric (isotropic-coordinate Schwarzschild exterior included).

Completes the {hydro, MHD} × {lapse-only, conformally-flat} model
matrix (`grhd`, `grmhd`, `grhd_cfc`, this).  Like `rmhd`, the momentum
and field are 3-vectors (planar symmetry for dim=2: a 3+1 spacetime
with ∂_z = 0), so every conformal factor uses the 3-D volume element
√γ = ψ⁶.

The same exact hat-map as `grhd_cfc` reduces everything to the flat
`rmhd` machinery — undensitize by ψ⁶, then Ŝ_j = ψ⁻²S_j and
B̂^i = ψ²B^i (v̂ = ψ²v preserves W; B̂, v̂ preserve every contraction):

- con2prim = the flat AD-Newton recovery on the hatted state (all of
  its boundedness/subluminality guarantees carry over);
- fluxes are the flat GLM-RMHD fluxes with per-row scalings
  F(D*,τ*) = αψ⁴ F̂,  F(S*) = αψ⁶ F̂,  F(B*, φ*) = αψ² F̂
  (with B* = ψ⁴B̂ the densitized field, so ∂_i B*^i is the FLAT
  divergence — the constraint GLM damps — and the cleaning subsystem's
  wave speed is exactly αψ⁻²c_h, inside the coordinate light cone);
- every characteristic's coordinate speed is αψ⁻² × its flat-hat value
  (conformal isometry), so the Rusanov bound is αψ⁻²·λ̂_rmhd;
- geometric sources (E* = τ* + D*, hat quantities from the recovery):
  s(S*_j) = −E* ∂_jα + 2αψ⁵∂_jψ · TR,
  TR = (ρh+b²)W²v̂² + 3(p+b²/2) − |b̂_s|²,
  |b̂_s|² = B̂²/W² + (v̂·B̂)²(2+W²v̂²),
  s(τ*)  = −ψ⁴ Ŝ^j ∂_jα;   D*, B*, φ* are source-free.

Exact anchors (tested): α=ψ=1 reduces to `rmhd`; ψ=1 reduces to the
lapse-only `grmhd`; with α ≡ 1 and a UNIFORM out-of-plane hatted field
B̂ = B̂ ẑ the static balance closes in closed form — ψ∂p = −2B̂²∂ψ, i.e.
p = p₀ − 2B̂² ln ψ with ρ free — giving a magnetized curved-space
equilibrium whose residual converges at the scheme's order; coordinate
causality λ ≤ αψ⁻² (≥ the cleaning speed).
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp

from exahype_jax.models import rmhd

N_HYDRO = rmhd.N_VARS  # 9: D, S(3), tau, B(3), psi_glm


def n_vars(dim: int) -> int:
    """[D*, S*(3), τ*, B*(3), φ*, α, ψ, ∂α(dim), ∂ψ(dim)]."""
    return N_HYDRO + 2 + 2 * dim


def _split(Q, dim: int):
    nh = N_HYDRO
    return (Q[..., :nh], Q[..., nh], Q[..., nh + 1],
            Q[..., nh + 2:nh + 2 + dim],
            Q[..., nh + 2 + dim:nh + 2 + 2 * dim])


def hat_state(Q, dim: int):
    """Densitized curved conserved block → the equivalent FLAT RMHD state."""
    hydro, _, psi, _, _ = _split(Q, dim)
    p2 = psi[..., None] ** 2
    flat = hydro * psi[..., None] ** (-6.0)
    return jnp.concatenate(
        [flat[..., :1], flat[..., 1:4] / p2, flat[..., 4:5],
         flat[..., 5:] * p2],  # B rows AND the GLM scalar scale together
        axis=-1,
    )


def pack_state(rho, v, p, B, alpha, psi, dalpha, dpsi, *,
               gamma: float = 5.0 / 3.0):
    """Primitives (v, B CONTRAVARIANT coordinate 3-vectors) + metric →
    the densitized var-last state."""
    rho, p = jnp.asarray(rho), jnp.asarray(p)
    alpha = jnp.broadcast_to(jnp.asarray(alpha), rho.shape)
    psi = jnp.broadcast_to(jnp.asarray(psi), rho.shape)
    p2 = psi[..., None] ** 2
    flat = rmhd.prim_to_cons(rho, jnp.asarray(v) * p2,
                             p, jnp.asarray(B) * p2, gamma=gamma)
    vol = psi[..., None] ** 6
    hydro = jnp.concatenate(
        [flat[..., :1], flat[..., 1:4] * p2, flat[..., 4:5],
         flat[..., 5:] / p2], axis=-1,
    ) * vol
    return jnp.concatenate(
        [hydro, alpha[..., None], psi[..., None],
         jnp.asarray(dalpha), jnp.asarray(dpsi)], axis=-1,
    )


def con2prim(Q, *, dim: int = 2, gamma: float = 5.0 / 3.0, iters: int = 20):
    """(ρ, v^i, p, W, B^i) — flat recovery on the hatted state, unhatted."""
    _, _, psi, _, _ = _split(Q, dim)
    hat = hat_state(Q, dim)
    rho, vhat, p, W = rmhd.con2prim(hat, gamma=gamma, iters=iters)
    p2 = psi[..., None] ** 2
    return rho, vhat / p2, p, W, hat[..., 5:8] / p2


def grmhd_cfc_flux(Q, normal, *, dim: int = 2, gamma: float = 5.0 / 3.0,
                   c_h: float = 1.0, iters: int = 20):
    hydro, alpha, psi, _, _ = _split(Q, dim)
    fhat = rmhd.rmhd_flux(hat_state(Q, dim), normal, gamma=gamma, c_h=c_h,
                          iters=iters)
    a = alpha[..., None]
    s_dt = a * psi[..., None] ** 4   # D*, τ* rows
    s_S = a * psi[..., None] ** 6    # S* rows
    s_B = a * psi[..., None] ** 2    # B*, φ* rows
    f = jnp.concatenate(
        [s_dt * fhat[..., :1], s_S * fhat[..., 1:4],
         s_dt * fhat[..., 4:5], s_B * fhat[..., 5:]], axis=-1,
    )
    zeros = jnp.zeros(Q.shape[:-1] + (2 + 2 * dim,), Q.dtype)
    return jnp.concatenate([f, zeros], axis=-1)


def grmhd_cfc_eigenvalue(Q, normal, *, dim: int = 2,
                         gamma: float = 5.0 / 3.0, c_h: float = 1.0,
                         iters: int = 20):
    _, alpha, psi, _, _ = _split(Q, dim)
    return alpha * psi ** (-2.0) * rmhd.rmhd_eigenvalue(
        hat_state(Q, dim), normal, gamma=gamma, c_h=c_h, iters=iters
    )


def grmhd_cfc(dim: int = 2, gamma: float = 5.0 / 3.0, c_h: float = 1.0,
              iters: int = 20):
    """(flux, max_eigenvalue) batch-native pair."""
    return (
        partial(grmhd_cfc_flux, dim=dim, gamma=gamma, c_h=c_h, iters=iters),
        partial(grmhd_cfc_eigenvalue, dim=dim, gamma=gamma, c_h=c_h,
                iters=iters),
    )


def grmhd_cfc_source(dim: int = 2, gamma: float = 5.0 / 3.0,
                     iters: int = 20):
    """Geometric sources in the ``ADERDGSolver.source_fn`` contract."""

    def source(q, var_axis):
        Q = jnp.moveaxis(q, var_axis, -1)
        hydro, alpha, psi, dalpha, dpsi = _split(Q, dim)
        hat = hat_state(Q, dim)
        rho, vhat, p, W = rmhd.con2prim(hat, gamma=gamma, iters=iters)
        Bhat = hat[..., 5:8]
        Shat = hat[..., 1:4]
        Bv = jnp.sum(Bhat * vhat, axis=-1)
        B2 = jnp.sum(Bhat * Bhat, axis=-1)
        v2 = jnp.sum(vhat * vhat, axis=-1)
        b2 = B2 / (W * W) + Bv * Bv
        h = 1.0 + gamma / (gamma - 1.0) * p / rho
        bs2 = B2 / (W * W) + Bv * Bv * (2.0 + W * W * v2)
        TR = (rho * h + b2) * W * W * v2 + 3.0 * (p + 0.5 * b2) - bs2
        Estar = hydro[..., 0] + hydro[..., 4]
        zero = jnp.zeros_like(Estar)
        sS = [zero, zero, zero]
        for d in range(dim):
            sS[d] = (-Estar * dalpha[..., d]
                     + 2.0 * alpha * psi**5 * dpsi[..., d] * TR)
        s_tau = -(psi ** 4) * sum(
            Shat[..., d] * dalpha[..., d] for d in range(dim)
        )
        parts = ([zero] + sS + [s_tau]
                 + [zero] * 4                    # B*(3), φ*
                 + [zero] * (2 + 2 * dim))       # α, ψ, ∂α, ∂ψ
        return jnp.moveaxis(jnp.stack(parts, axis=-1), -1, var_axis)

    return source


def grmhd_cfc_dissipation_mask(dim: int = 2) -> tuple:
    """Freeze the metric slots against Rusanov smearing."""
    return (1.0,) * N_HYDRO + (0.0,) * (2 + 2 * dim)


def grmhd_cfc_admissible(dim: int = 2, gamma: float = 5.0 / 3.0,
                         iters: int = 20):
    """Limiter hook: flat magnetized recovery admissible on the hatted
    state + positive lapse and conformal factor."""
    hydro_ok = rmhd.rmhd_admissible(gamma=gamma, iters=iters)

    def ok(Q, var_axis):
        q = jnp.moveaxis(Q, var_axis, -1)
        _, alpha, psi, _, _ = _split(q, dim)
        return (hydro_ok(hat_state(q, dim), q.ndim - 1)
                & (alpha > 0) & (psi > 0))

    return ok
