"""Special-relativistic ideal MHD (RMHD) — the astrophysics flagship's
flat-space core.

The ExaHyPE application papers' headline solvers are GRMHD codes; their
numerical heart is flat-space RMHD: Valencia conserved variables, a
conservative-to-primitive inversion with the magnetic coupling, and
divergence cleaning.  This module composes the two existing families —
SRHD (`models/srhd.py`: con2prim, causal signal speeds) and ideal MHD
(`models/mhd.py`: GLM cleaning) — into the relativistic magnetized system
as batch-native callbacks (variable axis last) for the FV builder, the
ADER-DG solver, and the limiter.

State (c = 1, ideal-gas EOS, 3 momentum/field components in any dim):

    Q = [D, S_x, S_y, S_z, τ, B_x, B_y, B_z, ψ]        (9 variables)

with D = ρW, S_i = (ρh + b²)W²v_i − b⁰b_i, τ = (ρh + b²)W² − (p + b²/2)
− (b⁰)² − D, where b^μ is the fluid-frame field: b⁰ = W(B·v),
b_i = B_i/W + W(B·v)v_i, b² = B²/W² + (B·v)².

**con2prim** is the defining kernel: the root of the energy residual in
z = ρhW² (Noble-style 1-D inversion),

    f(z) = z + B² − p(z) − ½(B²/W(z)² + (S·B)²/z²) − (τ + D),

with v²(z) = [S²z² + (S·B)²(B² + 2z)] / [z²(z + B²)²] and the ideal-gas
closure p(z) = (γ−1)/γ · (z − DW)/W².  Like the SRHD recovery it runs a
FIXED-iteration safeguarded Newton (derivative by forward-mode AD of the
residual), every iterate confined to the physical bracket
z ∈ [max(D, |S| − B²), γ(E + B²)] tightened by the residual sign —
branch-free, so it inlines into jitted kernels.

Signal speeds use the standard fast-magnetosonic approximation
(c_ms² = c_s² + c_a² − c_s²c_a², relativistic velocity addition), clamped
to the light cone; the GLM cleaning wave rides at ``c_h ≤ 1``.

Reduction checks (tested): B = 0 reproduces `srhd` fluxes exactly;
conserved totals of D, S, τ, B are preserved to rounding through the
ADER-DG step; |λ| ≤ 1 always.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

N_VARS = 9


def prim_to_cons(rho, v, p, B, *, gamma: float = 5.0 / 3.0):
    """[ρ, v (var-last 3-vector), p, B (3-vector)] → [D, S, τ, B, ψ=0]."""
    v = jnp.asarray(v)
    B = jnp.asarray(B)
    v2 = jnp.sum(v * v, axis=-1)
    B2 = jnp.sum(B * B, axis=-1)
    Bv = jnp.sum(B * v, axis=-1)
    W = 1.0 / jnp.sqrt(1.0 - v2)
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    b2 = B2 / (W * W) + Bv * Bv
    wtot = rho * h + b2
    ptot = p + 0.5 * b2
    b0 = W * Bv
    bi = B / W[..., None] + (W * Bv)[..., None] * v
    D = rho * W
    S = (wtot * W * W)[..., None] * v - b0[..., None] * bi
    tau = wtot * W * W - ptot - b0 * b0 - D
    zeros = jnp.zeros_like(D)
    return jnp.concatenate(
        [D[..., None], S, tau[..., None], B, zeros[..., None]], axis=-1
    )


def con2prim(Q, *, gamma: float = 5.0 / 3.0, iters: int = 20,
             z_floor: float = 1e-12):
    """Recover ``(rho, v, p, W)`` from the conserved state (ψ ignored)."""
    D = Q[..., 0]
    S = Q[..., 1:4]
    tau = Q[..., 4]
    B = Q[..., 5:8]
    E = tau + D
    S2 = jnp.sum(S * S, axis=-1)
    B2 = jnp.sum(B * B, axis=-1)
    sB = jnp.sum(S * B, axis=-1)
    Smag = jnp.sqrt(S2)

    def resid(z):
        z2 = z * z
        zB = z + B2
        v2 = jnp.clip(
            (S2 * z2 + sB * sB * (B2 + 2.0 * z)) / (z2 * zB * zB),
            0.0,
            1.0 - 1e-12,
        )
        W = 1.0 / jnp.sqrt(1.0 - v2)
        p = (gamma - 1.0) / gamma * (z - D * W) / (W * W)
        return z + B2 - p - 0.5 * (B2 / (W * W) + sB * sB / z2) - E, (W, p)

    tiny = jnp.asarray(z_floor, Q.dtype) * (1.0 + Smag + B2)
    z_lo = jnp.maximum(jnp.maximum(D, Smag - B2) + tiny, z_floor)
    z_hi = jnp.maximum(gamma * (E + B2) + tiny, z_lo * 2.0)
    # Weak-field estimate: E ≈ z + B² − p with the SRHD-style pressure
    # guess from the field-corrected τ.
    p0 = jnp.maximum((gamma - 1.0) * (tau - 0.5 * B2), z_floor)
    z = jnp.clip(E - B2 + p0, z_lo, z_hi)

    for _ in range(iters):
        (f, _), (df, _) = jax.jvp(resid, (z,), (jnp.ones_like(z),))
        newton = z - f / df
        # f is increasing in z: tighten the bracket by the residual sign.
        z_lo = jnp.where(f < 0, z, z_lo)
        z_hi = jnp.where(f < 0, z_hi, z)
        inside = jnp.isfinite(newton) & (newton >= z_lo) & (newton <= z_hi)
        z = jnp.maximum(
            jnp.where(inside, newton, 0.5 * (z_lo + z_hi)), z_floor
        )

    _, (W, p) = resid(z)
    v = (S + (sB / z)[..., None] * B) / (z + B2)[..., None]
    # Subluminal clamp: on UNPHYSICAL inputs (the a-posteriori limiter
    # evaluates physics on candidate/reconstructed states before rejecting
    # them) the bracket can collapse to the floor and sB/z blows v up —
    # the recovery must still return bounded primitives so the flux and
    # eigenvalue stay finite.  Physical states are unaffected (|v| < 1
    # already holds there).
    v2 = jnp.sum(v * v, axis=-1)
    scale = jnp.sqrt((1.0 - 1e-12) / jnp.maximum(v2, 1e-300))
    v = v * jnp.minimum(1.0, scale)[..., None]
    W = 1.0 / jnp.sqrt(1.0 - jnp.clip(v2, 0.0, 1.0 - 1e-12))
    rho = D / W
    return rho, v, p, W


def con2prim_scalar(D, S_par, S_perp, tau, Bmag, *,
                    gamma: float = 5.0 / 3.0, iters: int = 20,
                    z_floor: float = 1e-12):
    """Scalar-core magnetized con2prim on the field-aligned decomposition
    ``(D, S_∥, S_⊥, τ, |B|)`` — the same safeguarded Newton on
    z = ρhW² as :func:`con2prim`, with NO stacked momentum/field axes:
    every input/output is a plain grid-shaped array.  The proxy is exact: the
    iteration depends on (S², s·B, B², τ, D) only, all expressible in
    the aligned frame.  Returns ``(rho, p, W)`` with the same
    subluminal clamp as the vector form."""
    S2 = S_par * S_par + S_perp * S_perp
    B2 = Bmag * Bmag
    sB = S_par * Bmag
    E = tau + D
    Smag = jnp.sqrt(S2)

    def resid(z):
        z2 = z * z
        zB = z + B2
        v2 = jnp.clip(
            (S2 * z2 + sB * sB * (B2 + 2.0 * z)) / (z2 * zB * zB),
            0.0,
            1.0 - 1e-12,
        )
        W = 1.0 / jnp.sqrt(1.0 - v2)
        p = (gamma - 1.0) / gamma * (z - D * W) / (W * W)
        return z + B2 - p - 0.5 * (B2 / (W * W) + sB * sB / z2) - E, (W, p)

    tiny = jnp.asarray(z_floor, D.dtype) * (1.0 + Smag + B2)
    z_lo = jnp.maximum(jnp.maximum(D, Smag - B2) + tiny, z_floor)
    z_hi = jnp.maximum(gamma * (E + B2) + tiny, z_lo * 2.0)
    p0 = jnp.maximum((gamma - 1.0) * (tau - 0.5 * B2), z_floor)
    z = jnp.clip(E - B2 + p0, z_lo, z_hi)

    for _ in range(iters):
        (f, _), (df, _) = jax.jvp(resid, (z,), (jnp.ones_like(z),))
        newton = z - f / df
        z_lo = jnp.where(f < 0, z, z_lo)
        z_hi = jnp.where(f < 0, z_hi, z)
        inside = jnp.isfinite(newton) & (newton >= z_lo) & (newton <= z_hi)
        z = jnp.maximum(
            jnp.where(inside, newton, 0.5 * (z_lo + z_hi)), z_floor
        )

    _, (W, p) = resid(z)
    v_par = (S_par + (sB / z) * Bmag) / (z + B2)
    v_perp = S_perp / (z + B2)
    v2 = v_par * v_par + v_perp * v_perp
    W = 1.0 / jnp.sqrt(1.0 - jnp.clip(v2, 0.0, 1.0 - 1e-12))
    rho = D / W
    return rho, p, W


def _flux_impl(Q, n, gamma, c_h, iters):
    rho, v, p, W = con2prim(Q, gamma=gamma, iters=iters)
    B = Q[..., 5:8]
    psi = Q[..., 8]
    D = Q[..., 0]
    S = Q[..., 1:4]
    tau = Q[..., 4]
    Bv = jnp.sum(B * v, axis=-1)
    B2 = jnp.sum(B * B, axis=-1)
    b2 = B2 / (W * W) + Bv * Bv
    ptot = p + 0.5 * b2
    b0 = W * Bv
    bi = B / W[..., None] + (W * Bv)[..., None] * v
    vn = v[..., n]
    Bn = B[..., n]
    fD = D * vn
    # F_{S_i} = S_i v_n + p_tot δ_{in} − b_i B_n / W
    fS = S * vn[..., None] - bi * (Bn / W)[..., None]
    fS = fS.at[..., n].add(ptot)
    ftau = (tau + ptot) * vn - Bv * Bn
    # Induction + GLM: F_{B_i} = v_n B_i − v_i B_n (+ δ_{in} ψ); F_ψ = c_h² B_n.
    fB = vn[..., None] * B - Bn[..., None] * v
    fB = fB.at[..., n].add(psi)
    fpsi = c_h * c_h * Bn
    return jnp.concatenate(
        [fD[..., None], fS, ftau[..., None], fB, fpsi[..., None]], axis=-1
    )


def rmhd_flux(Q, normal, *, gamma: float = 5.0 / 3.0, c_h: float = 1.0,
              iters: int = 20):
    return _flux_impl(Q, int(normal), gamma, c_h, iters)


def rmhd_eigenvalue(Q, normal, *, gamma: float = 5.0 / 3.0, c_h: float = 1.0,
                    iters: int = 20):
    """Fast-magnetosonic bound via relativistic velocity addition, clamped
    to the light cone; at least the GLM wave speed ``c_h``."""
    n = int(normal)
    rho, v, p, W = con2prim(Q, gamma=gamma, iters=iters)
    B = Q[..., 5:8]
    Bv = jnp.sum(B * v, axis=-1)
    B2 = jnp.sum(B * B, axis=-1)
    b2 = B2 / (W * W) + Bv * Bv
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    cs2 = jnp.clip(gamma * p / (rho * h), 0.0, 1.0 - 1e-12)
    ca2 = jnp.clip(b2 / (rho * h + b2), 0.0, 1.0 - 1e-12)
    cms = jnp.sqrt(jnp.clip(cs2 + ca2 - cs2 * ca2, 0.0, 1.0 - 1e-12))
    vn = jnp.abs(v[..., n])
    lam = (vn + cms) / (1.0 + vn * cms)
    return jnp.maximum(jnp.minimum(lam, 1.0), c_h)


def rmhd(gamma: float = 5.0 / 3.0, c_h: float = 1.0, iters: int = 20):
    """(flux, max_eigenvalue) batch-native pair (any dim; 9 variables)."""
    return (
        partial(rmhd_flux, gamma=gamma, c_h=c_h, iters=iters),
        partial(rmhd_eigenvalue, gamma=gamma, c_h=c_h, iters=iters),
    )


def rmhd_admissible(gamma: float = 5.0 / 3.0, iters: int = 20):
    """Admissibility hook for the MOOD limiter: finite state, positive
    density/pressure after recovery, subluminal velocity."""

    def ok(Q, var_axis):
        q = jnp.moveaxis(Q, var_axis, -1)
        rho, v, p, W = con2prim(q, gamma=gamma, iters=iters)
        v2 = jnp.sum(v * v, axis=-1)
        fin = jnp.all(jnp.isfinite(q), axis=-1)
        return fin & (rho > 0) & (p > 0) & (v2 < 1.0)

    return ok
