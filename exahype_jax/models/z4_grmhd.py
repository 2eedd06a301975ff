"""Coupled magnetized matter + dynamic spacetime: Z4 + GRMHD.

The full ExaGRyPE flagship shape (FO-Z4 spacetime + ideal GRMHD matter,
evolved together) — the magnetized extension of
:mod:`~exahype_jax.models.z4_matter`.  Reference-family context: the
reference repo bundles only flat Euler physics
(``Unit test/Functions.cpp:9-62``); this is a family-capability module.

State (47 variables, var-last in the ``*_rhs`` functions): the 38
zero-shift Z4 variables of :mod:`z4`, the densitized Valencia hydro
block of :mod:`z4_matter`, then the densitized magnetic sector:

    Q = [ α, γ_ij, K_ij, Θ, Z_i, A_k, D_kij,  D̃, S̃_i(3), τ̃,  B̃^i(3), φ̃ ]

with B̃^i = √γ B^i and φ̃ the GLM cleaning scalar.  The magnetic
constraint of the densitized field is the FLAT divergence ∂_d B̃^d = 0
— exact on any dynamic metric — so divergence cleaning stays the flat
GLM pair at coordinate speed α·c_h (the same design as
:mod:`grmhd_cfc`'s "GLM on the densitized field").

Ideal-MHD closure (zero shift; b^μ the fluid-frame field):

    αb⁰ = W(v·B),   b_i = B_i/W² ·W = B_i/W + W(v·B)v_i,
    b²  = B²/W² + (v·B)²,   p* = p + b²/2,   ρh* = ρh + b²

(B² = γ_ij B^iB^j, v·B = v_i B^i).  Conserved (undensitized):
D = ρW, S_i = (ρhW² + B²)v_i − (v·B)B_i, τ = ρh*W² − p* − (αb⁰)² − D.

Fluxes along d (densitized by √γ, zero shift):

    F(D̃)    = α D̃ v^d
    F(S̃_j)  = α [ S̃_j v^d + √γ p* δ^d_j − √γ B^d (B_j/W² + (v·B) v_j) ]
    F(τ̃)    = α [ (τ̃ + √γ p*) v^d − √γ (v·B) B^d ]
    F(B̃^j)  = α ( v^d B̃^j − v^j B̃^d ) + δ^{dj} α φ̃
    F(φ̃)    = α c_h² B̃^d

Geometric sources are the :mod:`z4_matter` ones with the TOTAL
(fluid + electromagnetic) stress-energy projections

    E    = τ + D
    S_i  = the conserved momentum itself
    S^ij = ρh*W² v^iv^j + p* γ^{ij} − b^ib^j        (b^i = B^i/W + W(v·B)v^i)
    S_ij = ρh*W² v_iv_j + p* γ_ij − b_ib_j

and the Z4 sector takes the trace-reversed −8πα[S_ij − ½γ_ij(S−E)],
−8παE, −8παS_i with the same projections; the GLM scalar damps as
∂_t φ̃ = −α κ φ̃ and carries no stress-energy (it is a numerical device).

Conservative-to-primitive recovery reuses the flat safeguarded Newton of
:mod:`rmhd` unchanged: the residual in z = ρhW² depends on the metric
only through the scalars (|S|²_γ, S·B, |B|²_γ), so the curved recovery
is the flat one fed a scalar-equivalent proxy state; the covariant
velocity then follows from v_i = (S_i + (S·B/z)B_i)/(z + B²).

Validation (``tests/test_z4_grmhd.py``): exact B = 0 reduction to the
coupled hydro system; flat-frozen-metric flux reduction to :mod:`rmhd`;
stress-energy projections against an INDEPENDENT 4-tensor construction
(u^μ, b^μ, T^{μν} = ρh*u^μu^ν + p*g^{μν} − b^μb^ν contracted with the
normal/projector — a different derivation path); magnetized-FLRW
consistency; limiter and sharding composition.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.models import rmhd
from exahype_jax.models.z4 import (
    N_VARS as N_Z4,
    _AL,
    _G,
    _slicing,
    _z4_core,
    inv3,
    mat_to_sym,
    pack,
    sym_to_mat,
    unpack,
)
from exahype_jax.models.z4_matter import EIGHT_PI

#: Every einsum of state at HIGHEST precision (see models/aderdg.py).
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

N_VARS = N_Z4 + 9  # 47

_HD = N_Z4            # D̃
_HS = slice(N_Z4 + 1, N_Z4 + 4)   # S̃_i
_HTAU = N_Z4 + 4      # τ̃
_HB = slice(N_Z4 + 5, N_Z4 + 8)   # B̃^i
_HPSI = N_Z4 + 8      # φ̃


# ------------------------------------------------------------- recovery


def recover(q, *, gamma: float = 5.0 / 3.0, iters: int = 20):
    """Curved-metric magnetized con2prim on the var-last coupled state.

    Returns ``(rho, v_low[3], p, W, vB, sqg, gi)`` — primitives, the
    COVARIANT velocity, v·B = v_iB^i, √γ, and the inverse metric.  The
    flat :func:`rmhd.con2prim` runs on a scalar-equivalent proxy state
    (same D, τ, |S|, S·B, |B|), inheriting all its boundedness
    guarantees; the covariant velocity follows from the recovered
    z = ρhW².
    """
    g = sym_to_mat(q[..., _G])
    gi, detg = inv3(g)
    sqg = jnp.sqrt(detg)
    D = q[..., _HD] / sqg
    S = q[..., _HS] / sqg[..., None]          # lower index
    tau = q[..., _HTAU] / sqg
    Bup = q[..., _HB] / sqg[..., None]        # upper index
    B_low = _einsum("...ij,...j->...i", g, Bup)
    S2 = _einsum("...ij,...i,...j->...", gi, S, S)
    B2 = _einsum("...i,...i->...", Bup, B_low)
    sB = _einsum("...i,...i->...", S, Bup)
    Smag = jnp.sqrt(jnp.maximum(S2, 0.0))
    Bmag = jnp.sqrt(jnp.maximum(B2, 0.0))
    # Scalar-equivalent flat proxy: B̄ ∥ x̂, S̄ in the x-y plane.
    safe_B = jnp.maximum(Bmag, 1e-300)
    S_par = sB / safe_B
    S_perp = jnp.sqrt(jnp.maximum(S2 - S_par * S_par, 0.0))
    zeros = jnp.zeros_like(D)
    flat = jnp.stack(
        [D, S_par, S_perp, zeros, tau, Bmag, zeros, zeros, zeros],
        axis=-1,
    )
    rho, _, p, W = rmhd.con2prim(flat, gamma=gamma, iters=iters)
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    z = rho * h * W * W
    v_low = (S + (sB / z)[..., None] * B_low) / (z + B2)[..., None]
    # Subluminal clamp in the REAL metric (limiter totality: candidate
    # states may be unphysical; physical states are unaffected).
    v2 = _einsum("...ij,...i,...j->...", gi, v_low, v_low)
    scale = jnp.sqrt((1.0 - 1e-12) / jnp.maximum(v2, 1e-300))
    v_low = v_low * jnp.minimum(1.0, scale)[..., None]
    v2 = jnp.clip(v2, 0.0, 1.0 - 1e-12)
    W = 1.0 / jnp.sqrt(1.0 - v2)
    vB = _einsum("...i,...i->...", v_low, Bup)
    return rho, v_low, p, W, vB, sqg, gi


def stress_energy(q, *, gamma: float = 5.0 / 3.0, iters: int = 20):
    """TOTAL (fluid + EM) matter projections (E, S_i, S_ij, trace S)."""
    g = sym_to_mat(q[..., _G])
    rho, v_low, p, W, vB, sqg, gi = recover(q, gamma=gamma, iters=iters)
    Bup = q[..., _HB] / sqg[..., None]
    B_low = _einsum("...ij,...j->...i", g, Bup)
    B2 = _einsum("...i,...i->...", Bup, B_low)
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    whW2 = rho * h * W * W + b2 * W * W        # ρh* W²
    b_low = B_low / W[..., None] + (W * vB)[..., None] * v_low
    E = whW2 - ptot - (W * vB) ** 2
    S_low = whW2[..., None] * v_low - (W * vB)[..., None] * b_low
    S_ij = (
        whW2[..., None, None]
        * _einsum("...i,...j->...ij", v_low, v_low)
        + ptot[..., None, None] * g
        - _einsum("...i,...j->...ij", b_low, b_low)
    )
    v2 = _einsum("...ij,...i,...j->...", gi, v_low, v_low)
    bib_up = b2 + (W * vB) ** 2                # b_i b^i
    S_tr = whW2 * v2 + 3.0 * ptot - bib_up
    return E, S_low, S_ij, S_tr


# ------------------------------------------------------------------ RHS


def z4_grmhd_rhs(
    q,
    dq3,
    *,
    gamma: float = 5.0 / 3.0,
    iters: int = 20,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    glm_kappa: float = 0.0,
):
    """Coupled RHS EXCLUDING the conservative flux divergence: vacuum Z4
    + total-stress-energy matter sources on (K, Θ, Z) + the algebraic
    hydro geometric sources + GLM damping.  Affine in ``dq3``."""
    al, g, K, th, Z, A, D = unpack(q[..., :N_Z4])
    dz = dq3[..., :N_Z4]
    dK = sym_to_mat(dz[..., 7:13])
    dth = dz[..., 13]
    dZ = dz[..., 14:17]
    dA = dz[..., 17:20]
    dD = sym_to_mat(dz[..., 20:38].reshape(dz.shape[:-1] + (3, 6)))
    r_al, r_g, r_K, r_th, r_Z, r_A, r_D = _z4_core(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )

    E, S_low, S_ij, S_tr = stress_energy(q, gamma=gamma, iters=iters)
    alx = al[..., None]
    alxx = al[..., None, None]
    r_K = r_K - EIGHT_PI * alxx * (
        S_ij - 0.5 * (S_tr - E)[..., None, None] * g
    )
    r_th = r_th - EIGHT_PI * al * E
    r_Z = r_Z - EIGHT_PI * alx * S_low

    # Hydro geometric sources with the TOTAL S^{ik}.
    rho, v_low, p, W, vB, sqg, gi = recover(q, gamma=gamma, iters=iters)
    Bup = q[..., _HB] / sqg[..., None]
    B_low = _einsum("...ij,...j->...i", g, Bup)
    B2 = _einsum("...i,...i->...", Bup, B_low)
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    whW2 = rho * h * W * W + b2 * W * W
    v_up = _einsum("...ij,...j->...i", gi, v_low)
    b_up = Bup / W[..., None] + (W * vB)[..., None] * v_up
    S_up2 = (
        whW2[..., None, None]
        * _einsum("...i,...j->...ij", v_up, v_up)
        + ptot[..., None, None] * gi
        - _einsum("...i,...j->...ij", b_up, b_up)
    )  # S^{ik}
    asg = al * sqg
    r_Dt = jnp.zeros_like(al)
    r_S = asg[..., None] * (
        _einsum("...ik,...jik->...j", S_up2, D) - E[..., None] * A
    )
    S_up = _einsum("...ij,...j->...i", gi, S_low)
    r_tau = asg * (
        _einsum("...ik,...ik->...", S_up2, K)
        - _einsum("...k,...k->...", S_up, A)
    )
    r_B = jnp.zeros(q.shape[:-1] + (3,), q.dtype)
    r_psi = -glm_kappa * al * q[..., _HPSI]
    z4_part = pack(r_al, r_g, r_K, r_th, r_Z, r_A, r_D)
    return jnp.concatenate(
        [z4_part, r_Dt[..., None], r_S, r_tau[..., None], r_B,
         r_psi[..., None]], axis=-1,
    )


def z4_grmhd_flux(Q, axis, var_axis, *, gamma: float = 5.0 / 3.0,
                  iters: int = 20, c_h: float = 1.0):
    """Conservative flux along grid ``axis``: magnetized Valencia rows on
    the dynamic metric + induction + GLM, zero Z4 rows."""
    q = jnp.moveaxis(Q, var_axis, -1)
    al = q[..., _AL]
    rho, v_low, p, W, vB, sqg, gi = recover(q, gamma=gamma, iters=iters)
    g = sym_to_mat(q[..., _G])
    Bt = q[..., _HB]                          # densitized B̃^i
    Bup = Bt / sqg[..., None]
    B_low = _einsum("...ij,...j->...i", g, Bup)
    B2 = _einsum("...i,...i->...", Bup, B_low)
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    v_up = _einsum("...ij,...j->...i", gi, v_low)
    vd = v_up[..., axis]
    Bd = Bup[..., axis]
    Dt = q[..., _HD]
    St = q[..., _HS]
    taut = q[..., _HTAU]
    psi = q[..., _HPSI]
    psg = ptot * sqg
    one_hot = jnp.asarray(np.eye(3)[axis], q.dtype)
    f_D = al * Dt * vd
    f_S = (
        al[..., None] * (St * vd[..., None])
        + (al * psg)[..., None] * one_hot
        - (al * sqg * Bd)[..., None]
        * (B_low / (W * W)[..., None] + vB[..., None] * v_low)
    )
    f_tau = al * ((taut + psg) * vd - sqg * vB * Bd)
    f_B = (
        al[..., None] * (vd[..., None] * Bt - Bt[..., axis:axis + 1] * v_up)
        + (al * psi)[..., None] * one_hot
    )
    f_psi = al * c_h * c_h * Bt[..., axis]
    out = jnp.concatenate(
        [
            jnp.zeros(q.shape[:-1] + (N_Z4,), q.dtype),
            f_D[..., None],
            f_S,
            f_tau[..., None],
            f_B,
            f_psi[..., None],
        ],
        axis=-1,
    )
    return jnp.moveaxis(out, -1, var_axis)


def z4_grmhd_eig(Q, axis, var_axis, *, slicing: str = "harmonic",
                 f: float = 1.0, c_h: float = 1.0):
    """Rusanov bound: the widest of the gauge cone, the light cone (all
    magnetosonic speeds lie inside it), and the GLM coordinate speed
    α·c_h."""
    q = jnp.moveaxis(Q, var_axis, -1)
    al = q[..., _AL]
    gi, _ = inv3(sym_to_mat(q[..., _G]))
    gdd = gi[..., axis, axis]
    g_of, _ = _slicing(slicing, f)
    cone = jnp.sqrt(jnp.maximum(g_of(al), 1.0) * gdd)
    return al * jnp.maximum(cone, c_h)


# ------------------------------------------------------------ system


def z4_grmhd_system(
    gamma: float = 5.0 / 3.0,
    iters: int = 20,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    c_h: float = 1.0,
    glm_kappa: float = 0.0,
    impl: str = "einsum",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) in the solver
    ``(Q, axis, var_axis)`` contract.  ``impl='soa'`` routes the
    NCP/source algebra through :func:`z4_grmhd_rhs_soa`."""
    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m,
              kappa1=kappa1, kappa2=kappa2, glm_kappa=glm_kappa)

    rhs_impl = z4_grmhd_rhs_soa if impl == "soa" else z4_grmhd_rhs

    def _rhs(q, dq3):
        return rhs_impl(q, dq3, **kw)

    def flux(Q, axis, va):
        return z4_grmhd_flux(Q, axis, va, gamma=gamma, iters=iters,
                             c_h=c_h)

    def eig(Q, axis, va):
        return z4_grmhd_eig(Q, axis, va, slicing=slicing, f=f, c_h=c_h)

    def source(Q, va):
        q = jnp.moveaxis(Q, va, -1)
        dq3 = jnp.zeros(q.shape[:-1] + (3, N_VARS), q.dtype)
        return jnp.moveaxis(_rhs(q, dq3), -1, va)

    def ncp(Q, dQ, axis, va):
        q = jnp.moveaxis(Q, va, -1)
        dq = jnp.moveaxis(dQ, va, -1)
        zeros = jnp.zeros(q.shape[:-1] + (3, N_VARS), q.dtype)
        zrow = jnp.zeros_like(dq)
        dq3 = jnp.stack(
            [dq if d == axis else zrow for d in range(3)], axis=-2
        )
        out = _rhs(q, zeros) - _rhs(q, dq3)
        return jnp.moveaxis(out, -1, va)

    return flux, eig, ncp, source


def make_z4_grmhd_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    gamma: float = 5.0 / 3.0,
    iters: int = 20,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    c_h: float = 1.0,
    glm_kappa: float = 0.0,
    impl: str = "einsum",
    fused_rhs=False,
    **kwargs,
):
    """A fully-configured coupled Z4+GRMHD ADER-DG solver.  ``fused_rhs``
    installs the one-evaluation ``rhs_all_fn`` hook ("soa" = from the
    SoA twin)."""
    from exahype_jax.models.aderdg import ADERDGSolver
    from exahype_jax.models.z4 import _rhs_all_of

    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m,
              kappa1=kappa1, kappa2=kappa2, glm_kappa=glm_kappa)
    flux, eig, ncp, source = z4_grmhd_system(
        c_h=c_h, impl=impl, **kw
    )
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(
            lambda q, dq3: z4_grmhd_rhs_soa(q, dq3, **kw), N_VARS,
        )
    elif fused_rhs:
        rhs_all = _rhs_all_of(
            lambda q, dq3: z4_grmhd_rhs(q, dq3, **kw), N_VARS
        )
    else:
        rhs_all = None
    return ADERDGSolver(
        dim=dim,
        order=order,
        n_vars=N_VARS,
        grid_shape=grid_shape,
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        ncp_fn=ncp,
        source_fn=source,
        rhs_all_fn=rhs_all,
        dx=dx,
        **kwargs,
    )


def z4_grmhd_admissible(gamma: float = 5.0 / 3.0, iters: int = 20):
    """Limiter admissibility: positive lapse and metric (leading minors),
    positive magnetized recovery, subluminal."""

    def ok(Q, var_axis):
        q = jnp.moveaxis(Q, var_axis, -1)
        al = q[..., _AL]
        g = sym_to_mat(q[..., _G])
        m1 = g[..., 0, 0]
        m2 = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] ** 2
        _, detg = inv3(g)
        rho, v_low, p, W, vB, sqg, gi = recover(q, gamma=gamma,
                                                iters=iters)
        v2 = _einsum("...ij,...i,...j->...", gi, v_low, v_low)
        fin = jnp.all(jnp.isfinite(q), axis=-1)
        return (
            fin
            & (al > 0)
            & (m1 > 0)
            & (m2 > 0)
            & (detg > 0)
            & (rho > 0)
            & (p > 0)
            & (v2 < 1.0)
        )

    return ok


# --------------------------------------------------------------- states


def pack_matter_mhd(z4_vals, rho, v_low, p, B_up, *,
                    gamma: float = 5.0 / 3.0, psi_glm=0.0):
    """Z4 var-last values [..., 38] + primitives (v_i covariant, B^i
    contravariant) → coupled state [..., 47]."""
    z4_vals = jnp.asarray(z4_vals)
    g = sym_to_mat(z4_vals[..., _G])
    gi, detg = inv3(g)
    sqg = jnp.sqrt(detg)
    rho = jnp.asarray(rho)
    p = jnp.asarray(p)
    v_low = jnp.broadcast_to(jnp.asarray(v_low), rho.shape + (3,))
    B_up = jnp.broadcast_to(jnp.asarray(B_up), rho.shape + (3,))
    B_low = _einsum("...ij,...j->...i", g, B_up)
    B2 = _einsum("...i,...i->...", B_up, B_low)
    v2 = _einsum("...ij,...i,...j->...", gi, v_low, v_low)
    vB = _einsum("...i,...i->...", v_low, B_up)
    W = 1.0 / jnp.sqrt(1.0 - v2)
    eps = p / ((gamma - 1.0) * rho)
    h = 1.0 + eps + p / rho
    z = rho * h * W * W
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    b_low = B_low / W[..., None] + (W * vB)[..., None] * v_low
    whW2 = z + b2 * W * W
    Dt = sqg * rho * W
    St = sqg[..., None] * (
        whW2[..., None] * v_low - (W * vB)[..., None] * b_low
    )
    taut = sqg * (whW2 - ptot - (W * vB) ** 2) - Dt
    Bt = sqg[..., None] * B_up
    psit = jnp.broadcast_to(jnp.asarray(psi_glm, Dt.dtype), Dt.shape)
    return jnp.concatenate(
        [z4_vals, Dt[..., None], St, taut[..., None], Bt,
         psit[..., None]], axis=-1,
    )


# ------------------------------------------------- SoA-unrolled evaluation


def z4_grmhd_rhs_soa(
    q,
    dq3,
    *,
    gamma: float = 5.0 / 3.0,
    iters: int = 20,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    glm_kappa: float = 0.0,
):
    """Component-unrolled twin of :func:`z4_grmhd_rhs` (identical algebra
    to rounding — parity-tested): the vacuum SoA core plus total-stress-
    energy matter terms with object-array tensors (see
    :func:`~exahype_jax.models.z4.z4_rhs_soa`)."""
    from exahype_jax.models.z4 import (
        _oein,
        _oinv3,
        _vec_obj,
        _vsl,
        _z4_core_soa,
        _z4_pack_soa,
        _z4_unpack_soa,
    )

    al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD = _z4_unpack_soa(q, dq3)
    r_al, r_g, r_K, r_th, r_Z, r_A, r_D = _z4_core_soa(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )

    gi, detg = _oinv3(g)
    sqg = jnp.sqrt(detg)
    Dt = _vsl(q, _HD)
    St = _vec_obj(q, _HS)
    taut = _vsl(q, _HTAU)
    Btil = _vec_obj(q, _HB)
    Dh = Dt / sqg
    tau = taut / sqg
    S_low = np.empty((3,), dtype=object)
    Bup = np.empty((3,), dtype=object)
    for i in range(3):
        S_low[i] = St[i] / sqg
        Bup[i] = Btil[i] / sqg
    B_low = _oein("ij,j->i", g, Bup)
    S2 = _oein("ij,i,j->", gi, S_low, S_low)
    B2 = _oein("i,i->", Bup, B_low)
    sB = _oein("i,i->", S_low, Bup)
    Smag = jnp.sqrt(jnp.maximum(S2, 0.0))
    Bmag = jnp.sqrt(jnp.maximum(B2, 0.0))
    safe_B = jnp.maximum(Bmag, 1e-300)
    S_par = sB / safe_B
    S_perp = jnp.sqrt(jnp.maximum(S2 - S_par * S_par, 0.0))
    rho, p, W = rmhd.con2prim_scalar(
        Dh, S_par, S_perp, tau, Bmag, gamma=gamma, iters=iters
    )
    h_f = 1.0 + gamma / (gamma - 1.0) * p / rho
    z = rho * h_f * W * W
    v_low = np.empty((3,), dtype=object)
    for i in range(3):
        v_low[i] = (S_low[i] + (sB / z) * B_low[i]) / (z + B2)
    v2 = _oein("ij,i,j->", gi, v_low, v_low)
    scale = jnp.minimum(
        1.0, jnp.sqrt((1.0 - 1e-12) / jnp.maximum(v2, 1e-300))
    )
    for i in range(3):
        v_low[i] = v_low[i] * scale
    v2 = jnp.clip(v2 * scale * scale, 0.0, 1.0 - 1e-12)
    W = 1.0 / jnp.sqrt(1.0 - v2)
    vB = _oein("i,i->", v_low, Bup)
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    whW2 = rho * h_f * W * W + b2 * W * W
    b_low = np.empty((3,), dtype=object)
    for i in range(3):
        b_low[i] = B_low[i] / W + (W * vB) * v_low[i]
    E = whW2 - ptot - (W * vB) ** 2
    Sm_low = np.empty((3,), dtype=object)
    for i in range(3):
        Sm_low[i] = whW2 * v_low[i] - (W * vB) * b_low[i]
    bib_up = b2 + (W * vB) ** 2
    S_tr = whW2 * v2 + 3.0 * ptot - bib_up
    half_tr = 0.5 * (S_tr - E)
    for i in range(3):
        for j in range(3):
            S_ij = (whW2 * v_low[i] * v_low[j] + ptot * g[i, j]
                    - b_low[i] * b_low[j])
            r_K[i, j] = r_K[i, j] - EIGHT_PI * al * (
                S_ij - half_tr * g[i, j]
            )
    r_th = r_th - EIGHT_PI * al * E
    for i in range(3):
        r_Z[i] = r_Z[i] - EIGHT_PI * al * Sm_low[i]

    # Hydro geometric sources with the TOTAL S^{ik}.
    v_up = _oein("ij,j->i", gi, v_low)
    b_up = np.empty((3,), dtype=object)
    for i in range(3):
        b_up[i] = Bup[i] / W + (W * vB) * v_up[i]
    Sup = np.empty((3, 3), dtype=object)
    for i in range(3):
        for j in range(3):
            Sup[i, j] = (whW2 * v_up[i] * v_up[j] + ptot * gi[i, j]
                         - b_up[i] * b_up[j])
    asg = al * sqg
    r_S = _oein("ik,jik->j", Sup, D)
    SupK = _oein("ik,ik->", Sup, K)
    S_up_vec = _oein("ij,j->i", gi, Sm_low)
    SA = _oein("k,k->", S_up_vec, A)
    extra = [jnp.zeros_like(al)]
    for j in range(3):
        extra.append(asg * (r_S[j] - E * A[j]))
    extra.append(asg * (SupK - SA))
    for j in range(3):
        extra.append(jnp.zeros_like(al))
    extra.append(-glm_kappa * al * _vsl(q, _HPSI))
    return _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D,
                        extra=tuple(extra))
